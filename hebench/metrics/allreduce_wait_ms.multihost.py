"""A rank's all-reduce, milliseconds a call: the program's span
``multihost.allreduce`` (the collective, with the wait for the slowest
rank), the mean over ranks and traced calls."""

SPAN = "multihost.allreduce"


def read(data: dict):
    v = [s[SPAN] for s in data.get("spans") or () if s and SPAN in s]
    return sum(v) / len(v) if v else None
