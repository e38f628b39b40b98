"""A rank's decode, milliseconds a call: the program's span
``multihost.decode`` (its shard's parse, scan and PCM on its host, the
all-reduce left out), the mean over ranks and traced calls."""

SPAN = "multihost.decode"


def read(data: dict):
    v = [s[SPAN] for s in data.get("spans") or () if s and SPAN in s]
    return sum(v) / len(v) if v else None
