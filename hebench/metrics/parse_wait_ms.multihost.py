"""A rank's wait for its host parse, milliseconds a call: the program's
spans ``group.parse_wait`` under ``multihost.decode`` (a rank's one
group is parsed with no scan to overlap), summed over a call, the mean
over ranks and traced calls."""

SPAN = "group.parse_wait"


def read(data: dict):
    v = [s[SPAN] for s in data.get("spans") or () if s and SPAN in s]
    return sum(v) / len(v) if v else None
