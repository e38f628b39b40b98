"""A rank's PCM to its host, milliseconds a call: the program's span
``multihost.pcm`` (the copies off the card and the per-stream split),
the mean over ranks and traced calls."""

SPAN = "multihost.pcm"


def read(data: dict):
    v = [s[SPAN] for s in data.get("spans") or () if s and SPAN in s]
    return sum(v) / len(v) if v else None
