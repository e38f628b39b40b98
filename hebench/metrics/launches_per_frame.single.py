"""Kernel launches of a traced stretch of ``decode_frame`` calls over
its frames: a count."""


def read(data: dict):
    tr = data.get("trace")
    if tr is None or not data.get("frames"):
        return None
    return tr.launches() / data["frames"]
