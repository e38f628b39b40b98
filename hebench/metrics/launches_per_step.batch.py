"""Kernel launches of one traced ``decode_batch`` call over the frame
steps of its groups (the program's ``bucket_stats`` records): a count."""


def read(data: dict):
    tr = data.get("trace")
    if tr is None or not data.get("steps"):
        return None
    return tr.launches() / data["steps"]
