"""qwire scan, milliseconds a frame step: the harness's clock around one
group's scan with its wire already on the card, synchronised, over the
group's frame steps.  The Python frame loop's host issue is in it."""


def read(data: dict):
    if not data.get("scan_steps"):
        return None
    return data["scan_s"] / data["scan_steps"] * 1e3
