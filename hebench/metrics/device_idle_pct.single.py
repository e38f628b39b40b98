"""Device idle share of a traced stretch of ``decode_frame`` calls, in
percent: 100 less the union of the device's operations over the
stretch's wall."""


def read(data: dict):
    tr = data.get("trace")
    if tr is None or tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s() / tr.window_s)
