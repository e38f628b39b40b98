"""Device idle share of rank 0's card over one traced multi-rank call,
in percent: 100 less the union of the card's operations over the
call's wall on rank 0 (the all-reduce's wait for the other ranks
included)."""


def read(data: dict):
    tr = data.get("trace")
    if tr is None or tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s() / tr.window_s)
