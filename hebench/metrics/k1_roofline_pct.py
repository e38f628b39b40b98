"""Kernel K1's share of its roofline, in percent: the least time its
bytes take at HBM's rate over its time on the card, summed over the
traced launches of ``ps_decorrelate_kernel``.  The bytes come from the
work the traced call had to do, not from the program: every (lane,
frame) pair the cell's streams hold (``k1_lane_frames``) at the allpass
bands of the configuration's PS mode (``k1_napb``), and the launches
the trace shows.  Lanes the program pads in, or steps past a stream's
end, are work the bound does not count.  Nothing to read where K1 did
not run."""
from hebench.arith import k1_bound_total_s, roofline_pct

KERNEL = "ps_decorrelate_kernel"


def read(data: dict):
    tr = data.get("trace")
    if tr is None or not data.get("k1_lane_frames"):
        return None
    times = tr.kernel_durations_s(KERNEL)
    if len(times) == 0:
        return None
    bound = k1_bound_total_s(data["k1_lane_frames"], len(times),
                             data["k1_napb"])
    return roofline_pct(bound, float(times.sum()))
