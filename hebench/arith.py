"""Metric arithmetic of the benchmark: percentiles, and kernel K1's
bytes and its roofline share.  Plain Python and NumPy."""
from __future__ import annotations

import numpy as np

# NVIDIA H100 SXM data sheet: HBM3 at 3.35 TB/s (a card below 700 W may
# not reach it: the run prints the card's power limit beside the share)
HBM_BYTES_PER_S = 3.35e12
F32 = 4
# K1's allpass bands by the PS configuration's stereo bands
K1_NAPB = {20: 30, 34: 50}


def percentile(values, q: float) -> float:
    """The q-th percentile (0-100) of every value, linear between the
    two nearest ranks (numpy's default)."""
    v = np.asarray(values, np.float64)
    if v.size == 0:
        raise ValueError("percentile of no values")
    return float(np.percentile(v, q))


def k1_bytes(B: int, napb: int) -> int:
    """Bytes kernel K1 (``ps_decorrelate_kernel``) moves at B lanes and
    napb allpass bands, each input read once and each output written
    once (``heaac_tpu_torch/ops/ps_decorrelate.py`` ``decorrelate_seq``'s
    shapes, all float32): inputs power [B,34,32], in_re and in_im
    [B,napb,32], trans [B,34,3], ap [B,napb,3,5,2], ag [napb,3],
    qf [napb,3,2]; outputs tgain [B,32,34], ap_out [B,napb,32,2],
    new_trans [B,34,3], new_ap [B,napb,3,5,2]."""
    inputs = (B * 34 * 32 + 2 * B * napb * 32 + B * 34 * 3
              + B * napb * 30 + napb * 3 + napb * 6)
    outputs = B * 32 * 34 + B * napb * 64 + B * 34 * 3 + B * napb * 30
    return F32 * (inputs + outputs)


def k1_bound_s(B: int, napb: int) -> float:
    """K1's least time at B lanes and napb: its bytes over HBM's rate.
    (Its float32 operations, B * 32 * (34 * 11 + napb * 42), take under
    a tenth of that at 67 TFLOP/s: the bytes bound it.)"""
    return k1_bytes(B, napb) / HBM_BYTES_PER_S


def k1_bound_total_s(lane_frames: int, launches: int, napb: int) -> float:
    """K1's least time over ``launches`` launches that together decode
    ``lane_frames`` (lane, frame) pairs: its bytes are linear in the
    lanes of a launch, so the sum over launches needs only the total
    lanes and the count, not how the lanes were grouped."""
    fixed = k1_bytes(0, napb)                   # ag, qf: once a launch
    per_lane = k1_bytes(1, napb) - fixed
    return (per_lane * lane_frames + fixed * launches) / HBM_BYTES_PER_S


def roofline_pct(bound_s: float, measured_s: float) -> float | None:
    """Least time over measured time, in percent; None without a time."""
    if measured_s <= 0:
        return None
    return 100.0 * bound_s / measured_s
