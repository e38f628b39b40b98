"""The comparison that decides ``correct``: the program's int16 PCM
against the plain reference (``hebench.ref``), decoded again from the
same ADTS bytes in worker processes that import nothing but NumPy and
the reference.

Numbers compared, pooled over every sample of every stream checked:
  gt2_lsb_pct   samples that differ from the reference by more than
                2 int16 LSB, in percent;
  rms_lsb       root mean square of the difference, in LSB;
  max_lsb       the widest difference, in LSB;
  bad_streams   streams whose PCM has another length or channel count
                than the reference's (over the sampled streams), or, in
                the batched traffic, than their frames give (over every
                stream of every call).
The control is the reference itself with its IMDCT and QMF transforms
computed as TF32 matrix products (``ref.ops.imdct.imdct_half_tf32``),
read by the same numbers against the float32 reference.
"""
from __future__ import annotations

import numpy as np

from .pool import pool_map

NUMBERS = ("gt2_lsb_pct", "rms_lsb", "max_lsb", "bad_streams")


def ref_pcm(args) -> np.ndarray:
    """One stream through the reference -> int16 [samples, channels]."""
    data, tf32 = args
    from .ref.bitstream.adts import split_adts_stream
    from .ref.codec.decoder import Decoder
    from .ref.ops.imdct import imdct_half_ref, imdct_half_tf32
    frames = split_adts_stream(data)
    dec = Decoder(adts_probe=frames[0][:7],
                  transform=imdct_half_tf32 if tf32 else imdct_half_ref)
    return np.concatenate([dec.decode_frame(f) for f in frames])


def reference(streams: list, tf32: bool = False, workers=None) -> list:
    return pool_map(ref_pcm, [(s, tf32) for s in streams], workers)


def compare(got: list, want: list) -> dict:
    """The compared numbers of PCM ``got`` against ``want`` (lists of
    int16 arrays, pairwise)."""
    n = gt2 = 0
    sq = 0.0
    mx = 0
    bad = 0
    for g, w in zip(got, want):
        g = np.asarray(g)
        if g.shape != w.shape:
            bad += 1
            continue
        d = np.abs(g.astype(np.int64) - w.astype(np.int64))
        n += d.size
        gt2 += int((d > 2).sum())
        sq += float((d.astype(np.float64) ** 2).sum())
        mx = max(mx, int(d.max()) if d.size else 0)
    return dict(gt2_lsb_pct=100.0 * gt2 / n if n else None,
                rms_lsb=(sq / n) ** 0.5 if n else None,
                max_lsb=mx if n else None, bad_streams=bad)


def judge(numbers: dict, limits: dict) -> tuple:
    """-> (correct, {name: {"value", "limit"}}): every number at or
    under its limit; a number that could not be read fails."""
    rows = {}
    ok = True
    for name in NUMBERS:
        v, lim = numbers.get(name), limits[name]
        rows[name] = {"value": v, "limit": lim}
        if v is None or v > lim:
            ok = False
    return ok, rows
