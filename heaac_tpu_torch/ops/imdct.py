"""The long IMDCT in its four-step FFT form.

Counterpart: ``heaac_tpu/ops/imdct.py`` — imdct_fft_consts and
imdct_half_fft.  The decode path computes the IMDCT as one matmul with
the transform's matrix (``codec/core.py``); this form (pre-rotation, an
n/4-point inverse DFT factored into two small complex matmuls and a
twiddle, post-rotation) costs ~20x fewer operations at n2 = 1024 and is
the same transform as ``imdct_half`` (libavcodec/mdct.c:124-159).  No
decode path of either package calls it.
"""
from __future__ import annotations

import functools

import numpy as np
import torch


@functools.cache
def imdct_fft_consts(n2: int = 1024, f1: int = 32,
                     scale: float = 1.0) -> tuple:
    """Constants for ``imdct_half_fft`` (numpy float32): pre/post twiddles
    and the two DFT-factor matrices of n4 = f1 * f2, then f1 and f2."""
    n = 2 * n2
    n4 = n // 4
    f2 = n4 // f1
    theta = 1.0 / 8.0 + (n4 if scale < 0 else 0)
    sc = np.sqrt(abs(scale))
    alpha = 2 * np.pi * (np.arange(n4) + theta) / n
    tcos = (-np.cos(alpha) * sc).astype(np.float32)
    tsin = (-np.sin(alpha) * sc).astype(np.float32)
    j1 = np.arange(f1)
    w1 = np.exp(2j * np.pi * np.outer(j1, j1) / f1)        # [f1,f1]
    j2 = np.arange(f2)
    w2 = np.exp(2j * np.pi * np.outer(j2, j2) / f2)        # [f2,f2]
    tw = np.exp(2j * np.pi * np.outer(j2, j1) / n4)        # [f2,f1]
    return (tcos, tsin,
            w1.real.astype(np.float32), w1.imag.astype(np.float32),
            w2.real.astype(np.float32), w2.imag.astype(np.float32),
            tw.real.astype(np.float32), tw.imag.astype(np.float32),
            f1, f2)


def imdct_half_fft(x, consts):
    """Batched ``imdct_half``: x [B, n2] float32 -> [B, n2], with
    ``consts`` from ``imdct_fft_consts(n2, ...)``."""
    tcos, tsin, w1r, w1i, w2r, w2i, twr, twi = (
        torch.from_numpy(a).to(x.device) for a in consts[:8])
    f1, f2 = consts[8:]
    B, n2 = x.shape
    n4 = n2 // 2
    in1 = x[:, 0::2]
    in2 = torch.flip(x[:, 1::2], [1])
    zre = in2 * tcos - in1 * tsin
    zim = in2 * tsin + in1 * tcos
    # IDFT_{n4}(z) * n4 via factors (j = j1*f2 + j2, k = k2*f1 + k1)
    zr = zre.reshape(B, f1, f2)
    zi = zim.reshape(B, f1, f2)
    mm = functools.partial(torch.einsum, "bij,ik->bjk")
    ar = mm(zr, w1r) - mm(zi, w1i)
    ai = mm(zr, w1i) + mm(zi, w1r)
    br = ar * twr - ai * twi
    bi = ar * twi + ai * twr
    mm2 = functools.partial(torch.einsum, "bjk,jm->bmk")
    Zr = (mm2(br, w2r) - mm2(bi, w2i)).reshape(B, n4)
    Zi = (mm2(br, w2i) + mm2(bi, w2r)).reshape(B, n4)
    # post rotation (mdct.c:150-158): out_even[m] = u[m],
    # out_odd[m] = v[n4-1-m]
    u = Zi * tsin - Zr * tcos
    v = Zi * tcos + Zr * tsin
    return torch.stack([u, torch.flip(v, [1])], -1).reshape(B, n2)
