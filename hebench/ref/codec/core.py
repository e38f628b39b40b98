"""The AAC core's IMDCT and windowing with overlap-add, in NumPy.

A copy of the JAX package's ``core_frame`` (``codec/core.py``) and its
``ops/windowing.py`` with every ``jnp`` call written in NumPy: the
4-case overlap-add state machine of libavcodec/aacdec.c:1741-1806,
computed for every lane with per-lane masks.  The IMDCT is
``imdct_half`` itself (float64, ``ops.imdct.imdct_half_ref``) unless a
``transform`` is given (the control's TF32 form).
"""
from __future__ import annotations

import functools

import numpy as np

from ..ops.imdct import imdct_half_ref
from ..tables import aac_tables as T

ONLY_LONG, LONG_START, EIGHT_SHORT, LONG_STOP = 0, 1, 2, 3


def fmul_window(a, b, w):
    """ff_vector_fmul_window_c (dsputil.c:3832): a,b: [..., L]; w: [2L].

    dst[i]     = a[i] * w[2L-1-i] - b[L-1-i] * w[i]
    dst[L+i]   = a[L-1-i] * w[L-1-i] + b[i] * w[L+i]
    """
    L = a.shape[-1]
    w_lo, w_hi = w[..., :L], w[..., L:]
    first = a * w_hi[..., ::-1] - b[..., ::-1] * w_lo
    second = a[..., ::-1] * w_lo[..., ::-1] + b * w_hi
    return np.concatenate([first, second], axis=-1)


@functools.cache
def window_bank() -> np.ndarray:
    """[2, 1024+128] window constants: row = use_kbd; cols 0:1024 long,
    1024:1152 short."""
    sine_long, sine_short = T.sine_window(1024), T.sine_window(128)
    kbd_long, kbd_short = T.kbd_long_1024(), T.kbd_short_128()
    return np.stack([
        np.concatenate([sine_long, sine_short]),
        np.concatenate([kbd_long, kbd_short]),
    ]).astype(np.float32)


def imdct_ola(long_half, short_half, saved, win_seq, win_seq_prev,
              use_kbd, use_kbd_prev, bank):
    """One frame of windowing + overlap-add for a batch of channel lanes.

    long_half [B, 1024], short_half [B, 8, 128], saved [B, 512] float32;
    win_seq, win_seq_prev, use_kbd, use_kbd_prev [B] int.
    Returns (out [B, 1024], new_saved [B, 512])."""
    lw_prev = bank[:, :1024][use_kbd_prev]
    sw = bank[:, 1024:][use_kbd]
    sw_prev = bank[:, 1024:][use_kbd_prev]

    is_short = win_seq == EIGHT_SHORT
    prev_long = (win_seq_prev == ONLY_LONG) | (win_seq_prev == LONG_STOP)
    cur_longish = (win_seq == ONLY_LONG) | (win_seq == LONG_START)
    case_ll = prev_long & cur_longish                   # long->long

    # case A: long->long (aacdec.c:1771-1773)
    out_ll = fmul_window(saved, long_half[:, :512], lw_prev)
    # case B: long output with short seam (aacdec.c:1786-1789)
    seam = fmul_window(saved[:, 448:512], long_half[:, :64], sw_prev)
    out_mid = np.concatenate(
        [saved[:, :448], seam, long_half[:, 64:512]], axis=-1)
    # case C: eight-short (aacdec.c:1778-1784)
    b = short_half
    seam0 = fmul_window(saved[:, 448:512], b[:, 0, :64], sw_prev)
    seam1 = fmul_window(b[:, 0, 64:], b[:, 1, :64], sw)
    seam2 = fmul_window(b[:, 1, 64:], b[:, 2, :64], sw)
    seam3 = fmul_window(b[:, 2, 64:], b[:, 3, :64], sw)
    temp = fmul_window(b[:, 3, 64:], b[:, 4, :64], sw)
    out_short = np.concatenate(
        [saved[:, :448], seam0, seam1, seam2, seam3, temp[:, :64]], axis=-1)

    out = np.where(case_ll[:, None], out_ll,
                   np.where(is_short[:, None], out_short, out_mid))

    # saved-state update (aacdec.c:1792-1805)
    s1 = fmul_window(b[:, 4, 64:], b[:, 5, :64], sw)
    s2 = fmul_window(b[:, 5, 64:], b[:, 6, :64], sw)
    s3 = fmul_window(b[:, 6, 64:], b[:, 7, :64], sw)
    saved_short = np.concatenate(
        [temp[:, 64:], s1, s2, s3, b[:, 7, 64:]], axis=-1)
    saved_long = long_half[:, 512:]
    new_saved = np.where(is_short[:, None], saved_short, saved_long)
    return out.astype(np.float32), new_saved.astype(np.float32)


def core_frame_np(coeffs, saved, win_seq, win_seq_prev, use_kbd,
                  use_kbd_prev, transform=imdct_half_ref):
    """One frame for B channel lanes: coeffs [B, 1024], saved [B, 512]
    float32, window metadata [B] -> (time [B, 1024], new saved [B, 512])
    float32."""
    coeffs = np.asarray(coeffs, np.float32)
    long_half = transform(coeffs, 1.0).astype(np.float32)
    short_half = transform(coeffs.reshape(-1, 8, 128),
                           1.0).astype(np.float32)
    return imdct_ola(long_half, short_half, np.asarray(saved, np.float32),
                     np.asarray(win_seq), np.asarray(win_seq_prev),
                     np.asarray(use_kbd), np.asarray(use_kbd_prev),
                     window_bank())
