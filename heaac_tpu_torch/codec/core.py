"""Core AAC frame: batched IMDCT + windowing/overlap-add.

Counterparts: ``heaac_tpu/codec/core.py`` (core_frame) and
``heaac_tpu/ops/windowing.py`` (fmul_window, imdct_ola).  The IMDCT is a
constant-matrix matmul ([1024x1024] long, [128x128] short, full f32);
the 4-case overlap-add state machine (aacdec.c:1741-1806) is computed
branch-free with per-lane masks.
"""
from __future__ import annotations

import functools

import torch

from .. import tables as TB

ONLY_LONG, LONG_START, EIGHT_SHORT, LONG_STOP = range(4)


@functools.cache
def consts(device: torch.device):
    """(m2048, m256, bank) on ``device`` — core._consts."""
    return tuple(torch.from_numpy(a).to(device) for a in TB.core_consts())


def fmul_window(a, b, w):
    """ff_vector_fmul_window_c: a, b [..., L]; w [2L] -> [..., 2L]."""
    L = a.shape[-1]
    w_lo, w_hi = w[..., :L], w[..., L:]
    first = a * w_hi.flip(-1) - b.flip(-1) * w_lo
    second = a.flip(-1) * w_lo.flip(-1) + b * w_hi
    return torch.cat([first, second], dim=-1)


def imdct_ola(long_half, short_half, saved, win_seq, win_seq_prev,
              use_kbd, use_kbd_prev, bank):
    """One frame of windowing + overlap-add -> (out [B,1024],
    new_saved [B,512]); see windowing.imdct_ola."""
    lw_prev = bank[:, :1024][use_kbd_prev]                  # [B,1024]
    sw = bank[:, 1024:][use_kbd]                             # [B,128]
    sw_prev = bank[:, 1024:][use_kbd_prev]

    is_short = win_seq == EIGHT_SHORT
    prev_long = (win_seq_prev == ONLY_LONG) | (win_seq_prev == LONG_STOP)
    cur_longish = (win_seq == ONLY_LONG) | (win_seq == LONG_START)
    case_ll = prev_long & cur_longish

    out_ll = fmul_window(saved, long_half[:, :512], lw_prev)
    seam = fmul_window(saved[:, 448:512], long_half[:, :64], sw_prev)
    out_mid = torch.cat([saved[:, :448], seam, long_half[:, 64:512]], -1)

    b = short_half
    seam0 = fmul_window(saved[:, 448:512], b[:, 0, :64], sw_prev)
    seam1 = fmul_window(b[:, 0, 64:], b[:, 1, :64], sw)
    seam2 = fmul_window(b[:, 1, 64:], b[:, 2, :64], sw)
    seam3 = fmul_window(b[:, 2, 64:], b[:, 3, :64], sw)
    temp = fmul_window(b[:, 3, 64:], b[:, 4, :64], sw)
    out_short = torch.cat(
        [saved[:, :448], seam0, seam1, seam2, seam3, temp[:, :64]], -1)

    out = torch.where(case_ll[:, None], out_ll,
                      torch.where(is_short[:, None], out_short, out_mid))

    s1 = fmul_window(b[:, 4, 64:], b[:, 5, :64], sw)
    s2 = fmul_window(b[:, 5, 64:], b[:, 6, :64], sw)
    s3 = fmul_window(b[:, 6, 64:], b[:, 7, :64], sw)
    saved_short = torch.cat([temp[:, 64:], s1, s2, s3, b[:, 7, 64:]], -1)
    new_saved = torch.where(is_short[:, None], saved_short,
                            long_half[:, 512:])
    return out, new_saved


def core_frame(coeffs, saved, win_seq, win_seq_prev, use_kbd, use_kbd_prev,
               m2048, m256, bank):
    """coeffs [B,1024] f32, saved [B,512], metadata [B] int ->
    (time [B,1024], new_saved [B,512])."""
    long_half = coeffs @ m2048
    short_half = coeffs.reshape(-1, 8, 128) @ m256
    return imdct_ola(long_half, short_half, saved, win_seq, win_seq_prev,
                     use_kbd, use_kbd_prev, bank)
