"""Batched QMF analysis/synthesis filterbanks.

Counterpart: ``heaac_tpu/ops/qmf_jax.py`` (qmf_analysis, qmf_synthesis,
qmf_synthesis_ds).  Both banks are sliding windows plus constant-matrix
matmuls over [B, 32, ...]; the synthesis FIFO is the carried
``v_hist [B,9,128]`` (the downsampled synthesis keeps its state in the
first 64 columns).
"""
from __future__ import annotations

import functools

import torch

from .. import tables as TB


@functools.cache
def _analysis(device: torch.device):
    win, pre = TB.qmf_analysis_consts()
    return torch.from_numpy(win).to(device), torch.from_numpy(pre).to(device)


@functools.cache
def _synthesis(device: torch.device, ds: bool = False):
    consts = TB.qmf_synthesis_consts_ds() if ds else \
        TB.qmf_synthesis_consts()
    return tuple(torch.from_numpy(a).to(device) for a in consts)


def qmf_analysis(in_samples, x_hist):
    """in_samples [B,1024], x_hist [B,288] -> (W [B,32,32,2], new_hist)."""
    win, pre = _analysis(in_samples.device)
    x = torch.cat([x_hist, in_samples], -1)               # [B,1312]
    xw = x.unfold(-1, 320, 32)                            # [B,32,320]
    z = xw.flip(-1) * win
    out = z @ pre                                         # [B,32,64]
    w_re = -out[..., 32:64].flip(-1)
    w_im = out[..., :32]
    return torch.stack([w_re, w_im], -1), x[:, 1024:]


def qmf_synthesis(X, v_hist):
    """X [B,2,38,64] (slots 0..31 used), v_hist [B,9,128] ->
    (out [B,2048], new_v_hist [B,9,128])."""
    A, B2, win = _synthesis(X.device)
    v = X[:, 0, :32] @ A + X[:, 1, :32] @ B2              # [B,32,128]
    v_all = torch.cat([v_hist, v], 1)                     # [B,41,128]
    out = None
    for j, (bd, ro) in enumerate(TB.QMF_SYN_TAPS):
        term = v_all[:, 9 - bd:9 - bd + 32, ro:ro + 64] * win[j]
        out = term if out is None else out + term
    return out.reshape(out.shape[0], 2048), v_all[:, 32:]


def qmf_synthesis_ds(X, v_hist):
    """Downsampled (32-band) synthesis, sbr_qmf_synthesis with div=1
    (aacsbr.c:1175-1230): X [B,2,38,64] (slots 0..31, bands 0..31 used),
    v_hist [B,9,128] (only the first 64 columns carry state) ->
    (out [B,1024], new_v_hist [B,9,128] with zero columns 64..127)."""
    A, B2, win = _synthesis(X.device, True)
    v = X[:, 0, :32] @ A + X[:, 1, :32] @ B2              # [B,32,64]
    v_all = torch.cat([v_hist[:, :, :64], v], 1)          # [B,41,64]
    out = None
    for j, (bd, ro) in enumerate(TB.QMF_SYN_TAPS_DS):
        term = v_all[:, 9 - bd:9 - bd + 32, ro:ro + 32] * win[j]
        out = term if out is None else out + term
    tail = v_all[:, 32:]
    return (out.reshape(out.shape[0], 1024),
            torch.cat([tail, torch.zeros_like(tail)], 2))
