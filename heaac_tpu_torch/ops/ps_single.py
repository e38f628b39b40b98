"""Parametric stereo of the single-stream decoder (one SCE, 20 or 34 bands).

Counterpart: ``heaac_tpu/ops/ps_np.py``, the numpy PS of the JAX
package's single-stream ``Decoder`` (aacps.c:283-992).  The signal path
runs as torch ops on the decoder's device at one lane, through the
batched ops of ``ops/ps.py``: ``hybrid_analysis`` / ``hybrid_synthesis``,
``decorrelation`` (the delay lines as torch ops; the transient detector
and the 3-link allpass chain through kernel K1, ``decorrelate_seq`` at
B=1) and the per-slot interpolation and 2x2 mix of ``stereo_processing``.
The host keeps what depends only on the bitstream: the parameter remaps
(``_map_idx_*``, ``_remap``, ``_map_val_*``; ``_build_remap_tables`` is
``tables.remap_tables``) and the mixing matrices per envelope with their
IPD / OPD phase smoothing (``prepare``), which travel to the device in
the frame's one upload.

The signal state of a PS context lives on the device in K1's layout
(``PsState``: hybrid input history [1,5,6,2], delay lines [1,91,14,2],
allpass rings [1,50,3,5,2], transient detector [1,34,3]); it is reset
when the band mode differs from the last parse's, as the reference does.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .. import tables as P
from . import ps as PS

_f32 = np.float32


# ---------------------------------------------------------------------------
# Host: parameter band remapping (aacps.c:461-643; ps_np.py:214-345)
# ---------------------------------------------------------------------------
def _map_idx_10_to_20(par, full):
    out = np.zeros(34, par.dtype)
    b = 9 if full else 4
    for i in range(b, -1, -1):
        out[2 * i + 1] = out[2 * i] = par[i]
    return out


def _tdiv(a, b):
    """C integer division (truncation toward zero)."""
    return int(a / b) if b else 0


def _map_idx_34_to_20(par, full):
    p = [int(v) for v in par]
    out = np.zeros(34, par.dtype)
    out[0] = _tdiv(2 * p[0] + p[1], 3)
    out[1] = _tdiv(p[1] + 2 * p[2], 3)
    out[2] = _tdiv(2 * p[3] + p[4], 3)
    out[3] = _tdiv(p[4] + 2 * p[5], 3)
    out[4] = _tdiv(p[6] + p[7], 2)
    out[5] = _tdiv(p[8] + p[9], 2)
    out[6] = p[10]
    out[7] = p[11]
    out[8] = _tdiv(p[12] + p[13], 2)
    out[9] = _tdiv(p[14] + p[15], 2)
    out[10] = p[16]
    if full:
        out[11] = p[17]
        out[12] = p[18]
        out[13] = p[19]
        out[14] = _tdiv(p[20] + p[21], 2)
        out[15] = _tdiv(p[22] + p[23], 2)
        out[16] = _tdiv(p[24] + p[25], 2)
        out[17] = _tdiv(p[26] + p[27], 2)
        out[18] = _tdiv(p[28] + p[29] + p[30] + p[31], 4)
        out[19] = _tdiv(p[32] + p[33], 2)
    return out


def _map_idx_10_to_34(par, full):
    out = np.zeros(34, par.dtype)
    src = P._IDX_10_TO_34_FULL if full else P._IDX_10_TO_34_MAP
    for i, s in enumerate(src):
        out[i] = par[s]
    if not full:
        out[16] = 0
    return out


def _map_idx_20_to_34(par, full):
    out = np.zeros(34, par.dtype)
    for i in range(34 if full else 17):
        src = P._IDX_20_TO_34[i]
        if src == -1:
            out[i] = _tdiv(int(par[0]) + int(par[1]), 2)
        elif src == -2:
            out[i] = _tdiv(int(par[2]) + int(par[3]), 2)
        else:
            out[i] = par[src]
    return out


def _map_val_20_to_34(par):
    out = par.copy()
    for i in range(33, -1, -1):
        src = P._IDX_20_TO_34[i]
        if src == -1:
            out[i] = (par[0] + par[1]) * _f32(0.5)
        elif src == -2:
            out[i] = (par[2] + par[3]) * _f32(0.5)
        else:
            out[i] = par[src]
    return out


def _map_val_34_to_20(par):
    p = par
    out = par.copy()
    third = _f32(0.33333333)
    half = _f32(0.5)
    out[0] = (2 * p[0] + p[1]) * third
    out[1] = (p[1] + 2 * p[2]) * third
    out[2] = (2 * p[3] + p[4]) * third
    out[3] = (p[4] + 2 * p[5]) * third
    out[4] = (p[6] + p[7]) * half
    out[5] = (p[8] + p[9]) * half
    out[6] = p[10]
    out[7] = p[11]
    out[8] = (p[12] + p[13]) * half
    out[9] = (p[14] + p[15]) * half
    out[10] = p[16]
    out[11] = p[17]
    out[12] = p[18]
    out[13] = p[19]
    out[14] = (p[20] + p[21]) * half
    out[15] = (p[22] + p[23]) * half
    out[16] = (p[24] + p[25]) * half
    out[17] = (p[26] + p[27]) * half
    out[18] = (p[28] + p[29] + p[30] + p[31]) * _f32(0.25)
    out[19] = (p[32] + p[33]) * half
    return out


def _remap(par, num_par, num_env, full, to34):
    """remap20/remap34 (aacps.c:756-792)."""
    out = par.copy()
    for e in range(num_env):
        if to34:
            if num_par in (20, 11):
                out[e] = _map_idx_20_to_34(par[e], full)
            elif num_par in (10, 5):
                out[e] = _map_idx_10_to_34(par[e], full)
        else:
            if num_par in (34, 17):
                out[e] = _map_idx_34_to_20(par[e], full)
            elif num_par in (10, 5):
                out[e] = _map_idx_10_to_20(par[e], full)
    return out


# ---------------------------------------------------------------------------
# Host: the mixing matrices per envelope (aacps.c:794-902)
# ---------------------------------------------------------------------------
def prepare(ps, top: int) -> dict:
    """The host half of ``ps_apply``: advances the PS context's H and
    IPD / OPD history exactly as ``ps_np.stereo_processing`` does and
    returns the frame's plan (numpy, lane axis first): ``H`` [1,2,6,34,4]
    (real / imaginary, envelope border, parameter band, h11 h12 h21
    h22), ``Ws`` / ``We`` [1,6,32] (each slot's weights of the borders
    before and after it, the interpolation of aacps.c:909-956 as the JAX
    dense planner writes it), ``ipd_on`` [1], ``top_mask`` [1,91] (the
    delay lines above the SBR top, ff_ps_apply), ``reset`` [1] (the band
    mode differs from the last parse's: aacps.c:651-659) and ``is34``."""
    is34 = int(ps.is34bands)
    HA, HB = P.mixing_luts()
    pd_re, pd_im = P.pd_smooth()
    H_LUT = HA if ps.icc_mode < 3 else HB
    Hs = (ps.H11, ps.H12, ps.H21, ps.H22)
    for H in Hs:
        H[0][0] = H[0][ps.num_env_old]
        H[1][0] = H[1][ps.num_env_old]
    iid_mapped = _remap(ps.iid_par, ps.nr_iid_par, ps.num_env, 1, is34)
    icc_mapped = _remap(ps.icc_par, ps.nr_icc_par, ps.num_env, 1, is34)
    if ps.enable_ipdopd:
        ipd_mapped = _remap(ps.ipd_par, ps.nr_ipdopd_par, ps.num_env, 0,
                            is34)
        opd_mapped = _remap(ps.opd_par, ps.nr_ipdopd_par, ps.num_env, 0,
                            is34)
    if is34 != ps.is34bands_old:
        conv = _map_val_20_to_34 if is34 else _map_val_34_to_20
        for H in Hs:
            H[0][0] = conv(H[0][0])
            H[1][0] = conv(H[1][0])
        ps.ipd_hist[:] = 0
        ps.opd_hist[:] = 0

    nb = P.NR_PAR_BANDS[is34]
    b = np.arange(nb)
    for e in range(ps.num_env):
        h = H_LUT[iid_mapped[e][:nb] + 7 + 23 * ps.iid_quant,
                  icc_mapped[e][:nb]].T.copy()              # [4, nb]
        if ps.enable_ipdopd:
            nb_pd = min(int(ps.nr_ipdopd_par), nb)
            sel = b[:nb_pd]
            opd_idx = ps.opd_hist[sel] * 8 + opd_mapped[e][sel]
            ipd_idx = ps.ipd_hist[sel] * 8 + ipd_mapped[e][sel]
            opd_re, opd_im = pd_re[opd_idx], pd_im[opd_idx]
            ipd_re, ipd_im = pd_re[ipd_idx], pd_im[ipd_idx]
            ps.opd_hist[sel] = opd_idx & 0x3F
            ps.ipd_hist[sel] = ipd_idx & 0x3F
            adj_re = (opd_re * ipd_re + opd_im * ipd_im).astype(_f32)
            adj_im = (opd_im * ipd_re - opd_re * ipd_im).astype(_f32)
            rot_re = np.stack([opd_re, adj_re, opd_re, adj_re])
            rot_im = np.stack([opd_im, adj_im, opd_im, adj_im])
            for H, hi, ri in zip(Hs, h[:, sel], rot_im):
                H[1][e + 1][sel] = hi * ri
            h[:, sel] = h[:, sel] * rot_re
        for H, hr in zip(Hs, h):
            H[0][e + 1][:nb] = hr

    plan = dict(H=np.zeros((1, 2, 6, 34, 4), np.float32),
                Ws=np.zeros((1, 6, 32), np.float32),
                We=np.zeros((1, 6, 32), np.float32),
                ipd_on=np.array([1.0 if ps.enable_ipdopd else 0.0],
                                np.float32),
                reset=np.array([int(is34 != ps.is34bands_old)]),
                is34=is34)
    for j, H in enumerate(Hs):
        plan["H"][0, :, :, :, j] = H[:, :6]
    for e in range(ps.num_env):
        start = int(ps.border_position[e])
        stop = int(ps.border_position[e + 1])
        for n in range(max(start + 1, 0), min(stop + 1, 32)):
            t = np.float32(n - start) / np.float32(stop - start)
            plan["Ws"][0, e, n] = np.float32(1.0) - t
            plan["We"][0, e + 1, n] = t
    top = max(min(top + P.NR_BANDS[is34] - 64, 91), 0)
    plan["top_mask"] = (np.arange(91) < top).astype(np.float32)[None]
    return plan


# ---------------------------------------------------------------------------
# Device: the signal path (ps_np.py:70-211, 423-562)
# ---------------------------------------------------------------------------
@dataclass
class PsState:
    """One PS context's signal state on the device, in K1's layout."""
    in_buf: torch.Tensor      # [1,5,6,2]
    delay: torch.Tensor       # [1,91,14,2]
    ap: torch.Tensor          # [1,50,3,5,2]
    trans: torch.Tensor       # [1,34,3]

    @classmethod
    def zeros(cls, device) -> "PsState":
        z = lambda *s: torch.zeros(s, device=device)  # noqa: E731
        return cls(z(1, 5, 6, 2), z(1, 91, 14, 2), z(1, 50, 3, 5, 2),
                   z(1, 34, 3))


def hybrid_analysis(st: PsState, X, is34: int):
    """aacps.c:359-395: X [1,2,38,64] -> lbuf [1,91,32,2]; advances the
    hybrid input history."""
    lbuf, st.in_buf = PS.hybrid_analysis(X, st.in_buf, is34)
    return lbuf


# aacps.c:397-445: ([1,91,32,2], is34) -> [1,2,38,64]
hybrid_synthesis = PS.hybrid_synthesis


def decorrelation(st: PsState, lbuf, plan):
    """aacps.c:645-754: lbuf [1,91,32,2] -> rbuf [1,91,32,2]; K1 runs the
    transient detector and the allpass chain (``ops/ps.decorrelate``)."""
    keep = (plan["reset"] == 0).float()
    state = dict(delay=st.delay * keep[:, None, None, None],
                 ap=st.ap * keep[:, None, None, None, None],
                 trans=st.trans * keep[:, None, None])
    rbuf, new = PS.decorrelate(lbuf, state, plan["top_mask"], plan["is34"])
    st.delay, st.ap, st.trans = new["delay"], new["ap"], new["trans"]
    return rbuf


def stereo_processing(lbuf, rbuf, plan):
    """aacps.c:903-971, the device half: each slot's mixing matrix
    interpolated between the envelope borders, and the 2x2 complex mix
    -> (lbuf, rbuf) mixed."""
    return PS.stereo_mix(lbuf, rbuf, plan, plan["is34"])


def ps_apply(st: PsState, X, plan):
    """ff_ps_apply (aacps.c:973-992): X [1,2,38,64] -> (L, R) each
    [1,2,38,64]."""
    is34 = plan["is34"]
    lbuf = hybrid_analysis(st, X, is34)
    rbuf = decorrelation(st, lbuf, plan)
    lbuf, rbuf = stereo_processing(lbuf, rbuf, plan)
    return hybrid_synthesis(lbuf, is34), hybrid_synthesis(rbuf, is34)
