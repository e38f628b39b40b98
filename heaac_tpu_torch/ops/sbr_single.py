"""SBR of the single-stream decoder: one element's channels per call.

Counterpart: ``heaac_tpu/ops/sbr_np.py``, the numpy SBR chain of the JAX
package's single-stream ``Decoder`` (aacsbr.c:1136-1771).  Here the
signal path runs as torch ops on the decoder's device, over the one or
two SBR channels of an element at once, with the arithmetic of the
batched ops (``ops/qmf.py``, ``ops/sbr.py``): ``qmf_analysis``,
``qmf_synthesis`` (also the downsampled 32-band bank), ``lf_gen``,
``hf_inverse_filter``, ``hf_gen``, ``env_estimate``, ``gain_calc``,
``hf_assemble``, ``x_gen`` and ``sbr_apply``.  The host keeps what
depends only on the bitstream, as the JAX package does on every path:
``chirp``, ``mapping`` and ``sbr_dequant`` advance the parsed context,
and ``prepare`` turns it into the frame's masks and band maps (the
envelope loop; the arithmetic of the JAX dense planner's
``frame_plan.build_sbr_plan``), which travel to the device in the
frame's one upload (``codec/decoder._upload``).

The signal state of an element lives on the device (``SbrState``, kept
beside the parsed context as ``SBRContext.dev``): the
analysis history, the last two analysis frames W, the last two HF
frames Y, the gain / noise smoothing rows, the two synthesis FIFOs
(``ops/qmf``'s [9,128] layout in place of the numpy FIFO and offset)
and the noise and sine indices.  The noise / sine index progression is
computed on the device from each slot's ordinal within the frame's
envelopes.  The parser resets a channel's noise index (sbr_make_f_derived
sets ``f_indexnoise = 0``); the host hands such a value to the device
once and then marks it taken (``None``).
"""
from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch

from ..bitstream.sbr_syntax import (ENVELOPE_ADJUSTMENT_OFFSET, SBRContext,
                                    sbr_dequant)
from . import sbr as S
from .qmf import qmf_analysis, qmf_synthesis, qmf_synthesis_ds

_f32 = np.float32
E, M, L = 5, 48, 28        # envelope rows, SBR bands, limiter rows
BW_TAB = np.array([0.0, 0.75, 0.9, 0.98], np.float32)
LIMGAIN = np.array([0.70795, 1.0, 1.41254, 1e10], np.float32)
PHI_RE = np.array([1, 0, -1, 0], np.float32)
PHI_IM = np.array([0, 1, 0, -1], np.float32)


# ---------------------------------------------------------------------------
# Host: parameter math on the parsed context (sbr_np.py:160-264)
# ---------------------------------------------------------------------------
def chirp(sbr: SBRContext, ch_data) -> None:
    """aacsbr.c:1316-1334."""
    for i in range(sbr.n_q):
        if ch_data.bs_invf_mode[0][i] + ch_data.bs_invf_mode[1][i] == 1:
            new_bw = _f32(0.6)
        else:
            new_bw = BW_TAB[ch_data.bs_invf_mode[0][i]]
        if new_bw < ch_data.bw_array[i]:
            new_bw = _f32(_f32(0.75) * new_bw
                          + _f32(0.25) * ch_data.bw_array[i])
        else:
            new_bw = _f32(_f32(0.90625) * new_bw
                          + _f32(0.09375) * ch_data.bw_array[i])
        ch_data.bw_array[i] = _f32(0.0) if new_bw < 0.015625 else new_bw


def mapping(sbr: SBRContext, ch_data, e_a) -> tuple:
    """aacsbr.c:1451-1496.  Returns (e_origmapped, q_mapped, s_mapped) and
    updates ch_data.s_indexmapped."""
    kx1 = sbr.kx[1]
    e_orig = np.zeros((7, 48), np.float32)
    q_mapped = np.zeros((7, 48), np.float32)
    s_mapped = np.zeros((7, 48), np.int32)
    ch_data.s_indexmapped[1:8] = 0
    for e in range(ch_data.bs_num_env):
        ilim = sbr.n[ch_data.bs_freq_res[e + 1]]
        table = sbr.f_tablehigh if ch_data.bs_freq_res[e + 1] \
            else sbr.f_tablelow
        for i in range(ilim):
            e_orig[e, table[i] - kx1: table[i + 1] - kx1] = \
                ch_data.env_facs[e + 1][i]
        k = int((ch_data.bs_num_noise > 1)
                and (ch_data.t_env[e] >= ch_data.t_q[1]))
        for i in range(sbr.n_q):
            q_mapped[e, sbr.f_tablenoise[i] - kx1:
                     sbr.f_tablenoise[i + 1] - kx1] = \
                ch_data.noise_facs[k + 1][i]
        for i in range(sbr.n[1]):
            if ch_data.bs_add_harmonic_flag:
                m_mid = (sbr.f_tablehigh[i] + sbr.f_tablehigh[i + 1]) >> 1
                ch_data.s_indexmapped[e + 1][m_mid - kx1] = (
                    ch_data.bs_add_harmonic[i]
                    * int(e >= e_a[1]
                          or ch_data.s_indexmapped[0][m_mid - kx1] == 1))
        for i in range(ilim):
            present = int(ch_data.s_indexmapped[e + 1][
                table[i] - kx1: table[i + 1] - kx1].any())
            s_mapped[e, table[i] - kx1: table[i + 1] - kx1] = present
    ch_data.s_indexmapped[0] = ch_data.s_indexmapped[ch_data.bs_num_env]
    return e_orig, q_mapped, s_mapped


def _channel_plan(sbr: SBRContext, ch: int) -> dict:
    """One channel's frame plan (numpy); advances the channel's chirp and
    harmonic state in the reference's order (aacsbr.c:1737-1745)."""
    d = sbr.data[ch]
    kx0, kx1 = sbr.kx
    m0, m1 = sbr.m
    k = np.arange(64)
    p = dict(
        i_temp=np.array(max(2 * d.t_env_num_env_old - 32, 0)),
        xlow_old=(k < kx0).astype(np.float32),
        use_y_old=((k >= kx0) & (k < kx0 + m0)).astype(np.float32),
        xlow_new=(k < kx1).astype(np.float32),
        use_y_new=((k >= kx1) & (k < kx1 + m1)).astype(np.float32))
    if not sbr.start:
        return p
    e_orig, q_mapped, s_mapped = mapping(sbr, d, d.e_a)
    ne = d.bs_num_env
    mm = np.arange(M) < m1
    z = lambda *s: np.zeros(s, np.float32)  # noqa: E731
    p.update(e_orig=z(E, M), q_m0=z(E, M), s_m0=z(E, M), gain_num=z(E, M),
             den_q=np.ones((E, M), np.float32), noisegate=z(E, M),
             lim_onehot=z(L, M), env_onehot=z(E, 38), recip=z(E),
             freqres_sel=z(E),
             grp_mean=np.stack([np.eye(M, dtype=np.float32)] * 2))
    p["e_orig"][:ne] = e_orig[:ne, :M]
    temp = (e_orig[:ne, :M] / (1.0 + q_mapped[:ne, :M])).astype(np.float32)
    p["q_m0"][:ne] = np.sqrt(temp * q_mapped[:ne, :M], dtype=np.float32) * mm
    p["s_m0"][:ne] = np.sqrt(temp * d.s_indexmapped[1:ne + 1, :M],
                             dtype=np.float32) * mm
    delta = np.array([0.0 if e in (d.e_a[0], d.e_a[1]) else 1.0
                      for e in range(ne)], np.float32)
    sm = s_mapped[:ne, :M] > 0
    p["gain_num"][:ne] = e_orig[:ne, :M] * np.where(sm, q_mapped[:ne, :M],
                                                    1.0)
    p["den_q"][:ne] = 1.0 + q_mapped[:ne, :M] * np.where(sm, 1.0,
                                                         delta[:, None])
    p["noisegate"][:ne] = delta[:, None] * (p["s_m0"][:ne] == 0)
    p["limgain"] = LIMGAIN[sbr.bs_limiter_gains]
    for li in range(sbr.n_lim):
        lo = int(sbr.f_tablelim[li]) - kx1
        hi = int(sbr.f_tablelim[li + 1]) - kx1
        p["lim_onehot"][li, max(lo, 0):max(hi, 0)] = 1.0

    t_env = [int(t) for t in d.t_env[:ne + 1]]
    for e in range(ne):
        p["env_onehot"][e, 2 * t_env[e]: 2 * t_env[e + 1]] = 1.0
        if t_env[e + 1] > t_env[e]:
            p["recip"][e] = np.float32(0.5 / (t_env[e + 1] - t_env[e]))
        p["freqres_sel"][e] = np.float32(d.bs_freq_res[e + 1])
    # interpol_freq=0: e_curr is the mean over each scalefactor band
    # (aacsbr.c:1520-1545); with interpol_freq=1 the matrices stay identity
    if not sbr.bs_interpol_freq:
        for hi, (tab, nb) in enumerate((
                (sbr.f_tablelow, sbr.n[0]), (sbr.f_tablehigh, sbr.n[1]))):
            g = np.zeros((M, M), np.float32)
            for pband in range(nb):
                lo = int(tab[pband]) - kx1
                hi_b = int(tab[pband + 1]) - kx1
                if hi_b > lo and min(hi_b, M) > max(lo, 0):
                    g[max(lo, 0):min(hi_b, M),
                      max(lo, 0):min(hi_b, M)] = 1.0 / (hi_b - lo)
            p["grp_mean"][hi] = g

    # HF generation's patch map (aacsbr.c:1360-1409) after the chirp
    chirp(sbr, d)
    p.update(src_of_m=np.zeros(M, np.int64), bw_of_m=z(M), hf_mask=z(M),
             gen_slot_mask=z(40))
    g, kk, mi = 0, kx1, 0
    for j in range(sbr.num_patches):
        for x in range(int(sbr.patch_num_subbands[j])):
            while g <= sbr.n_q and kk >= sbr.f_tablenoise[g]:
                g += 1
            g -= 1
            if g < 0:
                raise ValueError("no noise subband found")
            p["src_of_m"][mi] = int(sbr.patch_start_subband[j]) + x
            p["bw_of_m"][mi] = d.bw_array[g]
            p["hf_mask"][mi] = 1.0
            kk += 1
            mi += 1
    p["gen_slot_mask"][2 * t_env[0] + ENVELOPE_ADJUSTMENT_OFFSET:
                       2 * t_env[ne] + ENVELOPE_ADJUSTMENT_OFFSET] = 1.0
    p["scatter_m"] = z(M, 64)
    for m_i in range(min(m1, M, 64 - kx1)):
        p["scatter_m"][m_i, kx1 + m_i] = 1.0

    # g_temp / q_temp rows (aacsbr.c:1630-1646)
    h_sl = 4 * (not sbr.bs_smoothing_mode)
    t0 = 2 * t_env[0]
    p["row_src"] = np.arange(42)
    p["fill_map"] = z(42, E)
    if sbr.reset:
        p["fill_map"][t0:t0 + h_sl, 0] = 1.0
    elif h_sl:
        told = 2 * int(d.t_env_num_env_old)
        for i in range(4):
            if 0 <= t0 + i < 42 and 0 <= told + i < 42:
                p["row_src"][t0 + i] = told + i
    for e in range(ne):
        p["fill_map"][h_sl + 2 * t_env[e]: h_sl + 2 * t_env[e + 1], e] = 1.0

    # per-slot assembly (aacsbr.c:1649-1713); the noise and sine indices
    # advance on the device by each slot's ordinal in the frame
    p["smooth_on"] = z(38)
    p["direct_row"] = np.arange(38) + h_sl
    for e in range(ne):
        if h_sl and e not in (d.e_a[0], d.e_a[1]):
            p["smooth_on"][2 * t_env[e]: 2 * t_env[e + 1]] = 1.0
    p["slot_ord"] = np.clip(np.arange(38) - t0, 0, None)
    p["nslots"] = np.array(2 * (t_env[ne] - t_env[0]))
    p["m1"] = np.array(m1)
    p["sign0"] = np.array(1 - 2 * (kx1 & 1), np.float32)
    p["index_set"] = np.array([-1, -1])
    for j, name in enumerate(("f_indexnoise", "f_indexsine")):
        if getattr(d, name) is not None:
            p["index_set"][j] = getattr(d, name)
            setattr(d, name, None)          # the device holds it now
    return p


def prepare(sbr: SBRContext, id_aac: int, nch: int) -> dict:
    """The host half of ``sbr_apply`` for one element's ``nch`` channels:
    dequantization and each channel's plan, stacked [nch, ...]."""
    if sbr.start:
        sbr_dequant(sbr, id_aac)
    plans = [_channel_plan(sbr, ch) for ch in range(nch)]
    return {k: np.stack([p[k] for p in plans]) for k in plans[0]}


# ---------------------------------------------------------------------------
# Device: the signal path (sbr_np.py:25-130, 174-230, 267-426)
# ---------------------------------------------------------------------------
@dataclass
class SbrState:
    """One element's SBR signal state on the device (n = its channels)."""
    x_hist: torch.Tensor      # [n,288]     analysis history
    W: torch.Tensor           # [n,32,32,2] last analysis frame
    Y0: torch.Tensor          # [n,38,64,2] HF frame before the last
    Y1: torch.Tensor          # [n,38,64,2] last HF frame
    g_temp: torch.Tensor      # [n,42,48]
    q_temp: torch.Tensor      # [n,42,48]
    v: torch.Tensor           # [2,9,128]   synthesis FIFOs (L, R)
    index: torch.Tensor       # [n,2] int64 noise and sine indices

    @classmethod
    def zeros(cls, n: int, device) -> "SbrState":
        z = lambda *s: torch.zeros(s, device=device)  # noqa: E731
        return cls(z(n, 288), z(n, 32, 32, 2), z(n, 38, 64, 2),
                   z(n, 38, 64, 2), z(n, 42, 48), z(n, 42, 48),
                   z(2, 9, 128),
                   torch.zeros((n, 2), dtype=torch.long, device=device))


@functools.cache
def _phi(device: torch.device):
    return (torch.from_numpy(PHI_RE).to(device),
            torch.from_numpy(PHI_IM).to(device))


def lf_gen(W_prev, W, plan):
    """aacsbr.c:1337-1357 -> X_low [n,32,40,2]."""
    return S.lf_gen(W_prev, W, plan["xlow_new"], plan["xlow_old"])


# aacsbr.c:1232-1313: X_low -> (alpha0, alpha1) [n,32,2]
hf_inverse_filter = S.hf_inverse_filter


def hf_gen(X_low, alpha0, alpha1, plan):
    """aacsbr.c:1360-1409 -> X_high [n,48,40,2] (band m is QMF band
    kx + m)."""
    return S.hf_gen(X_low, alpha0, alpha1, plan["src_of_m"],
                    plan["bw_of_m"], plan["hf_mask"], plan["gen_slot_mask"])


def env_estimate(X_high, plan):
    """aacsbr.c:1499-1546 -> e_curr [n,5,48]."""
    return S.env_estimate(X_high, plan["env_onehot"], plan["recip"],
                          plan["grp_mean"], plan["freqres_sel"])


# aacsbr.c:1552-1605: (e_curr, plan) -> (gain, q_m, s_m) [n,5,48]
gain_calc = S.gain_calc


def hf_assemble(X_high, gain, q_m, s_m, st: SbrState, plan):
    """aacsbr.c:1608-1714: gain smoothing and noise / sine injection into
    the new HF frame; advances the state's Y pair, smoothing rows and
    noise / sine indices."""
    phi_re, phi_im = _phi(X_high.device)
    index = torch.where(plan["index_set"] >= 0, plan["index_set"], st.index)
    noise0, sine0 = index[:, :1], index[:, 1:]
    slot = plan["slot_ord"]
    m1 = plan["m1"][:, None]
    sine = (sine0 + slot) & 3
    plan = dict(plan, noise_start=(noise0 + m1 * slot) & 0x1FF,
                sine_re=phi_re[sine],
                sine_im0=phi_im[sine] * plan["sign0"][:, None])
    Y_m, env_on, g_new, q_new = S.hf_assemble(
        X_high, gain, q_m, s_m, st.g_temp, st.q_temp, plan)
    # the reference writes the rows' first m bands only, and the HF frame's
    # bands kx..kx+m-1 only: the others keep their values
    rows = plan["row_src"][:, :, None].expand(-1, -1, M)
    in_m = (torch.arange(M, device=X_high.device) < m1[:, :, None])
    st.g_temp = torch.where(in_m, g_new, torch.gather(st.g_temp, 1, rows))
    st.q_temp = torch.where(in_m, q_new, torch.gather(st.q_temp, 1, rows))
    y_scat = torch.einsum("bsmc,bmk->bskc", Y_m, plan["scatter_m"])
    in_k = plan["scatter_m"].sum(1)[:, None, :, None] > 0
    st.Y0, st.Y1 = st.Y1, torch.where((env_on[..., None] > 0) & in_k,
                                      y_scat, st.Y1)
    n = plan["nslots"][:, None]
    st.index = torch.cat([(noise0 + m1 * n) & 0x1FF, (sine0 + n) & 3], 1)


def x_gen(X_low, Y0, Y1, plan):
    """aacsbr.c:1412-1446: the low band and the two HF frames into
    X [n,2,38,64]."""
    i = torch.arange(38, device=X_low.device)
    xl = torch.nn.functional.pad(X_low[:, :, 2:40].transpose(1, 2),
                                 (0, 0, 0, 32))               # [n,38,64,2]
    is_old = (i[None, :] < plan["i_temp"][:, None])[:, :, None, None]
    y0 = torch.nn.functional.pad(Y0[:, 32:38], (0, 0, 0, 0, 0, 32))
    y_eff = torch.where(is_old, y0, Y1)
    use_y = torch.where(is_old, plan["use_y_old"][:, None, :, None],
                        plan["use_y_new"][:, None, :, None]
                        * (i < 32)[None, :, None, None])
    xlm = torch.where(is_old, plan["xlow_old"][:, None, :, None],
                      plan["xlow_new"][:, None, :, None])
    X = xl * xlm + y_eff * use_y
    return torch.stack([X[..., 0], X[..., 1]], 1)


def sbr_apply(sbr: SBRContext, st: SbrState, x, plan, downsampled: bool,
              ps_apply=None):
    """aacsbr.c:1716-1771 for one element: x [n,1024] core samples of its
    n channels, ``plan`` this frame's ``prepare`` on the device;
    ``ps_apply(X) -> (L, R)`` for a mono element with parametric stereo
    (None without PS; ``sbr.ps`` not started copies L to R) -> out
    [n or 2, 2048] (1024 when downsampled)."""
    W, st.x_hist = qmf_analysis(x, st.x_hist)
    X_low = lf_gen(st.W, W, plan)
    st.W = W
    if sbr.start:
        alpha0, alpha1 = hf_inverse_filter(X_low)
        X_high = hf_gen(X_low, alpha0, alpha1, plan)
        e_curr = env_estimate(X_high, plan)
        gain, q_m, s_m = gain_calc(e_curr, plan)
        hf_assemble(X_high, gain, q_m, s_m, st, plan)
    X = x_gen(X_low, st.Y0, st.Y1, plan)
    if ps_apply is not None:
        X = torch.cat(ps_apply(X), 0)
    synth = qmf_synthesis_ds if downsampled else qmf_synthesis
    out, v = synth(X, st.v[:X.shape[0]])
    st.v = torch.cat([v, st.v[X.shape[0]:]], 0)
    return out
