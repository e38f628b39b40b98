"""Parametric Stereo DSP, numpy reference implementation.

Float32-faithful port of the reference DSP half (libavcodec/aacps.c:
283-992): hybrid analysis/synthesis filterbanks, decorrelation (transient
detection + 3-link fractional-delay allpass chain), and the interpolated
2x2 stereo mix.  Oracle for the batched TPU graph in ops/ps_jax.py.
"""
from __future__ import annotations

import numpy as np

from ..bitstream.ps_syntax import PSContext
from ..tables import ps_tables as P

_f32 = np.float32


# ---------------------------------------------------------------------------
# Hybrid filterbank (aacps.c:283-445)
# ---------------------------------------------------------------------------
def _hybrid2_re(inb, out, out_idx, filt, length, reverse):
    for i in range(length):
        w = inb[i: i + 13]
        re_in = _f32(filt[6] * w[6][0])
        im_in = _f32(filt[6] * w[6][1])
        re_op = _f32(0.0)
        im_op = _f32(0.0)
        for j in (0, 2, 4):
            re_op = _f32(re_op + filt[j + 1] * (w[j + 1][0] + w[12 - j - 1][0]))
            im_op = _f32(im_op + filt[j + 1] * (w[j + 1][1] + w[12 - j - 1][1]))
        out[out_idx + reverse][i] = (re_in + re_op, im_in + im_op)
        out[out_idx + (1 - reverse)][i] = (re_in - re_op, im_in - im_op)


def _hybrid_cx(inb, out, out_idx, filt, N, length, is6: bool):
    """hybrid6_cx / hybrid4_8_12_cx (aacps.c:303-357), vectorized over i."""
    # windows: [length, 13, 2]
    idx = np.arange(length)[:, None] + np.arange(13)[None, :]
    w = inb[idx]  # [len, 13, 2]
    in0 = w[:, 0:6]       # j = 0..5
    in1 = w[:, 12:6:-1]   # 12-j for j=0..5
    f_re = filt[:, :6, 0]  # [N, 6]
    f_im = filt[:, :6, 1]
    center = filt[:, 6, 0][:, None]  # [N,1]
    sum_re = (np.einsum("nj,lj->nl", f_re, in0[..., 0] + in1[..., 0])
              - np.einsum("nj,lj->nl", f_im, in0[..., 1] - in1[..., 1])
              + center * w[:, 6, 0][None, :]).astype(np.float32)
    sum_im = (np.einsum("nj,lj->nl", f_re, in0[..., 1] + in1[..., 1])
              + np.einsum("nj,lj->nl", f_im, in0[..., 0] - in1[..., 0])
              + center * w[:, 6, 1][None, :]).astype(np.float32)
    if is6:
        # output shuffle (aacps.c:323-335)
        out[out_idx + 0, :length, 0] = sum_re[6]
        out[out_idx + 0, :length, 1] = sum_im[6]
        out[out_idx + 1, :length, 0] = sum_re[7]
        out[out_idx + 1, :length, 1] = sum_im[7]
        out[out_idx + 2, :length, 0] = sum_re[0]
        out[out_idx + 2, :length, 1] = sum_im[0]
        out[out_idx + 3, :length, 0] = sum_re[1]
        out[out_idx + 3, :length, 1] = sum_im[1]
        out[out_idx + 4, :length, 0] = sum_re[2] + sum_re[5]
        out[out_idx + 4, :length, 1] = sum_im[2] + sum_im[5]
        out[out_idx + 5, :length, 0] = sum_re[3] + sum_re[4]
        out[out_idx + 5, :length, 1] = sum_im[3] + sum_im[4]
    else:
        out[out_idx: out_idx + N, :length, 0] = sum_re
        out[out_idx: out_idx + N, :length, 1] = sum_im


def hybrid_analysis(ps: PSContext, L: np.ndarray, is34: int,
                    length: int = 32) -> np.ndarray:
    """aacps.c:359-395.  L: [2,38,64] -> out [91,32,2]."""
    f = P.hybrid_filters()
    out = np.zeros((91, 32, 2), np.float32)
    inb = ps.in_buf
    inb[:, 6:44, 0] = L[0, :, :5].T
    inb[:, 6:44, 1] = L[1, :, :5].T
    if is34:
        _hybrid_cx(inb[0], out, 0, f["f34_0_12"], 12, length, False)
        _hybrid_cx(inb[1], out, 12, f["f34_1_8"], 8, length, False)
        _hybrid_cx(inb[2], out, 20, f["f34_2_4"], 4, length, False)
        _hybrid_cx(inb[3], out, 24, f["f34_2_4"], 4, length, False)
        _hybrid_cx(inb[4], out, 28, f["f34_2_4"], 4, length, False)
        out[32:91, :length, 0] = L[0, :length, 5:64].T
        out[32:91, :length, 1] = L[1, :length, 5:64].T
    else:
        _hybrid_cx(inb[0], out, 0, f["f20_0_8"], 8, length, True)
        _hybrid2_re(inb[1], out, 6, f["g1_Q2"], length, 1)
        _hybrid2_re(inb[2], out, 8, f["g1_Q2"], length, 0)
        out[10:71, :length, 0] = L[0, :length, 3:64].T
        out[10:71, :length, 1] = L[1, :length, 3:64].T
    ps.in_buf[:, 0:6] = ps.in_buf[:, 32:38]
    return out


def hybrid_synthesis(buf: np.ndarray, is34: int, length: int = 32) -> np.ndarray:
    """aacps.c:397-445.  buf: [91,32,2] -> out [2,38,64]."""
    out = np.zeros((2, 38, 64), np.float32)
    if is34:
        out[0, :length, 0] = buf[0:12, :length, 0].sum(axis=0, dtype=np.float32)
        out[1, :length, 0] = buf[0:12, :length, 1].sum(axis=0, dtype=np.float32)
        out[0, :length, 1] = buf[12:20, :length, 0].sum(axis=0, dtype=np.float32)
        out[1, :length, 1] = buf[12:20, :length, 1].sum(axis=0, dtype=np.float32)
        out[0, :length, 2] = buf[20:24, :length, 0].sum(axis=0, dtype=np.float32)
        out[1, :length, 2] = buf[20:24, :length, 1].sum(axis=0, dtype=np.float32)
        out[0, :length, 3] = buf[24:28, :length, 0].sum(axis=0, dtype=np.float32)
        out[1, :length, 3] = buf[24:28, :length, 1].sum(axis=0, dtype=np.float32)
        out[0, :length, 4] = buf[28:32, :length, 0].sum(axis=0, dtype=np.float32)
        out[1, :length, 4] = buf[28:32, :length, 1].sum(axis=0, dtype=np.float32)
        out[0, :length, 5:64] = buf[32:91, :length, 0].T
        out[1, :length, 5:64] = buf[32:91, :length, 1].T
    else:
        out[0, :length, 0] = buf[0:6, :length, 0].sum(axis=0, dtype=np.float32)
        out[1, :length, 0] = buf[0:6, :length, 1].sum(axis=0, dtype=np.float32)
        out[0, :length, 1] = buf[6:8, :length, 0].sum(axis=0, dtype=np.float32)
        out[1, :length, 1] = buf[6:8, :length, 1].sum(axis=0, dtype=np.float32)
        out[0, :length, 2] = buf[8:10, :length, 0].sum(axis=0, dtype=np.float32)
        out[1, :length, 2] = buf[8:10, :length, 1].sum(axis=0, dtype=np.float32)
        out[0, :length, 3:64] = buf[10:71, :length, 0].T
        out[1, :length, 3:64] = buf[10:71, :length, 1].T
    return out


# ---------------------------------------------------------------------------
# Decorrelation (aacps.c:645-754)
# ---------------------------------------------------------------------------
def decorrelation(ps: PSContext, s: np.ndarray, is34: int) -> np.ndarray:
    k_to_i = P.k_to_i(is34)
    nr_bands = P.NR_BANDS[is34]
    nr_par = P.NR_PAR_BANDS[is34]
    out = np.zeros((91, 32, 2), np.float32)

    if is34 != ps.is34bands_old:
        ps.peak_decay_nrg[:] = 0
        ps.power_smooth[:] = 0
        ps.peak_decay_diff_smooth[:] = 0
        ps.delay[:] = 0
        ps.ap_delay[:] = 0

    power = np.zeros((34, 32), np.float32)
    sq = (s[:nr_bands, :, 0] ** 2 + s[:nr_bands, :, 1] ** 2).astype(np.float32)
    for k in range(nr_bands):
        power[k_to_i[k]] = (power[k_to_i[k]] + sq[k]).astype(np.float32)

    # transient detection (serial in n, vectorized over bands)
    transient_gain = np.ones((34, 32), np.float32)
    pd = ps.peak_decay_nrg[:nr_par]
    psm = ps.power_smooth[:nr_par]
    pdd = ps.peak_decay_diff_smooth[:nr_par]
    for n in range(32):
        pn = power[:nr_par, n]
        pd[:] = np.maximum(P.PEAK_DECAY_FACTOR * pd, pn)
        psm += P.A_SMOOTH * (pn - psm)
        pdd += P.A_SMOOTH * (pd - pn - pdd)
        denom = P.TRANSIENT_IMPACT * pdd
        with np.errstate(divide="ignore", invalid="ignore",
                         over="ignore"):
            transient_gain[:nr_par, n] = np.where(denom > psm,
                                                  psm / denom, _f32(1.0))

    q_fract, phi_fract = P.fractional_delays()
    # allpass bands: serial over n and the three links for the filter
    # state, every band at once (the same float32 operations per band)
    napb = P.NR_ALLPASS_BANDS[is34]
    g_decay_slope = np.stack([np.clip(
        _f32(1.0) - P.DECAY_SLOPE * _f32(k - P.DECAY_CUTOFF[is34]),
        0.0, 1.0).astype(np.float32) for k in range(napb)])
    ag = (P.AP_A[None, :] * g_decay_slope[:, None]).astype(np.float32)
    delay = ps.delay[:napb]
    delay[:, :14] = delay[:, 32:46]
    delay[:, 14:46] = s[:napb, :32]
    apd = ps.ap_delay[:napb]
    apd[:, :, 0:5] = apd[:, :, 32:37]
    ph_re, ph_im = phi_fract[is34][:napb, 0], phi_fract[is34][:napb, 1]
    qf = q_fract[is34][:napb]
    tg = transient_gain[k_to_i[:napb]]
    for n in range(32):
        d = delay[:, n + 14 - 2]
        in_re = d[:, 0] * ph_re - d[:, 1] * ph_im
        in_im = d[:, 0] * ph_im + d[:, 1] * ph_re
        for m in range(3):
            a_re = ag[:, m] * in_re
            a_im = ag[:, m] * in_im
            ld = apd[:, m, n + 5 - P.LINK_DELAY[m]]
            fd_re, fd_im = qf[:, m, 0], qf[:, m, 1]
            apd[:, m, n + 5, 0] = in_re
            apd[:, m, n + 5, 1] = in_im
            new_re = ld[:, 0] * fd_re - ld[:, 1] * fd_im - a_re
            new_im = ld[:, 0] * fd_im + ld[:, 1] * fd_re - a_im
            in_re, in_im = new_re, new_im
            apd[:, m, n + 5, 0] = apd[:, m, n + 5, 0] + ag[:, m] * in_re
            apd[:, m, n + 5, 1] = apd[:, m, n + 5, 1] + ag[:, m] * in_im
        out[:napb, n, 0] = tg[:, n] * in_re
        out[:napb, n, 1] = tg[:, n] * in_im

    for k in range(napb, P.SHORT_DELAY_BAND[is34]):
        ps.delay[k][:14] = ps.delay[k][32:46]
        ps.delay[k][14:46] = s[k][:32]
        tg = transient_gain[k_to_i[k]]
        n = np.arange(32)
        out[k, :, 0] = tg * ps.delay[k][n + 14 - 14, 0]
        out[k, :, 1] = tg * ps.delay[k][n + 14 - 14, 1]
    for k in range(P.SHORT_DELAY_BAND[is34], nr_bands):
        ps.delay[k][:14] = ps.delay[k][32:46]
        ps.delay[k][14:46] = s[k][:32]
        tg = transient_gain[k_to_i[k]]
        n = np.arange(32)
        out[k, :, 0] = tg * ps.delay[k][n + 14 - 1, 0]
        out[k, :, 1] = tg * ps.delay[k][n + 14 - 1, 1]
    return out


# ---------------------------------------------------------------------------
# Parameter band remapping (aacps.c:461-643)
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


_IDX_10_TO_34_MAP = [0, 0, 0, 1, 1, 1, 2, 2, 2, 2, 3, 3, 4, 4, 4, 4]
_IDX_10_TO_34_FULL = [0, 0, 0, 1, 1, 1, 2, 2, 2, 2, 3, 3, 4, 4, 4, 4, 5, 5,
                      6, 6, 7, 7, 7, 7, 8, 8, 8, 8, 9, 9, 9, 9, 9, 9]


def _map_idx_10_to_34(par, full):
    out = np.zeros(34, par.dtype)
    if full:
        for i, src in enumerate(_IDX_10_TO_34_FULL):
            out[i] = par[src]
    else:
        for i, src in enumerate(_IDX_10_TO_34_MAP):
            out[i] = par[src]
        out[16] = 0
    return out


_IDX_20_TO_34 = [0, -1, 1, 2, -2, 3, 4, 4, 5, 5, 6, 7, 8, 8, 9, 9, 10, 11,
                 12, 13, 14, 14, 15, 15, 16, 16, 17, 17, 18, 18, 18, 18, 19, 19]


def _map_idx_20_to_34(par, full):
    out = np.zeros(34, par.dtype)
    n = 34 if full else 17
    for i in range(n):
        src = _IDX_20_TO_34[i]
        if src == -1:
            out[i] = _tdiv(int(par[0]) + int(par[1]), 2)
        elif src == -2:
            out[i] = _tdiv(int(par[2]) + int(par[3]), 2)
        else:
            out[i] = par[src]
    return out


def _map_val_20_to_34(par):
    out = par.copy()
    n = _IDX_20_TO_34
    for i in range(33, -1, -1):
        src = n[i]
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
# Table form of the index maps above, for the device-side remap
# (codec/qwire ships iid/icc at native band resolution): every output
# position is  out[i] = tdiv(sum_j w_j * par[s_j], den)  with C
# truncation toward zero; rows with den == 0 are 0.  Indexed
# [to34][src_kind][34][9] with columns (s0..s3, w0..w3, den) and
# src_kind 0/1/2 = 10/20/34-band native resolution (full=1, iid/icc)
# resp. 5/11/17 (full=0, ipd/opd).  tests/test_ps_remap_tables.py pins
# these against the literal _map_idx_* functions.
# ---------------------------------------------------------------------------
def _remap_tab(rows):
    t = np.zeros((34, 9), np.int32)
    for i, (srcs, ws, den) in rows.items():
        t[i, 0:len(srcs)] = srcs
        t[i, 4:4 + len(ws)] = ws
        t[i, 8] = den
    return t


def _build_remap_tables(full):
    one = lambda s: ((s,), (1,), 1)
    # 10 -> 20 (_map_idx_10_to_20): out[2i] = out[2i+1] = par[i]
    b = 9 if full else 4
    t10_20 = {2 * i + k: one(i) for i in range(b + 1) for k in (0, 1)}
    # identity at target resolution (_remap's fall-through copy; source
    # entries past the native width are 0 in the syntax arrays)
    t20_20 = {i: one(i) for i in range(20 if full else 11)}
    t34_34 = {i: one(i) for i in range(34 if full else 17)}
    # 34 -> 20 (_map_idx_34_to_20)
    t34_20 = {
        0: ((0, 1), (2, 1), 3), 1: ((1, 2), (1, 2), 3),
        2: ((3, 4), (2, 1), 3), 3: ((4, 5), (1, 2), 3),
        4: ((6, 7), (1, 1), 2), 5: ((8, 9), (1, 1), 2),
        6: one(10), 7: one(11),
        8: ((12, 13), (1, 1), 2), 9: ((14, 15), (1, 1), 2),
        10: one(16),
    }
    if full:
        t34_20.update({
            11: one(17), 12: one(18), 13: one(19),
            14: ((20, 21), (1, 1), 2), 15: ((22, 23), (1, 1), 2),
            16: ((24, 25), (1, 1), 2), 17: ((26, 27), (1, 1), 2),
            18: ((28, 29, 30, 31), (1, 1, 1, 1), 4),
            19: ((32, 33), (1, 1), 2),
        })
    # 10 -> 34 (_map_idx_10_to_34)
    src = _IDX_10_TO_34_FULL if full else _IDX_10_TO_34_MAP
    t10_34 = {i: one(s) for i, s in enumerate(src)}
    if not full:
        t10_34.pop(16, None)                # out[16] = 0
    # 20 -> 34 (_map_idx_20_to_34)
    t20_34 = {}
    for i in range(34 if full else 17):
        s = _IDX_20_TO_34[i]
        if s == -1:
            t20_34[i] = ((0, 1), (1, 1), 2)
        elif s == -2:
            t20_34[i] = ((2, 3), (1, 1), 2)
        else:
            t20_34[i] = one(s)
    return np.stack([
        np.stack([_remap_tab(t10_20), _remap_tab(t20_20),
                  _remap_tab(t34_20)]),     # to34 = 0
        np.stack([_remap_tab(t10_34), _remap_tab(t20_34),
                  _remap_tab(t34_34)]),     # to34 = 1
    ])


REMAP_TABLES_FULL = _build_remap_tables(True)    # iid / icc
REMAP_TABLES_PART = _build_remap_tables(False)   # ipd / opd


# ---------------------------------------------------------------------------
# Stereo processing (aacps.c:794-971)
# ---------------------------------------------------------------------------
def stereo_processing(ps: PSContext, lbuf: np.ndarray, rbuf: np.ndarray,
                      is34: int) -> None:
    HA, HB = P.mixing_luts()
    pd_re, pd_im = P.pd_smooth()
    k_to_i = P.k_to_i(is34)
    H11, H12, H21, H22 = ps.H11, ps.H12, ps.H21, ps.H22
    H_LUT = HA if ps.icc_mode < 3 else HB

    for H in (H11, H12, H21, H22):
        H[0][0] = H[0][ps.num_env_old]
        H[1][0] = H[1][ps.num_env_old]

    iid_mapped = _remap(ps.iid_par, ps.nr_iid_par, ps.num_env, 1, is34)
    icc_mapped = _remap(ps.icc_par, ps.nr_icc_par, ps.num_env, 1, is34)
    if ps.enable_ipdopd:
        ipd_mapped = _remap(ps.ipd_par, ps.nr_ipdopd_par, ps.num_env, 0, is34)
        opd_mapped = _remap(ps.opd_par, ps.nr_ipdopd_par, ps.num_env, 0, is34)
    if is34 and not ps.is34bands_old:
        for H in (H11, H12, H21, H22):
            H[0][0] = _map_val_20_to_34(H[0][0])
            H[1][0] = _map_val_20_to_34(H[1][0])
        ps.ipd_hist[:] = 0
        ps.opd_hist[:] = 0
    elif not is34 and ps.is34bands_old:
        for H in (H11, H12, H21, H22):
            H[0][0] = _map_val_34_to_20(H[0][0])
            H[1][0] = _map_val_34_to_20(H[1][0])
        ps.ipd_hist[:] = 0
        ps.opd_hist[:] = 0

    nr_par = P.NR_PAR_BANDS[is34]
    for e in range(ps.num_env):
        for b in range(nr_par):
            lut_i = int(iid_mapped[e][b]) + 7 + 23 * ps.iid_quant
            icc_i = int(icc_mapped[e][b])
            h11, h12, h21, h22 = H_LUT[lut_i][icc_i]
            if ps.enable_ipdopd and b < ps.nr_ipdopd_par:
                opd_idx = int(ps.opd_hist[b]) * 8 + int(opd_mapped[e][b])
                ipd_idx = int(ps.ipd_hist[b]) * 8 + int(ipd_mapped[e][b])
                opd_re, opd_im = pd_re[opd_idx], pd_im[opd_idx]
                ipd_re, ipd_im = pd_re[ipd_idx], pd_im[ipd_idx]
                ps.opd_hist[b] = opd_idx & 0x3F
                ps.ipd_hist[b] = ipd_idx & 0x3F
                adj_re = _f32(opd_re * ipd_re + opd_im * ipd_im)
                adj_im = _f32(opd_im * ipd_re - opd_re * ipd_im)
                H11[1][e + 1][b] = _f32(h11 * opd_im)
                H12[1][e + 1][b] = _f32(h12 * adj_im)
                H21[1][e + 1][b] = _f32(h21 * opd_im)
                H22[1][e + 1][b] = _f32(h22 * adj_im)
                h11 = _f32(h11 * opd_re)
                h12 = _f32(h12 * adj_re)
                h21 = _f32(h21 * opd_re)
                h22 = _f32(h22 * adj_re)
            H11[0][e + 1][b] = h11
            H12[0][e + 1][b] = h12
            H21[0][e + 1][b] = h21
            H22[0][e + 1][b] = h22

        start = int(ps.border_position[e])
        stop = int(ps.border_position[e + 1])
        width = _f32(1.0 / (stop - start))
        for k in range(P.NR_BANDS[is34]):
            b = k_to_i[k]
            h11r, h12r = H11[0][e][b], H12[0][e][b]
            h21r, h22r = H21[0][e][b], H22[0][e][b]
            h11i = h12i = h21i = h22i = _f32(0.0)
            if ps.enable_ipdopd:
                neg = (is34 and 9 <= k <= 13) or (not is34 and k <= 1)
                sgn = _f32(-1.0 if neg else 1.0)
                h11i = _f32(sgn * H11[1][e][b])
                h12i = _f32(sgn * H12[1][e][b])
                h21i = _f32(sgn * H21[1][e][b])
                h22i = _f32(sgn * H22[1][e][b])
            h11r_step = _f32((H11[0][e + 1][b] - h11r) * width)
            h12r_step = _f32((H12[0][e + 1][b] - h12r) * width)
            h21r_step = _f32((H21[0][e + 1][b] - h21r) * width)
            h22r_step = _f32((H22[0][e + 1][b] - h22r) * width)
            if ps.enable_ipdopd:
                h11i_step = _f32((H11[1][e + 1][b] - h11i) * width)
                h12i_step = _f32((H12[1][e + 1][b] - h12i) * width)
                h21i_step = _f32((H21[1][e + 1][b] - h21i) * width)
                h22i_step = _f32((H22[1][e + 1][b] - h22i) * width)
            # interpolate (serial accumulation like the C code)
            nsteps = stop - start
            if nsteps <= 0:
                continue
            # exact serial accumulation to match C's += rounding
            h11rs = np.empty(nsteps, np.float32)
            h12rs = np.empty(nsteps, np.float32)
            h21rs = np.empty(nsteps, np.float32)
            h22rs = np.empty(nsteps, np.float32)
            a1, a2, a3, a4 = h11r, h12r, h21r, h22r
            for t in range(nsteps):
                a1 = _f32(a1 + h11r_step)
                a2 = _f32(a2 + h12r_step)
                a3 = _f32(a3 + h21r_step)
                a4 = _f32(a4 + h22r_step)
                h11rs[t], h12rs[t], h21rs[t], h22rs[t] = a1, a2, a3, a4
            n = np.arange(start + 1, stop + 1)
            l_re = lbuf[k, n, 0].copy()
            l_im = lbuf[k, n, 1].copy()
            r_re = rbuf[k, n, 0].copy()
            r_im = rbuf[k, n, 1].copy()
            if ps.enable_ipdopd:
                h11is = np.empty(nsteps, np.float32)
                h12is = np.empty(nsteps, np.float32)
                h21is = np.empty(nsteps, np.float32)
                h22is = np.empty(nsteps, np.float32)
                a1, a2, a3, a4 = h11i, h12i, h21i, h22i
                for t in range(nsteps):
                    a1 = _f32(a1 + h11i_step)
                    a2 = _f32(a2 + h12i_step)
                    a3 = _f32(a3 + h21i_step)
                    a4 = _f32(a4 + h22i_step)
                    h11is[t], h12is[t], h21is[t], h22is[t] = a1, a2, a3, a4
                lbuf[k, n, 0] = h11rs * l_re + h21rs * r_re - h11is * l_im - h21is * r_im
                lbuf[k, n, 1] = h11rs * l_im + h21rs * r_im + h11is * l_re + h21is * r_re
                rbuf[k, n, 0] = h12rs * l_re + h22rs * r_re - h12is * l_im - h22is * r_im
                rbuf[k, n, 1] = h12rs * l_im + h22rs * r_im + h12is * l_re + h22is * r_re
            else:
                lbuf[k, n, 0] = h11rs * l_re + h21rs * r_re
                lbuf[k, n, 1] = h11rs * l_im + h21rs * r_im
                rbuf[k, n, 0] = h12rs * l_re + h22rs * r_re
                rbuf[k, n, 1] = h12rs * l_im + h22rs * r_im


def ps_apply(ps: PSContext, X: np.ndarray, top: int):
    """ff_ps_apply (aacps.c:973-992).  X: [2,38,64] -> (L, R)."""
    is34 = ps.is34bands
    top += P.NR_BANDS[is34] - 64
    if top < P.NR_BANDS[is34]:
        ps.delay[max(top, 0): P.NR_BANDS[is34]] = 0
    if top < P.NR_ALLPASS_BANDS[is34]:
        ps.ap_delay[max(top, 0):] = 0
    lbuf = hybrid_analysis(ps, X, is34)
    rbuf = decorrelation(ps, lbuf, is34)
    stereo_processing(ps, lbuf, rbuf, is34)
    L = hybrid_synthesis(lbuf, is34)
    R = hybrid_synthesis(rbuf, is34)
    return L, R
