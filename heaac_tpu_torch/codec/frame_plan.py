"""Dense frame plans: the host-built tensors that drive the batched SBR
and PS device graph (host numpy).

Counterpart: ``heaac_tpu/codec/frame_plan.py`` — SbrChannelPlan,
_zeros_plan, build_sbr_plan, stack_plans and build_ps_plan, names and
arithmetic as there.  Per frame and stream lane, everything that depends
only on the bitstream (dequantized envelopes, band maps, limiter
segments, noise / sine phase counters, chirp factors, the PS mixing
matrices with their IPD / OPD phase smoothing) becomes fixed-shape
masks, indices and coefficients; the device graph reads only those.
The builders advance the parsed context's host state (chirp, noise and
sine indices, s_indexmapped, the PS H and phase histories) exactly as
the reference DSP would.  The parameter math is the single-stream
decoder's host copy (``ops/sbr_single``: chirp, mapping, LIMGAIN;
``ops/ps_single.prepare``: the PS remaps and mixing matrices).

Shapes (per lane): E=5 envelope rows, M=48 SBR bands, L=28 limiter rows,
38 envelope time slots, 40 X_high slots, 64 QMF bands.
"""
from __future__ import annotations

from dataclasses import dataclass, fields

import numpy as np

from ..bitstream.sbr_syntax import (ENVELOPE_ADJUSTMENT_OFFSET, SBRContext,
                                    sbr_dequant)
from ..ops.ps_single import prepare
from ..ops.sbr_single import LIMGAIN, PHI_IM, PHI_RE, chirp, mapping

E, M, L = 5, 48, 28


@dataclass
class SbrChannelPlan:
    """All dense per-frame inputs for one SBR channel lane."""
    start: np.float32 = np.float32(0)
    # gain calculation
    gain_num: np.ndarray = None        # [E, M]
    den_q: np.ndarray = None           # [E, M]
    e_orig: np.ndarray = None          # [E, M]
    q_m0: np.ndarray = None            # [E, M] unlimited noise level
    s_m0: np.ndarray = None            # [E, M] unboosted sine level
    noisegate: np.ndarray = None       # [E, M] delta*(s_m==0) for boost sum
    lim_onehot: np.ndarray = None      # [L, M]
    limgain: np.float32 = np.float32(1.0)
    env_onehot: np.ndarray = None      # [E, 38] slot->envelope
    recip: np.ndarray = None           # [E] 0.5/env_len
    # HF generation
    src_of_m: np.ndarray = None        # [M] int32 source low band
    bw_of_m: np.ndarray = None         # [M] chirp factor
    hf_mask: np.ndarray = None         # [M] band in use
    gen_slot_mask: np.ndarray = None   # [40] X_high slots to generate
    # assembly
    row_src: np.ndarray = None         # [42] g_temp row shuffle
    fill_map: np.ndarray = None        # [42, E] row->envelope fill
    smooth_on: np.ndarray = None       # [38]
    direct_row: np.ndarray = None      # [38] int32 i + h_SL
    noise_start: np.ndarray = None     # [38] int32
    sine_re: np.ndarray = None         # [38]
    sine_im0: np.ndarray = None        # [38]
    # envelope estimation band grouping (interpol_freq=0; identity when 1)
    grp_mean: np.ndarray = None        # [2, M, M] low/high-res group mean
    freqres_sel: np.ndarray = None     # [E] 1 -> high-res table
    # x_gen
    i_temp: np.int32 = np.int32(0)
    use_y_old: np.ndarray = None       # [64]
    use_y_new: np.ndarray = None       # [64]
    xlow_old: np.ndarray = None        # [64]
    xlow_new: np.ndarray = None        # [64]
    scatter_m: np.ndarray = None       # [M, 64] m-domain -> QMF band


PLAN_FIELDS = tuple(f.name for f in fields(SbrChannelPlan))


def _zeros_plan() -> SbrChannelPlan:
    p = SbrChannelPlan()
    p.gain_num = np.zeros((E, M), np.float32)
    p.den_q = np.ones((E, M), np.float32)
    p.e_orig = np.zeros((E, M), np.float32)
    p.q_m0 = np.zeros((E, M), np.float32)
    p.s_m0 = np.zeros((E, M), np.float32)
    p.noisegate = np.zeros((E, M), np.float32)
    p.lim_onehot = np.zeros((L, M), np.float32)
    p.env_onehot = np.zeros((E, 38), np.float32)
    p.recip = np.zeros(E, np.float32)
    p.src_of_m = np.zeros(M, np.int32)
    p.bw_of_m = np.zeros(M, np.float32)
    p.hf_mask = np.zeros(M, np.float32)
    p.gen_slot_mask = np.zeros(40, np.float32)
    p.row_src = np.arange(42, dtype=np.int32)
    p.fill_map = np.zeros((42, E), np.float32)
    p.smooth_on = np.zeros(38, np.float32)
    p.direct_row = np.arange(38, dtype=np.int32)
    p.noise_start = np.zeros(38, np.int32)
    p.sine_re = np.zeros(38, np.float32)
    p.sine_im0 = np.zeros(38, np.float32)
    p.grp_mean = np.stack([np.eye(M, dtype=np.float32)] * 2)
    p.freqres_sel = np.zeros(E, np.float32)
    p.i_temp = np.int32(0)
    p.use_y_old = np.zeros(64, np.float32)
    p.use_y_new = np.zeros(64, np.float32)
    p.xlow_old = np.zeros(64, np.float32)
    p.xlow_new = np.zeros(64, np.float32)
    p.scatter_m = np.zeros((M, 64), np.float32)
    return p


def build_sbr_plan(sbr: SBRContext, ch: int, id_aac: int,
                   dequant_done: bool) -> SbrChannelPlan:
    """The dense plan of one channel of one frame; advances the host-side
    chirp / noise-index / sine-index state as the reference DSP would
    (aacsbr.c:1716-1745 ordering)."""
    d = sbr.data[ch]
    p = _zeros_plan()

    kx0, kx1 = sbr.kx  # NB: kx[0]=prev
    m0, m1 = sbr.m
    # x_gen region masks (aacsbr.c:1412-1446)
    k = np.arange(64)
    p.i_temp = np.int32(max(2 * d.t_env_num_env_old - 32, 0))
    p.xlow_old = (k < kx0).astype(np.float32)
    p.use_y_old = ((k >= kx0) & (k < kx0 + m0)).astype(np.float32)
    p.xlow_new = (k < kx1).astype(np.float32)
    p.use_y_new = ((k >= kx1) & (k < kx1 + m1)).astype(np.float32)

    if not sbr.start:
        return p
    p.start = np.float32(1)

    if not dequant_done:
        sbr_dequant(sbr, id_aac)

    # mapping (mutates d.s_indexmapped exactly like the reference)
    e_orig, q_mapped, s_mapped = mapping(sbr, d, d.e_a)
    ne = d.bs_num_env
    mm = np.arange(M) < m1
    p.e_orig[:ne] = e_orig[:ne, :M]
    temp = (e_orig[:ne, :M] / (1.0 + q_mapped[:ne, :M])).astype(np.float32)
    p.q_m0[:ne] = np.sqrt(temp * q_mapped[:ne, :M], dtype=np.float32) * mm
    p.s_m0[:ne] = np.sqrt(
        temp * d.s_indexmapped[1:ne + 1, :M], dtype=np.float32) * mm
    delta = np.array([0.0 if (e == d.e_a[0] or e == d.e_a[1]) else 1.0
                      for e in range(ne)], np.float32)
    sm = s_mapped[:ne, :M].astype(np.float32)
    p.gain_num[:ne] = e_orig[:ne, :M] * np.where(sm > 0, q_mapped[:ne, :M],
                                                 1.0)
    p.den_q[:ne] = 1.0 + q_mapped[:ne, :M] * np.where(
        sm > 0, 1.0, delta[:, None])
    p.noisegate[:ne] = delta[:, None] * (p.s_m0[:ne] == 0)
    p.limgain = LIMGAIN[sbr.bs_limiter_gains]
    for li in range(sbr.n_lim):
        lo = int(sbr.f_tablelim[li]) - kx1
        hi = int(sbr.f_tablelim[li + 1]) - kx1
        p.lim_onehot[li, max(lo, 0):max(hi, 0)] = 1.0

    # envelope slot structure
    for e in range(ne):
        t0, t1 = int(d.t_env[e]), int(d.t_env[e + 1])
        p.env_onehot[e, 2 * t0: 2 * t1] = 1.0
        if t1 > t0:
            p.recip[e] = np.float32(0.5 / (t1 - t0))
        p.freqres_sel[e] = np.float32(d.bs_freq_res[e + 1])

    # interpol_freq=0: e_curr becomes the group mean over scalefactor bands
    # (aacsbr.c:1520-1545); with interpol_freq=1 the matrices stay identity
    if not sbr.bs_interpol_freq:
        for hi, (tab, nb) in enumerate((
                (sbr.f_tablelow, sbr.n[0]), (sbr.f_tablehigh, sbr.n[1]))):
            g = np.zeros((M, M), np.float32)
            for pband in range(nb):
                lo = int(tab[pband]) - kx1
                hi_b = int(tab[pband + 1]) - kx1
                lo_c = max(lo, 0)
                hi_c = min(hi_b, M)
                wdt = hi_b - lo
                if wdt > 0 and hi_c > lo_c:
                    g[lo_c:hi_c, lo_c:hi_c] = 1.0 / wdt
            p.grp_mean[hi] = g

    # HF generation (aacsbr.c:1360-1409) + chirp state advance
    chirp(sbr, d)
    g = 0
    kk = kx1
    mi = 0
    for j in range(sbr.num_patches):
        for x in range(int(sbr.patch_num_subbands[j])):
            pband = int(sbr.patch_start_subband[j]) + x
            while g <= sbr.n_q and kk >= sbr.f_tablenoise[g]:
                g += 1
            g -= 1
            p.src_of_m[mi] = pband
            p.bw_of_m[mi] = d.bw_array[max(g, 0)]
            p.hf_mask[mi] = 1.0
            kk += 1
            mi += 1
    ilo = 2 * int(d.t_env[0]) + ENVELOPE_ADJUSTMENT_OFFSET
    ihi = 2 * int(d.t_env[ne]) + ENVELOPE_ADJUSTMENT_OFFSET
    p.gen_slot_mask[ilo:ihi] = 1.0

    # scatter m -> QMF band kx1+m
    for m_i in range(min(m1, M)):
        if kx1 + m_i < 64:
            p.scatter_m[m_i, kx1 + m_i] = 1.0

    # g_temp/q_temp bookkeeping (aacsbr.c:1630-1646)
    h_SL = 4 * (not sbr.bs_smoothing_mode)
    t0 = 2 * int(d.t_env[0])
    if sbr.reset:
        for i in range(h_SL):
            p.fill_map[i + t0, 0] = 1.0
    elif h_SL:
        told = 2 * int(d.t_env_num_env_old)
        for i in range(4):
            if 0 <= t0 + i < 42 and 0 <= told + i < 42:
                p.row_src[t0 + i] = told + i
    for e in range(ne):
        for i in range(2 * int(d.t_env[e]), 2 * int(d.t_env[e + 1])):
            p.fill_map[h_SL + i, e] = 1.0

    # per-slot assembly maps + noise/sine index advance (aacsbr.c:1649-1713)
    indexnoise = d.f_indexnoise
    indexsine = d.f_indexsine
    sign0 = np.float32(1 - 2 * (kx1 & 1))
    for e in range(ne):
        in_ea = e == d.e_a[0] or e == d.e_a[1]
        for i in range(2 * int(d.t_env[e]), 2 * int(d.t_env[e + 1])):
            p.smooth_on[i] = float(h_SL and not in_ea)
            p.direct_row[i] = i + h_SL
            p.noise_start[i] = indexnoise
            indexnoise = (indexnoise + m1) & 0x1FF
            p.sine_re[i] = PHI_RE[indexsine]
            p.sine_im0[i] = PHI_IM[indexsine] * sign0
            indexsine = (indexsine + 1) & 3
    d.f_indexnoise = indexnoise
    d.f_indexsine = indexsine
    return p


def stack_plans(plans: list) -> dict:
    """Stack per-lane plans into batched device inputs."""
    return {name: np.stack([np.asarray(getattr(pl, name)) for pl in plans])
            for name in PLAN_FIELDS}


# ---------------------------------------------------------------------------
# Parametric Stereo plan
# ---------------------------------------------------------------------------
def build_ps_plan(ps, top: int, is34: int = 0) -> dict:
    """Per-frame PS device inputs; advances the host H state.

    The H-matrix half of the reference stereo processing
    (aacps.c:794-902): remapping, IPD/OPD phase smoothing with history,
    and the per-envelope mixing matrices, as the single-stream decoder's
    host half computes them (``ops/ps_single.prepare``); the device graph
    only interpolates and mixes.  ``is34`` is the stream's band mode: a
    PS frame in the other mode raises NotImplementedError (the scans run
    one mode)."""
    if ps is None or not ps.start:
        return {"ps_on": np.float32(0),
                "H": np.zeros((2, 6, 34, 4), np.float32),
                "Ws": np.zeros((6, 32), np.float32),
                "We": np.zeros((6, 32), np.float32),
                "ipd_on": np.float32(0),
                "top_mask": np.ones(91, np.float32)}
    if int(ps.is34bands) != is34:
        raise NotImplementedError(
            "PS band mode differs from the stream's compiled mode")
    p = prepare(ps, top)
    return {"ps_on": np.float32(1), "H": p["H"][0], "Ws": p["Ws"][0],
            "We": p["We"][0], "ipd_on": p["ipd_on"][0],
            "top_mask": p["top_mask"][0]}
