"""Compact frame plans: their layout, host builders and the device
expansion.

Counterpart: ``heaac_tpu/codec/compact_plan.py`` — the slot layout
constants (SC_* / PC_*), zeros_compact, zeros_ps_compact,
build_sbr_compact and build_ps_compact (host numpy, names as there); on
tensors init_ps_hist, expand_sbr and expand_ps.

A compact plan is the few integers and floats per frame-lane that the
dense plans of ``codec/frame_plan.py`` are derived from (band maps,
envelope borders, kx / m, the patch map, noise and sine phases), ~3.5 KB
where the dense plan is ~58 KB; ``expand_sbr`` rebuilds the dense SBR
plan from it on the device, equal to ``frame_plan.build_sbr_plan``'s,
and ``expand_ps`` the PS plan, carrying the reference's persistent H /
IPD / OPD state (aacps.c:794-935) from frame to frame.

Differences from the JAX package: its packed, XOR-whitened record (the
REC_* / W* layout, its packing, masks and unpacking) has no counterpart,
as no decoder of the port reads it;
``expand_sbr`` takes its two square roots through float64
(``_sqrt_rn``), so that they round as numpy's do.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from .. import tables as TB
from ..bitstream.sbr_syntax import ENVELOPE_ADJUSTMENT_OFFSET, sbr_dequant
from ..ops.ps_single import _remap
from ..ops.sbr_single import LIMGAIN, chirp, mapping

E, M, L = 5, 48, 28

# ---- sc_i slots -----------------------------------------------------------
I_START, I_KX0, I_KX1, I_M0, I_M1, I_NE = 0, 1, 2, 3, 4, 5
I_TENV = 6                  # 6..11: 2*t_env[0..5] (absolute slot borders x2)
I_TOLD2 = 12                # 2*t_env_num_env_old
I_EA0, I_EA1 = 13, 14
I_HSL, I_RESET = 15, 16
I_NOISE0, I_SINE0 = 17, 18
I_ITEMP, I_FRBITS = 19, 20
SC_I_N = 24

# ---- sc_b slots (int8) ----------------------------------------------------
B_SRC = 0                   # [48] patch source band (0..31)
B_NOISB = 48                # [48] noise band of m (0..4)
B_PB_LO = 96                # [48] low-res grp band of m (-1: none)
B_PB_HI = 144               # [48] high-res grp band of m
B_LIMB = 192                # [48] limiter band of m (-1: none)
B_SMASK = 240               # [5*48] bit0: s_mapped>0, bit1: s_indexmapped
SC_B_N = 480

# ---- sc_f slots -----------------------------------------------------------
F_EORIG = 0                 # [5*48]
F_QMAP = 240                # [5*48]
F_BW = 480                  # [5] bw_array
F_RECIP = 485               # [5] 0.5/env_len
F_IWLO = 490                # [48] 1/band_width low-res (grp_mean values)
F_IWHI = 538                # [48] high-res
F_LIMG = 586                # limiter gain
SC_F_N = 587

# ---- pc_i slots -----------------------------------------------------------
PI_ON, PI_IPD, PI_QUANT, PI_NENV, PI_ICCMODE, PI_NIPD, PI_TOP = range(7)
PI_BORD = 7                 # 7..12: border_position[0..5] (b[0] == -1)
PC_I_N = 16

# ---- pc_b slots (int8) ----------------------------------------------------
PB_IID = 0                  # [5,34]
PB_ICC = 170                # [5,34]
PB_IPD = 340                # [5,17]
PB_OPD = 425                # [5,17]
PC_B_N = 510

# ---------------------------------------------------------------------------
# Host: silence
# ---------------------------------------------------------------------------
def zeros_compact() -> dict:
    """Silence-lane compact SBR plan (expands to frame_plan._zeros_plan())."""
    sc_i = np.zeros(SC_I_N, np.int32)
    sc_i[I_EA0] = sc_i[I_EA1] = -1
    sc_b = np.zeros(SC_B_N, np.int8)
    sc_b[B_PB_LO:B_PB_LO + 96] = -1      # both grp maps: no band
    sc_b[B_LIMB:B_LIMB + 48] = -1
    sc_f = np.zeros(SC_F_N, np.float32)
    return dict(sc_i=sc_i, sc_b=sc_b, sc_f=sc_f)


def zeros_ps_compact() -> dict:
    return dict(pc_i=np.zeros(PC_I_N, np.int32),
                pc_b=np.zeros(PC_B_N, np.int8))


# ---------------------------------------------------------------------------
# Host builders (frame_plan.build_sbr_plan / build_ps_plan's state advance:
# chirp, s_indexmapped, noise / sine phase)
# ---------------------------------------------------------------------------
def build_sbr_compact(sbr, ch: int, id_aac: int, dequant_done: bool) -> dict:
    """Compact counterpart of ``frame_plan.build_sbr_plan``, advancing the
    same host state; ``expand_sbr`` of it equals that dense plan."""
    d = sbr.data[ch]
    out = zeros_compact()
    sc_i, sc_b, sc_f = out["sc_i"], out["sc_b"], out["sc_f"]

    kx0, kx1 = sbr.kx
    m0, m1 = sbr.m
    sc_i[I_KX0], sc_i[I_KX1], sc_i[I_M0], sc_i[I_M1] = kx0, kx1, m0, m1
    sc_i[I_ITEMP] = max(2 * d.t_env_num_env_old - 32, 0)

    if not sbr.start:
        return out
    sc_i[I_START] = 1

    if not dequant_done:
        sbr_dequant(sbr, id_aac)

    e_orig, q_mapped, s_mapped = mapping(sbr, d, d.e_a)
    ne = d.bs_num_env
    sc_i[I_NE] = ne
    sc_f[F_EORIG:F_EORIG + 240] = e_orig[:E, :M].reshape(-1)
    qm = np.zeros((E, M), np.float32)
    qm[:ne] = q_mapped[:ne, :M]
    sc_f[F_QMAP:F_QMAP + 240] = qm.reshape(-1)
    smask = np.zeros((E, M), np.int8)
    smask[:ne] = (s_mapped[:ne, :M] > 0).astype(np.int8)
    smask[:ne] |= (d.s_indexmapped[1:ne + 1, :M] > 0).astype(np.int8) << 1
    sc_b[B_SMASK:B_SMASK + 240] = smask.reshape(-1)
    sc_i[I_EA0], sc_i[I_EA1] = int(d.e_a[0]), int(d.e_a[1])
    sc_f[F_LIMG] = LIMGAIN[sbr.bs_limiter_gains]

    for li in range(sbr.n_lim):
        lo = max(int(sbr.f_tablelim[li]) - kx1, 0)
        hi = max(int(sbr.f_tablelim[li + 1]) - kx1, 0)
        sc_b[B_LIMB + lo:B_LIMB + min(hi, M)] = li

    for e in range(ne):
        t0, t1 = int(d.t_env[e]), int(d.t_env[e + 1])
        sc_i[I_TENV + e] = 2 * t0
        if t1 > t0:
            sc_f[F_RECIP + e] = np.float32(0.5 / (t1 - t0))
        if d.bs_freq_res[e + 1]:
            sc_i[I_FRBITS] |= 1 << e
    # borders e..5 hold the final border so range tests see empty envelopes
    for e in range(ne, 6):
        sc_i[I_TENV + e] = 2 * int(d.t_env[ne])

    # grp-mean band maps: identity when interpol_freq=1
    if sbr.bs_interpol_freq:
        sc_b[B_PB_LO:B_PB_LO + 48] = np.arange(48, dtype=np.int8)
        sc_b[B_PB_HI:B_PB_HI + 48] = np.arange(48, dtype=np.int8)
        sc_f[F_IWLO:F_IWLO + 96] = 1.0
    else:
        for base, iw_base, (tab, nb) in (
                (B_PB_LO, F_IWLO, (sbr.f_tablelow, sbr.n[0])),
                (B_PB_HI, F_IWHI, (sbr.f_tablehigh, sbr.n[1]))):
            for pband in range(nb):
                lo = int(tab[pband]) - kx1
                hi_b = int(tab[pband + 1]) - kx1
                lo_c, hi_c = max(lo, 0), min(hi_b, M)
                wdt = hi_b - lo
                if wdt > 0 and hi_c > lo_c:
                    sc_b[base + lo_c:base + hi_c] = pband
                    sc_f[iw_base + lo_c:iw_base + hi_c] = \
                        np.float32(1.0 / wdt)

    # HF patch map + chirp state advance (aacsbr.c:1316-1409)
    chirp(sbr, d)
    sc_f[F_BW:F_BW + 5] = d.bw_array[:5]
    g = 0
    kk = kx1
    mi = 0
    for j in range(sbr.num_patches):
        for x in range(int(sbr.patch_num_subbands[j])):
            pband = int(sbr.patch_start_subband[j]) + x
            while g <= sbr.n_q and kk >= sbr.f_tablenoise[g]:
                g += 1
            g -= 1
            if mi < M:
                sc_b[B_SRC + mi] = pband
                sc_b[B_NOISB + mi] = max(g, 0)
            kk += 1
            mi += 1

    sc_i[I_HSL] = 4 * (not sbr.bs_smoothing_mode)
    sc_i[I_RESET] = int(bool(sbr.reset))
    sc_i[I_TOLD2] = 2 * int(d.t_env_num_env_old)
    sc_i[I_NOISE0] = int(d.f_indexnoise)
    sc_i[I_SINE0] = int(d.f_indexsine)
    # advance the noise/sine phase exactly like the dense builder
    nslots = 2 * (int(d.t_env[ne]) - int(d.t_env[0]))
    d.f_indexnoise = (d.f_indexnoise + nslots * m1) & 0x1FF
    d.f_indexsine = (d.f_indexsine + nslots) & 3
    return out


def build_ps_compact(ps, top: int, is34: int = 0) -> dict:
    """Compact counterpart of ``frame_plan.build_ps_plan``: the mapped
    parameter indices only (the H assembly runs in ``expand_ps`` on the
    device, which carries the H / IPD / OPD state); the host PS state is
    not advanced.  A band mode other than ``is34`` raises
    NotImplementedError."""
    out = zeros_ps_compact()
    pc_i, pc_b = out["pc_i"], out["pc_b"]
    if ps is None or not ps.start:
        return out
    if int(ps.is34bands) != is34:
        raise NotImplementedError(
            "PS band mode differs from the stream's compiled mode")
    # is34bands_old != is34bands can only be the first active PS frame
    # here (later flips raise in the planner): the carried H / IPD / OPD
    # state is still zero, and the reference's transition fixup
    # (aacps.c:832-860) maps zeros to zeros
    pc_i[PI_ON] = 1
    pc_i[PI_IPD] = int(ps.enable_ipdopd)
    pc_i[PI_QUANT] = int(ps.iid_quant)
    pc_i[PI_NENV] = int(ps.num_env)
    pc_i[PI_ICCMODE] = int(ps.icc_mode)
    pc_i[PI_NIPD] = int(ps.nr_ipdopd_par)
    pc_i[PI_TOP] = int(top)
    for e in range(min(ps.num_env + 1, 6)):
        pc_i[PI_BORD + e] = int(ps.border_position[e])

    npar = TB.NR_PAR_BANDS[is34]
    iid = _remap(ps.iid_par, ps.nr_iid_par, ps.num_env, 1, is34)
    icc = _remap(ps.icc_par, ps.nr_icc_par, ps.num_env, 1, is34)
    for e in range(ps.num_env):
        pc_b[PB_IID + 34 * e:PB_IID + 34 * e + npar] = iid[e][:npar]
        pc_b[PB_ICC + 34 * e:PB_ICC + 34 * e + npar] = icc[e][:npar]
    if ps.enable_ipdopd:
        ipd = _remap(ps.ipd_par, ps.nr_ipdopd_par, ps.num_env, 0, is34)
        opd = _remap(ps.opd_par, ps.nr_ipdopd_par, ps.num_env, 0, is34)
        nip = min(int(ps.nr_ipdopd_par), 17)
        for e in range(ps.num_env):
            pc_b[PB_IPD + 17 * e:PB_IPD + 17 * e + nip] = ipd[e][:nip]
            pc_b[PB_OPD + 17 * e:PB_OPD + 17 * e + nip] = opd[e][:nip]
    return out


# ---------------------------------------------------------------------------
# Device: expansion
# ---------------------------------------------------------------------------
@functools.cache
def _luts(device: torch.device):
    HA, HB = TB.mixing_luts()
    lut = np.concatenate([HA.reshape(-1, 4), HB.reshape(-1, 4)], 0)
    pd_re, pd_im = TB.pd_smooth()
    phi = np.array([[1, 0, -1, 0], [0, 1, 0, -1]], np.float32)
    return tuple(torch.from_numpy(a).to(device)
                 for a in (lut, pd_re, pd_im, phi))


def init_ps_hist(B: int, device) -> dict:
    """Persistent H planes [B,2,6,34,4] + ipd/opd histories [B,17]."""
    return dict(
        H=torch.zeros((B, 2, 6, 34, 4), dtype=torch.float32, device=device),
        ipd_hist=torch.zeros((B, 17), dtype=torch.long, device=device),
        opd_hist=torch.zeros((B, 17), dtype=torch.long, device=device))


def _sqrt_rn(x):
    """The correctly rounded float32 square root (numpy's, and the
    dense builder's): through float64, as PyTorch's vectorized CPU
    float32 sqrt is off by one unit in the last place for ~0.6% of
    inputs."""
    return torch.sqrt(x.double()).float()


def expand_sbr(sc: dict) -> dict:
    """sc_i [B,SC_I_N], sc_b [B,SC_B_N] (any int dtypes), sc_f [B,SC_F_N]
    float32 -> the dense SBR plan dict the frame graph reads, equal to
    ``frame_plan.build_sbr_plan``'s (integer fields int64)."""
    sc_i = sc["sc_i"].long()
    sc_b = sc["sc_b"].long()
    sc_f = sc["sc_f"]
    dev = sc_i.device
    B = sc_i.shape[0]
    f32 = torch.float32
    col = lambda j: sc_i[:, j]  # noqa: E731
    ar = lambda n: torch.arange(n, device=dev)[None, :]  # noqa: E731

    start = col(I_START).to(f32)
    kx0, kx1 = col(I_KX0)[:, None], col(I_KX1)[:, None]
    m0, m1 = col(I_M0)[:, None], col(I_M1)[:, None]
    ne = col(I_NE)[:, None]
    t2 = sc_i[:, I_TENV:I_TENV + 6]              # [B,6] 2*t_env
    h_sl = col(I_HSL)[:, None]
    reset = col(I_RESET)[:, None]
    told2 = col(I_TOLD2)[:, None]
    ea0, ea1 = col(I_EA0)[:, None], col(I_EA1)[:, None]
    frbits = col(I_FRBITS)[:, None]

    k64, m48, e5, s38, r42 = ar(64), ar(M), ar(E), ar(38), ar(42)

    xlow_old = (k64 < kx0).to(f32)
    xlow_new = (k64 < kx1).to(f32)
    use_y_old = ((k64 >= kx0) & (k64 < kx0 + m0)).to(f32)
    use_y_new = ((k64 >= kx1) & (k64 < kx1 + m1)).to(f32)

    sb = lambda base, n: sc_b[:, base:base + n]  # noqa: E731
    src_of_m = sb(B_SRC, 48)
    noisb = sb(B_NOISB, 48)
    bw_arr = sc_f[:, F_BW:F_BW + 5]
    bw_of_m = torch.gather(bw_arr, 1, noisb.clamp(0, 4))
    hf_mask = (m48 < m1).to(f32)
    bw_of_m = bw_of_m * hf_mask

    # gen_slot_mask over the 40 X_high slots (offset +2)
    s40 = ar(40)
    ilo = t2[:, 0:1] + ENVELOPE_ADJUSTMENT_OFFSET
    ihi = t2[:, 5:6] + ENVELOPE_ADJUSTMENT_OFFSET
    gen_slot_mask = ((s40 >= ilo) & (s40 < ihi)).to(f32)

    # envelope slot structure
    lo_e = t2[:, :5][:, :, None]                 # [B,5,1]
    hi_e = t2[:, 1:6][:, :, None]
    e_act = (e5 < ne)[:, :, None]                # [B,5,1]
    env_onehot = ((s38[:, None, :] >= lo_e) & (s38[:, None, :] < hi_e)
                  & e_act).to(f32)               # [B,5,38]
    recip = sc_f[:, F_RECIP:F_RECIP + 5]
    freqres_sel = (((frbits >> e5) & 1) & (e5 < ne)).to(f32)

    def grp(base, iw_base):
        """grp-mean matrix from a band-of-m map and its 1/width values."""
        pb = sb(base, 48)                        # [B,48]
        iw = sc_f[:, iw_base:iw_base + 48]       # [B,48]
        same = (pb[:, :, None] == pb[:, None, :]) & (pb >= 0)[:, :, None]
        return same.to(f32) * iw[:, None, :]
    grp_mean = torch.stack([grp(B_PB_LO, F_IWLO), grp(B_PB_HI, F_IWHI)], 1)

    limb = sb(B_LIMB, 48)
    l28 = torch.arange(L, device=dev)[None, :, None]
    lim_onehot = ((limb[:, None, :] == l28)
                  & (limb >= 0)[:, None, :]).to(f32)      # [B,28,48]

    # dequantized envelope grids -> gain-calc inputs
    e_orig = sc_f[:, F_EORIG:F_EORIG + 240].reshape(B, E, M)
    q_map = sc_f[:, F_QMAP:F_QMAP + 240].reshape(B, E, M)
    smask = sb(B_SMASK, 240).reshape(B, E, M)
    s_pos = (smask & 1).to(f32)
    s_idx = ((smask >> 1) & 1).to(f32)
    mm = (m48 < m1).to(f32)[:, None, :]          # [B,1,48]
    erow = (e5 < ne).to(f32)[:, :, None]         # [B,5,1]
    temp = e_orig / (1.0 + q_map)
    q_m0 = _sqrt_rn(temp * q_map) * mm
    s_m0 = _sqrt_rn(temp * s_idx) * mm
    in_ea_e = ((e5 == ea0) | (e5 == ea1)).to(f32)[:, :, None]
    delta = 1.0 - in_ea_e
    gain_num = e_orig * torch.where(s_pos > 0, q_map, 1.0)
    den_q = 1.0 + q_map * torch.where(s_pos > 0, 1.0, delta)
    den_q = torch.where(erow > 0, den_q, 1.0)
    noisegate = erow * delta * (s_m0 == 0).to(f32)

    # scatter m -> QMF band kx1+m
    scatter_m = ((k64[:, None, :] - kx1[:, :, None] == m48[:, :, None])
                 & (m48 < m1)[:, :, None]).to(f32)        # [B,48,64]

    # g_temp/q_temp bookkeeping (frame_plan.build_sbr_plan)
    t0_2 = t2[:, 0:1]
    rh = r42[:, None, :] - h_sl[:, :, None]
    env_of_r = (rh >= lo_e) & (rh < hi_e) & e_act          # [B,5,42]
    reset_row = ((reset > 0) & (r42 >= t0_2)
                 & (r42 < t0_2 + h_sl))[:, None, :] \
        & (e5 == 0)[:, :, None]                            # [B,5,42]
    fill_map = (env_of_r | reset_row).to(f32).transpose(1, 2)
    shuf = (reset == 0) & (h_sl > 0) & (r42 >= t0_2) & (r42 < t0_2 + 4)
    src = told2 + (r42 - t0_2)
    row_src = torch.where(shuf & (src >= 0) & (src < 42), src, r42)

    # per-slot assembly maps
    in_rng = (s38 >= t0_2) & (s38 < t2[:, 5:6])
    direct_row = torch.where(in_rng, s38 + h_sl, s38)
    is_ea_slot = torch.einsum("bes,be->bs", env_onehot, in_ea_e[:, :, 0])
    smooth_on = torch.where(in_rng, (h_sl > 0).to(f32) * (1.0 - is_ea_slot),
                            0.0)
    noise_start = torch.where(
        in_rng, (col(I_NOISE0)[:, None] + (s38 - t0_2) * m1) & 0x1FF, 0)
    phase = (col(I_SINE0)[:, None] + (s38 - t0_2)) & 3
    phi = _luts(dev)[3]
    sign0 = (1 - 2 * (kx1 & 1)).to(f32)
    sine_re = torch.where(in_rng, phi[0][phase], 0.0)
    sine_im0 = torch.where(in_rng, phi[1][phase] * sign0, 0.0)

    return dict(
        start=start, gain_num=gain_num, den_q=den_q, e_orig=e_orig * erow,
        q_m0=q_m0, s_m0=s_m0, noisegate=noisegate, lim_onehot=lim_onehot,
        limgain=sc_f[:, F_LIMG], env_onehot=env_onehot, recip=recip,
        src_of_m=src_of_m, bw_of_m=bw_of_m, hf_mask=hf_mask,
        gen_slot_mask=gen_slot_mask, row_src=row_src, fill_map=fill_map,
        smooth_on=smooth_on, direct_row=direct_row, noise_start=noise_start,
        sine_re=sine_re, sine_im0=sine_im0, grp_mean=grp_mean,
        freqres_sel=freqres_sel, i_temp=col(I_ITEMP),
        use_y_old=use_y_old, use_y_new=use_y_new, xlow_old=xlow_old,
        xlow_new=xlow_new, scatter_m=scatter_m)


def expand_ps(pc: dict, hist: dict, is34: int = 0):
    """pc_i [B,PC_I_N], pc_b [B,PC_B_N] (int) + hist -> (ps plan dict for
    ops/ps, new hist)."""
    pc_i, pc_b = pc["pc_i"].long(), pc["pc_b"]
    dev = pc_i.device
    B = pc_i.shape[0]
    f32 = torch.float32
    lut, pd_re_t, pd_im_t, _ = _luts(dev)

    ps_on = pc_i[:, PI_ON]
    ipd_on_i = pc_i[:, PI_IPD] * ps_on
    quant = pc_i[:, PI_QUANT]
    num_env = pc_i[:, PI_NENV]
    icc_mode = pc_i[:, PI_ICCMODE]
    nipd = pc_i[:, PI_NIPD]
    top = pc_i[:, PI_TOP]
    bord = pc_i[:, PI_BORD:PI_BORD + 6]

    pcb = pc_b.long()
    iid = pcb[:, PB_IID:PB_IID + 170].reshape(B, 5, 34)
    icc = pcb[:, PB_ICC:PB_ICC + 170].reshape(B, 5, 34)
    ipd = pcb[:, PB_IPD:PB_IPD + 85].reshape(B, 5, 17)
    opd = pcb[:, PB_OPD:PB_OPD + 85].reshape(B, 5, 17)

    base = torch.where(icc_mode < 3, 0, 368)[:, None]
    b17 = torch.arange(17, device=dev)[None, :]
    b34 = torch.arange(34, device=dev)[None, :]

    H = hist["H"]
    ipd_h, opd_h = hist["ipd_hist"], hist["opd_hist"]
    rows_re = [H[:, 0, 0]]
    rows_im = [H[:, 1, 0]]
    npar_mask = (b34 < TB.NR_PAR_BANDS[is34])[:, :, None]
    zpad = torch.zeros((B, 17), dtype=f32, device=dev)
    pad = lambda a: torch.cat([a, zpad], 1)  # noqa: E731
    for e in range(5):
        act = (e < num_env) & (ps_on > 0)
        flat = (base + (iid[:, e] + 7 + 23 * quant[:, None]) * 8
                + icc[:, e]).clamp(0, 735)
        h4 = lut[flat]                                        # [B,34,4]
        ipd_act = act & (ipd_on_i > 0)
        bsel = b17 < nipd[:, None]
        upd = ipd_act[:, None] & bsel
        opd_idx = (opd_h * 8 + opd[:, e]).clamp(0, 511)
        ipd_idx = (ipd_h * 8 + ipd[:, e]).clamp(0, 511)
        opd_h = torch.where(upd, opd_idx & 0x3F, opd_h)
        ipd_h = torch.where(upd, ipd_idx & 0x3F, ipd_h)
        opd_re, opd_im = pd_re_t[opd_idx], pd_im_t[opd_idx]
        ipd_re, ipd_im = pd_re_t[ipd_idx], pd_im_t[ipd_idx]
        adj_re = opd_re * ipd_re + opd_im * ipd_im
        adj_im = opd_im * ipd_re - opd_re * ipd_im
        mul_re = torch.stack([pad(opd_re), pad(adj_re),
                              pad(opd_re), pad(adj_re)], -1)
        mul_im = torch.stack([pad(opd_im), pad(adj_im),
                              pad(opd_im), pad(adj_im)], -1)
        bsel34 = torch.cat([bsel, torch.zeros_like(bsel)], 1)[:, :, None]
        do_ipd = ipd_act[:, None, None] & bsel34
        prev_re = H[:, 0, e + 1]
        prev_im = H[:, 1, e + 1]
        new_re = torch.where(do_ipd, h4 * mul_re, h4)
        new_im = torch.where(do_ipd, h4 * mul_im, prev_im)
        wr = act[:, None, None] & npar_mask
        rows_re.append(torch.where(wr, new_re, prev_re))
        rows_im.append(torch.where(wr, new_im, prev_im))

    H_re = torch.stack(rows_re, 1)                            # [B,6,34,4]
    H_im = torch.stack(rows_im, 1)
    idx = num_env.clamp(0, 5)[:, None, None, None].expand(B, 1, 34, 4)
    last_re = torch.gather(H_re, 1, idx)
    last_im = torch.gather(H_im, 1, idx)
    H_next = torch.stack([torch.cat([last_re, H_re[:, 1:]], 1),
                          torch.cat([last_im, H_im[:, 1:]], 1)], 1)
    on = ps_on > 0
    new_hist = dict(
        H=torch.where(on[:, None, None, None, None], H_next, H),
        ipd_hist=torch.where(on[:, None], ipd_h, hist["ipd_hist"]),
        opd_hist=torch.where(on[:, None], opd_h, hist["opd_hist"]))

    n32 = torch.arange(32, device=dev)[None, None, :]
    start_e = bord[:, :5][:, :, None]
    stop_e = bord[:, 1:6][:, :, None]
    e_act = ((torch.arange(5, device=dev)[None, :, None]
              < num_env[:, None, None]) & on[:, None, None])
    valid = e_act & (stop_e > start_e) & (n32 > start_e) & (n32 <= stop_e)
    den = torch.where(stop_e > start_e, stop_e - start_e, 1).to(f32)
    t = (n32 - start_e).to(f32) / den
    zrow = torch.zeros((B, 1, 32), dtype=f32, device=dev)
    Ws = torch.cat([torch.where(valid, 1.0 - t, 0.0), zrow], 1)
    We = torch.cat([zrow, torch.where(valid, t, 0.0)], 1)

    nrb = TB.NR_BANDS[is34]
    k91 = torch.arange(91, device=dev)[None, :]
    topx = (top + nrb - 64).clamp(0, 91)[:, None]
    top_mask = torch.where(on[:, None], (k91 < topx).to(f32),
                           torch.ones((B, 91), dtype=f32, device=dev))
    plan = dict(ps_on=ps_on.to(f32), H=torch.stack([H_re, H_im], 1),
                Ws=Ws, We=We, ipd_on=ipd_on_i.to(f32), top_mask=top_mask)
    return plan, new_hist
