"""Quantized wire format: device-side decode and expansion.

Counterpart: ``heaac_tpu/codec/qwire.py`` device half — decode_coeffs_jax
(byte-token spectrum decode), init_qcarry and expand_frame_jax with
is34 in (0, 1) or -1 (the band-mode flip scan: each lane's mode per
frame from side bit 6, returned as ``pc["m34"]``), rows_pair 0 or 1 (1: the coupled-CPE raw SBR rows of
stereo HE-AAC v1): per-frame side info + carried state -> core meta,
the dense SBR plan (sbr_dequant / mapping / chirp by LUT gathers), and
the PS codes (raw-bits row decode via ops/ps_huff + band remap); the
two row decoders run as one call of ``ops/qwire_rows.decode_rows``.  The
wire layout constants live in ``host.py``.  Every integer output and
carry matches the JAX code exactly.

Integers are int64 here (int32 in JAX); byte words that JAX bitcasts to
f32 are truncated to int32 first, so the bit patterns are the same.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from .. import tables as TB
from ..host import (E, H_FLAGS, H_KX1, H_LIMG, H_M1, H_N0, H_N1, H_NLIM,
                    H_NPATCH, H_NQ, H_TAB, HDR_MAX, M, NB_HI, NB_LIM, NB_LO,
                    NB_Q, NPATCH, PS_B0, PS_BORD, PS_HEAD, PS_KND, PS_NE,
                    PS_NIPD, PS_RB, PS_TOP, PS_WIDTH, R_TOKOFF, R_W1, R_W2,
                    RAW_MAX, SIDE_HEAD, SIDE_MAX, T_ESC1, T_ESC2, T_PAIR0,
                    T_QUAD0, T_QUAD_END, T_RAW0, T_SETSF, T_SFD_BASE, T_SGL0,
                    T_ZRUN0, ZRUN_MAX)
from ..ops import ps_huff, qwire_rows, sbr_huff
from . import compact_plan as CP


@functools.cache
def _luts(device: torch.device) -> dict:
    out = {k: torch.from_numpy(v).to(device)
           for k, v in TB.qwire_luts().items()}
    # [to34 * 3 + source kind, 34, 9]
    out["remap"] = torch.from_numpy(
        TB.remap_tables(True).astype(np.int64).reshape(6, 34, 9)).to(device)
    out["remap_p"] = torch.from_numpy(
        TB.remap_tables(False).astype(np.int64).reshape(6, 34, 9)).to(device)
    out["phi_re"] = torch.tensor([1, 0, -1, 0], dtype=torch.float32,
                                 device=device)
    out["phi_im"] = torch.tensor([0, 1, 0, -1], dtype=torch.float32,
                                 device=device)
    out["ps_width"] = torch.tensor(PS_WIDTH, dtype=torch.long, device=device)
    return out


def _f32_from_bytes(b0, b1, b2, b3):
    """Little-endian byte values -> the f32 with that bit pattern."""
    w = b0 | (b1 << 8) | (b2 << 16) | (b3 << 24)
    return w.to(torch.int32).view(torch.float32)


def decode_coeffs(heap, tok_off, ntok, S: int):
    """heap [N] int (byte values), tok_off/ntok [B] -> coeffs [B,1024] f32.

    Classify tokens, cumsum advances / ext sizes, binary-search each of
    the 1024 bins for its producing token, decode elementwise."""
    dev = heap.device
    Lt = _luts(dev)
    cbrt, pow2 = Lt["cbrt"], Lt["pow2sf"]
    N = heap.shape[0]
    B = tok_off.shape[0]
    i = torch.arange(S, device=dev)[None, :]
    live = i < ntok[:, None]
    toks = torch.where(live, heap[(tok_off[:, None] + i).clamp(0, N - 1)], 0)
    is_zrun = (toks >= T_ZRUN0) & (toks <= T_ZRUN0 - 1 + ZRUN_MAX)
    is_pair = (toks >= T_PAIR0) & (toks < T_PAIR0 + 49)
    is_sgl = (toks >= T_SGL0) & (toks < T_SGL0 + 32)
    is_esc1 = toks == T_ESC1
    is_esc2 = toks == T_ESC2
    is_sf = toks == T_SETSF
    is_sfd = live & (toks >= 0xEA)
    is_raw = (toks > T_RAW0) & (toks <= T_RAW0 + RAW_MAX)
    is_quad = (toks >= T_QUAD0) & (toks <= T_QUAD_END)
    L = lambda m: m.long()  # noqa: E731
    adv = (torch.where(is_zrun, toks, 0) + 2 * L(is_pair) + L(is_sgl)
           + L(is_esc1) + L(is_esc2) + torch.where(is_raw, toks - T_RAW0, 0)
           + 4 * L(is_quad))
    cum = torch.cumsum(adv, 1)
    start = cum - adv
    ext_sz = (L(is_esc1) + 2 * L(is_esc2) + 2 * L(is_sf)
              + torch.where(is_raw, 4 * (toks - T_RAW0), 0))
    ext0 = tok_off[:, None] + ntok[:, None]
    ext_pos = torch.cumsum(ext_sz, 1) - ext_sz + ext0
    sf_at = torch.where(is_sf, i, -1)
    last_sf = torch.cummax(sf_at, 1).values
    sf_ext = torch.gather(ext_pos, 1, last_sf.clamp(min=0))
    sfw_abs = (heap[sf_ext.clamp(0, N - 1)]
               | (heap[(sf_ext + 1).clamp(0, N - 1)] << 8))
    dlt = torch.where(is_sfd, toks - T_SFD_BASE, 0)
    dcum = torch.cumsum(dlt, 1)
    dbase = torch.gather(dcum, 1, last_sf.clamp(min=0)) * L(last_sf >= 0)
    sfw = sfw_abs + dcum - dbase
    # JAX's indexing clamps: garbage words (raw-bits lanes) hit index 427
    sf = torch.where(((sfw >> 15) & 1) > 0, 1.0, -1.0) \
        * pow2[(sfw & 511).clamp(max=427)]
    sf = sf * (last_sf >= 0)
    p = torch.arange(1024, device=dev)[None, :]
    lo = torch.zeros((B, 1024), dtype=torch.long, device=dev)
    hi = torch.full((B, 1024), S, dtype=torch.long, device=dev)
    for _ in range(S.bit_length()):
        mid = (lo + hi) >> 1
        cm = torch.gather(cum, 1, mid.clamp(0, S - 1))
        go = cm <= p
        lo = torch.where(go, mid + 1, lo)
        hi = torch.where(go, hi, mid)
    t_of = lo.clamp(0, S - 1)
    covered = p < cum[:, -1:]
    g = lambda a: torch.gather(a, 1, t_of)  # noqa: E731
    tok_p, start_p, sf_p, ext_p = g(toks), g(start), g(sf), g(ext_pos)
    k = p - start_p
    pairp = (tok_p >= T_PAIR0) & (tok_p < T_PAIR0 + 49)
    sglp = (tok_p >= T_SGL0) & (tok_p < T_SGL0 + 32)
    escp1 = tok_p == T_ESC1
    escp2 = tok_p == T_ESC2
    rawp = (tok_p > T_RAW0) & (tok_p <= T_RAW0 + RAW_MAX)
    quadp = (tok_p >= T_QUAD0) & (tok_p <= T_QUAD_END)
    fdiv = lambda a, b: torch.div(a, b, rounding_mode="floor")  # noqa: E731
    c = tok_p - T_PAIR0
    vpair = torch.where(k == 0, fdiv(c, 7) - 3, torch.remainder(c, 7) - 3)
    cq = tok_p - T_QUAD0
    vquad = torch.where(
        k == 0, torch.remainder(cq, 3),
        torch.where(k == 1, torch.remainder(fdiv(cq, 3), 3),
                    torch.where(k == 2, torch.remainder(fdiv(cq, 9), 3),
                                torch.remainder(fdiv(cq, 27), 3)))) - 1
    cs = tok_p - T_SGL0
    vsgl = torch.where(((cs >> 4) & 1) > 0, -(4 + (cs & 15)), 4 + (cs & 15))
    e0 = heap[ext_p.clamp(0, N - 1)]
    e1 = heap[(ext_p + 1).clamp(0, N - 1)]
    vesc = torch.where(escp1, (e0 ^ 128) - 128,
                       ((e0 | (e1 << 8)) ^ 32768) - 32768)
    v = (torch.where(pairp, vpair, 0) + torch.where(quadp, vquad, 0)
         + torch.where(sglp, vsgl, 0) + torch.where(escp1 | escp2, vesc, 0))
    mag = cbrt[v.abs().clamp(0, 8191)]
    val = torch.where(v < 0, -mag, mag) * sf_p
    rp = (ext_p + 4 * k).clamp(0, N - 4)
    rawv = _f32_from_bytes(heap[rp], heap[rp + 1], heap[rp + 2], heap[rp + 3])
    out = torch.where(rawp, rawv, torch.where(v == 0, 0.0, val))
    return torch.where(covered, out, 0.0)


def init_qcarry(B: int, device) -> dict:
    """Cross-frame state of the side expansion (qwire.init_qcarry)."""
    z = lambda *s: torch.zeros((B,) + s, dtype=torch.long,  # noqa: E731
                               device=device)
    hdr = z(HDR_MAX)
    hdr[:, H_KX1] = 32
    return dict(
        hdr=hdr, s_idx=z(M),
        bw=torch.zeros((B, 5), dtype=torch.float32, device=device),
        tend=z(), ws_prev=z(), kbd_prev=z(),
        ps=ps_huff.init_ps_carry(B, device), ps_pcb=z(510),
        sbrrows=sbr_huff.init_rows_carry(B, device),
        sbr_ec=z(5, M), sbr_qc=z(2, NB_Q), sbr_pc=z(5, M), sbr_qpc=z(2, NB_Q))


def expand_frame(heap, rec, carry, is34: int = 0, rows_pair: int = 0,
                 heap_hi=None):
    """rec [B, REC_W] int + heap + carry -> (core_meta, sbr dense plan,
    ps codes {pc_i, pc_b}, new carry) for one frame (expand_frame_jax).
    With is34 = -1 each lane's PS band mode is this frame's side bit 6:
    the parameters are remapped to it, and the ps codes also hold it as
    ``m34`` [B] (0 where PS is off).  ``heap_hi``: the heap's last index
    as a 0-d device tensor, where heap is a longer buffer that holds it
    (a CUDA graph's); None: heap.shape[0] - 1."""
    if is34 not in (-1, 0, 1):
        raise ValueError(f"is34 must be -1, 0 or 1, not {is34}")
    dev = heap.device
    Lt = _luts(dev)
    f32 = torch.float32
    B = rec.shape[0]
    ar = lambda n: torch.arange(n, device=dev)[None, :]  # noqa: E731
    gat = lambda a, idx: torch.gather(a, 1, idx)  # noqa: E731
    tok_off = rec[:, R_TOKOFF]
    w1 = rec[:, R_W1]
    w2 = rec[:, R_W2]
    side_off = tok_off + (w1 & 0xFFFF) + ((w1 >> 16) & 0xFFFF)
    hdr_off = side_off + (w2 & 0xFFFF)
    has_hdr = ((w2 >> 16) & 0xFF) > 0

    hi = heap.shape[0] - 1 if heap_hi is None else heap_hi
    # two clamps: a Scalar bound beside a Tensor one is uploaded, which
    # a CUDA graph cannot capture
    gw = lambda off, n: heap[(off[:, None] + ar(n)).clamp(  # noqa: E731
        min=0).clamp(max=hi)]
    side = gw(side_off, SIDE_MAX)
    hdr = torch.where(has_hdr[:, None], gw(hdr_off, HDR_MAX), carry["hdr"])
    sb = lambda j: side[:, j]  # noqa: E731
    hb = lambda j: hdr[:, j]  # noqa: E731
    core0 = sb(0)
    ws = core0 & 3
    kbd = (core0 >> 2) & 1
    err = (core0 >> 3) & 1
    hsl = 4 * ((core0 >> 4) & 1)
    ampres = (core0 >> 5) & 1
    bw_present = (core0 >> 6) & 1
    kxm0_diff = (core0 >> 7) & 1
    core_meta = dict(ws=ws, wsp=carry["ws_prev"], kbd=kbd,
                     kbdp=carry["kbd_prev"])
    flags = sb(1)
    start = flags & 1
    reset = (flags >> 1) & 1
    coupled = (flags >> 2) & 1
    pan = (flags >> 3) & 1
    addharm = (flags >> 4) & 1
    ps_on = (flags >> 5) & 1
    ne = sb(2) & 7
    nnoise = (sb(2) >> 3) & 3
    sine0 = (sb(2) >> 5) & 3
    frbits = sb(3) & 31
    ea0 = ((sb(3) >> 5) & 7) - 1
    tqsel = sb(4) & 31
    ea1 = ((sb(4) >> 5) & 7) - 1
    tenv = side[:, 5:11]
    noise0 = sb(11) | (sb(12) << 8)
    kx1, m1 = hb(H_KX1), hb(H_M1)
    opt0 = torch.full((B,), SIDE_HEAD, dtype=torch.long, device=dev)
    def g1(off):
        return gat(side, off[:, None].clamp(0, SIDE_MAX - 1))[:, 0]

    kx0 = torch.where(kxm0_diff > 0, g1(opt0), kx1)
    m0 = torch.where(kxm0_diff > 0, g1(opt0 + 1), m1)
    told2 = 2 * carry["tend"]
    bw_off = opt0 + 2 * kxm0_diff
    bwb = torch.stack([g1(bw_off + i) for i in range(20)], 1).reshape(B, 5, 4)
    bw_ship = _f32_from_bytes(bwb[..., 0], bwb[..., 1], bwb[..., 2],
                              bwb[..., 3])
    bw_now = torch.where(bw_present[:, None] > 0, bw_ship, carry["bw"])
    side_head_end = bw_off + 20 * bw_present
    n0, n1 = hb(H_N0), hb(H_N1)
    nq, nlim = hb(H_NQ), hb(H_NLIM)
    npat = hb(H_NPATCH)
    interpol = hb(H_FLAGS) & 1
    limg = Lt["limgain"][hb(H_LIMG).clamp(0, 3)]
    flow = hdr[:, H_TAB:H_TAB + NB_LO + 1]
    t_hi = H_TAB + n0[:, None] + 1
    idx_of = lambda base, n: (base + ar(n)).clamp(0, HDR_MAX - 1)  # noqa
    fhigh = gat(hdr, idx_of(t_hi, NB_HI + 1))
    t_q = t_hi + n1[:, None] + 1
    fnoise = gat(hdr, idx_of(t_q, NB_Q + 1))
    t_lim = t_q + nq[:, None] + 1
    flim = gat(hdr, idx_of(t_lim, NB_LIM + 1))
    t_ps = t_lim + nlim[:, None] + 1
    pstart = gat(hdr, idx_of(t_ps, NPATCH))
    pnum = gat(hdr, idx_of(t_ps + npat[:, None], NPATCH))
    pnum = pnum * (ar(NPATCH) < npat[:, None])

    m48 = ar(M)
    kk = kx1[:, None] + m48

    def band_of(tab, cnt, nb):
        valid = ar(nb + 1)[:, None, :] <= cnt[:, None, None]
        ge = (kk[:, :, None] >= tab[:, None, :nb + 1]) & valid
        idx = ge.long().sum(-1) - 1
        return torch.where((idx >= 0) & (idx < cnt[:, None]), idx, -1)

    map_lo = band_of(flow, n0, NB_LO)
    map_hi = band_of(fhigh, n1, NB_HI)
    map_q = band_of(fnoise, nq, NB_Q)
    map_lim = band_of(flim, nlim, NB_LIM)
    pcum = torch.cumsum(pnum, 1)
    pj = (m48[:, :, None] >= pcum[:, None, :]).long().sum(-1)
    pj_c = pj.clamp(0, NPATCH - 1)
    pbase = gat(pcum - pnum, pj_c)
    src_raw = (gat(pstart, pj_c) + m48 - pbase).clamp(0, 63)
    mm = m48 < m1[:, None]
    active = mm & (start > 0)[:, None]
    src_of_m = torch.where(active, src_raw, 0)
    noisb = torch.where(active, map_q.clamp(0, NB_Q - 1), 0)

    # ---- sbr_dequant via LUTs -----------------------------------------------
    soff = side_head_end[:, None]
    e5 = ar(E)
    res_e = (frbits[:, None] >> e5) & 1
    nb_e = torch.where(res_e > 0, n1[:, None], n0[:, None]) \
        * (e5 < ne[:, None])
    env_off = soff + torch.cat(
        [torch.zeros((B, 1), dtype=torch.long, device=dev),
         torch.cumsum(nb_e, 1)[:, :4]], 1)
    env_total = nb_e.sum(1, keepdim=True)
    j22 = torch.arange(NB_HI, device=dev)[None, None, :]
    ecodes = gat(side, (env_off[:, :, None] + j22).clamp(0, SIDE_MAX - 1)
                 .reshape(B, -1)).reshape(B, E, NB_HI)
    pan_off = env_off + env_total * coupled[:, None]
    pcodes = gat(side, (pan_off[:, :, None] + j22).clamp(0, SIDE_MAX - 1)
                 .reshape(B, -1)).reshape(B, E, NB_HI)
    after_env = soff[:, 0] + env_total[:, 0] * (1 + coupled)
    nrow = ar(2)
    nsz = nq[:, None] * (nrow < nnoise[:, None])
    noff = after_env[:, None] + torch.cat(
        [torch.zeros((B, 1), dtype=torch.long, device=dev), nsz[:, :1]], 1)
    j5 = torch.arange(NB_Q, device=dev)[None, None, :]
    qcodes = gat(side, (noff[:, :, None] + j5).clamp(0, SIDE_MAX - 1)
                 .reshape(B, -1)).reshape(B, 2, NB_Q)
    ntotal = nsz.sum(1)
    qpan_off = noff + (ntotal * coupled)[:, None]
    qpcodes = gat(side, (qpan_off[:, :, None] + j5).clamp(0, SIDE_MAX - 1)
                  .reshape(B, -1)).reshape(B, 2, NB_Q)
    after_noise = after_env + ntotal * (1 + coupled)

    # ---- wire-v5 raw-rows block (ops/sbr_huff) ------------------------------
    # the static rows_pair adds the coupled-CPE channel's blocks: both
    # lanes of a coupled pair ship the same region and each decodes both
    # channels' chained rows (read_sbr_cpe)
    rows_on = ((flags >> 7) & 1) * start
    byte_act = (start > 0) & (rows_on == 0)
    rr_off = soff[:, 0]
    lp16 = g1(rr_off) | (g1(rr_off + 1) << 8)
    rr_rbits = (lp16 & 0x1FFF) * rows_on
    rr_phase = ((lp16 >> 13) & 7) * rows_on
    rr_bytes = (rr_rbits + 7) >> 3
    rows_live = (rows_on > 0) & (rr_rbits > 0)
    region = gat(side, ((rr_off + 2)[:, None] + ar(sbr_huff.RW))
                 .clamp(0, SIDE_MAX - 1))
    after_noise = torch.where(rows_on > 0, rr_off + 2 + rr_bytes,
                              after_noise)
    ah_off = after_noise
    def ahb(j):
        return gat(side, (ah_off + j)[:, None].clamp(0, SIDE_MAX - 1))

    ah_lo = (ahb(0) | (ahb(1) << 8) | (ahb(2) << 16)) * addharm[:, None]
    ah_hi = (ahb(3) | (ahb(4) << 8) | (ahb(5) << 16)) * addharm[:, None]
    ps_off = after_noise + 6 * addharm

    # ---- PS head and region (ops/ps_huff; wire v5) --------------------------
    pg = lambda off, n: gat(side, (off[:, None] + ar(n)).clamp(  # noqa
        0, SIDE_MAX - 1))
    psb = pg(ps_off, PS_HEAD)
    pb0 = psb[:, PS_B0]
    penv = (pb0 & 7) * ps_on
    ps_hdr = ((pb0 >> 3) & 1) * ps_on
    pquant = ((pb0 >> 4) & 1) * ps_on
    pknd = psb[:, PS_KND] * ps_on
    enable_ext = (pknd >> 4) & 1
    bitoff = (pknd >> 5) & 7
    nipd = (psb[:, PS_NIPD] * ps_on).clamp(0, 17)
    nb10 = psb[:, PS_NE] * ps_on
    ne_pre = nb10 & 7
    fresh = (nb10 >> 3) & 1
    rbits = (psb[:, PS_RB] * ps_on) | (((nb10 >> 4) & 15) << 8)
    live = ps_on * fresh
    nr_iid = Lt["ps_width"][pknd & 3]
    nr_icc = Lt["ps_width"][(pknd >> 2) & 3]
    pregion = pg(ps_off + PS_HEAD, ps_huff.RW)

    # both regions' rows in one call (one kernel launch on the card)
    (ec_r, pc_r, qc_r, qpc_r, _rows_ok, sbrrows_new), \
        (iid_n, icc_n, ipd_n, opd_n, pd_on, ok_now, psc2) = \
        qwire_rows.decode_rows(
            dict(region=region, phase=rr_phase, rbits=rr_rbits, ne=ne,
                 nnoise=nnoise, frbits=frbits, n0=n0, n1=n1, nq=nq,
                 ampres=ampres, active=rows_live, carry=carry["sbrrows"],
                 coupled=coupled),
            dict(region=pregion, start_off=bitoff * live, rbits=rbits * live,
                 enable_iid=(nr_iid > 0).long() * live, iq=pquant * live,
                 nr_iid=nr_iid * live,
                 enable_icc=(nr_icc > 0).long() * live,
                 nr_icc=nr_icc * live, enable_ext=enable_ext * live,
                 ne_pre=ne_pre * live, penv=penv * live, nipd=nipd * live,
                 header=ps_hdr * live, carry=carry["ps"]),
            pair=bool(rows_pair))
    ec_w = ec_r & 0xFF
    qc_w = qc_r & 0xFF
    rl3 = rows_live[:, None, None]
    ba3 = byte_act[:, None, None]
    er_last = torch.where(rl3, ec_w, torch.where(ba3, ecodes,
                                                 carry["sbr_ec"]))
    qr_last = torch.where(rl3, qc_w, torch.where(ba3, qcodes,
                                                 carry["sbr_qc"]))
    ro3 = (rows_on > 0)[:, None, None]
    ecodes = torch.where(ro3, er_last, ecodes)
    qcodes = torch.where(ro3, qr_last, qcodes)
    if rows_pair:
        bcp = (byte_act & (coupled > 0))[:, None, None]
        pr_last = torch.where(rl3, pc_r & 0xFF,
                              torch.where(bcp, pcodes, carry["sbr_pc"]))
        qpr_last = torch.where(rl3, qpc_r & 0xFF,
                               torch.where(bcp, qpcodes, carry["sbr_qpc"]))
        pcodes = torch.where(ro3, pr_last, pcodes)
        qpcodes = torch.where(ro3, qpr_last, qpcodes)
    else:
        pr_last = carry["sbr_pc"]
        qpr_last = carry["sbr_qpc"]

    env_lut, c1_lut, c2_lut = Lt["env"], Lt["env_c1"], Lt["env_c2"]
    ar3 = ampres[:, None, None] > 0
    ecl = ecodes.clamp(0, 127)
    pcl = pcodes.clamp(0, 127)
    v_unc = torch.where(ar3, env_lut[1][ecl], env_lut[0][ecl])
    t1 = torch.where(ar3, c1_lut[1][ecl], c1_lut[0][ecl])
    t2 = torch.where(ar3, c2_lut[1][pcl], c2_lut[0][pcl])
    fac = t1 / (1.0 + t2)
    v_cpl = torch.where(pan[:, None, None] > 0, fac * t2, fac)
    env_vals = torch.where(coupled[:, None, None] > 0, v_cpl, v_unc)
    qcl = qcodes.clamp(0, 63)
    qpl = qpcodes.clamp(0, 63)
    q_unc = Lt["noise"][qcl]
    qt1 = Lt["noise_c1"][qcl]
    qt2 = Lt["noise_c2"][qpl]
    qfac = qt1 / (1.0 + qt2)
    q_cpl = torch.where(pan[:, None, None] > 0, qfac * qt2, qfac)
    noise_vals = torch.where(coupled[:, None, None] > 0, q_cpl, q_unc)

    # ---- sbr_mapping (aacsbr.c:1451-1496) -----------------------------------
    map_e = torch.where(res_e[:, :, None] > 0, map_hi[:, None, :],
                        map_lo[:, None, :])                      # [B,5,48]
    erow = (e5 < ne[:, None])[:, :, None] & (start > 0)[:, None, None]
    em = erow & mm[:, None, :]
    e_orig = torch.where(em, torch.gather(env_vals, 2,
                                          map_e.clamp(0, NB_HI - 1)), 0.0)
    qsel = (tqsel[:, None] >> e5) & 1
    q_rows = torch.gather(noise_vals, 1, qsel[:, :, None].expand(
        B, E, NB_Q).clamp(0, 1))
    q_map = torch.where(em, torch.gather(q_rows, 2, map_q.clamp(
        0, NB_Q - 1)[:, None, :].expand(B, E, M)), 0.0)
    m_mid = (((fhigh[:, :NB_HI] + fhigh[:, 1:NB_HI + 1]) >> 1)
             - kx1[:, None])
    i_hi = ar(NB_HI)
    ah_bits = torch.where(i_hi < 24, (ah_lo >> i_hi) & 1,
                          (ah_hi >> (i_hi - 24).clamp(min=0)) & 1)
    ah_bits = ah_bits * (i_hi < n1[:, None])
    ah_at_m = ((m48[:, :, None] == m_mid[:, None, :]) * ah_bits[:, None, :]
               ).sum(-1)
    gate = ((e5 >= ea1[:, None])[:, :, None]
            | (carry["s_idx"] > 0)[:, None, :])
    s_idxm = ah_at_m[:, None, :] * gate * erow                   # [B,5,48]
    same_e = ((map_e[:, :, :, None] == map_e[:, :, None, :])
              & (map_e >= 0)[:, :, :, None])
    s_mapped = ((same_e.long() * s_idxm[:, :, None, :]).sum(-1) > 0).long() \
        * erow * mm[:, None, :]
    # ne <= 5 on every legal frame (the JAX gather fills past it)
    s_idx_last = torch.gather(s_idxm, 1, (ne - 1).clamp(0, E - 1)[
        :, None, None].expand(B, 1, M))[:, 0]
    s_idx_next = torch.where((start > 0)[:, None], s_idx_last,
                             carry["s_idx"])

    # ---- assemble the dense plan --------------------------------------------
    k64 = ar(64)
    s38 = ar(38)
    s40 = ar(40)
    r42 = ar(42)
    t2e = 2 * tenv
    startf = (start & 1).to(f32)
    xlow_old = (k64 < kx0[:, None]).to(f32)
    xlow_new = (k64 < kx1[:, None]).to(f32)
    use_y_old = ((k64 >= kx0[:, None])
                 & (k64 < (kx0 + m0)[:, None])).to(f32)
    use_y_new = ((k64 >= kx1[:, None])
                 & (k64 < (kx1 + m1)[:, None])).to(f32)
    bw_of_m = gat(bw_now, noisb)
    hf_mask = mm.to(f32)
    bw_of_m = bw_of_m * hf_mask * startf[:, None]
    EAO = TB.ENVELOPE_ADJUSTMENT_OFFSET
    ilo = t2e[:, 0:1] + EAO
    ihi = t2e[:, 5:6] + EAO
    gen_slot_mask = ((s40 >= ilo) & (s40 < ihi)).to(f32) * startf[:, None]
    lo_e = t2e[:, :5][:, :, None]
    hi_e = t2e[:, 1:6][:, :, None]
    e_act = (e5 < ne[:, None])[:, :, None] & (start > 0)[:, None, None]
    env_onehot = ((s38[:, None, :] >= lo_e) & (s38[:, None, :] < hi_e)
                  & e_act).to(f32)
    dt_env = (tenv[:, 1:6] - tenv[:, :5]).to(f32)
    recip = torch.where((dt_env > 0) & (e5 < ne[:, None])
                        & (start > 0)[:, None],
                        0.5 / torch.where(dt_env > 0, dt_env, 1.0), 0.0)
    freqres_sel = (res_e * (e5 < ne[:, None]) * (start > 0)[:, None]).to(f32)

    def grp_maps(tab, cnt, bmap, nb):
        wdt = (tab[:, 1:nb + 1] - tab[:, :nb]).to(f32)
        iw_band = torch.where((ar(nb) < cnt[:, None]) & (wdt > 0),
                              1.0 / torch.where(wdt > 0, wdt, 1.0), 0.0)
        return gat(iw_band, bmap.clamp(0, nb - 1)) * (bmap >= 0)

    ident = interpol[:, None] > 0
    st1 = (start > 0)[:, None]
    pb_lo = torch.where(ident, m48, torch.where(st1, map_lo, -1))
    pb_hi = torch.where(ident, m48, torch.where(st1, map_hi, -1))
    iw_lo = torch.where(ident, 1.0, grp_maps(flow, n0, map_lo, NB_LO))
    iw_hi = torch.where(ident, 1.0, grp_maps(fhigh, n1, map_hi, NB_HI))
    iw_lo = iw_lo * st1
    iw_hi = iw_hi * st1
    pb_lo = torch.where(st1, pb_lo, -1)
    pb_hi = torch.where(st1, pb_hi, -1)
    same_lo = (pb_lo[:, :, None] == pb_lo[:, None, :]) \
        & (pb_lo >= 0)[:, :, None]
    same_hi = (pb_hi[:, :, None] == pb_hi[:, None, :]) \
        & (pb_hi >= 0)[:, :, None]
    grp_mean = torch.stack([same_lo.to(f32) * iw_lo[:, None, :],
                            same_hi.to(f32) * iw_hi[:, None, :]], 1)
    limb = torch.where(st1, map_lim, -1)
    l28 = torch.arange(NB_LIM, device=dev)[None, :, None]
    lim_onehot = ((limb[:, None, :] == l28)
                  & (limb >= 0)[:, None, :]).to(f32)

    smask_pos = s_mapped.to(f32)
    s_idx_f = s_idxm.to(f32)
    in_ea_e = ((e5 == ea0[:, None]) | (e5 == ea1[:, None])).to(f32)[:, :,
                                                                     None]
    delta = 1.0 - in_ea_e
    temp = e_orig / (1.0 + q_map)
    mmf = mm[:, None, :]
    q_m0 = torch.sqrt(temp * q_map) * mmf
    s_m0 = torch.sqrt(temp * s_idx_f) * mmf
    erow_f = erow.to(f32)
    gain_num = e_orig * torch.where(smask_pos > 0, q_map, 1.0)
    den_q = 1.0 + q_map * torch.where(smask_pos > 0, 1.0, delta)
    den_q = torch.where(erow_f > 0, den_q, 1.0)
    noisegate = erow_f * delta * (s_m0 == 0)
    scatter_m = (((k64[:, None, :] - kx1[:, None, None]) == m48[:, :, None])
                 & mm[:, :, None]).to(f32)

    t0_2 = t2e[:, 0:1]
    hslc = hsl[:, None]
    env_of_r = ((r42[:, None, :] - hslc[:, :, None] >= lo_e)
                & (r42[:, None, :] - hslc[:, :, None] < hi_e) & e_act)
    reset_row = (((reset[:, None] > 0) & (r42 >= t0_2)
                  & (r42 < t0_2 + hslc))[:, None, :]
                 & (e5 == 0)[:, :, None])
    fill_map = (env_of_r | reset_row).to(f32).transpose(1, 2)
    shuf = ((reset[:, None] == 0) & (hslc > 0) & (r42 >= t0_2)
            & (r42 < t0_2 + 4) & st1)
    src = told2[:, None] + (r42 - t0_2)
    row_src = torch.where(shuf & (src >= 0) & (src < 42), src, r42)
    in_rng = (s38 >= t0_2) & (s38 < t2e[:, 5:6]) & st1
    direct_row = torch.where(in_rng, s38 + hslc, s38)
    is_ea_slot = (env_onehot * in_ea_e).sum(1)
    smooth_on = torch.where(in_rng, (hslc > 0).to(f32) * (1.0 - is_ea_slot),
                            0.0)
    noise_start = torch.where(
        in_rng, (noise0[:, None] + (s38 - t0_2) * m1[:, None]) & 0x1FF, 0)
    phase = (sine0[:, None] + (s38 - t0_2)) & 3
    sign0 = (1 - 2 * (kx1[:, None] & 1)).to(f32)
    sine_re = torch.where(in_rng, Lt["phi_re"][phase], 0.0)
    sine_im0 = torch.where(in_rng, Lt["phi_im"][phase] * sign0, 0.0)
    itemp = (told2 - 32).clamp(min=0)

    plan = dict(
        start=startf, gain_num=gain_num, den_q=den_q,
        e_orig=e_orig * erow_f, q_m0=q_m0, s_m0=s_m0, noisegate=noisegate,
        lim_onehot=lim_onehot, limgain=limg * (start > 0),
        env_onehot=env_onehot, recip=recip, src_of_m=src_of_m,
        bw_of_m=bw_of_m, hf_mask=hf_mask, gen_slot_mask=gen_slot_mask,
        row_src=row_src, fill_map=fill_map, smooth_on=smooth_on,
        direct_row=direct_row, noise_start=noise_start, sine_re=sine_re,
        sine_im0=sine_im0, grp_mean=grp_mean, freqres_sel=freqres_sel,
        i_temp=itemp, use_y_old=use_y_old, use_y_new=use_y_new,
        xlow_old=xlow_old, xlow_new=xlow_new, scatter_m=scatter_m)

    # ---- PS block -> pc_i / pc_b (wire v5) ----------------------------------
    ok_eff = torch.where(fresh > 0, ok_now, carry["ps"]["ps_ok"]).clamp(
        0, 1) * ps_on
    ipdopd_on = torch.where(fresh > 0, pd_on, carry["ps"]["pd_enable"]
                            ).clamp(0, 1) * ps_on
    bords = ((psb[:, PS_BORD:PS_BORD + 6] ^ 128) - 128) * ps_on[:, None]
    zc = torch.zeros((B, 1), dtype=torch.long, device=dev)
    pc_i = torch.cat([
        ok_eff[:, None], ipdopd_on[:, None], pquant[:, None], penv[:, None],
        (((pb0 >> 5) & 7) * ps_on)[:, None],
        (psb[:, PS_NIPD] * ps_on)[:, None],
        (psb[:, PS_TOP] * ps_on)[:, None], bords,
        zc.expand(B, CP.PC_I_N - CP.PI_BORD - 6)], 1)

    # the target resolution: one mode for the scan, or per lane per frame
    m34 = ((flags >> 6) & 1) * ps_on if is34 == -1 else None
    to34 = m34 if m34 is not None else is34

    def remap_dev(vals, kind, tt):
        """vals [B,5,34] native resolution -> mixing resolution:
        out[i] = tdiv(sum_j w_j*vals[s_j], den); den == 0 rows are 0."""
        tab = tt[(to34 * 3 + kind.clamp(0, 2)).clamp(0, 5)]     # [B,34,9]
        s = tab[:, :, 0:4].reshape(B, 1, 136).expand(B, 5, 136)
        g = torch.gather(vals, 2, s).reshape(B, 5, 34, 4)
        num = (g * tab[:, None, :, 4:8]).sum(-1)
        den = tab[:, None, :, 8]
        q = torch.sign(num) * torch.div(num.abs(), den.clamp(min=1),
                                        rounding_mode="floor")
        return torch.where(den > 0, q, 0)

    iid = remap_dev(iid_n, pknd & 3, Lt["remap"])
    icc = remap_dev(icc_n, (pknd >> 2) & 3, Lt["remap"])
    pkind = (nipd >= 11).long() + (nipd >= 17).long()
    j17 = torch.arange(17, device=dev)[None, None, :]
    pad = torch.zeros((B, 5, 17), dtype=torch.long, device=dev)

    def part_remap(rows):
        full = torch.cat([rows, pad], 2)
        out = remap_dev(full, pkind, Lt["remap_p"])[:, :, :17]
        return torch.where(j17 < nipd[:, None, None], out, 0)

    ipd = part_remap(ipd_n)
    opd = part_remap(opd_n)
    pc_b_new = torch.cat([iid.reshape(B, 170), icc.reshape(B, 170),
                          ipd.reshape(B, 85), opd.reshape(B, 85)], 1)
    pc_b_new = ((pc_b_new + 128) & 255) - 128               # int8 semantics
    upd = live > 0
    pc_b = torch.where(upd[:, None], pc_b_new, carry["ps_pcb"])
    pc_b = torch.where((ps_on > 0)[:, None], pc_b, 0)
    pc = dict(pc_i=pc_i, pc_b=pc_b)
    if m34 is not None:
        pc["m34"] = m34

    ps_carry_new = {
        k: torch.where(upd.reshape((B,) + (1,) * (v.dim() - 1)), v,
                       carry["ps"][k]) for k, v in psc2.items()}
    laste = (ne - 1).clamp(0, 4)
    lastq = (nnoise - 1).clamp(0, 1)

    def rowat(rows, idx):
        return torch.gather(rows, 1, idx[:, None, None].expand(
            B, 1, rows.shape[2]))[:, 0]

    el = sbrrows_new["env_last"]
    nl = sbrrows_new["noise_last"]
    fl = sbrrows_new["fr_last"]
    fr_new = (frbits >> laste) & 1
    bac = byte_act & (coupled > 0)
    sbrrows_carry = dict(
        env_last=torch.stack(
            [torch.where(byte_act[:, None], rowat(ecodes, laste), el[:, 0]),
             torch.where(bac[:, None], rowat(pcodes, laste), el[:, 1])], 1),
        noise_last=torch.stack(
            [torch.where(byte_act[:, None], rowat(qcodes, lastq), nl[:, 0]),
             torch.where(bac[:, None], rowat(qpcodes, lastq), nl[:, 1])], 1),
        fr_last=torch.stack(
            [torch.where(byte_act, fr_new, fl[:, 0]),
             torch.where(bac, fr_new, fl[:, 1])], 1))
    new_carry = dict(
        hdr=hdr, s_idx=s_idx_next, bw=bw_now,
        tend=torch.where(start > 0, gat(tenv, ne.clamp(0, 5)[:, None])[:, 0],
                         carry["tend"]),
        ws_prev=torch.where(err > 0, 0, ws),
        kbd_prev=torch.where(err > 0, 0, kbd),
        ps=ps_carry_new,
        ps_pcb=torch.where(upd[:, None], pc_b_new, carry["ps_pcb"]),
        sbrrows=sbrrows_carry,
        sbr_ec=er_last, sbr_qc=qr_last, sbr_pc=pr_last, sbr_qpc=qpr_last)
    return core_meta, plan, pc, new_carry
