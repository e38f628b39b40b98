"""Parallel AAC spectral-Huffman decode (raw-bits qwire lanes).

Counterpart: ``heaac_tpu/ops/spec_huff.py`` decode_spec_jax, including
the EIGHT_SHORT de-interleave and the per-bin M/S mask (``with_ms``).  Every bit offset
of a lane's spectral region is classified against per-codebook 16-bit
flat LUTs, code starts are resolved by binary lifting, sections map to
bins, and the scalefactor delta chain decodes with the same
speculate+lift scheme.  Output is bit-identical to the JAX decoder.

All integer work is int64 (JAX's is int32; every value here fits either
way).  Gathers clip their indices exactly where the JAX code clips them.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from .. import tables as TB

NC_MAX = 512          # codes per lane (pairs cover 1024 bins)
SFB = 768             # sf-region classify width in bits


@functools.cache
def _consts(si: int, NS: int, device: torch.device) -> dict:
    sfbL, beyondL, ns = TB.sfb_of_bin(si)
    sfbS, beyondS, _nsS, offS, bwS = TB.sfb_of_bin_short(si)
    offL = np.asarray(TB.swb_offset_1024(si), np.int32)
    pcol = np.arange(1024)
    kcol = pcol & 127
    col_sfb_s = sfbS[kcol]
    bwL = np.zeros(NS, np.int32)
    bwL[:ns] = offL[1:ns + 1] - offL[:ns]
    q = TB.qwire_luts()
    arrs = dict(
        col_w=(pcol >> 7), col_sfb_s=col_sfb_s, col_sfb_l=sfbL,
        col_beyond_s=beyondS[kcol], col_beyond_l=beyondL,
        col_inoff_s=kcol - offS[col_sfb_s], col_inoff_l=pcol - offL[sfbL],
        col_bw_s=bwS[col_sfb_s], bwL=bwL, bwS=bwS,
        lut=TB.spec_luts().reshape(-1).view(np.int32),
        sflut=TB.sf_lut(), cb_dim=TB.CB_DIM, cb_uns=TB.CB_UNSIGNED)
    out = {k: torch.from_numpy(np.asarray(v, np.int64)).to(device)
           for k, v in arrs.items()}
    out["cbrt"] = torch.from_numpy(q["cbrt"]).to(device)
    out["pow2"] = torch.from_numpy(q["pow2sf"]).to(device)
    return out


def _gather(a, idx):
    return torch.gather(a, 1, idx)


def decode_spec(heap, off, w3, sampling_index: int, NBITS: int,
                with_ms: bool = False, NS: int = 52, SEC: int = 31):
    """heap [N] int (byte values), off [B] spec-block byte offsets, w3 [B]
    (nbits | nsec<<13 | sfidx0<<18 | flags) -> coeffs [B,1024] f32, or
    (coeffs, ms_mask [B,1024] int) with ``with_ms``: the per-bin M/S
    band mask of the lanes that ship one, for the caller's pair
    butterfly.  Lanes with w3 == 0 decode to zeros."""
    dev = heap.device
    C = _consts(sampling_index, NS, dev)
    N = heap.shape[0]
    B = off.shape[0]
    ar = lambda n: torch.arange(n, device=dev)[None, :]  # noqa: E731

    nbits = w3 & 0x1FFF
    nsec = (w3 >> 13) & 31
    sfidx0 = (w3 >> 18) & 511
    short = (w3 >> 30) & 1
    shortB = short[:, None] > 0

    def g(o):
        return heap[o.clamp(0, N - 1)]

    smap = off + short

    # ---- section table ----------------------------------------------------
    s24 = ar(SEC)
    so = smap[:, None] + 3 * s24
    u24 = g(so) | (g(so + 1) << 8) | (g(so + 2) << 16)
    valid_s = (s24 < nsec[:, None]).long()
    cb_s = (u24 & 15) * valid_s
    nsfb_s = ((u24 >> 4) & 63) * valid_s
    blen_s = ((u24 >> 10) & 0x3FFF) * valid_s
    coded_s = (cb_s >= 1) & (cb_s <= 11)
    sfb_end = torch.cumsum(nsfb_s, 1)
    bit_end = torch.cumsum(blen_s, 1)
    total_sfb = sfb_end[:, -1]
    nsf = (coded_s.long() * nsfb_s).sum(1)
    has_mask = (w3 >> 27) & 1
    mask_bytes = has_mask * ((total_sfb + 7) >> 3)

    # ---- short-window grouping --------------------------------------------
    gb = g(off) * short
    w8 = ar(8)
    same_w = torch.where(w8 >= 1, (gb[:, None] >> (7 - w8.clamp(1, 7))) & 1,
                         0)
    gid_w = torch.cumsum(1 - same_w, 1) - 1
    ranks = [torch.zeros(B, dtype=torch.long, device=dev)]
    for w in range(1, 8):
        ranks.append(torch.where(same_w[:, w] > 0, ranks[-1] + 1, 0))
    rank_w = torch.stack(ranks, 1)
    ngroups = torch.where(short > 0, gid_w[:, -1] + 1, 1)
    glen_g = (gid_w[:, :, None] == ar(8)[:, None, :]).long().sum(1)
    msfb = torch.where(short > 0, torch.div(
        total_sfb, ngroups.clamp(min=1), rounding_mode="floor"), total_sfb)

    # ---- per-band (read order: group-major for shorts) --------------------
    f52 = ar(NS)
    sec_of_f = (f52[:, :, None] >= sfb_end[:, None, :]).long().sum(-1)
    cb_f = _gather(cb_s, sec_of_f.clamp(0, SEC - 1))
    in_f = f52 < total_sfb[:, None]
    coded_f = (cb_f >= 1) & (cb_f <= 11) & in_f
    cfl = coded_f.long()
    rank_f = torch.cumsum(cfl, 1) - cfl
    msfb1 = msfb.clamp(min=1)[:, None]
    sfb_of_f = torch.where(shortB, torch.remainder(f52, msfb1), f52)
    grp_of_f = torch.where(shortB, torch.div(f52, msfb1,
                                             rounding_mode="floor"), 0)
    bw_f = torch.where(shortB, C["bwS"][sfb_of_f.clamp(0, 15)],
                       C["bwL"][f52.clamp(0, NS - 1)])
    glen_f = _gather(glen_g, grp_of_f.clamp(0, 7))
    sizes_f = cfl * torch.where(shortB, glen_f, 1) * bw_f
    cumsz_f = torch.cumsum(sizes_f, 1)
    starts_f = cumsz_f - sizes_f
    phase_base = smap + 3 * nsec + mask_bytes
    phase = g(phase_base) & 7
    bits_base = phase_base + 1

    def bits_at0(q, m):
        """m (<= 17) bits at sf-relative bit position q."""
        sh = (-1,) + (1,) * (q.dim() - 1)
        qq = q + phase.reshape(sh)
        ab = bits_base.reshape(sh) + (qq >> 3)
        w = (g(ab) << 16) | (g(ab + 1) << 8) | g(ab + 2)
        return (w >> (24 - (qq & 7) - m)) & ((1 << m) - 1)

    # ---- scalefactor huffman decode ---------------------------------------
    qsf = ar(SFB)
    w19 = bits_at0(qsf, 14) * 32 + bits_at0(qsf + 14, 5)
    ent_s = C["sflut"][w19]
    len_s = ent_s & 31
    Js = torch.clamp(qsf + torch.where(len_s < 31, len_s, SFB), max=SFB)
    Tks = torch.cat([Js, torch.full((B, 1), SFB, dtype=Js.dtype,
                                    device=dev)], 1)
    offs_s = torch.zeros((B, 1), dtype=torch.long, device=dev)
    for k in range(7):
        step = _gather(Tks, offs_s.clamp(0, SFB))
        offs_s = torch.cat([offs_s, step], 1)
        if k < 6:
            Tks = _gather(Tks, Tks.clamp(0, SFB))
    sfe = _gather(offs_s, nsf[:, None].clamp(0, 127))
    dsel = _gather(offs_s, rank_f.clamp(0, 127))
    dval = (_gather(ent_s, dsel.clamp(0, SFB - 1)) >> 5) - 60
    delta_f = torch.where(coded_f & (rank_f >= 1), dval, 0)
    sfidx_f = sfidx0[:, None] + torch.cumsum(delta_f, 1)
    sf_f = -C["pow2"][sfidx_f.clamp(0, 427) & 511]

    # ---- per-bit-offset classification ------------------------------------
    i = ar(NBITS)
    live = i < nbits[:, None]

    def bits_at(q, m):
        return bits_at0(q + 3 + sfe.reshape((-1,) + (1,) * (q.dim() - 1)),
                        m)

    def ones_at(q):
        w9 = bits_at(q, 9)
        n = torch.zeros_like(w9)
        for k in range(1, 10):
            n = n + ((w9 >> (9 - k)) == (1 << k) - 1).long()
        return n

    idx16 = bits_at(i, 16)
    sec_of_i = (i[:, :, None] >= bit_end[:, None, :]).long().sum(-1)
    cb_i = _gather(cb_s, sec_of_i.clamp(0, SEC - 1))
    del sec_of_i
    cb_ok = (cb_i >= 1) & (cb_i <= 11)
    ent = C["lut"][((cb_i.clamp(1, 11) - 1) << 16) + idx16]
    clen = ent & 31
    nnz = (ent >> 5) & 7
    esc = ((ent >> 24) & 1) > 0
    uns = C["cb_uns"][cb_i.clamp(0, 11)]
    adv = clen + nnz * uns
    v0e = ((ent >> 8) & 255) - 64
    v1e = ((ent >> 16) & 255) - 64
    e0 = (esc & (v0e.abs() == 16)).long()
    e1 = (esc & (v1e.abs() == 16)).long()
    q_esc = i + clen + nnz
    n0 = torch.where(e0 > 0, ones_at(q_esc), 0)
    l0 = (2 * n0 + 5) * e0
    n1 = torch.where(e1 > 0, ones_at(q_esc + l0), 0)
    adv = adv + l0 + (2 * n1 + 5) * e1
    adv = torch.where(live & cb_ok & (clen < 31), adv, NBITS)

    # ---- chain: binary lifting (progressive doubling) ---------------------
    sent = NBITS
    J = torch.clamp(i + adv, max=sent)
    Tk = torch.cat([J, torch.full((B, 1), sent, dtype=J.dtype, device=dev)],
                   1)
    nlev = NC_MAX.bit_length() - 1
    offs = torch.zeros((B, 1), dtype=torch.long, device=dev)
    for k in range(nlev):
        step = _gather(Tk, offs.clamp(0, sent))
        offs = torch.cat([offs, step], 1)
        if k < nlev - 1:
            Tk = _gather(Tk, Tk.clamp(0, sent))
    del Tk, J
    code_ok = offs < nbits[:, None]
    cok = code_ok.long()

    # ---- per-code payload -------------------------------------------------
    oc = offs.clamp(0, NBITS - 1)
    ent_j = _gather(ent, oc) * cok
    cb_j = _gather(cb_i, oc) * cok
    dim_j = C["cb_dim"][cb_j.clamp(0, 11)] * cok
    cum_j = torch.cumsum(dim_j, 1)
    start_j = cum_j - dim_j

    # ---- output bins ------------------------------------------------------
    col_w = C["col_w"]
    sfb_q = torch.where(shortB, C["col_sfb_s"][None, :],
                        C["col_sfb_l"][None, :])
    f_q = torch.where(shortB, gid_w[:, col_w] * msfb1 + sfb_q, sfb_q)
    fqc = f_q.clamp(0, NS - 1)
    inband = torch.where(
        shortB, C["col_inoff_s"][None, :]
        + rank_w[:, col_w] * C["col_bw_s"][None, :],
        C["col_inoff_l"][None, :])
    beyond_q = torch.where(shortB, C["col_beyond_s"][None, :],
                           C["col_beyond_l"][None, :])
    cb_p = _gather(cb_f, fqc)
    coded_p = ((cb_p >= 1) & (cb_p <= 11) & (beyond_q == 0)
               & (sfb_q < msfb[:, None]) & (f_q < total_sfb[:, None]))
    ci = _gather(starts_f, fqc) + inband
    lo = torch.zeros((B, 1024), dtype=torch.long, device=dev)
    hi = torch.full((B, 1024), NC_MAX, dtype=torch.long, device=dev)
    for _ in range(NC_MAX.bit_length()):
        mid = (lo + hi) >> 1
        cm = _gather(cum_j, mid.clamp(0, NC_MAX - 1))
        go = cm <= ci
        lo = torch.where(go, mid + 1, lo)
        hi = torch.where(go, hi, mid)
    jj = lo.clamp(0, NC_MAX - 1)
    ent_p = _gather(ent_j, jj)
    cb_pp = _gather(cb_j, jj)
    off_p = _gather(offs, jj)
    clen_p = ent_p & 31
    nnz_p = (ent_p >> 5) & 7
    d = ci - _gather(start_j, jj)
    is4 = cb_pp <= 4

    def vget(k):
        return torch.where(
            is4, ((ent_p >> (8 + 4 * k.clamp(0, 3))) & 15) - 4,
            ((ent_p >> (8 + 8 * k.clamp(0, 1))) & 255) - 64)

    v = vget(d)
    nz_before = torch.zeros_like(d)
    for k in range(3):
        nz_before = nz_before + ((k < d) & (vget(torch.full_like(d, k)) != 0)
                                 ).long()
    uns_p = C["cb_uns"][cb_pp.clamp(0, 11)]
    has_sign = (uns_p > 0) & (v != 0)
    sgn_bit = torch.where(has_sign, bits_at(off_p + clen_p + nz_before, 1), 0)
    esc_p = ((ent_p >> 24) & 1) > 0
    v0p = ((ent_p >> 8) & 255) - 64
    e0p = esc_p & (v0p.abs() == 16)
    my_esc = esc_p & (v.abs() == 16)
    qe_base = off_p + clen_p + nnz_p
    n0p = torch.where(e0p, ones_at(qe_base), 0)
    l0p = (2 * n0p + 5) * e0p.long()
    qe = torch.where((d > 0) & e0p, qe_base + l0p, qe_base)
    ne_ = torch.where(my_esc, ones_at(qe), 0)
    mant = bits_at(qe + ne_ + 1, 13) >> (13 - (ne_ + 4)).clamp(0, 13)
    av = torch.where(my_esc, torch.bitwise_left_shift(
        torch.ones_like(ne_), ne_ + 4) + mant, v.abs())
    mag = C["cbrt"][av.clamp(0, 8191)]
    sf_p = _gather(sf_f, fqc)
    sign = torch.where((v < 0) | (sgn_bit > 0), -1.0, 1.0)
    out = sign * mag * sf_p
    zero = ((v == 0) | ~coded_p | (ci >= cum_j[:, -1:])
            | ~_gather(code_ok, jj))
    out = torch.where(zero, 0.0, out)
    if not with_ms:
        return out
    # bit f of the mask region (right after the section map) -> every bin
    # of band f, through the same band index as the de-interleave; bins
    # beyond the last band stay untouched
    mbyte = g((smap + 3 * nsec)[:, None] + (f52 >> 3))
    mask_f = ((mbyte >> (7 - (f52 & 7))) & 1) * has_mask[:, None] * in_f
    return out, _gather(mask_f, fqc) * (beyond_q == 0)
