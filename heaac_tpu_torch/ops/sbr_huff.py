"""SBR envelope/noise Huffman decode on device (wire v5 raw rows).

Counterpart: ``heaac_tpu/ops/sbr_huff.py`` — init_rows_carry,
_env_block, _noise_block and decode_sbr_rows_jax (``pair`` adds the
coupled-CPE channel's blocks; without it the single-channel element
issues no op of theirs).  Each row
classifies every bit offset of its window against its codebook's flat
LUT, resolves code starts by binary lifting, then applies the time /
frequency delta coding.  Bit-identical to the JAX decoder.
"""
from __future__ import annotations

import functools

import torch

from .. import tables as TB

(T_ENV15, F_ENV15, T_BAL15, F_BAL15, T_ENV30, F_ENV30,
 T_BAL30, F_BAL30, T_NOISE30, T_NOISEBAL30) = range(10)
RW = 640           # region byte budget
W_ENV = 960        # env row window bits
W_NOI = 112        # noise row window bits
NLIFT = 6
E = 5
NQ = 5
NB = 48


@functools.cache
def _luts(device: torch.device):
    flat, bases, maxlens = TB.sbr_huff_luts()
    return tuple(torch.from_numpy(a.astype("int64")).to(device)
                 for a in (flat, bases, maxlens, TB.SBR_LAV))


def decode_row(region, pos, tid, count, active, W: int, nsyms: int, luts,
               rw: int):
    """One Huffman row per lane: ``count`` codes of table ``tid`` from bit
    ``pos`` of ``region`` [B, rw] -> (syms [B,nsyms], pos', row_ok).
    ``luts`` = (flat, bases, maxlens) on the region's device."""
    flat, bases, maxlens = luts[:3]
    dev = region.device
    B = region.shape[0]
    offs = pos[:, None] + torch.arange(W, device=dev)[None, :]
    byt = offs >> 3
    sh = offs & 7

    def gb(k):
        return torch.gather(region, 1, (byt + k).clamp(0, rw - 1))

    w32 = (gb(0) << 24) | (gb(1) << 16) | (gb(2) << 8) | gb(3)
    w20 = (w32 >> (12 - sh)) & 0xFFFFF
    ml = maxlens[tid][:, None]
    ent = flat[bases[tid][:, None] + (w20 >> (20 - ml))]
    ln = ent & 31
    sym = ent >> 5
    bad = ln == 31
    adv = torch.where(bad, W, ln)
    J = torch.clamp(torch.arange(W, device=dev)[None, :] + adv, max=W)
    Js = [J]
    for _ in range(NLIFT - 1):
        prev = Js[-1]
        nxt = torch.gather(prev, 1, prev.clamp(max=W - 1))
        Js.append(torch.where(prev >= W, W, nxt.clamp(max=W)))
    j_idx = torch.arange(nsyms + 1, device=dev)[None, :]
    P = torch.zeros((B, nsyms + 1), dtype=torch.long, device=dev)
    for k in range(NLIFT):
        jbit = (j_idx >> k) & 1
        Pk = torch.gather(Js[k], 1, P.clamp(max=W - 1))
        Pk = torch.where(P >= W, W, Pk)
        P = torch.where(jbit > 0, Pk, P)
    live = j_idx[:, :nsyms] < count[:, None]
    Ps = P[:, :nsyms].clamp(max=W - 1)
    syms = torch.where(live, torch.gather(sym, 1, Ps), 0)
    row_bad = (live & ((P[:, :nsyms] >= W)
                       | torch.gather(bad, 1, Ps))).any(1)
    # count <= nsyms on every legal row (the JAX gather fills past it)
    used = torch.gather(P, 1, count[:, None].clamp(0, nsyms))[:, 0]
    row_bad = row_bad | (used >= W)
    pos2 = torch.where(active, pos + used, pos)
    ok = torch.where(active, ~row_bad, True)
    return syms, pos2, ok


def read_bits(region, pos, n: int, rw: int):
    """n (<= 12) bits at per-lane bit offset pos (MSB-first)."""
    byt = pos >> 3
    sh = pos & 7

    def gb(k):
        return torch.gather(region, 1, (byt[:, None] + k).clamp(0, rw - 1)
                            )[:, 0]

    w24 = (gb(0) << 16) | (gb(1) << 8) | gb(2)
    return (w24 >> (24 - sh - n)) & ((1 << n) - 1)


def init_rows_carry(B: int, device) -> dict:
    z = lambda *s: torch.zeros((B,) + s, dtype=torch.long,  # noqa: E731
                               device=device)
    return dict(env_last=z(2, NB), noise_last=z(2, NQ), fr_last=z(2))


def _env_block(region, pos, ok, ne, frbits, n0, n1, odd, df_env, bal,
               ampres, active, prev_last, fr_first, L):
    """One channel's envelope rows (aacsbr.c:787-854) -> (rows [B,E,NB],
    pos', ok')."""
    dev = region.device
    delta = (1 + bal)[:, None]
    tid_t = torch.where(bal > 0, torch.where(ampres > 0, T_BAL30, T_BAL15),
                        torch.where(ampres > 0, T_ENV30, T_ENV15))
    tid_f = tid_t + 1
    nb5 = torch.where(ampres > 0, 5, 6)
    nb7 = torch.where(ampres > 0, 6, 7)
    lav_t = L[3][tid_t][:, None]
    lav_f = lav_t
    j48 = torch.arange(NB, device=dev)[None, :]
    rows = []
    prev = prev_last
    fr_prev = fr_first
    for e in range(E):
        act = active & (e < ne)
        fr = (frbits >> e) & 1
        nbands = torch.where(fr > 0, n1, n0)
        df = df_env[:, e]
        is_dt = act & (df > 0)
        is_df = act & (df == 0)
        st5 = read_bits(region, pos, 5, RW)
        st6 = read_bits(region, pos, 6, RW)
        st7 = read_bits(region, pos, 7, RW)
        nbits_first = torch.where(bal > 0, nb5, nb7)
        start = torch.where(nbits_first == 5, st5,
                            torch.where(nbits_first == 6, st6, st7))
        pos0 = pos + torch.where(is_df, nbits_first, 0)
        tid = torch.where(df > 0, tid_t, tid_f)
        count = torch.where(is_dt, nbands,
                            torch.where(is_df, (nbands - 1).clamp(min=0), 0))
        syms, pos2, ok_r = decode_row(region, pos0, tid, count,
                                      is_dt | is_df, W_ENV, NB, L, RW)
        kk = torch.where(
            (fr == fr_prev)[:, None], j48,
            torch.where(fr[:, None] > 0, (j48 + odd[:, None]) >> 1,
                        torch.where(j48 > 0, 2 * j48 - odd[:, None], 0)))
        pbase = torch.gather(prev, 1, kk.clamp(0, NB - 1))
        row_dt = pbase + delta * (syms - lav_t)
        deltas = torch.cat([(delta[:, 0] * start)[:, None],
                            delta * (syms[:, :NB - 1] - lav_f)], 1)
        live = j48 < nbands[:, None]
        row_df = torch.cumsum(torch.where(live, deltas, 0), 1)
        row = torch.where(is_dt[:, None], row_dt, row_df)
        row = torch.where(live & act[:, None], row, 0)
        pos = torch.where(act, pos2, pos)
        ok = ok & ok_r
        prev = torch.where(act[:, None], row, prev)
        fr_prev = torch.where(act, fr, fr_prev)
        rows.append(row)
    return torch.stack(rows, 1), pos, ok


def _noise_block(region, pos, ok, nnoise, nq, df_noise, bal, active,
                 prev_last, L):
    """One channel's noise-floor rows (aacsbr.c:856-890) -> (rows
    [B,2,NQ], pos', ok')."""
    dev = region.device
    delta = (1 + bal)[:, None]
    tid_t = torch.where(bal > 0, T_NOISEBAL30, T_NOISE30)
    tid_f = torch.where(bal > 0, F_BAL30, F_ENV30)
    lav_t = L[3][tid_t][:, None]
    lav_f = L[3][tid_f][:, None]
    j5 = torch.arange(NQ, device=dev)[None, :]
    rows = []
    prev = prev_last
    for i in range(2):
        act = active & (i < nnoise)
        df = df_noise[:, i]
        is_dt = act & (df > 0)
        is_df = act & (df == 0)
        start = read_bits(region, pos, 5, RW)
        pos0 = pos + torch.where(is_df, 5, 0)
        tid = torch.where(df > 0, tid_t, tid_f)
        count = torch.where(is_dt, nq,
                            torch.where(is_df, (nq - 1).clamp(min=0), 0))
        syms, pos2, ok_r = decode_row(region, pos0, tid, count,
                                      is_dt | is_df, W_NOI, NQ, L, RW)
        row_dt = prev + delta * (syms - lav_t)
        deltas = torch.cat([(delta[:, 0] * start)[:, None],
                            delta * (syms[:, :NQ - 1] - lav_f)], 1)
        live = j5 < nq[:, None]
        row_df = torch.cumsum(torch.where(live, deltas, 0), 1)
        row = torch.where(is_dt[:, None], row_dt, row_df)
        row = torch.where(live & act[:, None], row, 0)
        pos = torch.where(act, pos2, pos)
        ok = ok & ok_r
        prev = torch.where(act[:, None], row, prev)
        rows.append(row)
    return torch.stack(rows, 1), pos, ok


def decode_sbr_rows(region, phase, rbits, ne, nnoise, frbits, n0, n1, nq,
                    ampres, active, carry, coupled=None, pair: bool = False):
    """Decode of one element's dtdf+env+noise raw region
    (decode_sbr_rows_jax).  Control inputs are [B] int; ``region``
    [B, RW] bytes starting at the byte that holds the first dtdf bit (bit
    ``phase``); ``coupled`` [B] marks CPE-coupled lanes, whose second
    (balance) channel's rows follow the first's, and is read only with
    the static ``pair``.  Returns (ecodes [B,E,NB], pcodes, qcodes
    [B,2,NQ], qpcodes, ok [B], new_carry); without ``pair``,
    pcodes/qpcodes are the absent pan channel's zeros."""
    L = _luts(region.device)
    B = region.shape[0]
    pos = phase.long()
    ok = torch.ones(B, dtype=torch.bool, device=region.device)
    odd = n1 & 1

    def flag_bits(pos, count, cmax, act):
        out = []
        for i in range(cmax):
            a = act & (i < count)
            out.append(torch.where(a, read_bits(region, pos, 1, RW), 0))
            pos = torch.where(a, pos + 1, pos)
        return torch.stack(out, 1), pos

    # dtdf flags: ch0, then the coupled ch1 (read_sbr_cpe)
    df_env0, pos = flag_bits(pos, ne, E, active)
    df_noi0, pos = flag_bits(pos, nnoise, 2, active)
    if pair:
        cact = active & (coupled > 0)
        df_env1, pos = flag_bits(pos, ne, E, cact)
        df_noi1, pos = flag_bits(pos, nnoise, 2, cact)
    # invf: one channel's 2-bit modes (a coupled ch1 copies ch0's)
    pos = torch.where(active, pos + 2 * nq, pos)
    z = torch.zeros_like(ne)
    ecodes, pos, ok = _env_block(
        region, pos, ok, ne, frbits, n0, n1, odd, df_env0, z, ampres,
        active, carry["env_last"][:, 0], carry["fr_last"][:, 0], L)
    qcodes, pos, ok = _noise_block(
        region, pos, ok, nnoise, nq, df_noi0, z, active,
        carry["noise_last"][:, 0], L)
    if pair:
        pcodes, pos, ok = _env_block(
            region, pos, ok, ne, frbits, n0, n1, odd, df_env1, coupled,
            ampres, cact, carry["env_last"][:, 1], carry["fr_last"][:, 1], L)
        qpcodes, pos, ok = _noise_block(
            region, pos, ok, nnoise, nq, df_noi1, coupled, cact,
            carry["noise_last"][:, 1], L)
    else:
        pcodes = torch.zeros_like(ecodes)
        qpcodes = torch.zeros_like(qcodes)
    ok = ok & torch.where(active, pos <= rbits, True)

    laste = (ne - 1).clamp(0, E - 1)
    lastq = (nnoise - 1).clamp(0, 1)

    def last_row(rows, idx):
        return torch.gather(rows, 1, idx[:, None, None].expand(
            B, 1, rows.shape[2]))[:, 0]

    fr_new = (frbits >> laste) & 1
    cl = carry
    if pair:
        env1 = torch.where(cact[:, None], last_row(pcodes, laste),
                           cl["env_last"][:, 1])
        noise1 = torch.where(cact[:, None], last_row(qpcodes, lastq),
                             cl["noise_last"][:, 1])
        fr1 = torch.where(cact, fr_new, cl["fr_last"][:, 1])
    else:
        env1, noise1 = cl["env_last"][:, 1], cl["noise_last"][:, 1]
        fr1 = cl["fr_last"][:, 1]
    new_carry = dict(
        env_last=torch.stack(
            [torch.where(active[:, None], last_row(ecodes, laste),
                         cl["env_last"][:, 0]), env1], 1),
        noise_last=torch.stack(
            [torch.where(active[:, None], last_row(qcodes, lastq),
                         cl["noise_last"][:, 0]), noise1], 1),
        fr_last=torch.stack(
            [torch.where(active, fr_new, cl["fr_last"][:, 0]), fr1], 1))
    return ecodes, pcodes, qcodes, qpcodes, ok, new_carry
