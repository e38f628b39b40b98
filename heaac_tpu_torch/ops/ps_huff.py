"""Parametric-stereo parameter Huffman decode on device (wire v5).

Counterpart: ``heaac_tpu/ops/ps_huff.py`` — init_ps_carry and
decode_ps_region_jax: iid/icc/ipd/opd rows decoded from the raw ps_data
bits by classify + binary lifting (the row decoder is shared with
``ops/sbr_huff.py``), delta coding, validity limits, ipd/opd persistence
and the fake-envelope fixup.  Bit-identical to the JAX decoder.
"""
from __future__ import annotations

import functools

import torch

from .. import tables as TB
from .sbr_huff import decode_row, read_bits

(IID_DF1, IID_DT1, IID_DF0, IID_DT0, ICC_DF, ICC_DT, IPD_DF, IPD_DT,
 OPD_DF, OPD_DT) = range(10)
W_ROW = 704
W_PD = 96
RW = 288


@functools.cache
def _luts(device: torch.device):
    """(flat, bases, maxlens, symbol offsets, iid table by 2 * dt + iq)
    on ``device``, made once: a frame step uploads nothing, so it can be
    captured in a CUDA graph."""
    return tuple(torch.from_numpy(a.astype("int64")).to(device)
                 for a in TB.ps_huff_luts()) + (torch.tensor(
                     [IID_DF0, IID_DF1, IID_DT0, IID_DT1], dtype=torch.long,
                     device=device),)


def init_ps_carry(B: int, device) -> dict:
    z = lambda *s: torch.zeros((B,) + s, dtype=torch.long,  # noqa: E731
                               device=device)
    return dict(iid_last=z(34), icc_last=z(34), ipd_full=z(5, 17),
                opd_full=z(5, 17), pd_enable=z(), penv_prev=z(),
                ps_ok=torch.ones(B, dtype=torch.long, device=device))


def decode_ps_region(region, start_off, rbits, enable_iid, iq, nr_iid,
                     enable_icc, nr_icc, enable_ext, ne_pre, penv, nipd,
                     header, carry):
    """Batched PS-region decode (the value half of ff_ps_read_data).
    Control inputs are [B] int; region [B, RW] bytes.  Returns (iid
    [B,5,34], icc [B,5,34], ipd [B,5,17], opd [B,5,17], pd_on [B],
    ps_on_ok [B], new_carry)."""
    dev = region.device
    L = _luts(dev)
    off_j = L[3]
    B = region.shape[0]
    pos = start_off.long()
    ok = torch.ones(B, dtype=torch.bool, device=dev)
    j34 = torch.arange(34, device=dev)[None, :]
    j17 = torch.arange(17, device=dev)[None, :]

    def one_bit(pos, act):
        v = torch.where(act, read_bits(region, pos, 1, RW), 0)
        return v, torch.where(act, pos + 1, pos)

    # ---- iid rows -----------------------------------------------------------
    iid_rows = []
    lim = 7 + 8 * iq
    prev_row = carry["iid_last"]
    iid_tabsel = L[4]
    for e in range(4):
        act = (enable_iid > 0) & (e < ne_pre)
        dt, pos = one_bit(pos, act)
        tid = iid_tabsel[2 * dt + iq]
        syms, pos, rok = decode_row(region, pos, tid,
                                    torch.where(act, nr_iid, 0), act, W_ROW,
                                    34, L, RW)
        deltas = syms - off_j[tid][:, None]
        row = torch.where(dt[:, None] > 0, prev_row + deltas,
                          torch.cumsum(deltas, 1))
        jmask = j34 < nr_iid[:, None]
        row = torch.where(jmask & act[:, None], row, 0)
        ok = ok & rok & torch.where(
            act, ~(jmask & (row.abs() > lim[:, None])).any(1), True)
        prev_row = torch.where(act[:, None], row, prev_row)
        iid_rows.append(row)
    iid_rows.append(torch.zeros_like(prev_row))
    iid_rows = torch.stack(iid_rows, 1)

    # ---- icc rows -----------------------------------------------------------
    icc_rows = []
    prev_row_c = carry["icc_last"]
    for e in range(4):
        act = (enable_icc > 0) & (e < ne_pre)
        dt, pos = one_bit(pos, act)
        tid = torch.where(dt > 0, ICC_DT, ICC_DF)
        syms, pos, rok = decode_row(region, pos, tid,
                                    torch.where(act, nr_icc, 0), act, W_ROW,
                                    34, L, RW)
        deltas = syms - off_j[tid][:, None]
        row = torch.where(dt[:, None] > 0, prev_row_c + deltas,
                          torch.cumsum(deltas, 1))
        jmask = j34 < nr_icc[:, None]
        row = torch.where(jmask & act[:, None], row, 0)
        ok = ok & rok & torch.where(
            act, ~(jmask & ((row < 0) | (row > 7))).any(1), True)
        prev_row_c = torch.where(act[:, None], row, prev_row_c)
        icc_rows.append(row)
    icc_rows.append(torch.zeros_like(prev_row_c))
    icc_rows = torch.stack(icc_rows, 1)

    # ---- extension container (ipd/opd) --------------------------------------
    eact = enable_ext > 0
    cnt4 = torch.where(eact, read_bits(region, pos, 4, RW), 0)
    pos = torch.where(eact, pos + 4, pos)
    esc = eact & (cnt4 == 15)
    cnt8 = torch.where(esc, read_bits(region, pos, 8, RW), 0)
    pos = torch.where(esc, pos + 8, pos)
    cntbits = (cnt4 + cnt8) * 8
    ext_end = pos + cntbits
    found = torch.zeros(B, dtype=torch.bool, device=dev)
    remaining = cntbits
    for _ in range(4):
        can = eact & ~found & (remaining > 7)
        id2 = torch.where(can, read_bits(region, pos, 2, RW), 3)
        pos = torch.where(can, pos + 2, pos)
        remaining = torch.where(can, remaining - 2, remaining)
        found = found | (can & (id2 == 0))
    ipdopd_bit, pos = one_bit(pos, found)
    pd_enable = torch.where(found, ipdopd_bit, carry["pd_enable"])
    seed_idx = (carry["penv_prev"] - 1).clamp(0, 4)

    def seed_of(full):
        return torch.gather(full, 1, seed_idx[:, None, None].expand(
            B, 1, 17))[:, 0]

    prev_pd = [seed_of(carry["ipd_full"]), seed_of(carry["opd_full"])]
    new_pd = [[], []]
    parse_pd = found & (ipdopd_bit > 0)
    for e in range(4):
        for which in range(2):
            act = parse_pd & (e < ne_pre)
            dt, pos = one_bit(pos, act)
            tid = torch.where(dt > 0, IPD_DT if which == 0 else OPD_DT,
                              IPD_DF if which == 0 else OPD_DF)
            syms, pos, rok = decode_row(region, pos, tid,
                                        torch.where(act, nipd, 0), act,
                                        W_PD, 17, L, RW)
            deltas = syms - off_j[tid][:, None]
            row = torch.where(dt[:, None] > 0, prev_pd[which] + deltas,
                              torch.cumsum(deltas, 1)) & 7
            jmask = j17 < nipd[:, None]
            row = torch.where(jmask & act[:, None], row, 0)
            ok = ok & rok
            prev_pd[which] = torch.where(act[:, None], row, prev_pd[which])
            new_pd[which].append(row)
    new_pd = [torch.stack(r + [torch.zeros_like(r[0])], 1) for r in new_pd]
    pos = torch.where(found, pos + 1, pos)
    ok = ok & torch.where(found, pos <= ext_end, True)
    pos = torch.where(eact, torch.maximum(pos, ext_end), pos)
    ok = ok & (pos <= rbits)

    ipd_rows = torch.where(parse_pd[:, None, None], new_pd[0],
                           carry["ipd_full"])
    opd_rows = torch.where(parse_pd[:, None, None], new_pd[1],
                           carry["opd_full"])

    # ---- fake-envelope fixup (aacps.c:234-252) ------------------------------
    can_copy = penv > ne_pre
    e5 = torch.arange(5, device=dev)

    def fix(rows, seed, width, enabled):
        src_idx = (ne_pre - 1).clamp(0, 4)
        src = torch.gather(rows, 1, src_idx[:, None, None].expand(
            B, 1, width))[:, 0]
        src = torch.where((ne_pre > 0)[:, None], src, seed)
        src = torch.where(enabled[:, None], src, 0)
        onehot = e5[None, :, None] == ne_pre.clamp(0, 4)[:, None, None]
        return torch.where(onehot & can_copy[:, None, None],
                           src[:, None, :], rows)

    iid_rows = fix(iid_rows, carry["iid_last"], 34, enable_iid > 0)
    icc_rows = fix(icc_rows, carry["icc_last"], 34, enable_icc > 0)
    ipd_rows = fix(ipd_rows, seed_of(carry["ipd_full"]), 17, pd_enable > 0)
    opd_rows = fix(opd_rows, seed_of(carry["opd_full"]), 17, pd_enable > 0)

    env_mask = e5[None, :, None] < penv[:, None, None]
    iid_rows = torch.where(env_mask & (enable_iid > 0)[:, None, None],
                           iid_rows, 0)
    icc_rows = torch.where(env_mask & (enable_icc > 0)[:, None, None],
                           icc_rows, 0)
    pd_mask = env_mask & (pd_enable > 0)[:, None, None]
    ipd_rows = torch.where(pd_mask, ipd_rows, 0)
    opd_rows = torch.where(pd_mask, opd_rows, 0)

    # ---- carry update -------------------------------------------------------
    last = (penv - 1).clamp(0, 4)

    def last_row(rows, width):
        return torch.gather(rows, 1, last[:, None, None].expand(
            B, 1, width))[:, 0]

    ps_ok = torch.where(header > 0, 1, carry["ps_ok"])
    ps_ok = torch.where(ok, ps_ok, 0)
    pd_on = (pd_enable > 0).long()
    new_carry = dict(
        iid_last=last_row(iid_rows, 34),
        icc_last=last_row(icc_rows, 34),
        ipd_full=torch.where(pd_on[:, None, None] > 0, ipd_rows, 0),
        opd_full=torch.where(pd_on[:, None, None] > 0, opd_rows, 0),
        pd_enable=pd_enable.long(),
        penv_prev=penv.long(),
        ps_ok=ps_ok)
    return iid_rows, icc_rows, ipd_rows, opd_rows, pd_on, ps_ok, new_carry
