"""PS mixing prologue on device (20- and 34-band).

Counterpart: ``heaac_tpu/codec/compact_plan.py`` — init_ps_hist and
expand_ps: HA/HB LUT H-matrices with IPD/OPD phase
smoothing, the carried H row 0 and phase histories, and the
envelope-border interpolation weights Ws/We (aacps.c:816-935).
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from .. import tables as TB

PI_ON, PI_IPD, PI_QUANT, PI_NENV, PI_ICCMODE, PI_NIPD, PI_TOP = range(7)
PI_BORD = 7
PC_I_N = 16
PB_IID, PB_ICC, PB_IPD, PB_OPD = 0, 170, 340, 425
PC_B_N = 510


@functools.cache
def _luts(device: torch.device):
    HA, HB = TB.mixing_luts()
    lut = np.concatenate([HA.reshape(-1, 4), HB.reshape(-1, 4)], 0)
    pd_re, pd_im = TB.pd_smooth()
    return tuple(torch.from_numpy(a).to(device) for a in (lut, pd_re, pd_im))


def init_ps_hist(B: int, device) -> dict:
    """Persistent H planes [B,2,6,34,4] + ipd/opd histories [B,17]."""
    return dict(
        H=torch.zeros((B, 2, 6, 34, 4), dtype=torch.float32, device=device),
        ipd_hist=torch.zeros((B, 17), dtype=torch.long, device=device),
        opd_hist=torch.zeros((B, 17), dtype=torch.long, device=device))


def expand_ps(pc: dict, hist: dict, is34: int = 0):
    """pc_i [B,PC_I_N], pc_b [B,PC_B_N] (int) + hist -> (ps plan dict for
    ops/ps, new hist)."""
    pc_i, pc_b = pc["pc_i"], pc["pc_b"]
    dev = pc_i.device
    B = pc_i.shape[0]
    f32 = torch.float32
    lut, pd_re_t, pd_im_t = _luts(dev)

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
