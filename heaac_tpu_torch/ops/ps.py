"""Batched parametric stereo (20- and 34-band modes).

Counterpart: ``heaac_tpu/ops/ps_jax.py`` — hybrid_analysis,
decorrelate_and_mix (here its two halves ``decorrelate`` and
``stereo_mix``, which the single-stream PS of ``ops/ps_single.py``
also calls), hybrid_synthesis (aacps.c:283-992) and the band-mode flip
conversions map_val_20_to_34 / map_val_34_to_20 (aacps.c:829-860).  The
serial transient detector + allpass chain inside ``decorrelate`` is
kernel K1 (``ops/ps_decorrelate.py``) in both modes: 30 allpass bands
at is34=0, 50 at is34=1.  (The JAX package runs the 50-band case through
its lax.scan pair, ``ps_jax._decorrelate_scans``: the Pallas kernel's
50-row block did not fit the TPU's VMEM budget.)
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from .. import tables as TB
from .ps_decorrelate import decorrelate_seq


@functools.cache
def consts(is34: int, device: torch.device) -> dict:
    """ps_jax._consts on ``device`` (numbers stay python ints)."""
    out = {}
    for k, v in TB.ps_consts(is34).items():
        if hasattr(v, "dtype"):
            t = torch.from_numpy(v).to(device)
            out[k] = t.long() if t.dtype == torch.int32 else t
        else:
            out[k] = v
    return out


def _hybrid_cx(w, filt):
    """N-subband complex hybrid filter (aacps.c:338-357): w [B,32,13,2],
    filt [N,7,2] -> (re, im) each [B,N,32]."""
    in0 = w[:, :, 0:6]
    in1 = w[:, :, 7:13].flip(2)
    f_re, f_im = filt[:, :6, 0], filt[:, :6, 1]
    ctr = filt[:, 6, 0]
    s_re = (torch.einsum("nj,blj->bnl", f_re, in0[..., 0] + in1[..., 0])
            - torch.einsum("nj,blj->bnl", f_im, in0[..., 1] - in1[..., 1])
            + ctr[None, :, None] * w[:, None, :, 6, 0])
    s_im = (torch.einsum("nj,blj->bnl", f_re, in0[..., 1] + in1[..., 1])
            + torch.einsum("nj,blj->bnl", f_im, in0[..., 0] - in1[..., 0])
            + ctr[None, :, None] * w[:, None, :, 6, 1])
    return s_re, s_im


def hybrid_analysis(L, in_buf, is34: int = 0):
    """L [B,2,38,64], in_buf [B,5,6,2] -> (lbuf [B,91,32,2], new in_buf)
    (aacps.c:359-395)."""
    c = consts(is34, L.device)
    lin = torch.stack([L[:, 0, :, :5].transpose(1, 2),
                       L[:, 1, :, :5].transpose(1, 2)], -1)   # [B,5,38,2]
    full = torch.cat([in_buf, lin], 2)                        # [B,5,44,2]
    idx = (torch.arange(32, device=L.device)[:, None]
           + torch.arange(13, device=L.device)[None, :])
    w = full[:, :, idx]                                       # [B,5,32,13,2]

    if is34:
        # QMF bands 0..4 -> 12+8+4+4+4 complex sub-bands (aacps.c:368-379)
        parts = [_hybrid_cx(w[:, bi], c[f]) for bi, f in enumerate(
            ("f34_0", "f34_1", "f34_2", "f34_2", "f34_2"))]
        lbuf_re = torch.cat([p[0] for p in parts]
                            + [L[:, 0, :32, 5:64].transpose(1, 2)], 1)
        lbuf_im = torch.cat([p[1] for p in parts]
                            + [L[:, 1, :32, 5:64].transpose(1, 2)], 1)
        return torch.stack([lbuf_re, lbuf_im], -1), full[:, :, 32:38]

    s_re, s_im = _hybrid_cx(w[:, 0], c["f20"])
    b0_re = torch.stack([s_re[:, 6], s_re[:, 7], s_re[:, 0], s_re[:, 1],
                         s_re[:, 2] + s_re[:, 5], s_re[:, 3] + s_re[:, 4]], 1)
    b0_im = torch.stack([s_im[:, 6], s_im[:, 7], s_im[:, 0], s_im[:, 1],
                         s_im[:, 2] + s_im[:, 5], s_im[:, 3] + s_im[:, 4]], 1)

    g = [float(x) for x in TB.ps_consts(0)["g1"]]

    def h2(wb):
        re_in = g[6] * wb[:, :, 6, 0]
        im_in = g[6] * wb[:, :, 6, 1]
        re_op = im_op = None
        for j in (0, 2, 4):
            tr = g[j + 1] * (wb[:, :, j + 1, 0] + wb[:, :, 11 - j, 0])
            ti = g[j + 1] * (wb[:, :, j + 1, 1] + wb[:, :, 11 - j, 1])
            re_op = tr if re_op is None else re_op + tr
            im_op = ti if im_op is None else im_op + ti
        return re_in, im_in, re_op, im_op

    r1, i1, r1o, i1o = h2(w[:, 1])
    r2, i2, r2o, i2o = h2(w[:, 2])
    band12_re = torch.stack([r1 - r1o, r1 + r1o, r2 + r2o, r2 - r2o], 1)
    band12_im = torch.stack([i1 - i1o, i1 + i1o, i2 + i2o, i2 - i2o], 1)
    direct_re = L[:, 0, :32, 3:64].transpose(1, 2)            # [B,61,32]
    direct_im = L[:, 1, :32, 3:64].transpose(1, 2)
    pad = L.new_zeros((L.shape[0], 20, 32))
    lbuf_re = torch.cat([b0_re, band12_re, direct_re, pad], 1)
    lbuf_im = torch.cat([b0_im, band12_im, direct_im, pad], 1)
    return torch.stack([lbuf_re, lbuf_im], -1), full[:, :, 32:38]


def decorrelate(lbuf, state, top_mask, is34: int = 0):
    """Transient detection and allpass decorrelation (K1) of the
    reference's decorrelation (aacps.c:645-754): lbuf [B,91,32,2]; state
    dict delay [B,91,14,2], ap [B,50,3,5,2], trans [B,34,3]; top_mask
    [B,91] zeroes the delay lines above the SBR top (ff_ps_apply) ->
    (rbuf [B,91,32,2], new_state)."""
    c = consts(is34, lbuf.device)
    napb = c["napb"]
    tm = top_mask[:, :, None, None]
    delay_hist = state["delay"] * tm
    ap = state["ap"][:, :napb] * top_mask[:, :napb, None, None, None]

    power = torch.einsum("bkn,ki->bin", lbuf[..., 0] ** 2 + lbuf[..., 1] ** 2,
                         c["agg"])                            # [B,34,32]
    delay_full = torch.cat([delay_hist, lbuf], 2)             # [B,91,46,2]
    new_delay = delay_full[:, :, 32:]

    din = delay_full[:, :napb, 12:44]                         # [B,napb,32,2]
    pf = c["pf"]
    in_re = din[..., 0] * pf[None, :, 0:1] - din[..., 1] * pf[None, :, 1:2]
    in_im = din[..., 0] * pf[None, :, 1:2] + din[..., 1] * pf[None, :, 0:1]

    tgain, ap_out, ntrans, ap_new = decorrelate_seq(
        power.contiguous(), in_re.contiguous(), in_im.contiguous(),
        state["trans"].contiguous(), ap.contiguous(), c["ag"], c["qf"])
    tgain_k = tgain[:, :, c["k2i"]].transpose(1, 2)           # [B,91,32]

    sd = c["short_delay"]
    out_ap = ap_out * tgain_k[:, :napb, :, None]
    d14 = torch.cat([delay_hist[:, napb:sd], lbuf[:, napb:sd, 0:18]], 2)
    d1 = torch.cat([delay_hist[:, sd:, 13:14], lbuf[:, sd:, 0:31]], 2)
    out_rest = torch.cat([d14, d1], 1) * tgain_k[:, napb:, :, None]
    rbuf = torch.cat([out_ap, out_rest], 1)                   # [B,91,32,2]

    if napb < 50:  # the state keeps the 34-band row count
        ap_new = torch.cat([ap_new, state["ap"][:, napb:]], 1)
    return rbuf, dict(delay=new_delay, ap=ap_new, trans=ntrans)


def stereo_mix(lbuf, rbuf, plan, is34: int = 0):
    """The interpolated 2x2 mix of the reference's stereo processing
    (aacps.c:903-971): plan H [B,2,6,34,4] (per envelope border, real and
    imaginary), Ws/We [B,6,32] (each slot's weights of the borders before
    and after it), ipd_on [B] -> (lmix, rmix [B,91,32,2])."""
    c = consts(is34, lbuf.device)
    Ws, We = plan["Ws"], plan["We"]
    h_re = torch.einsum("ben,bedj->bndj", Ws + We, plan["H"][:, 0])
    h_im_pos = torch.einsum("ben,bedj->bndj", Ws + We, plan["H"][:, 1])
    h_im_neg = torch.einsum("ben,bedj->bndj", We - Ws, plan["H"][:, 1])
    k2i = c["k2i"]
    hk_re = h_re[:, :, k2i]                                   # [B,32,91,4]
    hk_imp = h_im_pos[:, :, k2i]
    hk_imn = h_im_neg[:, :, k2i]
    flip = c["flip"]
    hk_im = hk_imp * (1.0 - flip)[None, None, :, None] \
        + hk_imn * flip[None, None, :, None]
    h_re = hk_re.transpose(1, 2)                              # [B,91,32,4]
    h_im = hk_im.transpose(1, 2) * plan["ipd_on"][:, None, None, None]
    l_re, l_im = lbuf[..., 0], lbuf[..., 1]
    r_re, r_im = rbuf[..., 0], rbuf[..., 1]
    h11r, h12r, h21r, h22r = h_re.unbind(-1)
    h11i, h12i, h21i, h22i = h_im.unbind(-1)
    lm_re = h11r * l_re + h21r * r_re - h11i * l_im - h21i * r_im
    lm_im = h11r * l_im + h21r * r_im + h11i * l_re + h21i * r_re
    rm_re = h12r * l_re + h22r * r_re - h12i * l_im - h22i * r_im
    rm_im = h12r * l_im + h22r * r_im + h12i * l_re + h22i * r_re
    return torch.stack([lm_re, lm_im], -1), torch.stack([rm_re, rm_im], -1)


def decorrelate_and_mix(lbuf, state, plan, is34: int = 0):
    """Transient detection, allpass decorrelation (K1), stereo mix.

    lbuf [B,91,32,2]; state dict delay [B,91,14,2], ap [B,50,3,5,2],
    trans [B,34,3]; plan H [B,2,6,34,4], Ws/We [B,6,32], ipd_on [B],
    top_mask [B,91] -> (lmix, rmix [B,91,32,2], new_state)."""
    rbuf, new_state = decorrelate(lbuf, state, plan["top_mask"], is34)
    lmix, rmix = stereo_mix(lbuf, rbuf, plan, is34)
    return lmix, rmix, new_state


def hybrid_synthesis(buf, is34: int = 0):
    """[B,91,32,2] -> [B,2,38,64] (aacps.c:397-445)."""
    if is34:
        first = torch.stack([buf[:, 0:12].sum(1), buf[:, 12:20].sum(1),
                             buf[:, 20:24].sum(1), buf[:, 24:28].sum(1),
                             buf[:, 28:32].sum(1)], 1)        # [B,5,32,2]
        full = torch.cat([first, buf[:, 32:91]], 1)           # [B,64,32,2]
    else:
        first = torch.stack([buf[:, 0:6].sum(1), buf[:, 6:8].sum(1),
                             buf[:, 8:10].sum(1)], 1)         # [B,3,32,2]
        full = torch.cat([first, buf[:, 10:71]], 1)           # [B,64,32,2]
    X = full.transpose(1, 2)                                  # [B,32,64,2]
    X = torch.nn.functional.pad(X, (0, 0, 0, 0, 0, 6))        # [B,38,64,2]
    return torch.stack([X[..., 0], X[..., 1]], 1)


_HALF = float(np.float32(0.5))
_THIRD = float(np.float32(0.33333333))
_QUARTER = float(np.float32(0.25))


@functools.cache
def _idx_20_to_34(device: torch.device):
    return torch.tensor([max(s, 0) for s in TB._IDX_20_TO_34],
                        dtype=torch.long, device=device)


def map_val_20_to_34(v):
    """A carried per-band tensor at a 20 -> 34 PS band-mode flip
    (aacps.c map_val_20_to_34): bands along axis -2, v [..., 34, k]."""
    out = v.index_select(-2, _idx_20_to_34(v.device))
    out[..., 1, :] = (v[..., 0, :] + v[..., 1, :]) * _HALF
    out[..., 4, :] = (v[..., 2, :] + v[..., 3, :]) * _HALF
    return out


def map_val_34_to_20(v):
    """34 -> 20 flip conversion (aacps.c map_val_34_to_20); bands 20..33
    keep their values, as the reference's in-place arrays do.
    v [..., 34, k]."""
    p = lambda i: v[..., i, :]  # noqa: E731
    rows = [
        (2 * p(0) + p(1)) * _THIRD,
        (p(1) + 2 * p(2)) * _THIRD,
        (2 * p(3) + p(4)) * _THIRD,
        (p(4) + 2 * p(5)) * _THIRD,
        (p(6) + p(7)) * _HALF,
        (p(8) + p(9)) * _HALF,
        p(10), p(11),
        (p(12) + p(13)) * _HALF,
        (p(14) + p(15)) * _HALF,
        p(16), p(17), p(18), p(19),
        (p(20) + p(21)) * _HALF,
        (p(22) + p(23)) * _HALF,
        (p(24) + p(25)) * _HALF,
        (p(26) + p(27)) * _HALF,
        (p(28) + p(29) + p(30) + p(31)) * _QUARTER,
        (p(32) + p(33)) * _HALF,
    ]
    return torch.cat([torch.stack(rows, -2), v[..., 20:, :]], -2)
