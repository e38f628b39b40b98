"""Batched SBR HF reconstruction (HE-AAC v1 device half).

Counterpart: ``heaac_tpu/ops/sbr_jax.py`` — lf_gen, hf_inverse_filter,
hf_gen, env_estimate, gain_calc, hf_assemble, x_gen (aacsbr.c:1136-1771),
fed with the dense plan dict that ``codec/qwire.expand_frame`` emits.
Everything is masked arithmetic, gathers with plan indices and one-hot
einsums over [B, ...] lanes.
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from .. import tables as TB

EPS = float(np.finfo(np.float32).eps)
H_SMOOTH = np.array([0.33333333333333, 0.30150283239582, 0.21816949906249,
                     0.11516383427084, 0.03183050093751], np.float32)
_WREV = [float(w) for w in H_SMOOTH[::-1]]
_F1000001 = float(np.float32(1.000001))
_BOOST_MAX = float(np.float32(1.584893192))


@functools.cache
def _noise(device: torch.device):
    return torch.from_numpy(TB.noise_table()).to(device)


@functools.cache
def _alt48(device: torch.device):
    alt = np.ones(48, np.float32)
    alt[1::2] = -1.0
    return torch.from_numpy(alt).to(device)


def lf_gen(W_prev, W_cur, xlow_new, xlow_old):
    """[B,32,32,2] x2 -> X_low [B,32,40,2] (aacsbr.c:1337-1357)."""
    hist = W_prev[:, 24:32].transpose(1, 2)
    cur = W_cur.transpose(1, 2)
    return torch.cat([hist * xlow_old[:, :32, None, None],
                      cur * xlow_new[:, :32, None, None]], 2)


def hf_inverse_filter(X_low):
    """Covariance solve (aacsbr.c:1232-1313): X_low [B,32,40,2] ->
    alpha0, alpha1 [B,32,2]."""
    xr = X_low[..., 0]
    xi = X_low[..., 1]

    def corr(lag):
        a, b = xr[..., 0:38], xi[..., 0:38]
        c, d = xr[..., lag:38 + lag], xi[..., lag:38 + lag]
        return (a * c + b * d).sum(-1), (a * d - b * c).sum(-1)

    r01_re, r01_im = corr(1)
    r02_re, r02_im = corr(2)
    sq = xr * xr + xi * xi
    p21_0 = sq[..., 0:38].sum(-1)
    p10_0 = sq[..., 1:39].sum(-1)
    p00_re = r01_re - (xr[..., 0] * xr[..., 1] + xi[..., 0] * xi[..., 1]) \
        + (xr[..., 38] * xr[..., 39] + xi[..., 38] * xi[..., 39])
    p00_im = r01_im - (xr[..., 0] * xi[..., 1] - xi[..., 0] * xr[..., 1]) \
        + (xr[..., 38] * xi[..., 39] - xi[..., 38] * xr[..., 39])
    p11_re, p11_im = r01_re, r01_im
    p01_re, p01_im = r02_re, r02_im

    dk = p21_0 * p10_0 - (p11_re ** 2 + p11_im ** 2) / _F1000001
    t1_re = p00_re * p11_re - p00_im * p11_im - p01_re * p10_0
    t1_im = p00_re * p11_im + p00_im * p11_re - p01_im * p10_0
    safe_dk = torch.where(dk != 0, dk, 1.0)
    a1_re = torch.where(dk != 0, t1_re / safe_dk, 0.0)
    a1_im = torch.where(dk != 0, t1_im / safe_dk, 0.0)
    t0_re = p00_re + a1_re * p11_re + a1_im * p11_im
    t0_im = p00_im + a1_im * p11_re - a1_re * p11_im
    safe_p = torch.where(p10_0 != 0, p10_0, 1.0)
    a0_re = torch.where(p10_0 != 0, -t0_re / safe_p, 0.0)
    a0_im = torch.where(p10_0 != 0, -t0_im / safe_p, 0.0)
    bad = ((a1_re ** 2 + a1_im ** 2 >= 16.0)
           | (a0_re ** 2 + a0_im ** 2 >= 16.0))
    a0_re = torch.where(bad, 0.0, a0_re)
    a0_im = torch.where(bad, 0.0, a0_im)
    a1_re = torch.where(bad, 0.0, a1_re)
    a1_im = torch.where(bad, 0.0, a1_im)
    return torch.stack([a0_re, a0_im], -1), torch.stack([a1_re, a1_im], -1)


def hf_gen(X_low, alpha0, alpha1, src_of_m, bw_of_m, hf_mask, gen_slot_mask):
    """Patch copy + 2-tap filter, m-domain (aacsbr.c:1360-1409) ->
    X_high [B,48,40,2]."""
    B = X_low.shape[0]
    src = src_of_m.long().clamp(0, 31)
    xl = torch.gather(X_low, 1, src[:, :, None, None].expand(B, 48, 40, 2))
    a0 = torch.gather(alpha0, 1, src[:, :, None].expand(B, 48, 2))
    a1 = torch.gather(alpha1, 1, src[:, :, None].expand(B, 48, 2))
    bw = bw_of_m[:, :, None]
    bw2 = bw * bw
    c1_re, c1_im = a1[..., 0:1] * bw2, a1[..., 1:2] * bw2
    c0_re, c0_im = a0[..., 0:1] * bw, a0[..., 1:2] * bw
    xr, xi = xl[..., 0], xl[..., 1]
    xr2 = F.pad(xr[..., :-2], (2, 0))
    xi2 = F.pad(xi[..., :-2], (2, 0))
    xr1 = F.pad(xr[..., :-1], (1, 0))
    xi1 = F.pad(xi[..., :-1], (1, 0))
    hr = xr2 * c1_re - xi2 * c1_im + xr1 * c0_re - xi1 * c0_im + xr
    hi = xi2 * c1_re + xr2 * c1_im + xi1 * c0_re + xr1 * c0_im + xi
    mask = hf_mask[:, :, None] * gen_slot_mask[:, None, :]
    return torch.stack([hr * mask, hi * mask], -1)


def env_estimate(X_high, env_onehot, recip, grp_mean, freqres_sel):
    """Envelope energies (aacsbr.c:1499-1546) -> e_curr [B,5,48]."""
    energy = X_high[..., 0] ** 2 + X_high[..., 1] ** 2     # [B,48,40]
    eslots = F.pad(env_onehot, (2, 0))[..., :40]            # [B,5,40]
    acc = torch.einsum("bms,bes->bem", energy, eslots)
    e1 = acc * recip[:, :, None]
    g_lo = torch.einsum("bem,bmk->bek", e1, grp_mean[:, 0])
    g_hi = torch.einsum("bem,bmk->bek", e1, grp_mean[:, 1])
    sel = freqres_sel[:, :, None]
    return sel * g_hi + (1.0 - sel) * g_lo


def gain_calc(e_curr, plan):
    """Limiter + boost (aacsbr.c:1552-1605) -> gain, q_m, s_m [B,5,48]."""
    gain = torch.sqrt(plan["gain_num"] / ((1.0 + e_curr) * plan["den_q"]))
    q_m = plan["q_m0"]
    s_m = plan["s_m0"]
    lim = plan["lim_onehot"]                                # [B,L,48]
    sum_eo = torch.einsum("blm,bem->bel", lim, plan["e_orig"])
    sum_ec = torch.einsum("blm,bem->bel", lim, e_curr)
    gmax_band = plan["limgain"][:, None, None] * torch.sqrt(
        (EPS + sum_eo) / (EPS + sum_ec))
    gmax_band = torch.clamp(gmax_band, max=100000.0)
    gmax = torch.einsum("bel,blm->bem", gmax_band, lim)
    inlim = lim.sum(1)[:, None, :]
    q_m_max = q_m * gmax / torch.where(gain > 0, gain, 1.0)
    q_m = torch.where(inlim > 0, torch.minimum(q_m, q_m_max), q_m)
    gain = torch.where(inlim > 0, torch.minimum(gain, gmax), gain)
    sum_boost_den = torch.einsum(
        "blm,bem->bel", lim,
        e_curr * gain * gain + s_m * s_m + plan["noisegate"] * q_m * q_m)
    boost_band = torch.sqrt((EPS + sum_eo) / (EPS + sum_boost_den))
    boost_band = torch.clamp(boost_band, max=_BOOST_MAX)
    boost = torch.einsum("bel,blm->bem", boost_band, lim)
    boost = torch.where(inlim > 0, boost, 1.0)
    return gain * boost, q_m * boost, s_m * boost


def hf_assemble(X_high, gain, q_m, s_m, g_temp, q_temp, plan):
    """Gain smoothing + noise/sine injection (aacsbr.c:1608-1714) ->
    (Y_m [B,38,48,2], env_on [B,38,1], g_temp, q_temp)."""
    B = X_high.shape[0]
    rs = plan["row_src"].long()[:, :, None].expand(B, 42, 48)
    g_old = torch.gather(g_temp, 1, rs)
    q_old = torch.gather(q_temp, 1, rs)
    fill = plan["fill_map"]
    fill_g = torch.einsum("bre,bem->brm", fill, gain)
    fill_q = torch.einsum("bre,bem->brm", fill, q_m)
    wrote = fill.sum(-1, keepdim=True) > 0
    g_new = torch.where(wrote, fill_g, g_old)
    q_new = torch.where(wrote, fill_q, q_old)

    dr = plan["direct_row"].long()[:, :, None].expand(B, 38, 48)
    g_direct = torch.gather(g_new, 1, dr)
    q_direct = torch.gather(q_new, 1, dr)
    g_sm = None
    q_sm = None
    for j in range(5):
        tg, tq = _WREV[j] * g_new[:, j:j + 38], _WREV[j] * q_new[:, j:j + 38]
        g_sm = tg if g_sm is None else g_sm + tg
        q_sm = tq if q_sm is None else q_sm + tq
    son = plan["smooth_on"][:, :, None]
    g_filt = torch.where(son > 0, g_sm, g_direct)
    q_filt = torch.where(son > 0, q_sm, q_direct)

    eo = plan["env_onehot"]                                 # [B,5,38]
    s_slot = torch.einsum("bes,bem->bsm", eo, s_m)
    ngate = torch.einsum("bes,bem->bsm", eo, plan["noisegate"])
    env_on = eo.sum(1)[:, :, None]                          # [B,38,1]

    xh = X_high[:, :, 2:40].transpose(1, 2)                 # [B,38,48,2]
    y_re = xh[..., 0] * g_filt
    y_im = xh[..., 1] * g_filt

    noise = _noise(X_high.device)
    m_i = torch.arange(48, device=X_high.device)
    idx = (plan["noise_start"].long()[:, :, None] + m_i + 1) & 0x1FF
    y_re = y_re + ngate * q_filt * noise[:, 0][idx]
    y_im = y_im + ngate * q_filt * noise[:, 1][idx]

    y_re = y_re + s_slot * plan["sine_re"][:, :, None]
    y_im = y_im + s_slot * plan["sine_im0"][:, :, None] * _alt48(
        X_high.device)
    y_re = y_re * env_on
    y_im = y_im * env_on
    return torch.stack([y_re, y_im], -1), env_on, g_new, q_new


def x_gen(X_low, Y_m, Y_prev, env_slot_on, plan):
    """Stitch low band + HF into X [B,2,38,64] (aacsbr.c:1412-1446);
    returns (X, y_cur)."""
    dev = X_low.device
    y_scat = torch.einsum("bsmc,bmk->bskc", Y_m, plan["scatter_m"])
    y_cur = torch.where(env_slot_on[..., None] > 0, y_scat, Y_prev)
    xl = F.pad(X_low[:, :, 2:40].transpose(1, 2), (0, 0, 0, 32))  # [B,38,64,2]
    i = torch.arange(38, device=dev)
    is_old = (i[None, :] < plan["i_temp"][:, None])[:, :, None, None]
    y_prev_ext = F.pad(Y_prev[:, 32:38], (0, 0, 0, 0, 0, 32))
    y_eff = torch.where(is_old, y_prev_ext, y_cur)
    slot_lt32 = (i < 32)[None, :, None, None]
    use_y = torch.where(is_old, plan["use_y_old"][:, None, :, None],
                        plan["use_y_new"][:, None, :, None] * slot_lt32)
    xlm = torch.where(is_old, plan["xlow_old"][:, None, :, None],
                      plan["xlow_new"][:, None, :, None])
    X = xl * xlm + y_eff * use_y
    return torch.stack([X[..., 0], X[..., 1]], 1), y_cur
