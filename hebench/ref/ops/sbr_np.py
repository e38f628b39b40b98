"""SBR DSP chain, numpy reference implementation.

Float32-faithful port of the reference DSP half (libavcodec/aacsbr.c:
1136-1771): QMF analysis/synthesis, low/high-frequency generation, envelope
estimation, gain calculation and HF assembly.  This is the correctness
oracle for the batched TPU graph in ops/sbr_jax.py and the execution path
for odd-shaped single-stream decode.
"""
from __future__ import annotations

import numpy as np

from ..bitstream import sbr_syntax as S
from ..bitstream.sbr_syntax import ENVELOPE_ADJUSTMENT_OFFSET, SBRContext
from ..tables.aac_tables import TYPE_CPE
from .imdct import imdct_half_ref

_f32 = np.float32


def qmf_analysis(in_samples: np.ndarray, x_state: np.ndarray,
                 W: np.ndarray, scale: float, transform=imdct_half_ref) -> None:
    """aacsbr.c:1136-1169.  in: [1024]; x_state: [1312]; W: [2,32,32,2].
    ``transform`` computes ``imdct_half`` (the control passes its TF32
    form)."""
    win = S.qmf_window_ds()
    W[0] = W[1]
    x_state[:288] = x_state[1024:1312]
    x_state[288:1312] = (in_samples * _f32(scale)).astype(np.float32)
    # z[k] = win[k] * x[319-k]; then fold five 64-blocks
    idx = np.arange(32)[:, None] * 32 + np.arange(320)[None, ::-1]
    zs = win[None, :] * x_state[idx]                       # [32, 320]
    z = zs.reshape(32, 5, 64).sum(axis=1, dtype=np.float32)  # [32, 64]
    # shuffle to IMDCT input (aacsbr.c:1154-1160)
    q = np.zeros((32, 64), np.float32)
    q[:, 0] = z[:, 0]
    k = np.arange(1, 32)
    q[:, 2 * k - 1] = z[:, k]
    q[:, 2 * k] = -z[:, 64 - k]
    q[:, 63] = z[:, 32]
    out = transform(q, -2.0).astype(np.float32)  # [32, 64]
    kk = np.arange(32)
    W[1][:, kk, 0] = -out[:, 63 - kk]
    W[1][:, kk, 1] = out[:, kk]


def qmf_synthesis(X: np.ndarray, v0: np.ndarray, v_off: int,
                  downsampled: bool,
                  transform=imdct_half_ref) -> tuple[np.ndarray, int]:
    """aacsbr.c:1175-1230.  X: [2,38,64] (re/im planes); v0: [2304] FIFO.

    Returns (out [2048 or 1024], new v_off)."""
    div = 1 if downsampled else 0
    win = S.qmf_window_ds() if div else S.qmf_window_us()
    step = 64 >> div
    out = np.zeros(32 * step, np.float32)
    X = X.copy()
    for i in range(32):
        if v_off == 0:
            saved = (1280 - 128) >> div
            v0[2304 - saved:] = v0[:saved]
            v_off = 2304 - saved - (128 >> div)
        else:
            v_off -= 128 >> div
        v = v0[v_off:]
        if div:
            n = np.arange(32)
            q = np.empty(64, np.float32)
            q[:32] = -X[0][i][:32]
            q[32:] = X[1][i][31::-1]
            buf = transform(q, 1.0 / 64).astype(np.float32)
            v[n] = buf[63 - 2 * n]
            v[63 - n] = -buf[62 - 2 * n]
        else:
            X[1][i][1::2] = -X[1][i][1::2]
            b0 = transform(X[0][i], 1.0 / 64).astype(np.float32)
            b1 = transform(X[1][i], 1.0 / 64).astype(np.float32)
            n = np.arange(64)
            v[n] = -b0[63 - n] + b1[n]
            v[127 - n] = b0[63 - n] + b1[n]
        acc = np.zeros(step, np.float32)
        for j, voff in enumerate((0, 192, 256, 448, 512, 704, 768, 960,
                                  1024, 1216)):
            acc = (v[(voff >> div): (voff >> div) + step]
                   * win[j * step: (j + 1) * step] + acc).astype(np.float32)
        out[i * step: (i + 1) * step] = acc
    return out, v_off


def lf_gen(sbr: SBRContext, W: np.ndarray) -> np.ndarray:
    """aacsbr.c:1337-1357.  Returns X_low [32,40,2]."""
    X_low = np.zeros((32, 40, 2), np.float32)
    kx1 = sbr.kx[1]
    X_low[:kx1, 8:40] = W[1].transpose(1, 0, 2)[:kx1]
    kx0 = sbr.kx[0]
    X_low[:kx0, 0:8] = W[0][24:32].transpose(1, 0, 2)[:kx0]
    return X_low


def hf_inverse_filter(X_low: np.ndarray, k0: int):
    """aacsbr.c:1232-1313.  Returns (alpha0, alpha1) each [k0,2]."""
    alpha0 = np.zeros((64, 2), np.float32)
    alpha1 = np.zeros((64, 2), np.float32)
    x = X_low[:k0].astype(np.float32)
    xc = x[..., 0].astype(np.float32) + 1j * x[..., 1].astype(np.float32)
    xc = xc.astype(np.complex64)
    for k in range(k0):
        z = xc[k]
        # autocorrelations over slots 1..37 plus edge terms (aacsbr.c:1232);
        # serial float32 accumulation to match the C rounding exactly — the
        # 2x2 solve below is numerically unstable, so summation order matters
        def corr(lag):
            terms = (np.conj(z[1:38]) * z[1 + lag:38 + lag]).astype(np.complex64)
            sr = np.float32(0)
            si = np.float32(0)
            for t in terms:
                sr = np.float32(sr + t.real)
                si = np.float32(si + t.imag)
            return np.complex64(complex(sr, si))
        r01 = corr(1)
        r02 = corr(2)
        sq = (z[1:38].real ** 2 + z[1:38].imag ** 2).astype(np.float32)
        r00r = np.float32(0)
        for t in sq:
            r00r = np.float32(r00r + t)
        phi_2_1 = (r01 + (np.conj(z[0]) * z[1]).astype(np.complex64)).astype(np.complex64)
        phi_0_0 = (r01 + (np.conj(z[38]) * z[39]).astype(np.complex64)).astype(np.complex64)
        phi_0_1 = (r02 + (np.conj(z[0]) * z[2]).astype(np.complex64)).astype(np.complex64)
        phi_2_1_0 = np.float32(r00r + np.float32(z[0].real * z[0].real + z[0].imag * z[0].imag))
        phi_1_0_0 = np.float32(r00r + np.float32(z[38].real * z[38].real + z[38].imag * z[38].imag))
        dk = np.float32(phi_2_1_0 * phi_1_0_0 -
                        (phi_2_1.real ** 2 + phi_2_1.imag ** 2) / np.float32(1.000001))
        if dk == 0:
            a1 = np.complex64(0)
        else:
            tr = (phi_0_0.real * phi_2_1.real - phi_0_0.imag * phi_2_1.imag
                  - phi_0_1.real * phi_1_0_0)
            ti = (phi_0_0.real * phi_2_1.imag + phi_0_0.imag * phi_2_1.real
                  - phi_0_1.imag * phi_1_0_0)
            a1 = np.complex64(complex(tr / dk, ti / dk))
        if phi_1_0_0 == 0:
            a0 = np.complex64(0)
        else:
            tr = phi_0_0.real + a1.real * phi_2_1.real + a1.imag * phi_2_1.imag
            ti = phi_0_0.imag + a1.imag * phi_2_1.real - a1.real * phi_2_1.imag
            a0 = np.complex64(complex(-tr / phi_1_0_0, -ti / phi_1_0_0))
        if (a1.real ** 2 + a1.imag ** 2 >= 16.0
                or a0.real ** 2 + a0.imag ** 2 >= 16.0):
            a0 = np.complex64(0)
            a1 = np.complex64(0)
        alpha0[k] = (a0.real, a0.imag)
        alpha1[k] = (a1.real, a1.imag)
    return alpha0, alpha1


BW_TAB = np.array([0.0, 0.75, 0.9, 0.98], np.float32)


def chirp(sbr: SBRContext, ch_data) -> None:
    """aacsbr.c:1316-1334."""
    for i in range(sbr.n_q):
        if ch_data.bs_invf_mode[0][i] + ch_data.bs_invf_mode[1][i] == 1:
            new_bw = _f32(0.6)
        else:
            new_bw = BW_TAB[ch_data.bs_invf_mode[0][i]]
        if new_bw < ch_data.bw_array[i]:
            new_bw = _f32(_f32(0.75) * new_bw + _f32(0.25) * ch_data.bw_array[i])
        else:
            new_bw = _f32(_f32(0.90625) * new_bw + _f32(0.09375) * ch_data.bw_array[i])
        ch_data.bw_array[i] = _f32(0.0) if new_bw < 0.015625 else new_bw


def hf_gen(sbr: SBRContext, X_low: np.ndarray, alpha0, alpha1, bw_array,
           t_env, bs_num_env) -> np.ndarray:
    """aacsbr.c:1360-1409.  Returns X_high [64,40,2]."""
    X_high = np.zeros((64, 40, 2), np.float32)
    g = 0
    k = sbr.kx[1]
    ilo = 2 * int(t_env[0]) + ENVELOPE_ADJUSTMENT_OFFSET
    ihi = 2 * int(t_env[bs_num_env]) + ENVELOPE_ADJUSTMENT_OFFSET
    for j in range(sbr.num_patches):
        for x in range(sbr.patch_num_subbands[j]):
            p = int(sbr.patch_start_subband[j]) + x
            while g <= sbr.n_q and k >= sbr.f_tablenoise[g]:
                g += 1
            g -= 1
            if g < 0:
                raise ValueError("no noise subband found")
            bw = bw_array[g]
            a = [np.float32(alpha1[p][0] * bw * bw),
                 np.float32(alpha1[p][1] * bw * bw),
                 np.float32(alpha0[p][0] * bw),
                 np.float32(alpha0[p][1] * bw)]
            i = np.arange(ilo, ihi)
            xl0 = X_low[p, i - 2]
            xl1 = X_low[p, i - 1]
            xl2 = X_low[p, i]
            X_high[k, i, 0] = (xl0[:, 0] * a[0] - xl0[:, 1] * a[1]
                               + xl1[:, 0] * a[2] - xl1[:, 1] * a[3]
                               + xl2[:, 0]).astype(np.float32)
            X_high[k, i, 1] = (xl0[:, 1] * a[0] + xl0[:, 0] * a[1]
                               + xl1[:, 1] * a[2] + xl1[:, 0] * a[3]
                               + xl2[:, 1]).astype(np.float32)
            k += 1
    return X_high


def x_gen(sbr: SBRContext, X_low, Y, ch) -> np.ndarray:
    """aacsbr.c:1412-1446.  Returns X [2,38,64]."""
    X = np.zeros((2, 38, 64), np.float32)
    i_f = 32
    i_temp = max(2 * sbr.data[ch].t_env_num_env_old - i_f, 0)
    kx0, m0 = sbr.kx[0], sbr.m[0]
    kx1, m1 = sbr.kx[1], sbr.m[1]
    for k in range(kx0):
        X[0, :i_temp, k] = X_low[k, ENVELOPE_ADJUSTMENT_OFFSET:
                                 ENVELOPE_ADJUSTMENT_OFFSET + i_temp, 0]
        X[1, :i_temp, k] = X_low[k, ENVELOPE_ADJUSTMENT_OFFSET:
                                 ENVELOPE_ADJUSTMENT_OFFSET + i_temp, 1]
    for k in range(kx0, kx0 + m0):
        X[0, :i_temp, k] = Y[0, i_f: i_f + i_temp, k, 0]
        X[1, :i_temp, k] = Y[0, i_f: i_f + i_temp, k, 1]
    for k in range(kx1):
        X[0, i_temp:38, k] = X_low[k, i_temp + ENVELOPE_ADJUSTMENT_OFFSET: 40, 0]
        X[1, i_temp:38, k] = X_low[k, i_temp + ENVELOPE_ADJUSTMENT_OFFSET: 40, 1]
    for k in range(kx1, kx1 + m1):
        X[0, i_temp:i_f, k] = Y[1, i_temp:i_f, k, 0]
        X[1, i_temp:i_f, k] = Y[1, i_temp:i_f, k, 1]
    return X


def mapping(sbr: SBRContext, ch_data, e_a) -> tuple:
    """aacsbr.c:1451-1496.  Returns (e_origmapped, q_mapped, s_mapped) and
    updates ch_data.s_indexmapped."""
    kx1 = sbr.kx[1]
    e_orig = np.zeros((7, 48), np.float32)
    q_mapped = np.zeros((7, 48), np.float32)
    s_mapped = np.zeros((7, 48), np.int32)
    ch_data.s_indexmapped[1:8] = 0
    for e in range(ch_data.bs_num_env):
        ilim = sbr.n[ch_data.bs_freq_res[e + 1]]
        table = sbr.f_tablehigh if ch_data.bs_freq_res[e + 1] else sbr.f_tablelow
        for i in range(ilim):
            e_orig[e, table[i] - kx1: table[i + 1] - kx1] = \
                ch_data.env_facs[e + 1][i]
        k = int((ch_data.bs_num_noise > 1)
                and (ch_data.t_env[e] >= ch_data.t_q[1]))
        for i in range(sbr.n_q):
            q_mapped[e, sbr.f_tablenoise[i] - kx1: sbr.f_tablenoise[i + 1] - kx1] = \
                ch_data.noise_facs[k + 1][i]
        for i in range(sbr.n[1]):
            if ch_data.bs_add_harmonic_flag:
                m_mid = (sbr.f_tablehigh[i] + sbr.f_tablehigh[i + 1]) >> 1
                ch_data.s_indexmapped[e + 1][m_mid - kx1] = (
                    ch_data.bs_add_harmonic[i]
                    * int(e >= e_a[1]
                          or ch_data.s_indexmapped[0][m_mid - kx1] == 1))
        for i in range(ilim):
            present = int(
                ch_data.s_indexmapped[e + 1][table[i] - kx1: table[i + 1] - kx1].any())
            s_mapped[e, table[i] - kx1: table[i + 1] - kx1] = present
    ch_data.s_indexmapped[0] = ch_data.s_indexmapped[ch_data.bs_num_env]
    return e_orig, q_mapped, s_mapped


def env_estimate(X_high: np.ndarray, sbr: SBRContext, ch_data) -> np.ndarray:
    """aacsbr.c:1499-1546.  Returns e_curr [7,48]."""
    e_curr = np.zeros((7, 48), np.float32)
    kx1 = sbr.kx[1]
    if sbr.bs_interpol_freq:
        for e in range(ch_data.bs_num_env):
            recip = _f32(0.5 / (ch_data.t_env[e + 1] - ch_data.t_env[e]))
            ilb = int(ch_data.t_env[e]) * 2 + ENVELOPE_ADJUSTMENT_OFFSET
            iub = int(ch_data.t_env[e + 1]) * 2 + ENVELOPE_ADJUSTMENT_OFFSET
            xh = X_high[kx1: kx1 + sbr.m[1], ilb:iub]
            e_curr[e, : sbr.m[1]] = (
                (xh[..., 0] ** 2 + xh[..., 1] ** 2).sum(axis=1,
                                                        dtype=np.float32)
                * recip)
    else:
        for e in range(ch_data.bs_num_env):
            env_size = 2 * (int(ch_data.t_env[e + 1]) - int(ch_data.t_env[e]))
            ilb = int(ch_data.t_env[e]) * 2 + ENVELOPE_ADJUSTMENT_OFFSET
            iub = int(ch_data.t_env[e + 1]) * 2 + ENVELOPE_ADJUSTMENT_OFFSET
            table = (sbr.f_tablehigh if ch_data.bs_freq_res[e + 1]
                     else sbr.f_tablelow)
            for p in range(sbr.n[ch_data.bs_freq_res[e + 1]]):
                den = env_size * (table[p + 1] - table[p])
                xh = X_high[table[p]: table[p + 1], ilb:iub]
                s = np.float32((xh[..., 0] ** 2 + xh[..., 1] ** 2)
                               .sum(dtype=np.float32) / den)
                e_curr[e, table[p] - kx1: table[p + 1] - kx1] = s
    return e_curr


LIMGAIN = np.array([0.70795, 1.0, 1.41254, 1e10], np.float32)
EPS = np.float32(np.finfo(np.float32).eps)


def gain_calc(sbr: SBRContext, ch_data, e_a, e_orig, q_mapped, s_mapped,
              e_curr):
    """aacsbr.c:1552-1605.  Returns (gain, q_m, s_m) each [7,48]."""
    gain = np.zeros((7, 48), np.float32)
    q_m = np.zeros((7, 48), np.float32)
    s_m = np.zeros((7, 48), np.float32)
    kx1 = sbr.kx[1]
    limgain = LIMGAIN[sbr.bs_limiter_gains]
    for e in range(ch_data.bs_num_env):
        delta = 0 if (e == e_a[1] or e == e_a[0]) else 1
        for k in range(sbr.n_lim):
            lo = int(sbr.f_tablelim[k]) - kx1
            hi = int(sbr.f_tablelim[k + 1]) - kx1
            m = slice(lo, hi)
            temp = (e_orig[e, m] / (1.0 + q_mapped[e, m])).astype(np.float32)
            q_m[e, m] = np.sqrt(temp * q_mapped[e, m], dtype=np.float32)
            s_m[e, m] = np.sqrt(
                temp * ch_data.s_indexmapped[e + 1][lo:hi], dtype=np.float32)
            gain[e, m] = np.where(
                s_mapped[e, m] == 0,
                np.sqrt(e_orig[e, m]
                        / ((1.0 + e_curr[e, m])
                           * (1.0 + q_mapped[e, m] * delta)),
                        dtype=np.float32),
                np.sqrt(e_orig[e, m] * q_mapped[e, m]
                        / ((1.0 + e_curr[e, m]) * (1.0 + q_mapped[e, m])),
                        dtype=np.float32))
            sum0 = np.float32(e_orig[e, m].sum(dtype=np.float32))
            sum1 = np.float32(e_curr[e, m].sum(dtype=np.float32))
            gain_max = np.float32(limgain * np.sqrt(
                (EPS + sum0) / (EPS + sum1), dtype=np.float32))
            gain_max = min(np.float32(100000), gain_max)
            q_m_max = (q_m[e, m] * gain_max / gain[e, m]).astype(np.float32)
            q_m[e, m] = np.minimum(q_m[e, m], q_m_max)
            gain[e, m] = np.minimum(gain[e, m], gain_max)
            sum0 = np.float32(e_orig[e, m].sum(dtype=np.float32))
            sum1 = np.float32(
                (e_curr[e, m] * gain[e, m] * gain[e, m]
                 + s_m[e, m] * s_m[e, m]
                 + (np.float32(delta) * (s_m[e, m] == 0)) * q_m[e, m] * q_m[e, m]
                 ).sum(dtype=np.float32))
            gain_boost = np.float32(np.sqrt((EPS + sum0) / (EPS + sum1),
                                            dtype=np.float32))
            gain_boost = min(np.float32(1.584893192), gain_boost)
            gain[e, m] = (gain[e, m] * gain_boost).astype(np.float32)
            q_m[e, m] = (q_m[e, m] * gain_boost).astype(np.float32)
            s_m[e, m] = (s_m[e, m] * gain_boost).astype(np.float32)
    return gain, q_m, s_m


H_SMOOTH = np.array([0.33333333333333, 0.30150283239582, 0.21816949906249,
                     0.11516383427084, 0.03183050093751], np.float32)
PHI_RE = np.array([1, 0, -1, 0], np.float32)
PHI_IM = np.array([0, 1, 0, -1], np.float32)


def hf_assemble(Y, X_high, sbr: SBRContext, ch_data, e_a, gain, q_m, s_m):
    """aacsbr.c:1608-1714 (mutates Y and ch_data state)."""
    noise = S.noise_table()
    h_SL = 4 * (not sbr.bs_smoothing_mode)
    kx = sbr.kx[1]
    m_max = sbr.m[1]
    g_temp, q_temp = ch_data.g_temp, ch_data.q_temp
    indexnoise = ch_data.f_indexnoise
    indexsine = ch_data.f_indexsine
    Y[0] = Y[1]

    if sbr.reset:
        for i in range(h_SL):
            g_temp[i + 2 * ch_data.t_env[0]][:m_max] = gain[0][:m_max]
            q_temp[i + 2 * ch_data.t_env[0]][:m_max] = q_m[0][:m_max]
    elif h_SL:
        t0 = 2 * int(ch_data.t_env[0])
        told = 2 * int(ch_data.t_env_num_env_old)
        g_temp[t0: t0 + 4] = g_temp[told: told + 4]
        q_temp[t0: t0 + 4] = q_temp[told: told + 4]

    for e in range(ch_data.bs_num_env):
        for i in range(2 * int(ch_data.t_env[e]), 2 * int(ch_data.t_env[e + 1])):
            g_temp[h_SL + i][:m_max] = gain[e][:m_max]
            q_temp[h_SL + i][:m_max] = q_m[e][:m_max]

    for e in range(ch_data.bs_num_env):
        for i in range(2 * int(ch_data.t_env[e]), 2 * int(ch_data.t_env[e + 1])):
            phi_sign = np.float32(1 - 2 * (kx & 1))
            xh = X_high[kx: kx + m_max, i + ENVELOPE_ADJUSTMENT_OFFSET]
            if h_SL and e != e_a[0] and e != e_a[1]:
                g_filt = np.zeros(m_max, np.float32)
                for j in range(h_SL + 1):
                    g_filt = (g_filt
                              + g_temp[i + h_SL - j][:m_max] * H_SMOOTH[j]
                              ).astype(np.float32)
            else:
                g_filt = g_temp[i + h_SL][:m_max]
            Y[1, i, kx: kx + m_max, 0] = (xh[:, 0] * g_filt).astype(np.float32)
            Y[1, i, kx: kx + m_max, 1] = (xh[:, 1] * g_filt).astype(np.float32)

            if e != e_a[0] and e != e_a[1]:
                for m in range(m_max):
                    indexnoise = (indexnoise + 1) & 0x1FF
                    if s_m[e][m]:
                        Y[1, i, m + kx, 0] += s_m[e][m] * PHI_RE[indexsine]
                        Y[1, i, m + kx, 1] += s_m[e][m] * (PHI_IM[indexsine]
                                                           * phi_sign)
                    else:
                        if h_SL:
                            q_filt = np.float32(0)
                            for j in range(h_SL + 1):
                                q_filt = np.float32(
                                    q_filt + q_temp[i + h_SL - j][m] * H_SMOOTH[j])
                        else:
                            q_filt = q_temp[i][m]
                        Y[1, i, m + kx, 0] += q_filt * noise[indexnoise][0]
                        Y[1, i, m + kx, 1] += q_filt * noise[indexnoise][1]
                    phi_sign = -phi_sign
            else:
                indexnoise = (indexnoise + m_max) & 0x1FF
                for m in range(m_max):
                    Y[1, i, m + kx, 0] += s_m[e][m] * PHI_RE[indexsine]
                    Y[1, i, m + kx, 1] += s_m[e][m] * (PHI_IM[indexsine]
                                                       * phi_sign)
                    phi_sign = -phi_sign
            indexsine = (indexsine + 1) & 3
    ch_data.f_indexnoise = indexnoise
    ch_data.f_indexsine = indexsine


def sbr_apply(m4ac, sbr: SBRContext, id_aac: int, L: np.ndarray,
              R: np.ndarray, ps_apply=None, transform=imdct_half_ref) -> None:
    """aacsbr.c:1716-1771.  L, R: [2048] in/out (1024 core samples in)."""
    downsampled = m4ac.ext_sample_rate < sbr.sample_rate
    nch = 2 if id_aac == TYPE_CPE else 1
    if sbr.start:
        S.sbr_dequant(sbr, id_aac)
    X = [None, None]
    for ch in range(nch):
        d = sbr.data[ch]
        inbuf = (R if ch else L)[:1024]
        qmf_analysis(inbuf, d.analysis_filterbank_samples, d.W, 1.0,
                     transform)
        X_low = lf_gen(sbr, d.W)
        if sbr.start:
            alpha0, alpha1 = hf_inverse_filter(X_low, sbr.k[0])
            chirp(sbr, d)
            X_high = hf_gen(sbr, X_low, alpha0, alpha1, d.bw_array, d.t_env,
                            d.bs_num_env)
            e_orig, q_mapped, s_mapped = mapping(sbr, d, d.e_a)
            e_curr = env_estimate(X_high, sbr, d)
            gain, q_m, s_m = gain_calc(sbr, d, d.e_a, e_orig, q_mapped,
                                       s_mapped, e_curr)
            hf_assemble(d.Y, X_high, sbr, d, d.e_a, gain, q_m, s_m)
        X[ch] = x_gen(sbr, X_low, d.Y, ch)

    if m4ac.ps == 1:
        if sbr.ps is not None and sbr.ps.start:
            X[0], X[1] = ps_apply(sbr.ps, X[0], sbr.kx[1] + sbr.m[1])
        else:
            X[1] = X[0].copy()
        nch = 2

    for ch in range(nch):
        d = sbr.data[ch]
        out, d.synthesis_filterbank_samples_offset = qmf_synthesis(
            X[ch], d.synthesis_filterbank_samples,
            d.synthesis_filterbank_samples_offset, downsampled, transform)
        (R if ch else L)[: len(out)] = out
