"""Parametric Stereo constant tables.

Derived at import time in float64 then rounded to float32, mirroring the
reference's init-time generation (libavcodec/aacps_tablegen.h:80-209
``ps_tableinit``).  Band-map tables (k_to_i) and hybrid filter prototypes
come from the extracted spec data (see tools/extract_ref_tables.py).
"""
from __future__ import annotations

import functools

import numpy as np

from . import aac_tables as T

PS_MAX_NUM_ENV = 5
PS_MAX_NR_IIDICC = 34
PS_MAX_NR_IPDOPD = 17
PS_MAX_SSB = 91
PS_MAX_AP_BANDS = 50
PS_QMF_TIME_SLOTS = 32
PS_MAX_DELAY = 14
PS_AP_LINKS = 3
PS_MAX_AP_DELAY = 5

NR_PAR_BANDS = (20, 34)
NR_BANDS = (71, 91)
DECAY_CUTOFF = (10, 32)
NR_ALLPASS_BANDS = (30, 50)
SHORT_DELAY_BAND = (42, 62)
DECAY_SLOPE = np.float32(0.05)

# iid/icc dequantization (aacps_tablegen.h:86-107)
IID_PAR_DEQUANT = np.array([
    0.05623413251903, 0.12589254117942, 0.19952623149689, 0.31622776601684,
    0.44668359215096, 0.63095734448019, 0.79432823472428, 1,
    1.25892541179417, 1.58489319246111, 2.23872113856834, 3.16227766016838,
    5.01187233627272, 7.94328234724282, 17.7827941003892,
    0.00316227766017, 0.00562341325190, 0.01, 0.01778279410039,
    0.03162277660168, 0.05623413251903, 0.07943282347243, 0.11220184543020,
    0.15848931924611, 0.22387211385683, 0.31622776601684, 0.39810717055350,
    0.50118723362727, 0.63095734448019, 0.79432823472428, 1,
    1.25892541179417, 1.58489319246111, 1.99526231496888, 2.51188643150958,
    3.16227766016838, 4.46683592150963, 6.30957344480193, 8.91250938133745,
    12.5892541179417, 17.7827941003892, 31.6227766016838, 56.2341325190349,
    100, 177.827941003892, 316.227766016837,
], np.float64)
ICC_INVQ = np.array([1, 0.937, 0.84118, 0.60092, 0.36764, 0, -0.589, -1],
                    np.float64)
ACOS_ICC_INVQ = np.array([0, 0.35685527, 0.57133466, 0.92614472, 1.1943263,
                          np.pi / 2, 2.2006171, np.pi], np.float64)

F_CENTER_20 = np.array([-3, -1, 1, 3, 5, 7, 10, 14, 18, 22], np.float64)
F_CENTER_34 = np.array([
    2, 6, 10, 14, 18, 22, 26, 30,
    34, -10, -6, -2, 51, 57, 15, 21,
    27, 33, 39, 45, 54, 66, 78, 42,
    102, 66, 78, 90, 102, 114, 126, 90,
], np.float64)
FRACTIONAL_DELAY_LINKS = np.array([0.43, 0.75, 0.347], np.float64)
FRACTIONAL_DELAY_GAIN = 0.39
LINK_DELAY = np.array([3, 4, 5], np.int64)
AP_A = np.array([0.65143905753106, 0.56471812200776, 0.48954165955695],
                np.float32)
PEAK_DECAY_FACTOR = np.float32(0.76592833836465)
TRANSIENT_IMPACT = np.float32(1.5)
A_SMOOTH = np.float32(0.25)


@functools.cache
def pd_smooth() -> tuple[np.ndarray, np.ndarray]:
    """(pd_re_smooth[512], pd_im_smooth[512])."""
    ang = np.arange(8) * (np.pi / 4)
    cos_t, sin_t = np.cos(ang), np.sin(ang)
    pd0, pd1, pd2 = np.meshgrid(np.arange(8), np.arange(8), np.arange(8),
                                indexing="ij")
    re = 0.25 * cos_t[pd0] + 0.5 * cos_t[pd1] + cos_t[pd2]
    im = 0.25 * sin_t[pd0] + 0.5 * sin_t[pd1] + sin_t[pd2]
    mag = 1.0 / np.sqrt(im * im + re * re)
    return ((re * mag).ravel().astype(np.float32),
            (im * mag).ravel().astype(np.float32))


@functools.cache
def mixing_luts() -> tuple[np.ndarray, np.ndarray]:
    """(HA[46][8][4], HB[46][8][4]) mixing matrices."""
    HA = np.zeros((46, 8, 4), np.float32)
    HB = np.zeros((46, 8, 4), np.float32)
    for iid in range(46):
        c = np.float32(IID_PAR_DEQUANT[iid])
        c1 = np.float32(np.sqrt(2.0, dtype=np.float32) /
                        np.sqrt(np.float32(1.0) + c * c, dtype=np.float32))
        c2 = np.float32(c * c1)
        for icc in range(8):
            alpha = np.float32(0.5) * np.float32(ACOS_ICC_INVQ[icc])
            beta = np.float32(alpha * (c1 - c2) * np.float32(np.sqrt(0.5)))
            HA[iid][icc][0] = c2 * np.cos(np.float32(beta + alpha), dtype=np.float32)
            HA[iid][icc][1] = c1 * np.cos(np.float32(beta - alpha), dtype=np.float32)
            HA[iid][icc][2] = c2 * np.sin(np.float32(beta + alpha), dtype=np.float32)
            HA[iid][icc][3] = c1 * np.sin(np.float32(beta - alpha), dtype=np.float32)

            rho = np.float32(max(ICC_INVQ[icc], 0.05))
            alpha = np.float32(0.5) * np.arctan2(
                np.float32(2.0) * c * rho, c * c - np.float32(1.0),
                dtype=np.float32)
            mu = np.float32(c + np.float32(1.0) / c)
            mu = np.sqrt(np.float32(1 + (4 * rho * rho - 4) / (mu * mu)),
                         dtype=np.float32)
            gamma = np.arctan(np.sqrt((np.float32(1.0) - mu) /
                                      (np.float32(1.0) + mu), dtype=np.float32),
                              dtype=np.float32)
            if alpha < 0:
                alpha = np.float32(alpha + np.pi / 2)
            rt2 = np.float32(np.sqrt(2.0))
            HB[iid][icc][0] = rt2 * np.cos(alpha, dtype=np.float32) * np.cos(gamma, dtype=np.float32)
            HB[iid][icc][1] = rt2 * np.sin(alpha, dtype=np.float32) * np.cos(gamma, dtype=np.float32)
            HB[iid][icc][2] = -rt2 * np.sin(alpha, dtype=np.float32) * np.sin(gamma, dtype=np.float32)
            HB[iid][icc][3] = rt2 * np.cos(alpha, dtype=np.float32) * np.sin(gamma, dtype=np.float32)
    return HA, HB


@functools.cache
def fractional_delays() -> tuple[np.ndarray, np.ndarray]:
    """(Q_fract_allpass[2][50][3][2], phi_fract[2][50][2])."""
    q = np.zeros((2, 50, 3, 2), np.float32)
    phi = np.zeros((2, 50, 2), np.float32)
    for is34 in (0, 1):
        nbands = NR_ALLPASS_BANDS[is34]
        for k in range(nbands):
            if is34:
                fc = F_CENTER_34[k] / 24.0 if k < len(F_CENTER_34) else k - np.float32(26.5)
            else:
                fc = F_CENTER_20[k] * 0.125 if k < len(F_CENTER_20) else k - np.float32(6.5)
            for m in range(3):
                theta = -np.pi * FRACTIONAL_DELAY_LINKS[m] * fc
                q[is34][k][m] = (np.cos(theta), np.sin(theta))
            theta = -np.pi * FRACTIONAL_DELAY_GAIN * fc
            phi[is34][k] = (np.cos(theta), np.sin(theta))
    return q, phi


@functools.cache
def hybrid_filters() -> dict[str, np.ndarray]:
    """Complex hybrid analysis filters from the spec prototypes."""
    r = T.raw()

    def make(proto, bands):
        f = np.zeros((bands, 7, 2), np.float32)
        for qq in range(bands):
            n = np.arange(7)
            theta = 2 * np.pi * (qq + 0.5) * (n - 6) / bands
            f[qq, :, 0] = proto * np.cos(theta)
            f[qq, :, 1] = proto * -np.sin(theta)
        return f

    return {
        "f20_0_8": make(r["ps_g0_Q8"], 8),
        "f34_0_12": make(r["ps_g0_Q12"], 12),
        "f34_1_8": make(r["ps_g1_Q8"], 8),
        "f34_2_4": make(r["ps_g2_Q4"], 4),
        "g1_Q2": r["ps_g1_Q2"].astype(np.float32),
    }


def k_to_i(is34: int) -> np.ndarray:
    return T.raw()["ps_k_to_i_34" if is34 else "ps_k_to_i_20"]
