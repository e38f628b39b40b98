"""Constant tables of the port, built in numpy.

The port never imports the JAX package, so it carries its own copies of
the numpy functions the JAX package builds for its device constants.  The
irreducible spec data (Huffman codebooks, band offsets, filter
prototypes) is read from the JAX package's extracted table file as a
data file (``heaac_tpu/tables/_data/ref_tables.npz``); everything else
is derived here exactly as the JAX package derives it, and
``tests/test_torch_consts.py`` holds every array equal to the JAX
package's.

Sections mirror their counterparts:
  - AAC windows / dequant / codebooks,  heaac_tpu/tables/aac_tables.py
    band and TNS tables of the parser
  - IMDCT matrices                       heaac_tpu/ops/imdct.py
  - window bank                          heaac_tpu/ops/windowing.py
  - QMF prototypes and matrices          heaac_tpu/bitstream/sbr_syntax.py,
                                         heaac_tpu/ops/qmf_jax.py
  - PS constants                         heaac_tpu/tables/ps_tables.py,
                                         heaac_tpu/ops/ps_jax.py (_consts)
  - PS remap tables                      heaac_tpu/ops/ps_np.py
  - Huffman LUTs                         heaac_tpu/ops/{spec,sbr,ps}_huff.py
  - qwire dequant LUTs                   heaac_tpu/codec/qwire.py (_luts)
"""
from __future__ import annotations

import functools
import os

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RAW_TABLES = os.path.join(REPO, "heaac_tpu", "tables", "_data",
                          "ref_tables.npz")


@functools.cache
def raw() -> dict:
    with np.load(RAW_TABLES) as z:
        return {k: z[k] for k in z.files}


# ---------------------------------------------------------------------------
# AAC (aac_tables.py)
# ---------------------------------------------------------------------------
SAMPLE_RATES = np.array(
    [96000, 88200, 64000, 48000, 44100, 32000, 24000, 22050,
     16000, 12000, 11025, 8000, 7350, 0, 0, 0], np.int64)

CHANNEL_COUNTS = np.array([0, 1, 2, 3, 4, 5, 6, 8], np.int64)

ONLY_LONG, LONG_START, EIGHT_SHORT, LONG_STOP = range(4)

# band types
ZERO_BT, ESC_BT, NOISE_BT, INTENSITY_BT2, INTENSITY_BT = 0, 11, 13, 14, 15

(TYPE_SCE, TYPE_CPE, TYPE_CCE, TYPE_LFE, TYPE_DSE, TYPE_PCE, TYPE_FIL,
 TYPE_END) = range(8)

# default element layout (lane order) of ADTS channel configs 1..7
CHANNEL_LAYOUT_MAP = {
    1: [(TYPE_SCE, 0)],
    2: [(TYPE_CPE, 0)],
    3: [(TYPE_CPE, 0), (TYPE_SCE, 0)],
    4: [(TYPE_CPE, 0), (TYPE_SCE, 0), (TYPE_SCE, 1)],
    5: [(TYPE_CPE, 0), (TYPE_SCE, 0), (TYPE_CPE, 1)],
    6: [(TYPE_CPE, 0), (TYPE_SCE, 0), (TYPE_LFE, 0), (TYPE_CPE, 1)],
    7: [(TYPE_CPE, 0), (TYPE_SCE, 0), (TYPE_LFE, 0), (TYPE_CPE, 2),
        (TYPE_CPE, 1)],
}

CODEBOOK_INFO = {
    1: (4, 1, True), 2: (4, 1, True),
    3: (4, 2, False), 4: (4, 2, False),
    5: (2, 4, True), 6: (2, 4, True),
    7: (2, 7, False), 8: (2, 7, False),
    9: (2, 12, False), 10: (2, 12, False),
    11: (2, 16, False),
}


@functools.cache
def kbd_window(alpha: float, n: int) -> np.ndarray:
    """Kaiser-Bessel derived window (float64 accumulation, f32 result)."""
    alpha2 = (alpha * np.pi / n) ** 2
    local = np.zeros(n, np.float64)
    s = 0.0
    for i in range(n):
        tmp = i * (n - i) * alpha2
        bessel = 1.0
        for j in range(50, 0, -1):
            bessel = bessel * tmp / (j * j) + 1
        s += bessel
        local[i] = s
    s += 1.0
    return np.sqrt(local / s).astype(np.float32)


@functools.cache
def sine_window(n: int) -> np.ndarray:
    i = np.arange(n, dtype=np.float64)
    return np.sin((i + 0.5) * (np.pi / (2 * n))).astype(np.float32)


@functools.cache
def pow2sf_tab() -> np.ndarray:
    """2^((i-200)/4) for i in [0, 428)."""
    i = np.arange(428, dtype=np.float64)
    return np.exp2((i - 200) / 4).astype(np.float32)


@functools.cache
def cbrt_tab() -> np.ndarray:
    """cbrt(i)*i in float32 for i in [0, 8192)."""
    i = np.arange(8192, dtype=np.float64)
    return (np.cbrt(i) * i).astype(np.float32)


@functools.cache
def codebook_tuples(cb: int) -> np.ndarray:
    dim, lav, signed = CODEBOOK_INFO[cb]
    mod = 2 * lav + 1 if signed else lav + 1
    off = lav if signed else 0
    n = mod ** dim
    idx = np.arange(n)
    vals = np.zeros((n, dim), np.int32)
    for d in range(dim):
        vals[:, dim - 1 - d] = idx % mod - off
        idx = idx // mod
    return vals


def spectral_codes(cb: int) -> tuple:
    r = raw()
    return r[f"spec_codes_{cb}"], r[f"spec_bits_{cb}"]


def scalefactor_codes() -> tuple:
    r = raw()
    return r["scalefactor_code"], r["scalefactor_bits"]


def num_swb_1024(si: int) -> int:
    return int(raw()["num_swb_1024"][si])


def num_swb_128(si: int) -> int:
    return int(raw()["num_swb_128"][si])


def swb_offset_1024(si: int) -> np.ndarray:
    return raw()["swb_offset_1024"][si][: num_swb_1024(si) + 1]


def swb_offset_128(si: int) -> np.ndarray:
    return raw()["swb_offset_128"][si][: num_swb_128(si) + 1]


def tns_max_bands(si: int, eight_short: bool) -> int:
    key = "tns_max_bands_128" if eight_short else "tns_max_bands_1024"
    return int(raw()[key][si])


def pred_sfb_max(si: int) -> int:
    return int(raw()["pred_sfb_max"][si])


def tns_tmp2_map(coef_compress: int, coef_res: int) -> np.ndarray:
    return raw()[f"tns_tmp2_map_{coef_compress}_{coef_res + 3}"]


# ---------------------------------------------------------------------------
# IMDCT matrices (imdct.py) and window bank (windowing.py)
# ---------------------------------------------------------------------------
def imdct_half_ref(c: np.ndarray, scale: float = 1.0) -> np.ndarray:
    """ff_imdct_half in float64 numpy (mdct.c:124-159)."""
    c = np.asarray(c, np.float64)
    n2 = c.shape[-1]
    n = 2 * n2
    n4 = n // 4
    n8 = n // 8
    theta = 1.0 / 8.0 + (n4 if scale < 0 else 0)
    s = np.sqrt(abs(scale))
    alpha = 2 * np.pi * (np.arange(n4) + theta) / n
    tcos = -np.cos(alpha) * s
    tsin = -np.sin(alpha) * s
    in1 = c[..., 0::2][..., :n4]
    in2 = c[..., ::-1][..., 0::2][..., :n4]
    z = (in2 * tcos - in1 * tsin) + 1j * (in2 * tsin + in1 * tcos)
    z = np.fft.ifft(z, axis=-1) * n4
    out = np.zeros(c.shape, np.float64)
    k = np.arange(n8)
    zr1 = z[..., n8 - 1 - k]
    zr2 = z[..., n8 + k]
    out[..., 2 * (n8 - 1 - k)] = (zr1.imag * tsin[n8 - 1 - k]
                                  - zr1.real * tcos[n8 - 1 - k])
    out[..., 2 * (n8 + k) + 1] = (zr1.imag * tcos[n8 - 1 - k]
                                  + zr1.real * tsin[n8 - 1 - k])
    out[..., 2 * (n8 + k)] = zr2.imag * tsin[n8 + k] - zr2.real * tcos[n8 + k]
    out[..., 2 * (n8 - 1 - k) + 1] = (zr2.imag * tcos[n8 + k]
                                      + zr2.real * tsin[n8 + k])
    return out


@functools.cache
def imdct_half_matrix(n2: int, scale: float = 1.0) -> np.ndarray:
    """[n2, n2] f32 matrix M with imdct_half(c) == c @ M."""
    return imdct_half_ref(np.eye(n2), scale).astype(np.float32)


@functools.cache
def window_bank() -> np.ndarray:
    """[2, 1152]: row = use_kbd; cols 0:1024 long, 1024:1152 short."""
    return np.stack([
        np.concatenate([sine_window(1024), sine_window(128)]),
        np.concatenate([kbd_window(4.0, 1024), kbd_window(6.0, 128)]),
    ]).astype(np.float32)


@functools.cache
def core_consts():
    """(m2048 [1024,1024], m256 [128,128], bank [2,1152]) — core._consts."""
    return imdct_half_matrix(1024, 1.0), imdct_half_matrix(128, 1.0), \
        window_bank()


# ---------------------------------------------------------------------------
# QMF (sbr_syntax.py, qmf_jax.py)
# ---------------------------------------------------------------------------
ENVELOPE_ADJUSTMENT_OFFSET = 2


@functools.cache
def qmf_window_us() -> np.ndarray:
    half = raw()["sbr_qmf_window_us_half"].astype(np.float32)
    w = np.zeros(640, np.float32)
    w[:321] = half
    n = np.arange(1, 320)
    w[320 + n] = w[320 - n]
    w[384] = -w[384]
    w[512] = -w[512]
    return w


def qmf_window_ds() -> np.ndarray:
    return qmf_window_us()[0::2].copy()


@functools.cache
def noise_table() -> np.ndarray:
    return raw()["sbr_noise_table"].astype(np.float32)


@functools.cache
def qmf_analysis_consts():
    """(win [320], pre [320,64]) — qmf_jax._analysis_consts."""
    win = qmf_window_ds()
    m_ana = imdct_half_matrix(64, -2.0)
    fold = np.zeros((320, 64), np.float32)
    for k in range(64):
        for j in range(5):
            fold[k + 64 * j, k] = 1.0
    shuf = np.zeros((64, 64), np.float32)
    shuf[0, 0] = 1.0
    for k in range(1, 32):
        shuf[k, 2 * k - 1] = 1.0
        shuf[64 - k, 2 * k] = -1.0
    shuf[32, 63] = 1.0
    pre = fold @ shuf @ m_ana
    return win.copy(), pre


QMF_SYN_TAPS = ((0, 0), (1, 64), (2, 0), (3, 64), (4, 0), (5, 64), (6, 0),
                (7, 64), (8, 0), (9, 64))


@functools.cache
def qmf_synthesis_consts():
    """(A [64,128], B2 [64,128], win [10,64]) — qmf_jax._synthesis_consts
    (the tap list is QMF_SYN_TAPS)."""
    m_syn = imdct_half_matrix(64, 1.0 / 64)
    win = qmf_window_us()
    alt = np.ones(64, np.float32)
    alt[1::2] = -1.0
    a0 = np.zeros((64, 128), np.float32)
    a1 = np.zeros((64, 128), np.float32)
    for n in range(64):
        a0[63 - n, n] = -1.0
        a0[63 - n, 127 - n] = 1.0
        a1[n, n] += 1.0
        a1[n, 127 - n] += 1.0
    A = (m_syn @ a0).astype(np.float32)
    B2 = ((alt[:, None] * m_syn) @ a1).astype(np.float32)
    return A, B2, win.reshape(10, 64)


QMF_SYN_TAPS_DS = ((0, 0), (1, 32), (2, 0), (3, 32), (4, 0), (5, 32),
                   (6, 0), (7, 32), (8, 0), (9, 32))


@functools.cache
def qmf_synthesis_consts_ds():
    """(A [64,64], B2 [64,64], win [10,32]) of the downsampled (32-band)
    synthesis — qmf_jax._synthesis_consts_ds (aacsbr.c:1192-1203): q =
    [-X_re[:32], X_im[31::-1]], buf = imdct64(q, 1/64), v[n] =
    buf[63-2n], v[63-n] = -buf[62-2n]; 64-sample v-blocks, 32-sample
    window taps (QMF_SYN_TAPS_DS) from the qmf_window_ds prototype."""
    m_syn = imdct_half_matrix(64, 1.0 / 64)
    win = qmf_window_ds()
    E = np.zeros((64, 64), np.float32)      # X_re -> q
    F = np.zeros((64, 64), np.float32)      # X_im -> q
    for k in range(32):
        E[k, k] = -1.0
        F[31 - k, 32 + k] = 1.0
    P = np.zeros((64, 64), np.float32)      # buf -> v
    for n in range(32):
        P[63 - 2 * n, n] = 1.0
        P[62 - 2 * n, 63 - n] = -1.0
    A = (E @ m_syn @ P).astype(np.float32)
    B2 = (F @ m_syn @ P).astype(np.float32)
    return A, B2, win.reshape(10, 32)


# ---------------------------------------------------------------------------
# Parametric stereo (ps_tables.py, ps_jax._consts)
# ---------------------------------------------------------------------------
PS_MAX_NUM_ENV = 5
PS_MAX_NR_IIDICC = 34
PS_QMF_TIME_SLOTS = 32
NR_PAR_BANDS = (20, 34)
NR_BANDS = (71, 91)
DECAY_CUTOFF = (10, 32)
NR_ALLPASS_BANDS = (30, 50)
SHORT_DELAY_BAND = (42, 62)
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
def pd_smooth() -> tuple:
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
def mixing_luts() -> tuple:
    """(HA [46,8,4], HB [46,8,4]) mixing matrices."""
    f = np.float32
    HA = np.zeros((46, 8, 4), np.float32)
    HB = np.zeros((46, 8, 4), np.float32)
    for iid in range(46):
        c = f(IID_PAR_DEQUANT[iid])
        c1 = f(np.sqrt(2.0, dtype=np.float32)
               / np.sqrt(f(1.0) + c * c, dtype=np.float32))
        c2 = f(c * c1)
        for icc in range(8):
            alpha = f(0.5) * f(ACOS_ICC_INVQ[icc])
            beta = f(alpha * (c1 - c2) * f(np.sqrt(0.5)))
            HA[iid][icc][0] = c2 * np.cos(f(beta + alpha), dtype=np.float32)
            HA[iid][icc][1] = c1 * np.cos(f(beta - alpha), dtype=np.float32)
            HA[iid][icc][2] = c2 * np.sin(f(beta + alpha), dtype=np.float32)
            HA[iid][icc][3] = c1 * np.sin(f(beta - alpha), dtype=np.float32)
            rho = f(max(ICC_INVQ[icc], 0.05))
            alpha = f(0.5) * np.arctan2(f(2.0) * c * rho, c * c - f(1.0),
                                        dtype=np.float32)
            mu = f(c + f(1.0) / c)
            mu = np.sqrt(f(1 + (4 * rho * rho - 4) / (mu * mu)),
                         dtype=np.float32)
            gamma = np.arctan(np.sqrt((f(1.0) - mu) / (f(1.0) + mu),
                                      dtype=np.float32), dtype=np.float32)
            if alpha < 0:
                alpha = f(alpha + np.pi / 2)
            rt2 = f(np.sqrt(2.0))
            ca, sa = np.cos(alpha, dtype=f), np.sin(alpha, dtype=f)
            cg, sg = np.cos(gamma, dtype=f), np.sin(gamma, dtype=f)
            HB[iid][icc][0] = rt2 * ca * cg
            HB[iid][icc][1] = rt2 * sa * cg
            HB[iid][icc][2] = -rt2 * sa * sg
            HB[iid][icc][3] = rt2 * ca * sg
    return HA, HB


@functools.cache
def fractional_delays() -> tuple:
    """(Q_fract_allpass [2,50,3,2], phi_fract [2,50,2])."""
    q = np.zeros((2, 50, 3, 2), np.float32)
    phi = np.zeros((2, 50, 2), np.float32)
    for is34 in (0, 1):
        for k in range(NR_ALLPASS_BANDS[is34]):
            if is34:
                fc = (F_CENTER_34[k] / 24.0 if k < len(F_CENTER_34)
                      else k - np.float32(26.5))
            else:
                fc = (F_CENTER_20[k] * 0.125 if k < len(F_CENTER_20)
                      else k - np.float32(6.5))
            for m in range(3):
                theta = -np.pi * FRACTIONAL_DELAY_LINKS[m] * fc
                q[is34][k][m] = (np.cos(theta), np.sin(theta))
            theta = -np.pi * FRACTIONAL_DELAY_GAIN * fc
            phi[is34][k] = (np.cos(theta), np.sin(theta))
    return q, phi


@functools.cache
def hybrid_filters() -> dict:
    r = raw()

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
    return raw()["ps_k_to_i_34" if is34 else "ps_k_to_i_20"]


@functools.cache
def ps_consts(is34: int = 0) -> dict:
    """ps_jax._consts: hybrid filters, band aggregation and allpass
    constants of one band mode."""
    f = hybrid_filters()
    kti = k_to_i(is34)
    nr_bands = NR_BANDS[is34]
    agg = np.zeros((91, 34), np.float32)
    for k in range(nr_bands):
        agg[k, kti[k]] = 1.0
    k2i = np.zeros(91, np.int32)
    k2i[:nr_bands] = kti[:nr_bands]
    q_fract, phi_fract = fractional_delays()
    napb = NR_ALLPASS_BANDS[is34]
    gds = np.clip(1.0 - 0.05 * (np.arange(napb) - DECAY_CUTOFF[is34]),
                  0.0, 1.0).astype(np.float32)
    ag = (AP_A[None, :] * gds[:, None]).astype(np.float32)
    qf = q_fract[is34][:napb].astype(np.float32)
    pf = phi_fract[is34][:napb].astype(np.float32)
    flip = np.zeros(91, np.float32)
    if is34:
        flip[9:14] = 1.0
    else:
        flip[:2] = 1.0
    return dict(f20=f["f20_0_8"], g1=f["g1_Q2"],
                f34_0=f["f34_0_12"], f34_1=f["f34_1_8"], f34_2=f["f34_2_4"],
                agg=agg, k2i=k2i, ag=ag, qf=qf, pf=pf, napb=napb,
                nr_bands=nr_bands, flip=flip,
                short_delay=SHORT_DELAY_BAND[is34])


# ---- PS parameter remap tables (ps_np.REMAP_TABLES_FULL/PART) -------------
_IDX_10_TO_34_MAP = [0, 0, 0, 1, 1, 1, 2, 2, 2, 2, 3, 3, 4, 4, 4, 4]
_IDX_10_TO_34_FULL = [0, 0, 0, 1, 1, 1, 2, 2, 2, 2, 3, 3, 4, 4, 4, 4, 5, 5,
                      6, 6, 7, 7, 7, 7, 8, 8, 8, 8, 9, 9, 9, 9, 9, 9]
_IDX_20_TO_34 = [0, -1, 1, 2, -2, 3, 4, 4, 5, 5, 6, 7, 8, 8, 9, 9, 10, 11,
                 12, 13, 14, 14, 15, 15, 16, 16, 17, 17, 18, 18, 18, 18,
                 19, 19]


def _remap_tab(rows):
    t = np.zeros((34, 9), np.int32)
    for i, (srcs, ws, den) in rows.items():
        t[i, 0:len(srcs)] = srcs
        t[i, 4:4 + len(ws)] = ws
        t[i, 8] = den
    return t


@functools.cache
def remap_tables(full: bool) -> np.ndarray:
    """[to34][src_kind][34][9]: out[i] = tdiv(sum_j w_j*par[s_j], den),
    columns (s0..s3, w0..w3, den); full=True for iid/icc (10/20/34
    native bands), False for ipd/opd (5/11/17)."""
    one = lambda s: ((s,), (1,), 1)  # noqa: E731
    b = 9 if full else 4
    t10_20 = {2 * i + k: one(i) for i in range(b + 1) for k in (0, 1)}
    t20_20 = {i: one(i) for i in range(20 if full else 11)}
    t34_34 = {i: one(i) for i in range(34 if full else 17)}
    t34_20 = {
        0: ((0, 1), (2, 1), 3), 1: ((1, 2), (1, 2), 3),
        2: ((3, 4), (2, 1), 3), 3: ((4, 5), (1, 2), 3),
        4: ((6, 7), (1, 1), 2), 5: ((8, 9), (1, 1), 2),
        6: one(10), 7: one(11),
        8: ((12, 13), (1, 1), 2), 9: ((14, 15), (1, 1), 2),
        10: one(16),
    }
    if full:
        t34_20.update({
            11: one(17), 12: one(18), 13: one(19),
            14: ((20, 21), (1, 1), 2), 15: ((22, 23), (1, 1), 2),
            16: ((24, 25), (1, 1), 2), 17: ((26, 27), (1, 1), 2),
            18: ((28, 29, 30, 31), (1, 1, 1, 1), 4),
            19: ((32, 33), (1, 1), 2),
        })
    src = _IDX_10_TO_34_FULL if full else _IDX_10_TO_34_MAP
    t10_34 = {i: one(s) for i, s in enumerate(src)}
    if not full:
        t10_34.pop(16, None)
    t20_34 = {}
    for i in range(34 if full else 17):
        s = _IDX_20_TO_34[i]
        if s == -1:
            t20_34[i] = ((0, 1), (1, 1), 2)
        elif s == -2:
            t20_34[i] = ((2, 3), (1, 1), 2)
        else:
            t20_34[i] = one(s)
    return np.stack([
        np.stack([_remap_tab(t10_20), _remap_tab(t20_20),
                  _remap_tab(t34_20)]),
        np.stack([_remap_tab(t10_34), _remap_tab(t20_34),
                  _remap_tab(t34_34)]),
    ])


# ---------------------------------------------------------------------------
# Spectral / scalefactor Huffman LUTs (spec_huff.py)
# ---------------------------------------------------------------------------
CB_DIM = np.array([0, 4, 4, 4, 4, 2, 2, 2, 2, 2, 2, 2], np.int32)
CB_UNSIGNED = np.array([0, 0, 0, 1, 1, 0, 0, 1, 1, 1, 1, 1], np.int32)


@functools.cache
def spec_luts() -> np.ndarray:
    """[11, 65536] u32: len(0-4, 31 invalid) | nnz<<5 | values<<8 |
    cb11-escape<<24, indexed by [cb-1, 16-bit window]."""
    luts = np.zeros((11, 1 << 16), np.uint32)
    r = raw()
    for cb in range(1, 12):
        dim = CODEBOOK_INFO[cb][0]
        codes, bits = r[f"spec_codes_{cb}"], r[f"spec_bits_{cb}"]
        tup = codebook_tuples(cb)
        ent = np.full(1 << 16, 31, np.uint32)
        for ci in range(len(codes)):
            ln = int(bits[ci])
            vals = tup[ci]
            nnz = int(np.count_nonzero(vals))
            packed = 0
            if dim == 4:
                for d in range(4):
                    packed |= (int(vals[d]) + 4) << (8 + 4 * d)
            else:
                for d in range(2):
                    packed |= (int(vals[d]) + 64) << (8 + 8 * d)
            esc = int(cb == 11 and np.any(np.abs(vals) == 16))
            e = ln | (nnz << 5) | packed | (esc << 24)
            base = int(codes[ci]) << (16 - ln)
            ent[base:base + (1 << (16 - ln))] = e
        luts[cb - 1] = ent
    return luts


@functools.cache
def sf_lut() -> np.ndarray:
    """[2^19] i32 scalefactor table: len (bits 0-4, 31 invalid) | index<<5."""
    codes, bits = raw()["scalefactor_code"], raw()["scalefactor_bits"]
    ent = np.full(1 << 19, 31, np.uint32)
    for ci in range(len(codes)):
        ln = int(bits[ci])
        base = int(codes[ci]) << (19 - ln)
        ent[base:base + (1 << (19 - ln))] = ln | (ci << 5)
    return ent.view(np.int32)


@functools.cache
def sfb_of_bin(si: int):
    """([1024] sfb of each long-window bin, [1024] beyond-last-band, ns)."""
    off = swb_offset_1024(si)
    ns = int(raw()["num_swb_1024"][si])
    sfb = np.searchsorted(off[:ns + 1], np.arange(1024), side="right") - 1
    sfb = np.clip(sfb, 0, ns - 1).astype(np.int32)
    beyond = np.arange(1024) >= off[ns]
    return sfb, beyond.astype(np.int32), ns


@functools.cache
def sfb_of_bin_short(si: int):
    """Short-window analogue: (sfb [128], beyond [128], ns, off [16],
    width [16])."""
    off = np.asarray(swb_offset_128(si), np.int32)
    ns = int(raw()["num_swb_128"][si])
    sfb = np.searchsorted(off[:ns + 1], np.arange(128), side="right") - 1
    sfb = np.clip(sfb, 0, ns - 1).astype(np.int32)
    beyond = np.arange(128) >= off[ns]
    bw = (off[1:ns + 1] - off[:ns]).astype(np.int32)
    bw = np.concatenate([bw, np.zeros(16 - ns, np.int32)])
    offp = np.concatenate([off[:ns], np.zeros(16 - ns, np.int32)])
    return sfb, beyond.astype(np.int32), ns, offp, bw


# ---------------------------------------------------------------------------
# SBR / PS row-Huffman LUTs (sbr_huff.py, ps_huff.py)
# ---------------------------------------------------------------------------
SBR_HUFF_NAMES = ["t_huffman_env_1_5dB", "f_huffman_env_1_5dB",
                  "t_huffman_env_bal_1_5dB", "f_huffman_env_bal_1_5dB",
                  "t_huffman_env_3_0dB", "f_huffman_env_3_0dB",
                  "t_huffman_env_bal_3_0dB", "f_huffman_env_bal_3_0dB",
                  "t_huffman_noise_3_0dB", "t_huffman_noise_bal_3_0dB"]
SBR_LAV = np.array([60, 60, 24, 24, 31, 31, 12, 12, 31, 12], np.int32)
PS_HUFF_NAMES = ["huff_iid_df1", "huff_iid_dt1", "huff_iid_df0",
                 "huff_iid_dt0", "huff_icc_df", "huff_icc_dt", "huff_ipd_df",
                 "huff_ipd_dt", "huff_opd_df", "huff_opd_dt"]


def _flat_luts(prefix: str, names) -> tuple:
    """(flat u16 [sum 2^maxlen], base i32 [10], maxlen i32 [10]); entry =
    code length (bits 0-4, 31 invalid) | symbol index << 5."""
    r = raw()
    maxlens = [int(r[f"{prefix}{n}_bits"].max()) for n in names]
    bases = np.zeros(len(names), np.int32)
    flat = np.full(sum(1 << L for L in maxlens), 31, np.uint16)
    cur = 0
    for t, n in enumerate(names):
        codes, bits = r[f"{prefix}{n}_codes"], r[f"{prefix}{n}_bits"]
        L = maxlens[t]
        bases[t] = cur
        for ci in range(len(codes)):
            ln = int(bits[ci])
            if ln == 0:
                continue
            lo = int(codes[ci]) << (L - ln)
            flat[cur + lo:cur + lo + (1 << (L - ln))] = ln | (ci << 5)
        cur += 1 << L
    return flat, bases, np.asarray(maxlens, np.int32)


@functools.cache
def sbr_huff_luts() -> tuple:
    return _flat_luts("sbr_", SBR_HUFF_NAMES)


@functools.cache
def ps_huff_luts() -> tuple:
    """sbr_huff_luts' layout plus the per-table symbol offsets."""
    flat, bases, maxlens = _flat_luts("ps_", PS_HUFF_NAMES)
    return flat, bases, maxlens, raw()["ps_huff_offset"].astype(np.int32)


# ---------------------------------------------------------------------------
# qwire dequant LUTs (qwire._luts)
# ---------------------------------------------------------------------------
@functools.cache
def qwire_luts() -> dict:
    def exp2(x):
        return np.exp2(np.float32(min(x, 126.0)), dtype=np.float32)

    Ei = np.arange(128)
    lut = dict(
        cbrt=cbrt_tab(),
        pow2sf=pow2sf_tab(),
        env=np.stack([np.array([exp2(0.5 * e + 6.0) for e in Ei]),
                      np.array([exp2(1.0 * e + 6.0) for e in Ei])]),
        env_c1=np.stack([np.array([exp2(0.5 * e + 7.0) for e in Ei]),
                         np.array([exp2(1.0 * e + 7.0) for e in Ei])]),
        env_c2=np.stack([np.array([exp2((24.0 - e) * 0.5) for e in Ei]),
                         np.array([exp2((12.0 - e) * 1.0) for e in Ei])]),
        noise=np.array([exp2(6.0 - q) for q in range(64)]),
        noise_c1=np.array([exp2(7.0 - q) for q in range(64)]),
        noise_c2=np.array([exp2(12.0 - q) for q in range(64)]),
        bw_tab=np.array([0.0, 0.75, 0.9, 0.98], np.float32),
        limgain=np.array([0.70795, 1.0, 1.41254, 1e10], np.float32),
    )
    return {k: np.ascontiguousarray(v, np.float32) for k, v in lut.items()}
