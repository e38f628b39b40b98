"""AAC constant tables: extracted ISO-spec data + derived constants.

Irreducible specification constants (Huffman codebooks, scalefactor-band
offsets, TNS coefficient maps) are loaded from ``_data/ref_tables.npz``
(produced once by ``tools/extract_ref_tables.py``; provenance in that script).
Everything derivable is computed here in float64 and rounded to float32 the
same way the reference does at init time:

* KBD windows       (reference libavcodec/mdct.c:35-54 ``ff_kbd_window_init``)
* sine windows      (reference libavcodec/fft.h / dsputil sine window init)
* pow2sf table      (reference libavcodec/aac_tablegen.h:32-39)
* cbrt dequant tab  (reference libavcodec/cbrt_tablegen.h:36-48)
* spectral codebook value tuples (ISO/IEC 13818-7 Tables A.2-A.13 index
  arithmetic; reference packs these as aactab.c codebook_vector*_idx)
"""
from __future__ import annotations

import functools
import os

import numpy as np

_DATA = os.path.join(os.path.dirname(__file__), "_data", "ref_tables.npz")


@functools.cache
def raw() -> dict[str, np.ndarray]:
    with np.load(_DATA) as z:
        return {k: z[k] for k in z.files}


# ---------------------------------------------------------------------------
# Sample rates / channel configuration (reference libavcodec/mpeg4audio.c:55-62)
# ---------------------------------------------------------------------------
SAMPLE_RATES = np.array(
    [96000, 88200, 64000, 48000, 44100, 32000, 24000, 22050,
     16000, 12000, 11025, 8000, 7350, 0, 0, 0], np.int64)
CHANNEL_COUNTS = np.array([0, 1, 2, 3, 4, 5, 6, 8], np.int64)

# element types (reference libavcodec/aac.h:46-55)
TYPE_SCE, TYPE_CPE, TYPE_CCE, TYPE_LFE, TYPE_DSE, TYPE_PCE, TYPE_FIL, TYPE_END = range(8)

# window sequences (reference libavcodec/aac.h:66-71)
ONLY_LONG, LONG_START, EIGHT_SHORT, LONG_STOP = range(4)

# band types (reference libavcodec/aac.h:73-80)
ZERO_BT, ESC_BT, NOISE_BT, INTENSITY_BT2, INTENSITY_BT = 0, 11, 13, 14, 15

# default channel element layout per channel_config 1..7
# (reference libavcodec/aacdectab.h:74-82; spec ISO 14496-3 Table 1.17)
CHANNEL_LAYOUT_MAP = {
    1: [(TYPE_SCE, 0)],
    2: [(TYPE_CPE, 0)],
    3: [(TYPE_CPE, 0), (TYPE_SCE, 0)],
    4: [(TYPE_CPE, 0), (TYPE_SCE, 0), (TYPE_SCE, 1)],
    5: [(TYPE_CPE, 0), (TYPE_SCE, 0), (TYPE_CPE, 1)],
    6: [(TYPE_CPE, 0), (TYPE_SCE, 0), (TYPE_LFE, 0), (TYPE_CPE, 1)],
    7: [(TYPE_CPE, 0), (TYPE_SCE, 0), (TYPE_LFE, 0), (TYPE_CPE, 2), (TYPE_CPE, 1)],
}
TAGS_PER_CONFIG = [0, 1, 1, 2, 3, 3, 4, 5]


# ---------------------------------------------------------------------------
# Windows
# ---------------------------------------------------------------------------
@functools.cache
def kbd_window(alpha: float, n: int) -> np.ndarray:
    """Kaiser-Bessel derived window, float64 accumulation, float32 result
    (matches reference mdct.c:35-54 bit-for-bit in float32)."""
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
    """sin((i+0.5) * pi/(2n)); reference ff_sine_window_init (fft.h)."""
    i = np.arange(n, dtype=np.float64)
    return np.sin((i + 0.5) * (np.pi / (2 * n))).astype(np.float32)


def kbd_long_1024() -> np.ndarray:
    return kbd_window(4.0, 1024)


def kbd_short_128() -> np.ndarray:
    return kbd_window(6.0, 128)


# ---------------------------------------------------------------------------
# Scalefactor / dequant tables
# ---------------------------------------------------------------------------
@functools.cache
def pow2sf_tab() -> np.ndarray:
    """2^((i-200)/4) for i in [0,428); reference aac_tablegen.h:32-39."""
    i = np.arange(428, dtype=np.float64)
    return np.exp2((i - 200) / 4).astype(np.float32)


@functools.cache
def cbrt_tab() -> np.ndarray:
    """cbrtf(i)*i in float32 for i in [0,8192); reference cbrt_tablegen.h."""
    i = np.arange(8192, dtype=np.float64)
    return (np.cbrt(i) * i).astype(np.float32)


# ---------------------------------------------------------------------------
# Spectral Huffman codebooks (ISO 13818-7 Tables A.2-A.13)
# ---------------------------------------------------------------------------
# (dim, lav, signed) per codebook 1..11; ESC_BT==11 has escape handling.
CODEBOOK_INFO = {
    1: (4, 1, True), 2: (4, 1, True),
    3: (4, 2, False), 4: (4, 2, False),
    5: (2, 4, True), 6: (2, 4, True),
    7: (2, 7, False), 8: (2, 7, False),
    9: (2, 12, False), 10: (2, 12, False),
    11: (2, 16, False),
}


@functools.cache
def codebook_tuples(cb: int) -> np.ndarray:
    """[n_codes, dim] integer tuples for spectral codebook cb, in the
    canonical spec codeword-index order (idx = sum v_i * mod^i)."""
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


@functools.cache
def dequant_abs() -> np.ndarray:
    """|v|^(4/3) in float32 for |v| in [0, 8192)."""
    return cbrt_tab()


def spectral_codes(cb: int) -> tuple[np.ndarray, np.ndarray]:
    r = raw()
    return r[f"spec_codes_{cb}"], r[f"spec_bits_{cb}"]


def scalefactor_codes() -> tuple[np.ndarray, np.ndarray]:
    r = raw()
    return r["scalefactor_code"], r["scalefactor_bits"]


# ---------------------------------------------------------------------------
# Band layout tables
# ---------------------------------------------------------------------------
def num_swb_1024(sampling_index: int) -> int:
    return int(raw()["num_swb_1024"][sampling_index])


def num_swb_128(sampling_index: int) -> int:
    return int(raw()["num_swb_128"][sampling_index])


def swb_offset_1024(sampling_index: int) -> np.ndarray:
    n = num_swb_1024(sampling_index)
    return raw()["swb_offset_1024"][sampling_index][: n + 1]


def swb_offset_128(sampling_index: int) -> np.ndarray:
    n = num_swb_128(sampling_index)
    return raw()["swb_offset_128"][sampling_index][: n + 1]


def tns_max_bands(sampling_index: int, eight_short: bool) -> int:
    key = "tns_max_bands_128" if eight_short else "tns_max_bands_1024"
    return int(raw()[key][sampling_index])


def pred_sfb_max(sampling_index: int) -> int:
    return int(raw()["pred_sfb_max"][sampling_index])


def tns_tmp2_map(coef_compress: int, coef_res: int) -> np.ndarray:
    return raw()[f"tns_tmp2_map_{coef_compress}_{coef_res + 3}"]
