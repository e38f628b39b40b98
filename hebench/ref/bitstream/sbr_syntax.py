"""SBR (Spectral Band Replication) bitstream parsing + frequency tables.

Host half of HE-AAC v1: everything bit-granular or integer-combinatorial —
header, frequency-band table derivation, grid/envelope/noise Huffman decode,
dequantization — mirroring reference libavcodec/aacsbr.c:86-1128.  The dense
DSP chain (QMF, HF generation/adjustment) is in ops/sbr_np.py (numpy
reference) and ops/sbr_jax.py (TPU graph).
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np

from ..tables import aac_tables as T
from .reader import BitReader, BitstreamError
from .vlc import VLC

FIXFIX, FIXVAR, VARFIX, VARVAR = range(4)
ENVELOPE_ADJUSTMENT_OFFSET = 2
NOISE_FLOOR_OFFSET = 6.0


# ---------------------------------------------------------------------------
# VLC tables (reference aacsbr.c:72-115); LAV offsets aacsbr.c:73-74
# ---------------------------------------------------------------------------
_SBR_VLC_NAMES = [
    ("t_huffman_env_1_5dB", 60), ("f_huffman_env_1_5dB", 60),
    ("t_huffman_env_bal_1_5dB", 24), ("f_huffman_env_bal_1_5dB", 24),
    ("t_huffman_env_3_0dB", 31), ("f_huffman_env_3_0dB", 31),
    ("t_huffman_env_bal_3_0dB", 12), ("f_huffman_env_bal_3_0dB", 12),
    ("t_huffman_noise_3_0dB", 31), ("t_huffman_noise_bal_3_0dB", 12),
]
(T_ENV15, F_ENV15, T_BAL15, F_BAL15, T_ENV30, F_ENV30, T_BAL30, F_BAL30,
 T_NOISE30, T_NOISEBAL30) = range(10)

_vlcs: list | None = None


def sbr_vlcs():
    global _vlcs
    if _vlcs is None:
        r = T.raw()
        _vlcs = [
            (VLC(r[f"sbr_{name}_codes"], r[f"sbr_{name}_bits"], name=name), lav)
            for name, lav in _SBR_VLC_NAMES
        ]
    return _vlcs


def qmf_window_us() -> np.ndarray:
    """640-tap QMF prototype, unfolded per aacsbr.c:117-120 (float32)."""
    half = T.raw()["sbr_qmf_window_us_half"].astype(np.float32)
    w = np.zeros(640, np.float32)
    w[:321] = half
    n = np.arange(1, 320)
    w[320 + n] = w[320 - n]
    w[384] = -w[384]
    w[512] = -w[512]
    return w


def qmf_window_ds() -> np.ndarray:
    return qmf_window_us()[0::2].copy()


def noise_table() -> np.ndarray:
    return T.raw()["sbr_noise_table"].astype(np.float32)


# ---------------------------------------------------------------------------
# State
# ---------------------------------------------------------------------------
@dataclass
class SpectrumParams:
    bs_start_freq: int = 0
    bs_stop_freq: int = 0
    bs_xover_band: int = 0
    bs_freq_scale: int = 2
    bs_alter_scale: int = 1
    bs_noise_bands: int = 2

    def key(self):
        return (self.bs_start_freq, self.bs_stop_freq, self.bs_xover_band,
                self.bs_freq_scale, self.bs_alter_scale, self.bs_noise_bands)


class SBRData:
    """Per-channel SBR state (reference sbr.h:59-107)."""

    def __init__(self):
        self.bs_frame_class = 0
        self.bs_add_harmonic_flag = 0
        self.bs_num_env = 0
        self.bs_freq_res = np.zeros(7, np.int32)
        self.bs_num_noise = 0
        self.bs_df_env = np.zeros(5, np.int32)
        self.bs_df_noise = np.zeros(2, np.int32)
        self.bs_invf_mode = np.zeros((2, 5), np.int32)
        self.bs_add_harmonic = np.zeros(48, np.int32)
        self.bs_amp_res = 1
        # DSP state
        self.synthesis_filterbank_samples = np.zeros(2304, np.float32)
        self.synthesis_filterbank_samples_offset = 2304 - (1280 - 128)
        self.analysis_filterbank_samples = np.zeros(1312, np.float32)
        self.e_a = [0, -1]
        self.bw_array = np.zeros(5, np.float32)
        self.W = np.zeros((2, 32, 32, 2), np.float32)
        self.Y = np.zeros((2, 38, 64, 2), np.float32)
        self.g_temp = np.zeros((42, 48), np.float32)
        self.q_temp = np.zeros((42, 48), np.float32)
        self.s_indexmapped = np.zeros((8, 48), np.int32)
        self.env_facs = np.zeros((6, 48), np.float32)
        self.noise_facs = np.zeros((3, 5), np.float32)
        self.t_env = np.zeros(8, np.int32)
        self.t_env_num_env_old = 0
        self.t_q = np.zeros(3, np.int32)
        self.f_indexnoise = 0
        self.f_indexsine = 0


class SBRContext:
    """Per-element SBR state (reference sbr.h:112-183)."""

    def __init__(self):
        self.sample_rate = 0
        self.start = 0
        self.reset = 0
        self.spectrum_params = SpectrumParams()
        self.bs_amp_res_header = 1
        self.bs_limiter_bands = 2
        self.bs_limiter_gains = 2
        self.bs_interpol_freq = 1
        self.bs_smoothing_mode = 1
        self.bs_coupling = 0
        self.k = [0, 0, 0]           # k0, k1, k2
        self.kx = [32, 32]           # kx', kx (spec-typo init, aacsbr.c:130)
        self.m = [0, 0]
        self.n_master = 0
        self.data = [SBRData(), SBRData()]
        self.n = [0, 0]
        self.n_q = 0
        self.n_lim = 0
        self.f_master = np.zeros(49, np.int32)
        self.f_tablelow = np.zeros(25, np.int32)
        self.f_tablehigh = np.zeros(49, np.int32)
        self.f_tablenoise = np.zeros(6, np.int32)
        self.f_tablelim = np.zeros(29, np.int32)
        self.num_patches = 0
        self.patch_num_subbands = np.zeros(6, np.int32)
        self.patch_start_subband = np.zeros(6, np.int32)
        self.ps = None               # PSContext, attached by ps module
        # wire-v5 raw-rows capture (SCE elements: the dtdf..noise region
        # ships as raw bits and decodes on device, ops/sbr_huff; set by
        # _read_sbr_single_channel_element, consumed + cleared by
        # codec/qwire.build_side)
        self.wire_rows_fresh = 0
        self.wire_rows_bitoff = 0
        self.wire_rows_rbits = 0
        self.wire_rows_region = b""
        # this frame carried SBR data but in byte mode (uncoupled CPE or
        # an oversize coupled region): the side block must ship byte rows
        # even while the element is latched in rows mode
        self.wire_rows_datab = 0


# ---------------------------------------------------------------------------
# Frequency band tables (aacsbr.c:160-593)
# ---------------------------------------------------------------------------
def _make_bands(start: int, stop: int, num_bands: int) -> np.ndarray:
    """aacsbr.c:269-285 (float32 pow/round semantics preserved via lrintf)."""
    bands = np.zeros(num_bands, np.int64)
    base = np.float32(stop / start) ** np.float32(1.0 / num_bands)
    prod = np.float32(start)
    previous = start
    for k in range(num_bands - 1):
        prod = np.float32(prod * base)
        present = round(float(prod))
        bands[k] = present - previous
        previous = present
    bands[num_bands - 1] = stop - previous
    return bands


def sbr_make_f_master(sbr: SBRContext, spectrum: SpectrumParams) -> None:
    sr = sbr.sample_rate
    if sr < 32000:
        temp = 3000
    elif sr < 64000:
        temp = 4000
    else:
        temp = 5000
    start_min = ((temp << 7) + (sr >> 1)) // sr
    stop_min = ((temp << 8) + (sr >> 1)) // sr

    sbr_offset_row = {16000: 0, 22050: 1, 24000: 2, 32000: 3,
                      44100: 4, 48000: 4, 64000: 4,
                      88200: 5, 96000: 5, 128000: 5, 176400: 5, 192000: 5}
    if sr not in sbr_offset_row:
        raise BitstreamError(f"unsupported SBR sample rate {sr}")
    offsets = T.raw()["sbr_offset"][sbr_offset_row[sr]]

    sbr.k[0] = start_min + int(offsets[spectrum.bs_start_freq])

    if spectrum.bs_stop_freq < 14:
        sbr.k[2] = stop_min
        stop_dk = np.sort(_make_bands(stop_min, 64, 13))
        sbr.k[2] += int(stop_dk[: spectrum.bs_stop_freq].sum())
    elif spectrum.bs_stop_freq == 14:
        sbr.k[2] = 2 * sbr.k[0]
    else:
        sbr.k[2] = 3 * sbr.k[0]
    sbr.k[2] = min(64, sbr.k[2])

    if sr <= 32000:
        max_qmf_subbands = 48
    elif sr == 44100:
        max_qmf_subbands = 35
    else:
        max_qmf_subbands = 32
    if sbr.k[2] - sbr.k[0] > max_qmf_subbands:
        raise BitstreamError("too many QMF subbands")

    if not spectrum.bs_freq_scale:
        dk = spectrum.bs_alter_scale + 1
        n_master = ((sbr.k[2] - sbr.k[0] + (dk & 2)) >> dk) << 1
        _check_n_master(n_master, spectrum.bs_xover_band)
        fm = np.full(n_master + 1, dk, np.int64)
        k2diff = sbr.k[2] - sbr.k[0] - n_master * dk
        if k2diff < 0:
            fm[1] -= 1
            fm[2] -= k2diff < -1
        elif k2diff:
            fm[n_master] += 1
        fm[0] = sbr.k[0]
        sbr.n_master = n_master
        sbr.f_master[: n_master + 1] = np.cumsum(fm)
    else:
        half_bands = 7 - spectrum.bs_freq_scale
        if 49 * sbr.k[2] > 110 * sbr.k[0]:
            two_regions = 1
            sbr.k[1] = 2 * sbr.k[0]
        else:
            two_regions = 0
            sbr.k[1] = sbr.k[2]
        num_bands_0 = round(half_bands * np.log2(
            np.float32(sbr.k[1]) / np.float32(sbr.k[0])).astype(np.float32).item()) * 2
        if num_bands_0 <= 0:
            raise BitstreamError("invalid num_bands_0")
        vk0 = np.sort(_make_bands(sbr.k[0], sbr.k[1], num_bands_0))
        vdk0_max = int(vk0[-1])
        if (vk0 <= 0).any():
            raise BitstreamError("invalid vDk0")
        vk0 = np.concatenate([[sbr.k[0]], vk0]).cumsum()
        if two_regions:
            invwarp = 0.76923076923076923077 if spectrum.bs_alter_scale else 1.0
            num_bands_1 = round(half_bands * invwarp * np.log2(
                np.float32(sbr.k[2]) / np.float32(sbr.k[1])).astype(np.float32).item()) * 2
            vk1 = _make_bands(sbr.k[1], sbr.k[2], num_bands_1)
            vdk1_min = int(vk1.min())
            if vdk1_min < vdk0_max:
                vk1 = np.sort(vk1)
                change = min(vdk0_max - int(vk1[0]),
                             (int(vk1[-1]) - int(vk1[0])) >> 1)
                vk1[0] += change
                vk1[-1] -= change
            vk1 = np.sort(vk1)
            if (vk1 <= 0).any():
                raise BitstreamError("invalid vDk1")
            vk1 = np.concatenate([[sbr.k[1]], vk1]).cumsum()
            sbr.n_master = num_bands_0 + num_bands_1
            _check_n_master(sbr.n_master, spectrum.bs_xover_band)
            sbr.f_master[: num_bands_0 + 1] = vk0
            sbr.f_master[num_bands_0 + 1: sbr.n_master + 1] = vk1[1:]
        else:
            sbr.n_master = num_bands_0
            _check_n_master(sbr.n_master, spectrum.bs_xover_band)
            sbr.f_master[: num_bands_0 + 1] = vk0


def _check_n_master(n_master: int, bs_xover_band: int) -> None:
    if n_master <= 0:
        raise BitstreamError(f"invalid n_master {n_master}")
    if bs_xover_band >= n_master:
        raise BitstreamError("crossover band out of bounds")


def sbr_hf_calc_npatches(sbr: SBRContext) -> None:
    """aacsbr.c:491-539."""
    sb = 0
    msb = sbr.k[0]
    usb = sbr.kx[1]
    goal_sb = ((1000 << 11) + (sbr.sample_rate >> 1)) // sbr.sample_rate
    sbr.num_patches = 0
    if goal_sb < sbr.kx[1] + sbr.m[1]:
        k = 0
        while sbr.f_master[k] < goal_sb:
            k += 1
    else:
        k = sbr.n_master
    while True:
        odd = 0
        i = k
        first = True
        while first or sb > (sbr.k[0] - 1 + msb - odd):
            first = False
            sb = int(sbr.f_master[i])
            odd = (sb + sbr.k[0]) & 1
            i -= 1
        if sbr.num_patches > 5:
            raise BitstreamError("too many patches")
        sbr.patch_num_subbands[sbr.num_patches] = max(sb - usb, 0)
        sbr.patch_start_subband[sbr.num_patches] = (
            sbr.k[0] - odd - sbr.patch_num_subbands[sbr.num_patches])
        if sbr.patch_num_subbands[sbr.num_patches] > 0:
            usb = sb
            msb = sb
            sbr.num_patches += 1
        else:
            msb = sbr.kx[1]
        if sbr.f_master[k] - sb < 3:
            k = sbr.n_master
        if sb == sbr.kx[1] + sbr.m[1]:
            break
    if sbr.num_patches > 1 and sbr.patch_num_subbands[sbr.num_patches - 1] < 3:
        sbr.num_patches -= 1


def sbr_make_f_tablelim(sbr: SBRContext) -> None:
    """aacsbr.c:160-205."""
    if sbr.bs_limiter_bands > 0:
        bands_warped = [1.32715174233856803909, 1.18509277094158210129,
                        1.11987160404675912501]
        warp = bands_warped[sbr.bs_limiter_bands - 1]
        patch_borders = [int(sbr.kx[1])]
        for k in range(1, sbr.num_patches + 1):
            patch_borders.append(
                patch_borders[-1] + int(sbr.patch_num_subbands[k - 1]))
        lim = list(sbr.f_tablelow[: sbr.n[0] + 1])
        lim += patch_borders[1:sbr.num_patches]
        lim.sort()
        n_lim = sbr.n[0] + sbr.num_patches - 1
        # in-place merge walk (aacsbr.c:186-199)
        out = 0
        inp = 1
        while out < n_lim:
            if lim[inp] >= lim[out] * warp:
                out += 1
                lim[out] = lim[inp]
                inp += 1
            elif (lim[inp] == lim[out]
                  or lim[inp] not in patch_borders):
                inp += 1
                n_lim -= 1
            elif lim[out] not in patch_borders:
                lim[out] = lim[inp]
                inp += 1
                n_lim -= 1
            else:
                out += 1
                lim[out] = lim[inp]
                inp += 1
        sbr.n_lim = n_lim
        sbr.f_tablelim[: n_lim + 1] = lim[: n_lim + 1]
    else:
        sbr.f_tablelim[0] = sbr.f_tablelow[0]
        sbr.f_tablelim[1] = sbr.f_tablelow[sbr.n[0]]
        sbr.n_lim = 1


def sbr_make_f_derived(sbr: SBRContext) -> None:
    """aacsbr.c:542-593."""
    sp = sbr.spectrum_params
    sbr.n[1] = sbr.n_master - sp.bs_xover_band
    sbr.n[0] = (sbr.n[1] + 1) >> 1
    sbr.f_tablehigh[: sbr.n[1] + 1] = sbr.f_master[
        sp.bs_xover_band: sp.bs_xover_band + sbr.n[1] + 1]
    sbr.m[1] = int(sbr.f_tablehigh[sbr.n[1]] - sbr.f_tablehigh[0])
    sbr.kx[1] = int(sbr.f_tablehigh[0])
    if sbr.kx[1] + sbr.m[1] > 64:
        raise BitstreamError("stop frequency border too high")
    if sbr.kx[1] > 32:
        raise BitstreamError("start frequency border too high")
    sbr.f_tablelow[0] = sbr.f_tablehigh[0]
    temp = sbr.n[1] & 1
    for k in range(1, sbr.n[0] + 1):
        sbr.f_tablelow[k] = sbr.f_tablehigh[2 * k - temp]
    sbr.n_q = max(1, round(sp.bs_noise_bands * np.log2(
        np.float32(sbr.k[2]) / np.float32(sbr.kx[1])).astype(np.float32).item()))
    if sbr.n_q > 5:
        raise BitstreamError("too many noise floor scale factors")
    sbr.f_tablenoise[0] = sbr.f_tablelow[0]
    temp = 0
    for k in range(1, sbr.n_q + 1):
        temp += (sbr.n[0] - temp) // (sbr.n_q + 1 - k)
        sbr.f_tablenoise[k] = sbr.f_tablelow[temp]
    sbr_hf_calc_npatches(sbr)
    sbr_make_f_tablelim(sbr)
    sbr.data[0].f_indexnoise = 0
    sbr.data[1].f_indexnoise = 0


# ---------------------------------------------------------------------------
# Bitstream reading (aacsbr.c:207-1021)
# ---------------------------------------------------------------------------
def read_sbr_header(sbr: SBRContext, br: BitReader) -> None:
    sbr.start = 1
    old_key = sbr.spectrum_params.key()
    old_limiter_bands = sbr.bs_limiter_bands
    sp = sbr.spectrum_params
    sbr.bs_amp_res_header = br.get1()
    sp.bs_start_freq = br.get(4)
    sp.bs_stop_freq = br.get(4)
    sp.bs_xover_band = br.get(3)
    br.skip(2)
    extra1 = br.get1()
    extra2 = br.get1()
    if extra1:
        sp.bs_freq_scale = br.get(2)
        sp.bs_alter_scale = br.get1()
        sp.bs_noise_bands = br.get(2)
    else:
        sp.bs_freq_scale = 2
        sp.bs_alter_scale = 1
        sp.bs_noise_bands = 2
    if sp.key() != old_key:
        sbr.reset = 1
    if extra2:
        sbr.bs_limiter_bands = br.get(2)
        sbr.bs_limiter_gains = br.get(2)
        sbr.bs_interpol_freq = br.get1()
        sbr.bs_smoothing_mode = br.get1()
    else:
        sbr.bs_limiter_bands = 2
        sbr.bs_limiter_gains = 2
        sbr.bs_interpol_freq = 1
        sbr.bs_smoothing_mode = 1
    if sbr.bs_limiter_bands != old_limiter_bands and not sbr.reset:
        sbr_make_f_tablelim(sbr)


_CEIL_LOG2 = [0, 1, 2, 2, 3, 3]


def read_sbr_grid(sbr: SBRContext, br: BitReader, ch_data: SBRData) -> None:
    """aacsbr.c:609-749."""
    abs_bord_trail = 16
    bs_pointer = 0
    bs_num_env_old = ch_data.bs_num_env
    ch_data.bs_freq_res[0] = ch_data.bs_freq_res[ch_data.bs_num_env]
    ch_data.bs_amp_res = sbr.bs_amp_res_header
    ch_data.t_env_num_env_old = int(ch_data.t_env[bs_num_env_old])

    ch_data.bs_frame_class = br.get(2)
    if ch_data.bs_frame_class == FIXFIX:
        ch_data.bs_num_env = 1 << br.get(2)
        num_rel_lead = ch_data.bs_num_env - 1
        if ch_data.bs_num_env == 1:
            ch_data.bs_amp_res = 0
        if ch_data.bs_num_env > 4:
            raise BitstreamError("too many envelopes (FIXFIX)")
        ch_data.t_env[0] = 0
        ch_data.t_env[ch_data.bs_num_env] = abs_bord_trail
        abs_bord_trail = ((abs_bord_trail + (ch_data.bs_num_env >> 1)) //
                          ch_data.bs_num_env)
        for i in range(num_rel_lead):
            ch_data.t_env[i + 1] = ch_data.t_env[i] + abs_bord_trail
        ch_data.bs_freq_res[1] = br.get1()
        for i in range(1, ch_data.bs_num_env):
            ch_data.bs_freq_res[i + 1] = ch_data.bs_freq_res[1]
    elif ch_data.bs_frame_class == FIXVAR:
        abs_bord_trail += br.get(2)
        num_rel_trail = br.get(2)
        ch_data.bs_num_env = num_rel_trail + 1
        ch_data.t_env[0] = 0
        ch_data.t_env[ch_data.bs_num_env] = abs_bord_trail
        for i in range(num_rel_trail):
            ch_data.t_env[ch_data.bs_num_env - 1 - i] = (
                ch_data.t_env[ch_data.bs_num_env - i] - 2 * br.get(2) - 2)
        bs_pointer = br.get(_CEIL_LOG2[ch_data.bs_num_env])
        for i in range(ch_data.bs_num_env):
            ch_data.bs_freq_res[ch_data.bs_num_env - i] = br.get1()
    elif ch_data.bs_frame_class == VARFIX:
        ch_data.t_env[0] = br.get(2)
        num_rel_lead = br.get(2)
        ch_data.bs_num_env = num_rel_lead + 1
        ch_data.t_env[ch_data.bs_num_env] = abs_bord_trail
        for i in range(num_rel_lead):
            ch_data.t_env[i + 1] = ch_data.t_env[i] + 2 * br.get(2) + 2
        bs_pointer = br.get(_CEIL_LOG2[ch_data.bs_num_env])
        for i in range(ch_data.bs_num_env):
            ch_data.bs_freq_res[i + 1] = br.get1()
    else:  # VARVAR
        ch_data.t_env[0] = br.get(2)
        abs_bord_trail += br.get(2)
        num_rel_lead = br.get(2)
        num_rel_trail = br.get(2)
        ch_data.bs_num_env = num_rel_lead + num_rel_trail + 1
        if ch_data.bs_num_env > 5:
            raise BitstreamError("too many envelopes (VARVAR)")
        ch_data.t_env[ch_data.bs_num_env] = abs_bord_trail
        for i in range(num_rel_lead):
            ch_data.t_env[i + 1] = ch_data.t_env[i] + 2 * br.get(2) + 2
        for i in range(num_rel_trail):
            ch_data.t_env[ch_data.bs_num_env - 1 - i] = (
                ch_data.t_env[ch_data.bs_num_env - i] - 2 * br.get(2) - 2)
        bs_pointer = br.get(_CEIL_LOG2[ch_data.bs_num_env])
        for i in range(ch_data.bs_num_env):
            ch_data.bs_freq_res[i + 1] = br.get1()

    if bs_pointer > ch_data.bs_num_env + 1:
        raise BitstreamError("bs_pointer out of range")
    for i in range(1, ch_data.bs_num_env + 1):
        if ch_data.t_env[i - 1] > ch_data.t_env[i]:
            raise BitstreamError("non-monotone time borders")

    ch_data.bs_num_noise = (ch_data.bs_num_env > 1) + 1
    ch_data.t_q[0] = ch_data.t_env[0]
    ch_data.t_q[ch_data.bs_num_noise] = ch_data.t_env[ch_data.bs_num_env]
    if ch_data.bs_num_noise > 1:
        if ch_data.bs_frame_class == FIXFIX:
            idx = ch_data.bs_num_env >> 1
        elif ch_data.bs_frame_class & 1:  # FIXVAR / VARVAR
            if bs_pointer == 0:
                # faithful reproduction of the reference's unsigned
                # underflow: bs_num_env - FFMAX(0u-1, 1) wraps to
                # bs_num_env + 1, picking up a stale t_env entry
                # (aacsbr.c:729 with unsigned bs_pointer)
                idx = ch_data.bs_num_env + 1
            else:
                idx = ch_data.bs_num_env - max(bs_pointer - 1, 1)
        else:  # VARFIX
            if not bs_pointer:
                idx = 1
            elif bs_pointer == 1:
                idx = ch_data.bs_num_env - 1
            else:
                idx = bs_pointer - 1
        ch_data.t_q[1] = ch_data.t_env[idx]

    ch_data.e_a[0] = -int(ch_data.e_a[1] != bs_num_env_old)
    ch_data.e_a[1] = -1
    if (ch_data.bs_frame_class & 1) and bs_pointer:
        ch_data.e_a[1] = ch_data.bs_num_env + 1 - bs_pointer
    elif ch_data.bs_frame_class == VARFIX and bs_pointer > 1:
        ch_data.e_a[1] = bs_pointer - 1


def copy_sbr_grid(dst: SBRData, src: SBRData) -> None:
    """aacsbr.c:751-766."""
    dst.bs_freq_res[0] = dst.bs_freq_res[dst.bs_num_env]
    dst.t_env_num_env_old = int(dst.t_env[dst.bs_num_env])
    dst.e_a[0] = -int(dst.e_a[1] != dst.bs_num_env)
    dst.bs_freq_res[1:] = src.bs_freq_res[1:]
    dst.t_env[:] = src.t_env
    dst.t_q[:] = src.t_q
    dst.bs_num_env = src.bs_num_env
    dst.bs_amp_res = src.bs_amp_res
    dst.bs_num_noise = src.bs_num_noise
    dst.bs_frame_class = src.bs_frame_class
    dst.e_a[1] = src.e_a[1]


def read_sbr_dtdf(sbr: SBRContext, br: BitReader, ch_data: SBRData) -> None:
    for i in range(ch_data.bs_num_env):
        ch_data.bs_df_env[i] = br.get1()
    for i in range(ch_data.bs_num_noise):
        ch_data.bs_df_noise[i] = br.get1()


def read_sbr_invf(sbr: SBRContext, br: BitReader, ch_data: SBRData) -> None:
    ch_data.bs_invf_mode[1] = ch_data.bs_invf_mode[0].copy()
    for i in range(sbr.n_q):
        ch_data.bs_invf_mode[0][i] = br.get(2)


def read_sbr_envelope(sbr: SBRContext, br: BitReader, ch_data: SBRData,
                      ch: int) -> None:
    """aacsbr.c:787-854."""
    vlcs = sbr_vlcs()
    delta = (1 if (ch == 1 and sbr.bs_coupling == 1) else 0) + 1
    odd = sbr.n[1] & 1
    if sbr.bs_coupling and ch:
        if ch_data.bs_amp_res:
            bits, (t_huff, t_lav), (f_huff, f_lav) = 5, vlcs[T_BAL30], vlcs[F_BAL30]
        else:
            bits, (t_huff, t_lav), (f_huff, f_lav) = 6, vlcs[T_BAL15], vlcs[F_BAL15]
    else:
        if ch_data.bs_amp_res:
            bits, (t_huff, t_lav), (f_huff, f_lav) = 6, vlcs[T_ENV30], vlcs[F_ENV30]
        else:
            bits, (t_huff, t_lav), (f_huff, f_lav) = 7, vlcs[T_ENV15], vlcs[F_ENV15]

    ef = ch_data.env_facs
    for i in range(ch_data.bs_num_env):
        if ch_data.bs_df_env[i]:
            if ch_data.bs_freq_res[i + 1] == ch_data.bs_freq_res[i]:
                for j in range(sbr.n[ch_data.bs_freq_res[i + 1]]):
                    ef[i + 1][j] = ef[i][j] + delta * (t_huff.decode(br) - t_lav)
            elif ch_data.bs_freq_res[i + 1]:
                for j in range(sbr.n[ch_data.bs_freq_res[i + 1]]):
                    k = (j + odd) >> 1
                    ef[i + 1][j] = ef[i][k] + delta * (t_huff.decode(br) - t_lav)
            else:
                for j in range(sbr.n[ch_data.bs_freq_res[i + 1]]):
                    k = 2 * j - odd if j else 0
                    ef[i + 1][j] = ef[i][k] + delta * (t_huff.decode(br) - t_lav)
        else:
            ef[i + 1][0] = delta * br.get(bits)
            for j in range(1, sbr.n[ch_data.bs_freq_res[i + 1]]):
                ef[i + 1][j] = ef[i + 1][j - 1] + delta * (f_huff.decode(br) - f_lav)
    ef[0][:] = ef[ch_data.bs_num_env]


def read_sbr_noise(sbr: SBRContext, br: BitReader, ch_data: SBRData,
                   ch: int) -> None:
    """aacsbr.c:856-890."""
    vlcs = sbr_vlcs()
    delta = (1 if (ch == 1 and sbr.bs_coupling == 1) else 0) + 1
    if sbr.bs_coupling and ch:
        (t_huff, t_lav), (f_huff, f_lav) = vlcs[T_NOISEBAL30], vlcs[F_BAL30]
    else:
        (t_huff, t_lav), (f_huff, f_lav) = vlcs[T_NOISE30], vlcs[F_ENV30]
    nf = ch_data.noise_facs
    for i in range(ch_data.bs_num_noise):
        if ch_data.bs_df_noise[i]:
            for j in range(sbr.n_q):
                nf[i + 1][j] = nf[i][j] + delta * (t_huff.decode(br) - t_lav)
        else:
            nf[i + 1][0] = delta * br.get(5)
            for j in range(1, sbr.n_q):
                nf[i + 1][j] = nf[i + 1][j - 1] + delta * (f_huff.decode(br) - f_lav)
    nf[0][:] = nf[ch_data.bs_num_noise]


def _capture_rows_region(sbr: SBRContext, br: BitReader,
                         rows_start: int) -> None:
    """Capture the byte-aligned dtdf..noise raw region ending at the
    current position for device decode (wire v5, ops/sbr_huff); clears
    `wire_rows_fresh` when the region exceeds the 640 B budget."""
    b0 = rows_start >> 3
    rbits = br.pos - 8 * b0
    nby = (rbits + 7) // 8
    if nby <= 640:
        shift = br.nbits - 8 * b0 - 8 * nby
        v = br._val >> shift if shift >= 0 else br._val << -shift
        sbr.wire_rows_region = (v & ((1 << (8 * nby)) - 1)).to_bytes(
            nby, "big")
        sbr.wire_rows_bitoff = rows_start & 7
        sbr.wire_rows_rbits = rbits
        sbr.wire_rows_fresh = 1
        sbr.wire_rows_datab = 0
    else:
        sbr.wire_rows_fresh = 0
        sbr.wire_rows_datab = 1


def _read_sbr_single_channel_element(dec, sbr: SBRContext, br: BitReader) -> None:
    if br.get1():
        br.skip(4)
    read_sbr_grid(sbr, br, sbr.data[0])
    rows_start = br.pos
    read_sbr_dtdf(sbr, br, sbr.data[0])
    read_sbr_invf(sbr, br, sbr.data[0])
    read_sbr_envelope(sbr, br, sbr.data[0], 0)
    read_sbr_noise(sbr, br, sbr.data[0], 0)
    # wire-v5 raw-rows capture (codec/qwire SBR side block): the
    # dtdf..noise region ships as raw bits for device decode
    # (ops/sbr_huff); 640 B bounds the legal single-channel worst case
    # (dtdf 7 + invf 10 + 5 env rows x 947 + 2 noise rows x 85 + phase
    # = 4929 bits = 617 B)
    _capture_rows_region(sbr, br, rows_start)
    sbr.data[0].bs_add_harmonic_flag = br.get1()
    if sbr.data[0].bs_add_harmonic_flag:
        for i in range(sbr.n[1]):
            sbr.data[0].bs_add_harmonic[i] = br.get1()


def _read_sbr_channel_pair_element(dec, sbr: SBRContext, br: BitReader) -> None:
    if br.get1():
        br.skip(8)
    sbr.bs_coupling = br.get1()
    if sbr.bs_coupling:
        read_sbr_grid(sbr, br, sbr.data[0])
        copy_sbr_grid(sbr.data[1], sbr.data[0])
        rows_start = br.pos
        read_sbr_dtdf(sbr, br, sbr.data[0])
        read_sbr_dtdf(sbr, br, sbr.data[1])
        read_sbr_invf(sbr, br, sbr.data[0])
        sbr.data[1].bs_invf_mode[1] = sbr.data[1].bs_invf_mode[0].copy()
        sbr.data[1].bs_invf_mode[0] = sbr.data[0].bs_invf_mode[0].copy()
        read_sbr_envelope(sbr, br, sbr.data[0], 0)
        read_sbr_noise(sbr, br, sbr.data[0], 0)
        read_sbr_envelope(sbr, br, sbr.data[1], 1)
        read_sbr_noise(sbr, br, sbr.data[1], 1)
        # wire-v5 raw-rows capture, coupled CPE (both channels chained:
        # dtdf0 dtdf1 invf env0 noise0 env1(bal) noise1(bal)); the legal
        # coupled worst case exceeds the 640 B budget, so oversize frames
        # demote to byte mode for THIS frame (wire_rows_datab)
        _capture_rows_region(sbr, br, rows_start)
    else:
        read_sbr_grid(sbr, br, sbr.data[0])
        read_sbr_grid(sbr, br, sbr.data[1])
        read_sbr_dtdf(sbr, br, sbr.data[0])
        read_sbr_dtdf(sbr, br, sbr.data[1])
        read_sbr_invf(sbr, br, sbr.data[0])
        read_sbr_invf(sbr, br, sbr.data[1])
        read_sbr_envelope(sbr, br, sbr.data[0], 0)
        read_sbr_envelope(sbr, br, sbr.data[1], 1)
        read_sbr_noise(sbr, br, sbr.data[0], 0)
        read_sbr_noise(sbr, br, sbr.data[1], 1)
        # uncoupled frames interleave per-channel grids; keep byte mode
        sbr.wire_rows_fresh = 0
        sbr.wire_rows_datab = 1
    for ch in (0, 1):
        sbr.data[ch].bs_add_harmonic_flag = br.get1()
        if sbr.data[ch].bs_add_harmonic_flag:
            for i in range(sbr.n[1]):
                sbr.data[ch].bs_add_harmonic[i] = br.get1()


def _read_sbr_data(dec, sbr: SBRContext, br: BitReader, id_aac: int) -> None:
    from ..tables.aac_tables import TYPE_CCE, TYPE_CPE, TYPE_SCE
    try:
        if id_aac in (TYPE_SCE, TYPE_CCE):
            _read_sbr_single_channel_element(dec, sbr, br)
        elif id_aac == TYPE_CPE:
            _read_sbr_channel_pair_element(dec, sbr, br)
        else:
            sbr.start = 0
            return
    except BitstreamError:
        sbr.start = 0
        raise
    if br.get1():  # bs_extended_data
        num_bits_left = br.get(4)
        if num_bits_left == 15:
            num_bits_left += br.get(8)
        num_bits_left <<= 3
        while num_bits_left > 7:
            num_bits_left -= 2
            ext_id = br.get(2)
            num_bits_left = _read_sbr_extension(dec, sbr, br, ext_id,
                                                num_bits_left)
        if num_bits_left > 0:
            br.skip(num_bits_left)


def _read_sbr_extension(dec, sbr: SBRContext, br: BitReader,
                        bs_extension_id: int, num_bits_left: int) -> int:
    EXTENSION_ID_PS = 2
    if bs_extension_id == EXTENSION_ID_PS and dec.m4ac.ps:
        from . import ps_syntax
        if sbr.ps is None:
            sbr.ps = ps_syntax.PSContext()
        num_bits_left -= ps_syntax.read_ps_data(sbr.ps, br, num_bits_left)
    else:
        br.skip(num_bits_left)
        num_bits_left = 0
    return num_bits_left


def decode_sbr_extension(dec, br: BitReader, che, crc: bool, cnt: int,
                         elem_type_prev: int) -> int:
    """Entry from the FIL element loop (aacsbr.c:1044-1086).

    Consumes exactly cnt bytes of the fill payload (4 bits of extension
    type were already read by the caller).
    """
    if che.sbr is None:
        che.sbr = SBRContext()
    sbr: SBRContext = che.sbr
    end_pos = br.pos + cnt * 8 - 4

    sbr.reset = 0
    if not sbr.sample_rate:
        sbr.sample_rate = 2 * dec.m4ac.sample_rate
    if not dec.m4ac.ext_sample_rate:
        dec.m4ac.ext_sample_rate = 2 * dec.m4ac.sample_rate

    if crc:
        br.skip(10)

    sbr.kx[0] = sbr.kx[1]
    sbr.m[0] = sbr.m[1]

    try:
        if br.get1():  # bs_header_flag
            read_sbr_header(sbr, br)
        if sbr.reset:
            try:
                sbr_make_f_master(sbr, sbr.spectrum_params)
                sbr_make_f_derived(sbr)
            except BitstreamError:
                # fall back to pure upsampling mode (aacsbr.c:1030-1033)
                sbr.start = 0
        if sbr.start:
            try:
                _read_sbr_data(dec, sbr, br, elem_type_prev)
            except BitstreamError:
                # reference logs and continues without SBR (aacsbr.c:988-996)
                sbr.start = 0
    finally:
        br.pos = end_pos
    return cnt


def sbr_dequant(sbr: SBRContext, id_aac: int) -> None:
    """aacsbr.c:1089-1128 (float32 exp2 semantics)."""
    from ..tables.aac_tables import TYPE_CPE
    exp2 = lambda x: np.exp2(np.float32(x), dtype=np.float32)
    if id_aac == TYPE_CPE and sbr.bs_coupling:
        alpha = np.float32(1.0 if sbr.data[0].bs_amp_res else 0.5)
        pan_offset = np.float32(12.0 if sbr.data[0].bs_amp_res else 24.0)
        for e in range(1, sbr.data[0].bs_num_env + 1):
            for k in range(sbr.n[sbr.data[0].bs_freq_res[e]]):
                temp1 = exp2(sbr.data[0].env_facs[e][k] * alpha + 7.0)
                temp2 = exp2((pan_offset - sbr.data[1].env_facs[e][k]) * alpha)
                fac = np.float32(temp1 / (np.float32(1.0) + temp2))
                sbr.data[0].env_facs[e][k] = fac
                sbr.data[1].env_facs[e][k] = np.float32(fac * temp2)
        for e in range(1, sbr.data[0].bs_num_noise + 1):
            for k in range(sbr.n_q):
                temp1 = exp2(NOISE_FLOOR_OFFSET - sbr.data[0].noise_facs[e][k] + 1)
                temp2 = exp2(12 - sbr.data[1].noise_facs[e][k])
                fac = np.float32(temp1 / (np.float32(1.0) + temp2))
                sbr.data[0].noise_facs[e][k] = fac
                sbr.data[1].noise_facs[e][k] = np.float32(fac * temp2)
    else:
        for ch in range(2 if id_aac == TYPE_CPE else 1):
            d = sbr.data[ch]
            alpha = np.float32(1.0 if d.bs_amp_res else 0.5)
            for e in range(1, d.bs_num_env + 1):
                for k in range(sbr.n[d.bs_freq_res[e]]):
                    d.env_facs[e][k] = exp2(alpha * d.env_facs[e][k] + 6.0)
            for e in range(1, d.bs_num_noise + 1):
                for k in range(sbr.n_q):
                    d.noise_facs[e][k] = exp2(
                        NOISE_FLOOR_OFFSET - d.noise_facs[e][k])
