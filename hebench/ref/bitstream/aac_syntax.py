"""AAC raw_data_block parsing + all spectral-domain tools (host side).

This is the host half of the decoder: everything from bitstream bits down to
final per-channel dequantized spectra (float32 [1024]) plus window metadata.
The device half (IMDCT, windowing/overlap-add, SBR, PS) consumes only dense
arrays produced here.

Mirrors reference behavior at:
* element loop / syntax:   libavcodec/aacdec.c:1973-2076
* ICS info:                aacdec.c:645-710
* band types/scalefactors: aacdec.c:720-822
* pulses/TNS syntax:       aacdec.c:827-887
* spectrum + dequant:      aacdec.c:988-1245
* M/S, intensity:          aacdec.c:1390-1451
* CCE:                     aacdec.c:1503-1567
* AAC-Main prediction:     aacdec.c:1247-1322
* TNS filter:              aacdec.c:1698-1736 (applied host-side here; in the
  reference it runs in spectral_to_sample, but it is spectral-domain serial
  work that belongs on the host in a TPU-first split)

Scaling contract: "no-bias" flavor (aacdec.c:577-581): sf_offset=60, so
float PCM comes out in +/-32768 and int16 conversion is plain round+clip.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..tables import aac_tables as T
from .reader import BitReader, BitstreamError
from .vlc import VLC

# ---------------------------------------------------------------------------
# VLC tables (built once)
# ---------------------------------------------------------------------------
_vlc_cache: dict[str, VLC] = {}


def _sf_vlc() -> VLC:
    if "sf" not in _vlc_cache:
        _vlc_cache["sf"] = VLC(*T.scalefactor_codes(), name="scalefactor")
    return _vlc_cache["sf"]


def _spec_vlc(cb: int) -> VLC:
    key = f"spec{cb}"
    if key not in _vlc_cache:
        _vlc_cache[key] = VLC(*T.spectral_codes(cb), name=f"spectral{cb}")
    return _vlc_cache[key]


# ---------------------------------------------------------------------------
# Data structures
# ---------------------------------------------------------------------------
@dataclass
class IcsInfo:
    window_sequence: int = T.ONLY_LONG
    window_sequence_prev: int = T.ONLY_LONG
    use_kb_window: int = 0
    use_kb_window_prev: int = 0
    max_sfb: int = 0
    num_windows: int = 1
    num_window_groups: int = 1
    group_len: list[int] = field(default_factory=lambda: [1])
    swb_offset: np.ndarray | None = None
    num_swb: int = 0
    tns_max_bands: int = 0
    predictor_present: int = 0
    predictor_reset_group: int = 0
    prediction_used: np.ndarray | None = None


@dataclass
class TnsData:
    present: int = 0
    n_filt: list = field(default_factory=list)          # per window
    length: list = field(default_factory=list)          # [w][filt]
    direction: list = field(default_factory=list)
    order: list = field(default_factory=list)
    coef: list = field(default_factory=list)            # [w][filt] -> np array


@dataclass
class ChannelData:
    """Parsed + dequantized single channel of one frame."""
    ics: IcsInfo = field(default_factory=IcsInfo)
    tns: TnsData = field(default_factory=TnsData)
    band_type: np.ndarray | None = None      # [120] int
    band_type_run_end: np.ndarray | None = None
    sf: np.ndarray | None = None              # [120] float32
    coeffs: np.ndarray | None = None           # [1024] float32


@dataclass
class CceData:
    coupling_point: int = 0
    num_coupled: int = 0
    type: list = field(default_factory=list)
    id_select: list = field(default_factory=list)
    ch_select: list = field(default_factory=list)
    gain: np.ndarray | None = None  # [16][120] float32


class ChannelElement:
    """Persistent per-(type,id) element state across frames."""

    def __init__(self):
        self.ch = [PersistentChannelState(), PersistentChannelState()]
        self.sbr = None          # SBRContext, attached lazily
        # per-frame parse results:
        self.cur: list[ChannelData] = [ChannelData(), ChannelData()]
        self.ms_mask: np.ndarray | None = None
        self.coup: CceData | None = None
        self.present_this_frame = False


class PersistentChannelState:
    def __init__(self):
        self.window_sequence_prev = T.ONLY_LONG
        self.use_kb_window_prev = 0
        self.predictor_state = None       # np [672, 6] float32 (AAC Main)
        self.predictor_initialized = False


# ---------------------------------------------------------------------------
# ICS info
# ---------------------------------------------------------------------------
def decode_ics_info(br: BitReader, ics: IcsInfo, sampling_index: int,
                    object_type: int, common_window: int) -> None:
    if br.get1():
        raise BitstreamError("reserved bit set in ics_info")
    ics.window_sequence_prev = ics.window_sequence
    ics.window_sequence = br.get(2)
    ics.use_kb_window_prev = ics.use_kb_window
    ics.use_kb_window = br.get1()
    ics.num_window_groups = 1
    ics.group_len = [1]
    if ics.window_sequence == T.EIGHT_SHORT:
        ics.max_sfb = br.get(4)
        for _ in range(7):
            if br.get1():
                ics.group_len[-1] += 1
            else:
                ics.group_len.append(1)
        ics.num_window_groups = len(ics.group_len)
        ics.num_windows = 8
        ics.swb_offset = T.swb_offset_128(sampling_index)
        ics.num_swb = T.num_swb_128(sampling_index)
        ics.tns_max_bands = T.tns_max_bands(sampling_index, True)
        ics.predictor_present = 0
    else:
        ics.max_sfb = br.get(6)
        ics.num_windows = 1
        ics.swb_offset = T.swb_offset_1024(sampling_index)
        ics.num_swb = T.num_swb_1024(sampling_index)
        ics.tns_max_bands = T.tns_max_bands(sampling_index, False)
        ics.predictor_present = br.get1()
        ics.predictor_reset_group = 0
        if ics.predictor_present:
            if object_type == 1:  # AAC Main
                if br.get1():
                    ics.predictor_reset_group = br.get(5)
                    if not 1 <= ics.predictor_reset_group <= 30:
                        raise BitstreamError("invalid predictor reset group")
                nmax = min(ics.max_sfb, T.pred_sfb_max(sampling_index))
                ics.prediction_used = np.array(
                    [br.get1() for _ in range(nmax)], np.int32)
            else:
                raise BitstreamError("prediction not allowed for this AOT")
    if ics.max_sfb > ics.num_swb:
        raise BitstreamError(
            f"max_sfb {ics.max_sfb} > num_swb {ics.num_swb}")


# ---------------------------------------------------------------------------
# Section / scalefactor data
# ---------------------------------------------------------------------------
def decode_band_types(br: BitReader, ics: IcsInfo):
    band_type = np.zeros(120, np.int32)
    run_end = np.zeros(120, np.int32)
    bits = 3 if ics.window_sequence == T.EIGHT_SHORT else 5
    esc = (1 << bits) - 1
    idx = 0
    for _g in range(ics.num_window_groups):
        k = 0
        while k < ics.max_sfb:
            sect_end = k
            sect_band_type = br.get(4)
            if sect_band_type == 12:
                raise BitstreamError("invalid band type 12")
            while True:
                sect_len_incr = br.get(bits)
                sect_end += sect_len_incr
                if sect_len_incr != esc:
                    break
            if br.bits_left() < 0:
                raise BitstreamError("overread in band types")
            if sect_end > ics.max_sfb:
                raise BitstreamError("section beyond max_sfb")
            while k < sect_end:
                band_type[idx] = sect_band_type
                run_end[idx] = sect_end
                idx += 1
                k += 1
    return band_type, run_end


SF_OFFSET = 60  # no-bias output path (aacdec.c:580)

# When set (by the qwire planner), decode_ics records the spectral
# section's per-band bit positions so the emitter can ship the raw bits
# (wire v4 spec-mode lanes, ops/spec_huff.py).
CAPTURE_SPEC = False


def decode_scalefactors(br: BitReader, global_gain: int, ics: IcsInfo,
                        band_type, run_end) -> np.ndarray:
    pow2sf = T.pow2sf_tab()
    sf = np.zeros(120, np.float32)
    sf_off = SF_OFFSET + (12 if ics.window_sequence == T.EIGHT_SHORT else 0)
    offset = [global_gain, global_gain - 90, 100]
    noise_flag = 1
    vlc = _sf_vlc()
    idx = 0
    for _g in range(ics.num_window_groups):
        i = 0
        while i < ics.max_sfb:
            bt = band_type[idx]
            end = run_end[idx]
            if bt == T.ZERO_BT:
                while i < end:
                    sf[idx] = 0.0
                    i += 1
                    idx += 1
            elif bt in (T.INTENSITY_BT, T.INTENSITY_BT2):
                while i < end:
                    offset[2] += vlc.decode(br) - 60
                    if not 0 <= offset[2] <= 255:
                        raise BitstreamError("intensity position out of range")
                    sf[idx] = pow2sf[-offset[2] + 300]
                    i += 1
                    idx += 1
            elif bt == T.NOISE_BT:
                while i < end:
                    if noise_flag > 0:
                        noise_flag -= 1
                        offset[1] += br.get(9) - 256
                    else:
                        offset[1] += vlc.decode(br) - 60
                    if not 0 <= offset[1] <= 255:
                        raise BitstreamError("noise gain out of range")
                    sf[idx] = -pow2sf[offset[1] + sf_off + 100]
                    i += 1
                    idx += 1
            else:
                while i < end:
                    offset[0] += vlc.decode(br) - 60
                    if not 0 <= offset[0] <= 255:
                        raise BitstreamError("global gain out of range")
                    sf[idx] = -pow2sf[offset[0] + sf_off]
                    i += 1
                    idx += 1
    return sf


# ---------------------------------------------------------------------------
# Pulses / TNS syntax
# ---------------------------------------------------------------------------
def decode_pulses(br: BitReader, swb_offset, num_swb):
    num_pulse = br.get(2) + 1
    pulse_swb = br.get(6)
    if pulse_swb >= num_swb:
        raise BitstreamError("pulse swb out of range")
    pos = [int(swb_offset[pulse_swb]) + br.get(5)]
    if pos[0] > 1023:
        raise BitstreamError("pulse position out of range")
    amp = [br.get(4)]
    for _ in range(1, num_pulse):
        p = br.get(5) + pos[-1]
        if p > 1023:
            raise BitstreamError("pulse position out of range")
        pos.append(p)
        amp.append(br.get(4))
    return pos, amp


def decode_tns(br: BitReader, ics: IcsInfo, object_type: int) -> TnsData:
    tns = TnsData(present=1)
    is8 = ics.window_sequence == T.EIGHT_SHORT
    tns_max_order = 7 if is8 else (20 if object_type == 1 else 12)
    for _w in range(ics.num_windows):
        n_filt = br.get(2 - is8)
        tns.n_filt.append(n_filt)
        lengths, dirs, orders, coefs = [], [], [], []
        if n_filt:
            coef_res = br.get1()
            for _f in range(n_filt):
                lengths.append(br.get(6 - 2 * is8))
                order = br.get(5 - 2 * is8)
                if order > tns_max_order:
                    raise BitstreamError(f"TNS order {order} too high")
                orders.append(order)
                if order:
                    dirs.append(br.get1())
                    coef_compress = br.get1()
                    coef_len = coef_res + 3 - coef_compress
                    tmp2 = T.tns_tmp2_map(coef_compress, coef_res)
                    coefs.append(np.array(
                        [tmp2[br.get(coef_len)] for _ in range(order)],
                        np.float32))
                else:
                    dirs.append(0)
                    coefs.append(np.zeros(0, np.float32))
        tns.length.append(lengths)
        tns.direction.append(dirs)
        tns.order.append(orders)
        tns.coef.append(coefs)
    return tns


# ---------------------------------------------------------------------------
# Spectrum decode + dequant (the hot VLC loop; aacdec.c:988-1245)
# ---------------------------------------------------------------------------
def decode_spectrum_and_dequant(br: BitReader, sf, ics: IcsInfo, band_type,
                                rng, bandpos: list | None = None
                                ) -> np.ndarray:
    coef = np.zeros(1024, np.float32)
    icoef = coef.view(np.uint32)
    offsets = ics.swb_offset
    cbrt = T.cbrt_tab()
    idx = 0
    g_base = 0
    for g in range(ics.num_window_groups):
        g_len = ics.group_len[g]
        for i in range(ics.max_sfb):
            if bandpos is not None:
                bandpos.append(br.pos)
            bt = int(band_type[idx])
            off = int(offsets[i])
            off_len = int(offsets[i + 1]) - off
            if bt in (T.INTENSITY_BT, T.INTENSITY_BT2, T.ZERO_BT):
                pass  # already zero; intensity filled later from ch0
            elif bt == T.NOISE_BT:
                for group in range(g_len):
                    base = g_base + group * 128 + off
                    band = np.empty(off_len, np.float32)
                    for k in range(off_len):
                        rng[0] = (rng[0] * 1664525 + 1013904223) & 0xFFFFFFFF
                        band[k] = np.float32(np.int32(rng[0]))
                    # serial float32 dot as scalarproduct_float_c
                    e = np.float32(0.0)
                    for k in range(off_len):
                        e = np.float32(e + band[k] * band[k])
                    scale = np.float32(sf[idx] / np.sqrt(e, dtype=np.float32))
                    coef[base:base + off_len] = band * scale
            else:
                vlc = _spec_vlc(bt)
                tuples = T.codebook_tuples(bt)
                dim, _lav, signed = T.CODEBOOK_INFO[bt]
                s = np.float32(sf[idx])
                for group in range(g_len):
                    base = g_base + group * 128 + off
                    k = 0
                    while k < off_len:
                        code = vlc.decode(br)
                        vals = tuples[code]
                        if bt == T.ESC_BT and code == 0:
                            # all-zero pair fast path (aacdec.c:1160-1164)
                            icoef[base + k] = 0
                            icoef[base + k + 1] = 0
                            k += 2
                            continue
                        if not signed:
                            out = np.zeros(dim, np.float32)
                            # sign bits for all nonzero values come first,
                            # in spectral order (aacdec.c:1085,1137,1174)
                            negs = [br.get1() if v else 0 for v in vals]
                            for j in range(dim):
                                v = int(vals[j])
                                if v == 0:
                                    continue
                                if bt == T.ESC_BT and v == 16:
                                    # escape: N leading 1s, 0, then (N+4)-bit
                                    # mantissa (aacdec.c:1177-1201)
                                    b = 0
                                    while br.get1():
                                        b += 1
                                    if b > 8:
                                        raise BitstreamError("ESC overflow")
                                    b += 4
                                    v = (1 << b) + br.get(b)
                                out[j] = -cbrt[v] if negs[j] else cbrt[v]
                            coef[base + k:base + k + dim] = out * s
                        else:
                            mags = cbrt[np.abs(vals)]
                            mags = np.where(vals < 0, -mags, mags).astype(np.float32)
                            coef[base + k:base + k + dim] = mags * s
                        k += dim
            idx += 1
        g_base += g_len * 128
    if bandpos is not None:
        bandpos.append(br.pos)
    return coef


def apply_pulses(coef: np.ndarray, pos, amp, sf, band_type, offsets) -> None:
    """aacdec.c:1222-1237 (applies only to long windows)."""
    idx = 0
    for i in range(len(pos)):
        co = np.float32(coef[pos[i]])
        while offsets[idx + 1] <= pos[i]:
            idx += 1
        if band_type[idx] != T.NOISE_BT and sf[idx]:
            ico = np.float32(-amp[i])
            if co:
                co = np.float32(co / sf[idx])
                adj = np.float32(co / np.sqrt(np.sqrt(np.abs(co))))
                ico = np.float32(adj + (-ico if co > 0 else ico))
            coef[pos[i]] = np.float32(
                np.cbrt(np.abs(ico)) * ico * sf[idx])


# ---------------------------------------------------------------------------
# individual_channel_stream
# ---------------------------------------------------------------------------
def decode_ics(br: BitReader, cd: ChannelData, sampling_index: int,
               object_type: int, common_window: int, rng) -> None:
    ics = cd.ics
    global_gain = br.get(8)
    if not common_window:
        decode_ics_info(br, ics, sampling_index, object_type, 0)
    cd.band_type, cd.band_type_run_end = decode_band_types(br, ics)
    sfpos0 = br.pos
    cd.sf = decode_scalefactors(br, global_gain, ics, cd.band_type,
                                cd.band_type_run_end)
    # sf-region bit span for the raw-bits wire mode (the device decodes
    # the bitstream's own sf-huffman chain, ops/spec_huff.py)
    cd.spec_sfpos = (sfpos0, br.pos) if CAPTURE_SPEC else None
    pulse = None
    if br.get1():
        if ics.window_sequence == T.EIGHT_SHORT:
            raise BitstreamError("pulses with eight-short sequence")
        pulse = decode_pulses(br, ics.swb_offset, ics.num_swb)
    if br.get1():
        cd.tns = decode_tns(br, ics, object_type)
    else:
        cd.tns = TnsData()
    if br.get1():
        raise BitstreamError("SSR gain control not supported")
    bandpos = [] if CAPTURE_SPEC else None
    cd.coeffs = decode_spectrum_and_dequant(br, cd.sf, ics, cd.band_type,
                                            rng, bandpos)
    # the raw-bits wire mode is only valid when nothing rewrites the
    # decoded spectrum after the VLC loop (EIGHT_SHORT frames ship a
    # grouping byte and the device de-interleaves, ops/spec_huff.py)
    clean = (pulse is None and not cd.tns.present)
    cd.spec_bandpos = bandpos if clean else None
    cd.pulse_present = pulse is not None
    if pulse is not None:
        apply_pulses(cd.coeffs, pulse[0], pulse[1], cd.sf, cd.band_type,
                     ics.swb_offset)


# ---------------------------------------------------------------------------
# Stereo tools (aacdec.c:1390-1451)
# ---------------------------------------------------------------------------
def apply_mid_side_stereo(cpe: ChannelElement) -> None:
    ch0, ch1 = cpe.cur[0], cpe.cur[1]
    ics = ch0.ics
    offsets = ics.swb_offset
    ms = cpe.ms_mask
    idx = 0
    base = 0
    for g in range(ics.num_window_groups):
        for i in range(ics.max_sfb):
            if (ms[idx] and ch0.band_type[idx] < T.NOISE_BT
                    and ch1.band_type[idx] < T.NOISE_BT):
                for group in range(ics.group_len[g]):
                    s = slice(base + group * 128 + int(offsets[i]),
                              base + group * 128 + int(offsets[i + 1]))
                    a = ch0.coeffs[s].copy()
                    b = ch1.coeffs[s].copy()
                    ch0.coeffs[s] = a + b
                    ch1.coeffs[s] = a - b
            idx += 1
        base += ics.group_len[g] * 128
    return


def apply_intensity_stereo(cpe: ChannelElement, ms_present: int) -> None:
    ch0, ch1 = cpe.cur[0], cpe.cur[1]
    ics = ch1.ics
    offsets = ics.swb_offset
    idx = 0
    base = 0
    for g in range(ics.num_window_groups):
        i = 0
        while i < ics.max_sfb:
            bt = ch1.band_type[idx]
            if bt in (T.INTENSITY_BT, T.INTENSITY_BT2):
                end = int(ch1.band_type_run_end[idx])
                while i < end:
                    c = -1 + 2 * (int(ch1.band_type[idx]) - 14)
                    if ms_present:
                        c *= 1 - 2 * int(cpe.ms_mask[idx])
                    scale = np.float32(c * ch1.sf[idx])
                    for group in range(ics.group_len[g]):
                        s = slice(base + group * 128 + int(offsets[i]),
                                  base + group * 128 + int(offsets[i + 1]))
                        ch1.coeffs[s] = scale * ch0.coeffs[s]
                    i += 1
                    idx += 1
            else:
                end = int(ch1.band_type_run_end[idx])
                idx += end - i
                i = end
        base += ics.group_len[g] * 128


# ---------------------------------------------------------------------------
# TNS filter (aacdec.c:1698-1736) — host-side spectral all-pole filter
# ---------------------------------------------------------------------------
def compute_lpc_from_reflection(coefs: np.ndarray) -> np.ndarray:
    """lpc.h:61-103 with normalize=0: reflection -> direct form, float32."""
    order = len(coefs)
    lpc = np.zeros(order, np.float32)
    for i in range(order):
        r = np.float32(-coefs[i])
        lpc[i] = r
        half = (i + 1) >> 1
        for j in range(half):
            f = lpc[j]
            b = lpc[i - 1 - j]
            lpc[j] = np.float32(f + r * b)
            lpc[i - 1 - j] = np.float32(b + r * f)
    return lpc


def apply_tns(coef: np.ndarray, cd: ChannelData) -> None:
    ics, tns = cd.ics, cd.tns
    mmm = min(ics.tns_max_bands, ics.max_sfb)
    for w in range(ics.num_windows):
        bottom = ics.num_swb
        for filt in range(tns.n_filt[w]):
            top = bottom
            bottom = max(0, top - tns.length[w][filt])
            order = tns.order[w][filt]
            if order == 0:
                continue
            lpc = compute_lpc_from_reflection(tns.coef[w][filt])
            start = int(ics.swb_offset[min(bottom, mmm)])
            end = int(ics.swb_offset[min(top, mmm)])
            size = end - start
            if size <= 0:
                continue
            if tns.direction[w][filt]:
                inc = -1
                start = end - 1
            else:
                inc = 1
            start += w * 128
            for m in range(size):
                acc = np.float32(coef[start])
                for i in range(1, min(m, order) + 1):
                    acc = np.float32(acc - coef[start - i * inc] * lpc[i - 1])
                coef[start] = acc
                start += inc


# ---------------------------------------------------------------------------
# AAC-Main frequency-domain prediction (aacdec.c:1247-1322), vectorized over
# the 672 predictor bins with exact float16-emulation bit ops.
# ---------------------------------------------------------------------------
MAX_PREDICTORS = 672


def _flt16_round(x: np.ndarray) -> np.ndarray:
    i = x.view(np.uint32)
    return ((i + 0x00008000) & 0xFFFF0000).astype(np.uint32).view(np.float32)


def _flt16_even(x: np.ndarray) -> np.ndarray:
    i = x.view(np.uint32)
    return ((i + 0x00007FFF + ((i & 0x00010000) >> 16)) & 0xFFFF0000).astype(
        np.uint32).view(np.float32)


def _flt16_trunc(x: np.ndarray) -> np.ndarray:
    return (x.view(np.uint32) & 0xFFFF0000).astype(np.uint32).view(np.float32)


def new_predictor_state() -> np.ndarray:
    # columns: cor0 cor1 var0 var1 r0 r1
    st = np.zeros((MAX_PREDICTORS, 6), np.float32)
    st[:, 2] = 1.0
    st[:, 3] = 1.0
    return st


def apply_prediction(state: PersistentChannelState, cd: ChannelData,
                     sampling_index: int, sf_scale: float) -> None:
    if state.predictor_state is None or not state.predictor_initialized:
        state.predictor_state = new_predictor_state()
        state.predictor_initialized = True
    ics = cd.ics
    if ics.window_sequence == T.EIGHT_SHORT:
        state.predictor_state = new_predictor_state()
        return
    st = state.predictor_state
    pmax = T.pred_sfb_max(sampling_index)
    kmax = int(ics.swb_offset[min(pmax, ics.num_swb)])
    cor0, cor1 = st[:kmax, 0], st[:kmax, 1]
    var0, var1 = st[:kmax, 2], st[:kmax, 3]
    r0, r1 = st[:kmax, 4], st[:kmax, 5]
    a = np.float32(0.953125)
    alpha = np.float32(0.90625)
    k1 = np.where(var0 > 1, cor0 * _flt16_even(np.float32(a) / var0), 0).astype(np.float32)
    k2 = np.where(var1 > 1, cor1 * _flt16_even(np.float32(a) / var1), 0).astype(np.float32)
    pv = _flt16_round((k1 * r0 + k2 * r1).astype(np.float32))
    # output_enable per sfb
    enable = np.zeros(kmax, bool)
    if ics.predictor_present and ics.prediction_used is not None:
        nmax = min(ics.max_sfb, pmax)
        for sfb in range(min(nmax, len(ics.prediction_used))):
            if ics.prediction_used[sfb]:
                enable[int(ics.swb_offset[sfb]):int(ics.swb_offset[sfb + 1])] = True
    coef = cd.coeffs
    coef[:kmax] = np.where(
        enable, (coef[:kmax] + pv * np.float32(sf_scale)).astype(np.float32),
        coef[:kmax])
    e0 = (coef[:kmax] / np.float32(sf_scale)).astype(np.float32)
    e1 = (e0 - k1 * r0).astype(np.float32)
    st[:kmax, 1] = _flt16_trunc((alpha * cor1 + r1 * e1).astype(np.float32))
    st[:kmax, 3] = _flt16_trunc((alpha * var1 + np.float32(0.5) * (r1 * r1 + e1 * e1)).astype(np.float32))
    st[:kmax, 0] = _flt16_trunc((alpha * cor0 + r0 * e0).astype(np.float32))
    st[:kmax, 2] = _flt16_trunc((alpha * var0 + np.float32(0.5) * (r0 * r0 + e0 * e0)).astype(np.float32))
    st[:kmax, 5] = _flt16_trunc((a * (r0 - k1 * e0)).astype(np.float32))
    st[:kmax, 4] = _flt16_trunc((a * e0).astype(np.float32))
    if ics.predictor_reset_group:
        idxs = np.arange(ics.predictor_reset_group - 1, MAX_PREDICTORS, 30)
        st[idxs] = 0.0
        st[idxs, 2] = 1.0
        st[idxs, 3] = 1.0


# ---------------------------------------------------------------------------
# PCE (aacdec.c:303-349)
# ---------------------------------------------------------------------------
def parse_pce_layout(br: BitReader):
    """Returns the channel-position layout lists parsed from a PCE."""
    br.skip(2)  # object type
    br.get(4)   # sampling index (warn-only in reference)
    num_front = br.get(4)
    num_side = br.get(4)
    num_back = br.get(4)
    num_lfe = br.get(2)
    num_assoc = br.get(3)
    num_cc = br.get(4)
    if br.get1():
        br.skip(4)
    if br.get1():
        br.skip(4)
    if br.get1():
        br.skip(3)

    layout = {"front": [], "side": [], "back": [], "lfe": [], "cc": []}

    def chan_map(dest, n, cpe_allowed=True):
        for _ in range(n):
            is_cpe = br.get1() if cpe_allowed else 0
            tag = br.get(4)
            dest.append((T.TYPE_CPE if is_cpe else T.TYPE_SCE, tag))

    chan_map(layout["front"], num_front)
    chan_map(layout["side"], num_side)
    chan_map(layout["back"], num_back)
    for _ in range(num_lfe):
        layout["lfe"].append((T.TYPE_LFE, br.get(4)))
    br.skip(4 * num_assoc)
    for _ in range(num_cc):
        br.get1()  # cc_element_is_ind_sw
        layout["cc"].append((T.TYPE_CCE, br.get(4)))
    br.align()
    comment = br.get(8)
    if br.bits_left() < 8 * comment:
        raise BitstreamError("overread in PCE comment")
    br.skip(8 * comment)
    return layout


# ---------------------------------------------------------------------------
# CCE (aacdec.c:1503-1567)
# ---------------------------------------------------------------------------
def decode_cce(br: BitReader, che: ChannelElement, sampling_index: int,
               object_type: int, rng) -> None:
    coup = CceData()
    coup.coupling_point = 2 * br.get1()
    coup.num_coupled = br.get(3)
    num_gain = 0
    for _c in range(coup.num_coupled + 1):
        num_gain += 1
        is_cpe = br.get1()
        coup.type.append(T.TYPE_CPE if is_cpe else T.TYPE_SCE)
        coup.id_select.append(br.get(4))
        if is_cpe:
            cs = br.get(2)
            if cs == 3:
                num_gain += 1
            coup.ch_select.append(cs)
        else:
            coup.ch_select.append(2)
    coup.coupling_point += 1 if (br.get1() or (coup.coupling_point >> 1)) else 0

    sign = br.get1()
    scale = np.float64(2.0) ** (2.0 ** (br.get(2) - 3))

    decode_ics(br, che.cur[0], sampling_index, object_type, 0, rng)
    sce = che.cur[0]

    coup.gain = np.zeros((16, 120), np.float32)
    vlc = _sf_vlc()
    for c in range(num_gain):
        idx = 0
        cge = 1
        gain = 0
        gain_cache = np.float32(1.0)
        if c:
            cge = 1 if coup.coupling_point == 3 else br.get1()
            gain = vlc.decode(br) - 60 if cge else 0
            gain_cache = np.float32(scale ** -gain)
        if coup.coupling_point == 3:  # AFTER_IMDCT
            coup.gain[c][0] = gain_cache
        else:
            for _g in range(sce.ics.num_window_groups):
                for _sfb in range(sce.ics.max_sfb):
                    if sce.band_type[idx] != T.ZERO_BT:
                        if not cge:
                            t = vlc.decode(br) - 60
                            if t:
                                s = 1
                                gain += t
                                t = gain
                                if sign:
                                    s -= 2 * (t & 0x1)
                                    t >>= 1
                                gain_cache = np.float32((scale ** -t) * s)
                        coup.gain[c][idx] = gain_cache
                    idx += 1
    che.coup = coup


def apply_dependent_coupling(target: ChannelData, cce: ChannelElement,
                             index: int) -> None:
    """aacdec.c:1813-1842 (spectral-domain coupling add)."""
    ics = cce.cur[0].ics
    offsets = ics.swb_offset
    idx = 0
    base = 0
    for g in range(ics.num_window_groups):
        for i in range(ics.max_sfb):
            if cce.cur[0].band_type[idx] != T.ZERO_BT:
                gain = cce.coup.gain[index][idx]
                for group in range(ics.group_len[g]):
                    s = slice(base + group * 128 + int(offsets[i]),
                              base + group * 128 + int(offsets[i + 1]))
                    target.coeffs[s] = (
                        target.coeffs[s] + gain * cce.cur[0].coeffs[s]
                    ).astype(np.float32)
            idx += 1
        base += ics.group_len[g] * 128
