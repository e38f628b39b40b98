"""Host-only numpy helpers of the qwire path.

Counterparts: ADTS header parse and ``split_adts_stream``
(heaac_tpu/bitstream/adts.py), ``_count_adts_frames`` (codec/batch.py),
the lane counts of a program config element (``parse_pce_layout`` of
bitstream/aac_syntax.py with codec/decoder.py ``_configure_from_pce``),
and the qwire wire-format
constants and helpers (codec/qwire.py: token set, record layout, side /
header / PS block layout, ``silence_lane``, ``spec_static_args``).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np

from . import tables as TB
from .tables import SAMPLE_RATES

# ---- token constants (qwire.py) --------------------------------------------
T_ZRUN0 = 0x01          # ZRUN n = tok (1..64)
ZRUN_MAX = 64
T_PAIR0 = 0x41          # 49 codes
T_SGL0 = 0x72           # 32 codes, mag 4..19
T_ESC1 = 0x92
T_ESC2 = 0x93
T_SETSF = 0x94
T_RAW0 = 0x94           # RAWRUN n = tok - T_RAW0 (1..4)
RAW_MAX = 4
T_QUAD0 = 0x99          # 81 codes
T_QUAD_END = 0xE9
T_SFD_BASE = 0xF5       # SETSF_DELTA: d = tok - T_SFD_BASE in [-11, 10]

# ---- record layout -------------------------------------------------------
REC_W = 4               # i32 record words per frame-lane
R_TOKOFF = 0            # heap byte offset of the lane payload
R_W1 = 1                # ntok (u16) | n_ext (u16)<<16
R_W2 = 2                # side_len (u16) | hdr_len (u8)<<16 | mode<<24
R_W3 = 3                # spec mode: nbits(13) | nsec<<13 | sfidx0<<18 | flags

# ---- side / header / PS block layout -------------------------------------
SIDE_HEAD = 13
SIDE_MAX = 1024
PS_B0, PS_KND, PS_NIPD, PS_TOP, PS_BORD, PS_NE, PS_RB, PS_HEAD = (
    0, 1, 2, 3, 4, 10, 11, 12)
PS_WIDTH = [10, 20, 34, 0]
H_N0, H_N1, H_NQ, H_NLIM, H_NPATCH, H_KX1, H_M1, H_FLAGS, H_LIMG = range(9)
H_TAB = 9
HDR_MAX = 144
NB_HI = 48
NB_LO = 25
NB_Q = 5
NB_LIM = 28
NPATCH = 6
E, M = 5, 48


class AdtsHeader(NamedTuple):
    object_type: int          # ADTS profile + 1 (1 Main, 2 LC)
    sampling_index: int
    sample_rate: int
    chan_config: int
    frame_length: int


def parse_adts_header(b: bytes) -> AdtsHeader:
    """Fixed ADTS header fields of the first 7 bytes."""
    if len(b) < 7 or b[0] != 0xFF or (b[1] & 0xF0) != 0xF0:
        raise ValueError("not an ADTS stream")
    si = (b[2] >> 2) & 15
    if SAMPLE_RATES[si] == 0:
        raise ValueError(f"bad ADTS sample rate index {si}")
    flen = ((b[3] & 3) << 11) | (b[4] << 3) | (b[5] >> 5)
    if flen < 7:
        raise ValueError(f"bad ADTS frame length {flen}")
    return AdtsHeader(object_type=(b[2] >> 6) + 1, sampling_index=si,
                      sample_rate=int(SAMPLE_RATES[si]),
                      chan_config=((b[2] & 1) << 2) | (b[3] >> 6),
                      frame_length=flen)


def split_adts_stream(data: bytes) -> list:
    """Whole ADTS frames of ``data`` (header included), resynchronizing
    on the 0xFFF sync word past garbage and past headers that do not
    parse; a truncated last frame ends the walk (adts.split_adts_stream,
    aac_ac3_parser.c:44-48)."""
    frames = []
    pos = 0
    n = len(data)
    while pos + 7 <= n:
        if data[pos] == 0xFF and (data[pos + 1] & 0xF6) == 0xF0:
            try:
                flen = parse_adts_header(data[pos:pos + 7]).frame_length
            except ValueError:
                pos += 1
                continue
            if pos + flen > n:
                break
            frames.append(data[pos:pos + flen])
            pos += flen
        else:
            pos += 1
    return frames


def count_adts_frames(data: bytes) -> int:
    """Header-only ADTS frame count (resynchronizing walk)."""
    n = 0
    off = 0
    end = len(data)
    while off + 7 <= end:
        if data[off] != 0xFF or (data[off + 1] & 0xF6) != 0xF0:
            off += 1
            continue
        flen = ((data[off + 3] & 3) << 11) | (data[off + 4] << 3) \
            | (data[off + 5] >> 5)
        if flen < 7 or off + flen > end:
            break
        n += 1
        off += flen
    return n


def pce_lanes(frame: bytes) -> tuple:
    """(output lanes, CCE lanes) of the program config element that opens
    an ADTS frame's raw data block (channel configuration 0), past any
    fill or data stream elements before it: a CPE gives two output lanes,
    an SCE or LFE one, and each coupling channel one lane after them (the
    native parser's lane order).  Raises NotImplementedError when no PCE
    comes first."""
    hdr_len = 7 if frame[1] & 1 else 9          # protection_absent: no CRC
    bits = int.from_bytes(frame[hdr_len:], "big")
    nbits = 8 * (len(frame) - hdr_len)
    pos = 0

    def get(n: int) -> int:
        nonlocal pos
        if pos + n > nbits:
            raise NotImplementedError("frame ends before its PCE")
        pos += n
        return (bits >> (nbits - pos)) & ((1 << n) - 1)

    while True:
        elem = get(3)
        if elem == TB.TYPE_FIL:
            count = get(4)
            if count == 15:
                count += get(8) - 1
            pos += 8 * count
        elif elem == TB.TYPE_DSE:
            get(4)
            align = get(1)
            count = get(8)
            if count == 255:
                count += get(8)
            if align:
                pos += -pos % 8
            pos += 8 * count
        elif elem == TB.TYPE_PCE:
            break
        else:
            raise NotImplementedError(
                "channel configuration 0 whose first frame does not open "
                "with a program config element")
    get(4 + 2 + 4)                   # element tag, object type, rate index
    n_front, n_side, n_back, n_lfe = get(4), get(4), get(4), get(2)
    n_assoc, n_cc = get(3), get(4)
    for skip in (4, 4, 3):           # mono / stereo / matrix mixdown
        if get(1):
            get(skip)
    out = 0
    for _ in range(n_front + n_side + n_back):
        out += 1 + get(1)            # is_cpe
        get(4)
    return out + n_lfe, n_cc


def silence_lane() -> tuple:
    """Payload + record of a silence/padding lane (qwire.silence_lane)."""
    toks = bytes([T_ZRUN0 - 1 + ZRUN_MAX]) * (1024 // ZRUN_MAX)
    rec = np.zeros(REC_W, np.int32)
    rec[R_W1] = len(toks)
    rec[R_W2] = SIDE_HEAD
    return toks + bytes(SIDE_HEAD), rec


def spec_static_args(recs) -> dict:
    """Static sizes of the spectral-Huffman decode from a [.., REC_W]
    record array: NB (bit-axis width), MS, NS (band-axis width), SEC."""
    w2 = np.asarray(recs[..., R_W2])
    w3 = np.asarray(recs[..., R_W3])
    spec = ((w2 >> 24) & 15) == 1
    if not spec.any():
        return dict(NB=0, MS=0, NS=52, SEC=8)
    w3s = w3[spec]
    nb = int((w3s & 0x1FFF).max())
    return dict(
        NB=max(256, -(-nb // 256) * 256),
        MS=int((((w3s >> 28) & 3) != 0).any()),
        NS=128 if ((w3s >> 30) & 1).any() else 52,
        SEC=max(8, -(-int(((w3s >> 13) & 31).max()) // 8) * 8))


def rows_pair_static(heap, recs) -> int:
    """1 iff any frame-lane ships coupled-CPE raw SBR rows (side flags
    bit 7 AND bit 2), i.e. the decode needs the rows_pair graph."""
    recs = np.asarray(recs)
    h = np.asarray(heap, np.uint8)
    if h.size == 0:
        return 0
    w1 = recs[..., R_W1]
    soff = recs[..., R_TOKOFF] + (w1 & 0xFFFF) + ((w1 >> 16) & 0xFFFF)
    flags = h[np.clip(soff + 1, 0, h.size - 1)]
    return int(bool(((flags & 0x84) == 0x84).any()))
