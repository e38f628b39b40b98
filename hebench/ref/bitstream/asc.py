"""AudioSpecificConfig (MPEG-4 audio) parsing.

Mirrors reference libavcodec/mpeg4audio.c:79-143 (ff_mpeg4audio_get_config)
plus the GASpecificConfig handling of libavcodec/aacdec.c:402-452.
Supported object types: AAC-Main (1), AAC-LC (2), SBR (5), PS (29); anything
else raises, matching the reference's unsupported-AOT error path.
"""
from __future__ import annotations

from dataclasses import dataclass, field

from ..tables.aac_tables import CHANNEL_COUNTS, SAMPLE_RATES
from .reader import BitReader, BitstreamError

AOT_AAC_MAIN, AOT_AAC_LC, AOT_SBR, AOT_PS = 1, 2, 5, 29
AOT_ESCAPE = 31


@dataclass
class M4AConfig:
    object_type: int = 0
    sampling_index: int = 0
    sample_rate: int = 0
    chan_config: int = 0
    channels: int = 0
    sbr: int = -1          # -1 implicit/unknown, 0 absent, 1 present
    ps: int = -1
    ext_object_type: int = 0
    ext_sampling_index: int = 0
    ext_sample_rate: int = 0
    # from GASpecificConfig:
    pce_channel_layout: list | None = field(default=None)


def _get_object_type(br: BitReader) -> int:
    t = br.get(5)
    if t == AOT_ESCAPE:
        t = 32 + br.get(6)
    return t


def _get_sample_rate(br: BitReader) -> tuple[int, int]:
    idx = br.get(4)
    if idx == 0xF:
        return idx, br.get(24)
    return idx, int(SAMPLE_RATES[idx])


def parse_audio_specific_config(data: bytes) -> M4AConfig:
    br = BitReader(data)
    c = M4AConfig()
    c.object_type = _get_object_type(br)
    c.sampling_index, c.sample_rate = _get_sample_rate(br)
    c.chan_config = br.get(4)
    if c.chan_config < len(CHANNEL_COUNTS):
        c.channels = int(CHANNEL_COUNTS[c.chan_config])
    c.sbr = -1
    c.ps = -1
    if c.object_type == AOT_SBR or (
        c.object_type == AOT_PS
        and not (br.show(3) & 0x03 and not (br.show(9) & 0x3F))
    ):
        if c.object_type == AOT_PS:
            c.ps = 1
        c.ext_object_type = AOT_SBR
        c.sbr = 1
        c.ext_sampling_index, c.ext_sample_rate = _get_sample_rate(br)
        c.object_type = _get_object_type(br)
    else:
        c.ext_object_type = 0
        c.ext_sample_rate = 0

    if c.object_type not in (AOT_AAC_MAIN, AOT_AAC_LC):
        raise BitstreamError(f"unsupported audio object type {c.object_type}")

    # GASpecificConfig (aacdec.c:402-452)
    if br.get1():  # frameLengthFlag
        raise BitstreamError("960-sample frames not supported")
    if br.get1():  # dependsOnCoreCoder
        br.skip(14)
    extension_flag = br.get1()
    if c.chan_config == 0:
        br.skip(4)  # element_instance_tag
        from .aac_syntax import parse_pce_layout  # lazy; avoids cycle
        c.pce_channel_layout = parse_pce_layout(br)
    if extension_flag:
        br.skip(1)  # extensionFlag3

    # sync extension scan for explicit backward-compatible SBR/PS signalling
    if c.ext_object_type != AOT_SBR:
        while br.bits_left() > 15:
            if br.show(11) == 0x2B7:
                br.get(11)
                c.ext_object_type = _get_object_type(br)
                if c.ext_object_type == AOT_SBR:
                    c.sbr = br.get1()
                    if c.sbr == 1:
                        c.ext_sampling_index, c.ext_sample_rate = _get_sample_rate(br)
                if br.bits_left() > 11 and br.get(11) == 0x548:
                    c.ps = br.get1()
                break
            br.skip(1)

    if not c.sbr:
        c.ps = 0
    if (c.ps == -1 and c.object_type != AOT_AAC_LC) or (c.channels & ~0x01):
        c.ps = 0
    # decoder-side default (aacdec.c:476-477): explicit SBR with unknown PS
    if c.sbr == 1 and c.ps == -1:
        c.ps = 1
    if c.sampling_index > 12:
        raise BitstreamError(f"invalid sampling rate index {c.sampling_index}")
    return c
