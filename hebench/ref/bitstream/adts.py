"""ADTS header parsing and stream framing.

Mirrors the reference contract:
* header fields/validation: libavcodec/aac_parser.c:29-70 (ff_aac_parse_header)
* stream re-framing into one ADTS frame per packet:
  libavcodec/aac_ac3_parser.c:26-101 (sync-scan state machine); here we frame
  a whole in-memory stream at once since decode is batched, not streaming.
"""
from __future__ import annotations

from dataclasses import dataclass

from ..tables.aac_tables import SAMPLE_RATES
from .reader import BitReader, BitstreamError

ADTS_HEADER_SIZE = 7


@dataclass(frozen=True)
class AdtsHeader:
    object_type: int      # profile + 1 (1=Main, 2=LC)
    sampling_index: int
    sample_rate: int
    chan_config: int
    crc_absent: int
    frame_length: int     # whole ADTS frame incl. header
    num_aac_frames: int


def parse_adts_header(br: BitReader) -> AdtsHeader:
    if br.get(12) != 0xFFF:
        raise BitstreamError("bad ADTS syncword")
    br.skip(1)              # id
    br.skip(2)              # layer
    crc_abs = br.get1()     # protection_absent
    aot = br.get(2)         # profile_objecttype
    sr = br.get(4)          # sampling_frequency_index
    if SAMPLE_RATES[sr] == 0:
        raise BitstreamError(f"bad ADTS sample rate index {sr}")
    br.skip(1)              # private_bit
    ch = br.get(3)          # channel_configuration
    br.skip(2)              # original/copy, home
    br.skip(2)              # copyright id bit/start
    size = br.get(13)       # aac_frame_length
    if size < ADTS_HEADER_SIZE:
        raise BitstreamError(f"bad ADTS frame length {size}")
    br.skip(11)             # adts_buffer_fullness
    rdb = br.get(2)         # number_of_raw_data_blocks_in_frame
    return AdtsHeader(
        object_type=aot + 1,
        sampling_index=sr,
        sample_rate=int(SAMPLE_RATES[sr]),
        chan_config=ch,
        crc_absent=crc_abs,
        frame_length=size,
        num_aac_frames=rdb + 1,
    )


def split_adts_stream(data: bytes) -> list[bytes]:
    """Split a byte stream into whole ADTS frames (header included).

    Resynchronizes on corruption by scanning for the next 0xFFF syncword,
    like the reference parser's state machine (aac_ac3_parser.c:44-48).
    """
    frames = []
    pos = 0
    n = len(data)
    while pos + ADTS_HEADER_SIZE <= n:
        if data[pos] == 0xFF and (data[pos + 1] & 0xF6) == 0xF0:
            try:
                hdr = parse_adts_header(BitReader(data[pos : pos + ADTS_HEADER_SIZE]))
            except BitstreamError:
                pos += 1
                continue
            end = pos + hdr.frame_length
            if end > n:
                break  # truncated final frame
            frames.append(data[pos:end])
            pos = end
        else:
            pos += 1
    return frames


def probe_adts(data: bytes, max_frames: int = 8) -> AdtsHeader | None:
    """Probe: require a chain of consecutive valid headers (raw.c:666-700)."""
    frames = split_adts_stream(data[: 64 * 1024])
    if len(frames) < min(2, max_frames):
        return None
    return parse_adts_header(BitReader(frames[0]))
