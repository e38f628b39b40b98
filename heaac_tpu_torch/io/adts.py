"""Port copy of ``heaac_tpu/io/adts.py``: the port imports nothing of the
JAX package, so it keeps its own copy (tables from
``heaac_tpu_torch.tables``).  Names as there.

ADTS muxing + the ADTS->ASC bitstream filter.

Write side of the container layer (the reference's libavformat/adtsenc.c:60
``ff_adts_write_frame_header`` and libavcodec/aac_adtstoasc_bsf.c).
"""
from __future__ import annotations

import numpy as np

from ..bitstream.adts import parse_adts_header, split_adts_stream
from ..bitstream.reader import BitReader
from ..tables import SAMPLE_RATES
from .bitwriter import BitWriter


def adts_frame_header(payload_len: int, object_type: int,
                      sampling_index: int, chan_config: int) -> bytes:
    """7-byte ADTS header (no CRC), mirroring adtsenc.c:60-100 field
    layout."""
    bw = BitWriter()
    bw.put(12, 0xFFF)          # syncword
    bw.put1(0)                 # id (MPEG-4)
    bw.put(2, 0)               # layer
    bw.put1(1)                 # protection_absent
    bw.put(2, object_type - 1)
    bw.put(4, sampling_index)
    bw.put1(0)                 # private
    bw.put(3, chan_config)
    bw.put(4, 0)               # original/copy, home, copyright x2
    bw.put(13, payload_len + 7)
    bw.put(11, 0x7FF)          # buffer fullness: VBR
    bw.put(2, 0)               # 1 raw data block
    return bw.bytes()


def mux_adts(frames: list[bytes], object_type: int, sample_rate: int,
             chan_config: int) -> bytes:
    """Wrap raw AAC frames (raw_data_blocks) into an ADTS stream."""
    sr_index = int(np.where(np.asarray(SAMPLE_RATES) == sample_rate)[0][0])
    out = bytearray()
    for f in frames:
        out += adts_frame_header(len(f), object_type, sr_index, chan_config)
        out += f
    return bytes(out)


def make_asc(object_type: int, sampling_index: int, chan_config: int) -> bytes:
    """Minimal AudioSpecificConfig (2 bytes) for LC-family streams."""
    bw = BitWriter()
    bw.put(5, object_type)
    bw.put(4, sampling_index)
    bw.put(4, chan_config)
    bw.put(1, 0)   # frameLengthFlag
    bw.put(1, 0)   # dependsOnCoreCoder
    bw.put(1, 0)   # extensionFlag
    return bw.bytes()


def adts_to_asc(data: bytes) -> tuple[bytes, list[bytes]]:
    """ADTS->ASC bitstream filter (aac_adtstoasc_bsf.c behavior): strip the
    ADTS headers and synthesize AudioSpecificConfig extradata.

    Returns (asc_bytes, raw_frames)."""
    frames = split_adts_stream(data)
    if not frames:
        raise ValueError("no ADTS frames")
    hdr = parse_adts_header(BitReader(frames[0]))
    if not hdr.chan_config:
        raise ValueError("in-band PCE streams not supported by this filter")
    asc = make_asc(hdr.object_type, hdr.sampling_index, hdr.chan_config)
    raw = []
    for f in frames:
        h = parse_adts_header(BitReader(f))
        off = 7 if h.crc_absent else 9
        raw.append(f[off:])
    return asc, raw
