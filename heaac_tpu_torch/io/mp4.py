"""Port copy of ``heaac_tpu/io/mp4.py``: the port imports nothing of the
JAX package, so it keeps its own copy (the ASC parser from
``heaac_tpu_torch.bitstream.asc``).  Names as there.

MP4/M4A (ISO base media) demuxer + muxer for AAC audio tracks.

The container-layer input path the reference serves with
libavformat/mov.c (esds atom -> AudioSpecificConfig extradata,
mov.c:494 ``ff_mov_read_esds``; sample tables -> packets) and the write
side of libavformat/movenc.c.  Scope mirrors the survey contract: one
AAC audio track, ASC extradata, stsz/stsc/stco/co64 sample walk; video
tracks and edit lists are skipped, fragmented MP4 (moof) is rejected.

Descriptor layout follows mov.c:458-548 exactly: the esds box body is
version+flags(4) then an ES_Descriptor (tag 0x03: ES_ID(2)+priority(1))
containing a DecoderConfigDescriptor (tag 0x04: object_type_id(1),
stream_type(1), buffer_size(3), max_bitrate(4), avg_bitrate(4))
containing a DecoderSpecificInfo (tag 0x05: the raw ASC bytes).
"""
from __future__ import annotations

import struct
from dataclasses import dataclass, field


class Mp4Error(ValueError):
    pass


# ---- box reading -------------------------------------------------------------

def _boxes(data: bytes, start: int, end: int):
    """Yield (fourcc, payload_start, payload_end) for the box sequence in
    data[start:end], handling 64-bit largesize and size==0 (to end of
    file), like mov.c's atom walker (mov_read_default)."""
    off = start
    while off + 8 <= end:
        size = struct.unpack_from(">I", data, off)[0]
        fourcc = data[off + 4:off + 8]
        body = off + 8
        if size == 1:
            if off + 16 > end:
                raise Mp4Error("truncated largesize box")
            size = struct.unpack_from(">Q", data, off + 8)[0]
            body = off + 16
        elif size == 0:
            size = end - off
        if size < body - off or off + size > end:
            raise Mp4Error(f"box {fourcc!r} overruns container")
        yield fourcc, body, off + size
        off += size


def _find(data: bytes, start: int, end: int, fourcc: bytes):
    for fc, a, b in _boxes(data, start, end):
        if fc == fourcc:
            return a, b
    return None


def _read_descr_len(data: bytes, off: int) -> tuple[int, int]:
    """MPEG-4 descriptor expandable length (mov.c:458
    ff_mp4_read_descr_len): up to 4 bytes of 7-bit groups."""
    n = 0
    for _ in range(4):
        c = data[off]
        off += 1
        n = (n << 7) | (c & 0x7F)
        if not (c & 0x80):
            break
    return n, off


def parse_esds(body: bytes) -> bytes:
    """esds box body -> AudioSpecificConfig bytes (mov.c:494)."""
    try:
        off = 4                                 # version + flags
        tag = body[off]
        ln, off = _read_descr_len(body, off + 1)
        if tag == 0x03:                         # MP4ESDescrTag
            off += 3                            # ES_ID + priority
        else:
            off += 2                            # ES_ID
        tag = body[off]
        ln, off = _read_descr_len(body, off + 1)
        if tag != 0x04:                         # MP4DecConfigDescrTag
            raise Mp4Error(f"esds: expected DecoderConfig, got tag {tag:#x}")
        object_type_id = body[off]
        if object_type_id not in (0x40, 0x66, 0x67, 0x68):  # MPEG-4/2 AAC
            raise Mp4Error(
                f"esds: not an AAC object_type_id {object_type_id:#x}")
        off += 13               # otid, stream type, buf size, max/avg bitrate
        tag = body[off]
        ln, off = _read_descr_len(body, off + 1)
    except IndexError:
        raise Mp4Error("esds: truncated descriptor chain") from None
    if tag != 0x05:                             # MP4DecSpecificDescrTag
        raise Mp4Error(f"esds: expected DecoderSpecificInfo, got tag {tag:#x}")
    if off + ln > len(body):
        raise Mp4Error("esds: DecoderSpecificInfo overruns box")
    return bytes(body[off:off + ln])


@dataclass
class M4aTrack:
    asc: bytes                       # AudioSpecificConfig extradata
    frames: list = field(default_factory=list)  # raw AAC access units
    sample_rate: int = 0             # from the mp4a sample entry
    channels: int = 0
    timescale: int = 0               # mdhd


def demux_m4a(data: bytes) -> M4aTrack:
    """Parse an MP4/M4A file and return its (first) AAC audio track:
    ASC extradata + the raw AAC access units, reassembled through the
    stsc/stco/stsz chunk maps exactly as mov.c builds its sample index
    (mov_build_index).  Malformed input raises Mp4Error (never
    struct.error / IndexError / unbounded allocation)."""
    try:
        return _demux_m4a(data)
    except (struct.error, IndexError) as e:
        raise Mp4Error(f"truncated or malformed MP4 structure: {e}") from None


def _demux_m4a(data: bytes) -> M4aTrack:
    top = {fc: (a, b) for fc, a, b in _boxes(data, 0, len(data))}
    if b"moof" in top:
        raise Mp4Error("fragmented MP4 (moof) unsupported")
    if b"moov" not in top:
        raise Mp4Error("no moov box (not an MP4 file?)")
    moov_a, moov_b = top[b"moov"]

    for fc, ta, tb in _boxes(data, moov_a, moov_b):
        if fc != b"trak":
            continue
        mdia = _find(data, ta, tb, b"mdia")
        if mdia is None:
            continue
        hdlr = _find(data, *mdia, b"hdlr")
        if hdlr is None or data[hdlr[0] + 8:hdlr[0] + 12] != b"soun":
            continue
        mdhd = _find(data, *mdia, b"mdhd")
        timescale = 0
        if mdhd is not None:
            v = data[mdhd[0]]
            timescale = struct.unpack_from(
                ">I", data, mdhd[0] + (20 if v == 1 else 12))[0]
        minf = _find(data, *mdia, b"minf")
        stbl = minf and _find(data, *minf, b"stbl")
        if not stbl:
            continue
        boxes = {fc: (a, b) for fc, a, b in _boxes(data, *stbl)}

        # ---- stsd -> mp4a sample entry -> esds --------------------------
        if b"stsd" not in boxes:
            continue
        sa, sb = boxes[b"stsd"]
        try:
            ea, eb = next(_boxes(data, sa + 8, sb))[1:]  # first sample entry
        except StopIteration:
            raise Mp4Error("empty stsd") from None
        entry_fc = data[ea - 4:ea]
        if entry_fc != b"mp4a":
            raise Mp4Error(f"audio sample entry {entry_fc!r} is not mp4a")
        # SampleEntry: reserved(6) + data_reference_index(2); then
        # AudioSampleEntry v0: version(2) revision(2) vendor(4)
        # channels(2) samplesize(2) compression(2) packetsize(2) rate(4)
        ver = struct.unpack_from(">H", data, ea + 8)[0]
        channels = struct.unpack_from(">H", data, ea + 16)[0]
        sample_rate = struct.unpack_from(">I", data, ea + 24)[0] >> 16
        child_off = ea + 28
        if ver == 1:                 # QT v1: 4 extra u32 fields
            child_off += 16
        elif ver == 2:               # QT v2: 36-byte extension
            child_off += 36
        esds = _find(data, child_off, eb, b"esds")
        if esds is None:             # QT sometimes nests it in a wave box
            wave = _find(data, child_off, eb, b"wave")
            esds = wave and _find(data, *wave, b"esds")
        if esds is None:
            raise Mp4Error("mp4a entry without esds")
        asc = parse_esds(data[esds[0]:esds[1]])

        # ---- sample tables ----------------------------------------------
        # every table read is bounded to ITS OWN box (a hostile count
        # must not read adjacent file bytes as table entries or allocate
        # unboundedly; mov.c caps via atom.size the same way)
        if not {b"stsz", b"stsc"} <= boxes.keys():
            raise Mp4Error("missing stsz/stsc sample table")
        if not {b"stco", b"co64"} & boxes.keys():
            raise Mp4Error("missing stco/co64 chunk offsets")
        sza, szb = boxes[b"stsz"]
        if szb - sza < 12:
            raise Mp4Error("truncated stsz")
        fixed = struct.unpack_from(">I", data, sza + 4)[0]
        count = struct.unpack_from(">I", data, sza + 8)[0]
        if fixed:
            if fixed * count > len(data):
                raise Mp4Error(f"stsz claims {count}x{fixed} B > file size")
            sizes = [fixed] * count
        else:
            if sza + 12 + 4 * count > szb:
                raise Mp4Error(f"stsz table ({count} entries) overruns box")
            sizes = list(struct.unpack_from(f">{count}I", data, sza + 12))

        if b"stco" in boxes:
            ca, cb = boxes[b"stco"]
            nch = struct.unpack_from(">I", data, ca + 4)[0]
            if ca + 8 + 4 * nch > cb:
                raise Mp4Error(f"stco table ({nch} entries) overruns box")
            chunk_offs = struct.unpack_from(f">{nch}I", data, ca + 8)
        else:
            ca, cb = boxes[b"co64"]
            nch = struct.unpack_from(">I", data, ca + 4)[0]
            if ca + 8 + 8 * nch > cb:
                raise Mp4Error(f"co64 table ({nch} entries) overruns box")
            chunk_offs = struct.unpack_from(f">{nch}Q", data, ca + 8)

        sca, scb = boxes[b"stsc"]
        nsc = struct.unpack_from(">I", data, sca + 4)[0]
        if sca + 8 + 12 * nsc > scb:
            raise Mp4Error(f"stsc table ({nsc} entries) overruns box")
        stsc = [struct.unpack_from(">III", data, sca + 8 + 12 * i)
                for i in range(nsc)]          # (first_chunk, per_chunk, _)

        frames: list[bytes] = []
        si = 0
        for ci in range(nch):
            per = 0
            for first, n, _ in stsc:
                if first <= ci + 1:
                    per = n
                else:
                    break
            off = chunk_offs[ci]
            for _ in range(per):
                if si >= count:
                    break
                sz = sizes[si]
                if off + sz > len(data):
                    raise Mp4Error(f"sample {si} overruns file")
                frames.append(bytes(data[off:off + sz]))
                off += sz
                si += 1
        if si != count:
            raise Mp4Error(f"chunk map covers {si}/{count} samples")
        return M4aTrack(asc=asc, frames=frames, sample_rate=sample_rate,
                        channels=channels, timescale=timescale)
    raise Mp4Error("no AAC audio track found")


def probe_m4a(data: bytes) -> bool:
    """True if the bytes look like an ISO-BMFF file (ftyp/moov leading
    box), the mov.c mov_probe analogue."""
    return len(data) >= 8 and data[4:8] in (
        b"ftyp", b"moov", b"mdat", b"free", b"skip", b"wide")


def m4a_to_adts(data: bytes) -> bytes:
    """Demux an .m4a and re-wrap its AAC track as an ADTS stream (the
    inverse of the adtstoasc path) so container input rides the same
    native batched fast path as ADTS files.  Only ASCs that ADTS can
    carry are representable: object type 1/2, channel config 1-7,
    implicit SBR/PS signaling (the reference's mov->aac path relies on
    the same implicit detection, mpeg4audio.c:120-133)."""
    from ..bitstream.asc import parse_audio_specific_config
    from .adts import mux_adts

    t = demux_m4a(data)
    c = parse_audio_specific_config(t.asc)
    if c.ext_object_type or c.sbr == 1:
        raise Mp4Error("explicitly-signaled SBR ASC is not ADTS-representable")
    if not 1 <= c.chan_config <= 7:
        raise Mp4Error(f"channel config {c.chan_config} needs in-band PCE")
    return mux_adts(t.frames, c.object_type, c.sample_rate, c.chan_config)


# ---- muxer -------------------------------------------------------------------

def _box(fourcc: bytes, *payload: bytes) -> bytes:
    body = b"".join(payload)
    return struct.pack(">I", 8 + len(body)) + fourcc + body


def _full(fourcc: bytes, version: int, flags: int, *payload: bytes) -> bytes:
    return _box(fourcc, struct.pack(">I", (version << 24) | flags),
                *payload)


def _descr(tag: int, body: bytes) -> bytes:
    """MPEG-4 descriptor with the 4-byte expandable length movenc.c
    emits (putDescr/descrLength)."""
    n = len(body)
    ln = bytes([0x80 | ((n >> 21) & 0x7F), 0x80 | ((n >> 14) & 0x7F),
                0x80 | ((n >> 7) & 0x7F), n & 0x7F])
    return bytes([tag]) + ln + body


def make_esds(asc: bytes, avg_bitrate: int = 0) -> bytes:
    """esds box for an AAC track (movenc.c mov_write_esds_tag)."""
    dsi = _descr(0x05, asc)
    dec_cfg = _descr(0x04, struct.pack(
        ">BBBHII", 0x40, 0x15, 0, 0, 0, avg_bitrate) + dsi)
    sl = _descr(0x06, b"\x02")
    es = _descr(0x03, struct.pack(">HB", 1, 0) + dec_cfg + sl)
    return _full(b"esds", 0, 0, es)


def mux_m4a(frames: list, asc: bytes, sample_rate: int,
            channels: int, frame_samples: int = 1024,
            frames_per_chunk: int = 0) -> bytes:
    """Write raw AAC access units + ASC into a minimal valid .m4a:
    ftyp + mdat + moov with per-sample stsz, the movenc.c layout reduced
    to the audio-only case.  frames_per_chunk=0 puts all samples in one
    chunk; a positive value splits the mdat into interleave-style chunks
    (exercising the stsc/stco walk the way movenc.c:1578 lays out real
    files)."""
    ftyp = _box(b"ftyp", b"M4A \x00\x00\x02\x00", b"M4A mp42isom")
    payload = b"".join(frames)
    mdat = _box(b"mdat", payload)
    data_off = len(ftyp) + 8          # first sample = mdat body start

    n = len(frames)
    duration = n * frame_samples
    per = frames_per_chunk if frames_per_chunk > 0 else max(n, 1)

    def u32(*vals):
        return struct.pack(f">{len(vals)}I", *vals)

    rate1616 = (sample_rate << 16) if sample_rate < 0x10000 else 0
    stsd = _full(
        b"stsd", 0, 0, u32(1),
        _box(b"mp4a",
             b"\0" * 6 + struct.pack(">H", 1),           # dref index
             struct.pack(">HHIHHHHI", 0, 0, 0, channels, 16, 0, 0,
                         rate1616),
             make_esds(asc)))
    stts = _full(b"stts", 0, 0, u32(1, n, frame_samples))
    nchunks = max(1, -(-n // per))
    last = n - per * (nchunks - 1)
    if nchunks > 1 and last != per:       # short tail chunk
        stsc = _full(b"stsc", 0, 0, u32(2, 1, per, 1, nchunks, last, 1))
    else:
        stsc = _full(b"stsc", 0, 0, u32(1, 1, per, 1))
    stsz = _full(b"stsz", 0, 0, u32(0, n, *[len(f) for f in frames]))
    offs, cur = [], data_off
    for ci in range(nchunks):
        offs.append(cur)
        cur += sum(len(f) for f in frames[ci * per:(ci + 1) * per])
    stco = _full(b"stco", 0, 0, u32(nchunks, *offs))
    stbl = _box(b"stbl", stsd, stts, stsc, stsz, stco)

    url_ = _full(b"url ", 0, 1)
    dinf = _box(b"dinf", _full(b"dref", 0, 0, u32(1), url_))
    smhd = _full(b"smhd", 0, 0, b"\0" * 4)
    minf = _box(b"minf", smhd, dinf, stbl)
    hdlr = _full(b"hdlr", 0, 0, u32(0), b"soun", u32(0, 0, 0),
                 b"SoundHandler\0")
    mdhd = _full(b"mdhd", 0, 0, u32(0, 0, sample_rate, duration),
                 struct.pack(">HH", 0x55C4, 0))          # lang "und"
    mdia = _box(b"mdia", mdhd, hdlr, minf)
    tkhd = _full(b"tkhd", 0, 7, u32(0, 0, 1, 0, duration, 0, 0),
                 struct.pack(">HHHH", 0, 0, 0x0100, 0),  # volume 1.0
                 u32(0x00010000, 0, 0, 0, 0x00010000, 0, 0, 0,
                     0x40000000, 0, 0))
    trak = _box(b"trak", tkhd, mdia)
    mvhd = _full(b"mvhd", 0, 0,
                 u32(0, 0, sample_rate, duration, 0x00010000),
                 struct.pack(">HH", 0x0100, 0), b"\0" * 8,
                 u32(0x00010000, 0, 0, 0, 0x00010000, 0, 0, 0,
                     0x40000000, 0, 0, 0, 0, 0, 0, 2))
    moov = _box(b"moov", mvhd, trak)
    return ftyp + mdat + moov
