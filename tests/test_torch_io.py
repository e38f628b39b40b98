"""The port's container layer (``heaac_tpu_torch.io``) against the JAX
package's (``heaac_tpu.io``), on committed streams: the same bytes out of
every writer (BitWriter, ADTS headers and muxing, the minimal ASC, the
ADTS->ASC filter, the MP4 muxer with one chunk and with several), the same
values out of every reader (the MP4 demuxer, the M4A->ADTS re-wrap, the
MP4 probe, the WAV writer and reader), and the committed
tests/data/front_*.m4a inputs (written by the JAX muxer,
tools/make_torch_golden.py ``front``) made again by the port's muxer.
The JAX functions are plain Python: nothing is compiled.  The two
demuxer robustness tests of tests/test_mp4.py run against the port.
"""
import random
import struct as st

import numpy as np
import pytest
import torch

from heaac_tpu.io import adts as jax_adts
from heaac_tpu.io import bitwriter as jax_bw
from heaac_tpu.io import mp4 as jax_mp4
from heaac_tpu.io import wav as jax_wav
from heaac_tpu_torch.bitstream.adts import probe_adts
from heaac_tpu_torch.io import adts, bitwriter, mp4, wav
from heaac_tpu_torch.io.mp4 import Mp4Error, demux_m4a, mux_m4a, probe_m4a
from test_torch_common import (  # noqa: F401 (autouse fixture)
    REPO, golden_tool, release_jax_memory, streams_of)

KINDS = ["he20", "he34", "he_v1s", "lc"]


def _stream(kind: str) -> bytes:
    return streams_of(kind, 1)[0]


def test_bitwriter_matches_jax():
    rng = np.random.default_rng(0)
    ops = [(int(n), int(rng.integers(0, 1 << int(n))))
           for n in rng.integers(1, 33, 200)]
    data = bytes(rng.integers(0, 256, 64, dtype=np.uint8))
    outs = []
    for mod in (bitwriter, jax_bw):
        bw, tail = mod.BitWriter(), mod.BitWriter()
        for n, v in ops:
            bw.put(n, v)
        bw.put1(3)
        tail.put_bits_from(data, 13, 101)
        bw.extend(tail)
        pad = bw.align()
        outs.append((pad, bw.nbits, bw.bytes()))
    assert outs[0] == outs[1]


@pytest.mark.parametrize("kind", KINDS)
def test_adts_writers_match_jax(kind):
    """adts_to_asc, make_asc, adts_frame_header and mux_adts: the same
    bytes, and the re-muxed stream equals the committed one."""
    data = _stream(kind)
    asc, raw = adts.adts_to_asc(data)
    jasc, jraw = jax_adts.adts_to_asc(data)
    assert (asc, raw) == (jasc, jraw)
    h = probe_adts(data)
    cfg = (h.object_type, h.sampling_index, h.chan_config)
    assert adts.make_asc(*cfg) == jax_adts.make_asc(*cfg) == asc
    assert adts.adts_frame_header(len(raw[0]), *cfg) == \
        jax_adts.adts_frame_header(len(raw[0]), *cfg) == data[:7]
    args = (h.object_type, h.sample_rate, h.chan_config)
    assert adts.mux_adts(raw, *args) == jax_adts.mux_adts(raw, *args) == data


def test_adts_to_asc_refuses_a_pce_layout():
    """Channel config 0 (the layout in an in-band PCE): both filters
    refuse it."""
    for mod in (adts, jax_adts):
        with pytest.raises(ValueError, match="PCE"):
            mod.adts_to_asc(_stream("cce_after"))


@pytest.mark.parametrize("per", [0, 7])
@pytest.mark.parametrize("kind", KINDS)
def test_mp4_mux_demux_match_jax(kind, per):
    """mux_m4a (one chunk, or chunks of 7 frames with a short tail),
    demux_m4a, m4a_to_adts and probe_m4a: the same bytes and values."""
    asc, raw = adts.adts_to_asc(_stream(kind))
    ch = 2 if kind == "he_v1s" else 1
    m4a = mp4.mux_m4a(raw, asc, 24000, ch, frames_per_chunk=per)
    assert m4a == jax_mp4.mux_m4a(raw, asc, 24000, ch, frames_per_chunk=per)
    assert mp4.make_esds(asc, 64000) == jax_mp4.make_esds(asc, 64000)
    got, want = demux_m4a(m4a), jax_mp4.demux_m4a(m4a)
    assert (got.asc, got.frames, got.sample_rate, got.channels,
            got.timescale) == (want.asc, want.frames, want.sample_rate,
                               want.channels, want.timescale)
    assert got.frames == raw and got.asc == asc
    assert mp4.m4a_to_adts(m4a) == jax_mp4.m4a_to_adts(m4a) == _stream(kind)
    assert probe_m4a(m4a) and jax_mp4.probe_m4a(m4a)
    assert not probe_m4a(_stream(kind)) and not jax_mp4.probe_m4a(
        _stream(kind))


@pytest.mark.parametrize("name", [n for n, _, _ in golden_tool().FRONT_LIST])
def test_front_inputs_remade_by_the_port(name):
    """The committed .m4a inputs (JAX muxer) again from the port's
    filter and muxer, byte for byte; the explicit-SBR ones refuse the
    ADTS re-wrap in both packages."""
    tool = golden_tool()
    with open(f"{REPO}/{tool.FRONT_FILE.format(name)}", "rb") as f:
        want = f.read()
    assert tool.front_m4a(name, adts.adts_to_asc, mux_m4a) == want
    if "explicit" in name or name == "ds_0":
        for mod in (mp4, jax_mp4):
            with pytest.raises(jax_mp4.Mp4Error if mod is jax_mp4
                               else Mp4Error, match="SBR"):
                mod.m4a_to_adts(want)


@pytest.mark.parametrize("as_tensor", [False, True])
def test_wav_matches_jax(tmp_path, as_tensor):
    """write_wav gives the JAX writer's bytes, also from the CPU int16
    tensor the port's decoders return; read_wav reads them back."""
    pcm = (np.arange(2000).reshape(-1, 2) % 251 - 125).astype(np.int16)
    wav.write_wav(str(tmp_path / "p.wav"), torch.from_numpy(pcm)
                  if as_tensor else pcm, 48000)
    jax_wav.write_wav(str(tmp_path / "j.wav"), pcm, 48000)
    assert (tmp_path / "p.wav").read_bytes() == \
        (tmp_path / "j.wav").read_bytes()
    got, rate = wav.read_wav(str(tmp_path / "p.wav"))
    assert rate == 48000 and np.array_equal(got, pcm)


# the non-golden demuxer tests of tests/test_mp4.py, against the port

def test_demux_rejects_garbage():
    assert not probe_m4a(b"\xff\xf1\x00\x00\x00\x00\x00\x00")
    with pytest.raises(Mp4Error):
        demux_m4a(b"\x00\x00\x00\x08ftyp" + b"\x00" * 64)
    with pytest.raises(Mp4Error):       # truncated box
        demux_m4a(b"\x00\x00\xff\xffmoov")


def test_demux_fuzz_robustness():
    """Structured fuzz over the demuxer: truncations, byte flips, and
    targeted hostile sample-table counts must all either parse or raise
    Mp4Error -- never struct.error/IndexError, never an allocation bomb
    (mov.c bounds every table read by atom.size the same way)."""
    asc = adts.make_asc(2, 4, 2)
    frames = [bytes([i & 0xFF] * (20 + 7 * (i % 13))) for i in range(40)]
    good = mux_m4a(frames, asc, 44100, 2, frames_per_chunk=7)
    demux_m4a(good)                       # sanity: the base file parses

    def check(blob):
        try:
            t = demux_m4a(blob)
            # chunks may overlap after mutation (sum can exceed the file),
            # but every individual sample read must have been in bounds
            assert all(len(f) <= len(blob) for f in t.frames)
        except Mp4Error:
            pass

    # every truncation length
    for n in range(0, len(good), 17):
        check(good[:n])
    # deterministic random byte flips (3 per mutant)
    rng = random.Random(0xAAC)
    for _ in range(300):
        b = bytearray(good)
        for _ in range(3):
            b[rng.randrange(len(good))] = rng.randrange(256)
        check(bytes(b))

    # targeted: hostile counts in stsz/stsc/stco must not allocate
    # count*entry memory or read past their boxes
    def patch_u32(blob, fourcc, field_off, val):
        i = blob.find(fourcc)
        assert i > 0, fourcc
        b = bytearray(blob)
        st.pack_into(">I", b, i + 4 + field_off, val)
        return bytes(b)

    for fourcc, off in ((b"stsz", 8), (b"stsc", 4), (b"stco", 4)):
        hostile = patch_u32(good, fourcc, off, 0x7FFFFFFF)
        with pytest.raises(Mp4Error):
            demux_m4a(hostile)
    # hostile fixed-size stsz: fixed*count far beyond the file
    b = bytearray(good)
    i = b.find(b"stsz")
    st.pack_into(">II", b, i + 8, 0x10000, 0x10000)   # fixed, count
    with pytest.raises(Mp4Error):
        demux_m4a(bytes(b))
