"""The port's stream generators (``heaac_tpu_torch.io.heaac_testgen``)
against the JAX package's, byte for byte.

Every writer and splicer runs in both packages on the same LC cores (the
first CORE_FRAMES frames of benchdata/lc_core_24k_{0,1}.aac, and a
stereo 24 kHz core from the encoder), over the options the repo's tests
and tools use: SBR inverse filtering, envelope range, amplitude
resolution, coupled and uncoupled CPEs, grid classes, a fixed envelope
count, CRC, header cadence and no header, delta-frequency only, no
harmonics, the crossover band, skipped frames; PS band modes with
switches, IPD/OPD and frame classes; SBR after each element of a
multi-element stream; the PCE rewrite; coupling channels before TNS,
between TNS and the IMDCT and after the IMDCT, from frame 0 or later.
The generators find each element's end with the port's parse-only
``Decoder`` (``device=None``), whose native element parse must place
every element end where its Python parse and the JAX Decoder do.  The
JAX generators are numpy: nothing is compiled.
"""
import functools
import hashlib
import os

import numpy as np
import pytest

from heaac_tpu.bitstream.reader import BitReader as JaxBitReader
from heaac_tpu.codec.decoder import Decoder as JaxDecoder
from heaac_tpu.io import heaac_testgen as jax_tg
from heaac_tpu_torch import tables as T
from heaac_tpu_torch.bitstream.adts import parse_adts_header
from heaac_tpu_torch.bitstream.reader import BitReader
from heaac_tpu_torch.codec.decoder import Decoder
from heaac_tpu_torch.codec.encoder import AacEncoder
from heaac_tpu_torch.host import split_adts_stream
from heaac_tpu_torch.io import heaac_testgen as tg
from test_torch_common import (  # noqa: F401 (autouse fixture)
    REPO, golden_tool, release_jax_memory)

CORE_FRAMES = 6


@functools.cache
def core(i: int) -> bytes:
    """The first CORE_FRAMES frames of bundled LC core i (24 kHz mono)."""
    with open(os.path.join(REPO, "benchdata", f"lc_core_24k_{i}.aac"),
              "rb") as f:
        return b"".join(split_adts_stream(f.read())[:CORE_FRAMES])


@functools.cache
def stereo_core() -> bytes:
    """A 24 kHz stereo LC core (one CPE), CORE_FRAMES frames."""
    n = (CORE_FRAMES - 1) * 1024
    t = np.arange(n) / 24000
    x = np.stack([0.4 * np.sin(2 * np.pi * 500 * t),
                  0.3 * np.sin(2 * np.pi * 730 * t)], -1)
    return AacEncoder(24000, 2).encode((x * 8000).astype(np.int16))


def _sbr(m, seed, ps=None, **kw):
    kw.setdefault("env_hi_shift", -12)
    return m.SbrStreamWriter(core_rate=24000, is_cpe=kw.pop("is_cpe", False),
                             seed=seed, ps_writer=ps, **kw)


def _bounded_ps(m, **kw):
    """A PsStreamWriter whose payloads stay under 160 bytes (re-rolled
    draws), as tools/make_torch_streams.py bounds 34-band PS."""
    ps = m.PsStreamWriter(**kw)
    ps.ps_payload = functools.partial(m.PsStreamWriter.ps_payload, ps,
                                      max_bytes=160)
    return ps


# name -> stream built with generator module m (the port's or JAX's)
CASES = {
    "ps20_invf": lambda m: m.splice_sbr_into_lc(
        core(0), _sbr(m, 3, m.PsStreamWriter(seed=4))),
    "ps34_ipdopd_amp_res0": lambda m: m.splice_sbr_into_lc(
        core(1), _sbr(m, 5, _bounded_ps(m, seed=6, iid_mode=5, icc_mode=2,
                                        enable_ipdopd=True),
                      amp_res=0, invf_modes=(0,))),
    "ps20_frame_class1": lambda m: m.splice_sbr_into_lc(
        core(0), _sbr(m, 15, m.PsStreamWriter(
            seed=16, frame_classes=(1,), header_every=3), invf_modes=(0,))),
    "ps_switch_at": lambda m: m.splice_sbr_into_lc(
        core(0), _sbr(m, 7, m.PsStreamWriter(
            seed=8, iid_mode=1, icc_mode=1, switch_at={2: (2, 2), 4: 1}),
            invf_modes=(0,))),
    "fixfix_crc_headers": lambda m: m.splice_sbr_into_lc(
        core(1), _sbr(m, 9, grid_classes=(0,), fix_num_env=2, crc=True,
                      header_every=2, allow_df=False, allow_harmonics=False,
                      xover_band=1, env_hi_shift=0)),
    "no_header_skip_frames": lambda m: m.splice_sbr_into_lc(
        core(0), _sbr(m, 11, no_header=True), skip_frames=(2, 3)),
    "skip_frames_varvar": lambda m: m.splice_sbr_into_lc(
        core(1), _sbr(m, 12, grid_classes=(3,), invf_modes=(0,)),
        skip_frames={3, 4}),
    "cpe_coupled": lambda m: m.splice_sbr_into_lc(
        stereo_core(), _sbr(m, 13, is_cpe=True, coupling=True,
                            env_hi_shift=-14, grid_classes=(1, 2))),
    "cpe_uncoupled": lambda m: m.splice_sbr_into_lc(
        stereo_core(), _sbr(m, 14, is_cpe=True, amp_res=0,
                            invf_modes=(0,))),
    "pce_config0": lambda m: m.to_pce_config0(core(0)),
    "pce_config0_he": lambda m: m.splice_sbr_into_lc(
        m.to_pce_config0(core(1)), _sbr(m, 21, m.PsStreamWriter(seed=22),
                                        invf_modes=(0,))),
    "cce_before": lambda m: m.splice_cce_into_lc(
        core(0), coupling_point="before", seed=1),
    "cce_between": lambda m: m.splice_cce_into_lc(
        core(1), coupling_point="between", seed=2),
    "cce_after_start3": lambda m: m.splice_cce_into_lc(
        core(0), coupling_point="after", seed=3, start_frame=3),
    "cce_multi_sbr_ps": lambda m: m.splice_sbr_multi(
        m.splice_cce_into_lc(core(1), coupling_point="after"),
        {(T.TYPE_SCE, 0): _sbr(m, 11, m.PsStreamWriter(
            seed=5, switch_at={3: (1, 2)}), grid_classes=(0,),
            fix_num_env=1, invf_modes=(0,))}),
}


@pytest.mark.parametrize("name", list(CASES))
def test_generator_bytes_match_jax(name):
    got, want = CASES[name](tg), CASES[name](jax_tg)
    assert len(split_adts_stream(got)) == CORE_FRAMES and got == want


def test_ps_payloads_match_jax():
    """PsStreamWriter alone: ps_payload with its FIL bound and a tighter
    one (re-rolled draws), and switch_mode between payloads."""
    outs = []
    for m in (tg, jax_tg):
        w = m.PsStreamWriter(seed=3, iid_mode=4, icc_mode=1,
                             enable_ipdopd=True)
        got = []
        for f in range(8):
            if f == 4:
                w.switch_mode(2, 2)
            bw = w.ps_payload(max_bytes=None if f % 2 else 12)
            got.append((bw.nbits, bw.bytes() if bw.nbits % 8 == 0
                        else bw.nbits))
        outs.append(got)
    assert outs[0] == outs[1]


def test_payload_overflow_raises_value_error():
    """A delta outside its Huffman table raises ValueError in the port,
    where the JAX writer asserts (the stream makers re-draw on either)."""
    bw = tg.BitWriter()
    with pytest.raises(ValueError, match="outside Huffman table"):
        tg._put_vlc(bw, 0, 10 ** 6)
    with pytest.raises(AssertionError):
        jax_tg._put_vlc(jax_tg.BitWriter(), 0, 10 ** 6)


def test_distinct_streams_match_jax_and_golden():
    """``distinct_stream``, the one recipe of the distinct HE-AAC v2
    streams: the JAX writers draw the same bytes through it, and the
    port's first streams have the sha256 of the encode golden (the card
    run draws 512)."""
    tool = golden_tool()
    cores = tool.bench_cores(REPO)
    with np.load(tool.ENCODE_GOLDEN) as z:
        sha = [str(h) for h in z["distinct_sha256"]]
    got = [tg.distinct_stream(cores, i) for i in range(len(sha))]
    assert [hashlib.sha256(d).hexdigest() for d in got] == sha
    assert tg.distinct_stream(cores, 3, gen=jax_tg) == got[3]


def _element_ends(data: bytes, dec, reader) -> list:
    """Per frame (END element bit, [(etype, eid, end bit)]) from ``dec``'s
    element parse, as the splicers read them."""
    out = []
    for f in split_adts_stream(data):
        br = reader(f)
        dec.m4ac.object_type = parse_adts_header(br).object_type
        dec._parse_raw_data_block(br)
        out.append((dec._end_bitpos, list(dec._elem_ends)))
    return out


@pytest.mark.parametrize("name", ["mono", "stereo", "cce_after"])
def test_element_ends_native_match_python_and_jax(name):
    """The port's parse-only Decoder places every END and element end
    where its Python parse and the JAX Decoder do, with the native
    element parse (SCE / CPE) on every frame."""
    data = {"mono": lambda: core(0), "stereo": stereo_core,
            "cce_after": lambda: CASES["cce_after_start3"](tg)}[name]()
    head = data[:7]
    nat = Decoder(adts_probe=head, device=None)
    assert nat.use_native and nat.device is None
    got = _element_ends(data, nat, BitReader)
    py = _element_ends(data, Decoder(adts_probe=head, use_native=False,
                                     device=None), BitReader)
    jax = _element_ends(data, JaxDecoder(adts_probe=head), JaxBitReader)
    assert got == py == jax
    assert len(got) == CORE_FRAMES and all(ends for _, ends in got)
