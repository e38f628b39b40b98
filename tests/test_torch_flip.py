"""Mid-stream PS band-mode flips (20 <-> 34 bands) in the PyTorch port
against the JAX package: map_val_20_to_34 / map_val_34_to_20 and
_convert_ps_flip (eager JAX, exact), expand_frame(is34=-1) at the first
flip of flip streams 0 and 1 (integers exact, floats within 1e-6 of each
element), the flip scan started from the JAX flip scan's carry just after
stream 1's flip, the eight flip streams in one 8-lane flip scan,
decode_qwire_flip_stream on the flip + coupling-channel stream, and
decode_batch and QwirePipelinedDecoder routing: PCM within 2 int16 LSB of
tests/data/flip_golden_jax.npz (tools/make_torch_golden.py: the JAX
decode_qwire_flip_stream over the first 16 frames; no JAX scan compiles
here).  Streams: tests/data/heaac_v2_flip_{0..7}.aac and
heaac_flip_cce_0.aac (tools/make_torch_streams.py)."""
import functools
import logging

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from heaac_tpu.codec import heaac_graph as jg
from heaac_tpu.ops import ps_jax
from heaac_tpu_torch import decode_batch
from heaac_tpu_torch.codec import batch, heaac_graph, qwire
from heaac_tpu_torch.codec.batch import (QwirePipelinedDecoder,
                                         decode_qwire_flip_stream,
                                         pack_planner_frames)
from heaac_tpu_torch.codec.planner import parse_stream_qwire
from heaac_tpu_torch.codec.state import carry_from_numpy, carry_to_numpy
from heaac_tpu_torch.host import (R_W1, parse_adts_header, spec_static_args,
                                  split_adts_stream)
from heaac_tpu_torch.ops import ps
from test_torch_common import (  # noqa: F401 (autouse fixture)
    assert_exact, golden_tool, n, release_jax_memory, streams_of, t)

TOL_LSB = 2
FRAMES = 16        # frames of each stream in the golden
SCAN_FRAMES = 12   # frames of the 8-lane scan: every flip is at frame <= 11


@functools.cache
def gold() -> dict:
    with np.load(golden_tool().FLIP_GOLDEN) as z:
        return {k: z[k] for k in z.files}


def sub(prefix: str) -> dict:
    g = gold()
    return {k[len(prefix) + 1:]: v for k, v in g.items()
            if k.startswith(prefix + "/")}


def tens(tree):
    """Nested dicts of numpy arrays -> the same of CPU tensors."""
    if isinstance(tree, dict):
        return {k: tens(v) for k, v in tree.items()}
    return t(tree)


def stereo_rows(pcm) -> np.ndarray:
    """[T, 1, 2, 2048] mono-core lane -> [T * 2048, 2] int32."""
    return n(pcm)[:, 0].transpose(0, 2, 1).reshape(-1, 2).astype(np.int32)


def lsb(got, name: str, f0: int = 0, f1: int = FRAMES) -> int:
    want = gold()[f"pcm_{name}"][f0 * 2048:f1 * 2048].astype(np.int32)
    got = np.asarray(got, np.int32)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert np.abs(want).max() > 1000, name
    return int(np.abs(got - want).max())


@pytest.mark.parametrize("way", ["20_to_34", "34_to_20"])
def test_map_val_matches_jax(way):
    v = (np.random.default_rng(len(way)).standard_normal((3, 2, 34, 4))
         * 50).astype(np.float32)
    fn = f"map_val_{way}"
    assert_exact(getattr(ps, fn)(t(v)), getattr(ps_jax, fn)(jnp.asarray(v)),
                 fn)


def test_convert_ps_flip_matches_jax():
    rng = np.random.default_rng(4)
    B = 4
    shapes = heaac_graph.STATE_SHAPES
    state = {k: (rng.standard_normal((B,) + s) * 10).astype(np.float32)
             for k, s in shapes.items()}
    ph = dict(H=rng.standard_normal((B, 2, 6, 34, 4)).astype(np.float32),
              ipd_hist=rng.integers(0, 64, (B, 17)),
              opd_hist=rng.integers(0, 64, (B, 17)))
    to34 = np.array([1, 0, 0, 1], bool)
    to20 = np.array([0, 1, 0, 0], bool)
    js, jph = jg._convert_ps_flip(
        jg.HeaacState(**{k: jnp.asarray(v) for k, v in state.items()}),
        {k: jnp.asarray(v.astype(np.int32) if v.dtype.kind == "i" else v)
         for k, v in ph.items()}, jnp.asarray(to34), jnp.asarray(to20))
    ps_state, pph = heaac_graph._convert_ps_flip(
        heaac_graph.HeaacState(**tens(state)), tens(ph), t(to34, torch.bool),
        t(to20, torch.bool))
    assert_exact(ps_state._asdict(), js._asdict(), "state")
    assert_exact(pph, jph, "ps_hist")
    # lanes that do not flip keep everything
    assert_exact(pph["H"][2], ph["H"][2], "unflipped H")


@pytest.mark.parametrize("stream", [0, 1])
def test_expand_frame_flip_matches_golden(stream):
    """From the JAX carry before the flip frame: the flip frame and the
    next, the band mode ``m34`` included."""
    tool = golden_tool()
    f = tool.FLIP_EXPAND[stream]
    g = sub(f"expand_{stream}")
    heap = t(g["heap"].astype(np.int32))
    recs = g["recs"]
    qc = tens(tool.unflatten_tree(g, f"carry_{f - 1}"))
    trail = gold()[f"trail_flip_{stream}"]
    assert trail[f] != trail[f - 1]
    for k in (f, f + 1):
        core_meta, plan, pc, qc = qwire.expand_frame(heap, t(recs[k]), qc, -1)
        want = tool.unflatten_tree(g, f"frame_{k}")
        for name, a, b in zip(("core_meta", "plan", "pc"),
                              (core_meta, plan, pc), want):
            assert_exact(a, b, f"frame {k} {name}",
                         float_rtol=1e-6 if name == "plan" else 0.0)
        assert_exact(qc, tool.unflatten_tree(g, f"carry_{k}"),
                     f"frame {k} carry")
        assert int(n(pc["m34"])[0]) == trail[k]


def test_flip_scan_from_jax_carry_matches_golden():
    """Frames 10-15 of flip stream 1 (34 -> 20 bands at frame 9) from the
    JAX flip scan's carry after frames 0-9."""
    tool = golden_tool()
    g = gold()
    carry = carry_from_numpy(tool.unflatten_tree(g, "scan_carry"), "cpu")
    assert len(carry) == 4 and int(n(carry[3])[0]) == 0   # 20 bands now
    ds, S, rate_idx, NB, NS, SEC, RP = (int(x) for x in g["scan_static"])
    k = tool.FLIP_CARRY_FRAMES
    carry, pcm = heaac_graph.qwire_scan_decode_flip(
        t(g["scan_heap"]), t(g["scan_recs"][k:]), carry, ds, S, rate_idx,
        NB, NS, SEC, RP)
    assert lsb(stereo_rows(pcm), f"flip_{tool.FLIP_CARRY_STREAM}", k) \
        <= TOL_LSB
    assert len(carry_to_numpy(carry)) == 4


def test_flip_streams_in_one_scan_match_golden():
    """The eight flip streams as eight lanes of one flip scan over their
    first SCAN_FRAMES frames: each lane within 2 LSB of its JAX decode,
    and each stream's band-mode trail as scheduled
    (tools/make_torch_streams.py)."""
    streams = streams_of("flip", 8)
    frames, worst = [], {}
    for i, data in enumerate(streams):
        trail = []
        frames_q, _, nl, _, ds = parse_stream_qwire(
            data, max_frames=FRAMES, is34_out=trail)
        assert (nl, ds) == (1, 0)
        assert trail == list(gold()[f"trail_flip_{i}"])
        first, switches = {0: (0, {6: 1}), 1: (1, {9: 0}),
                           2: (0, {5: 1, 11: 0}),
                           3: (1, {2: 0, 11: 1})}[i % 4]
        want = [first]
        for f in range(1, FRAMES):
            want.append(switches.get(f, want[-1]))
        assert trail == want, i
        frames.append(frames_q)
    heap, cur, recs = pack_planner_frames(frames, 1, SCAN_FRAMES)
    S = -(-max(64, int((recs[..., R_W1] & 0xFFFF).max())) // 64) * 64
    sa = spec_static_args(recs)
    _, pcm = heaac_graph.qwire_scan_decode_flip(
        t(heap), t(recs), heaac_graph.init_qwire_flip_carry(8, "cpu"), 0, S,
        parse_adts_header(streams[0][:7]).sampling_index, sa["NB"],
        sa["NS"], sa["SEC"])
    for i in range(8):
        worst[i] = lsb(stereo_rows(pcm[:, i:i + 1]), f"flip_{i}", 0,
                       SCAN_FRAMES)
    assert max(worst.values()) <= TOL_LSB, worst


def test_decode_qwire_flip_stream_with_coupling_matches_golden():
    """The flip + coupling-channel stream: its band mode flips 20 -> 34 at
    frame 6, and the AFTER_IMDCT coupling mixes into the float PCM."""
    data = streams_of("flip_cce", 1)[0]
    trail, info = [], {}
    parse_stream_qwire(data, max_frames=FRAMES, is34_out=trail,
                       info_out=info)
    assert trail == [0] * 6 + [1] * (FRAMES - 6)
    assert trail == list(gold()["trail_flip_cce_0"])
    assert info["couple"] is not None and info["out_nl"] == 1
    pcm = decode_qwire_flip_stream(data, max_frames=FRAMES, device="cpu")
    assert pcm.dtype == torch.int16 and tuple(pcm.shape) == (
        FRAMES * 2048, 2)
    assert lsb(pcm.numpy(), "flip_cce_0") <= TOL_LSB


def _head(data: bytes, frames: int) -> bytes:
    return b"".join(split_adts_stream(data)[:frames])


def test_decode_batch_sends_flip_streams_through_the_flip_scan(caplog):
    T = 10                        # past the first flip of each flip stream
    named = [("flip_0", streams_of("flip", 1)[0]),
             ("he20_0", streams_of("he20", 1)[0]),
             ("flip_1", streams_of("flip", 2)[1]),
             ("he34_0", streams_of("he34", 1)[0]),
             ("flip_cce_0", streams_of("flip_cce", 1)[0])]
    caplog.set_level(logging.INFO, logger="heaac_tpu_torch")
    outs = decode_batch([_head(d, T) for _, d in named], device="cpu")
    flips = sorted(r.flip_stats["stream"] for r in caplog.records
                   if hasattr(r, "flip_stats"))
    assert flips == [0, 2, 4]
    batched = sorted((r.bucket_stats["key"][3], r.bucket_stats["streams"])
                     for r in caplog.records if hasattr(r, "bucket_stats"))
    assert batched == [(0, 1), (1, 1)]
    for k, (name, _) in enumerate(named):
        assert tuple(outs[k].shape) == (T * 2048, 2), name
        if name.startswith("flip"):
            assert lsb(outs[k].numpy(), name, 0, T) <= TOL_LSB, name
    tool = golden_tool()
    with np.load(tool.BATCH_GOLDEN) as z:
        want = {str(nm): z[f"pcm_{j}"] for j, nm in enumerate(z["names"])}
    for k in (1, 3):
        name = named[k][0]
        d = np.abs(outs[k].numpy().astype(np.int32)
                   - want[name][:T * 2048]).max()
        assert d <= TOL_LSB, name


@pytest.mark.parametrize("kind", ["he20", "cce_after"])
def test_pipelined_decoder_planner_fallback_matches_native(kind, caplog):
    """The native parse refused for stream 1 (as for a stream it cannot
    take): the Python planner parses it into the same staging (raw-f32
    lanes overflow the first heap: grow and retry), within 2 LSB of the
    native decode of the same stream."""
    streams = [_head(d, 4) for d in streams_of(kind, 2)]
    native = QwirePipelinedDecoder(streams, group_streams=2, max_frames=4,
                                   device="cpu").decode()[0].numpy()
    dec = QwirePipelinedDecoder(streams, group_streams=2, max_frames=4,
                                device="cpu")
    parse = dec.parser.parse_qwire
    refused = streams[1]
    dec.parser.parse_qwire = lambda data, *a: (
        -1 if data == refused else parse(data, *a))
    caplog.set_level(logging.INFO, logger="heaac_tpu_torch")
    got = dec.decode()[0].numpy()
    msgs = [r.getMessage() for r in caplog.records]
    assert "qwire pipelined decode: stream 1 fell back to the Python " \
        "planner" in msgs
    assert dec.frame_counts == [4, 4] and dec.error_count == 0
    assert np.abs(native).max() > 1000
    assert np.abs(got.astype(np.int32) - native).max() <= TOL_LSB


def test_downsampled_sbr_raises(monkeypatch):
    """ADTS never signals downsampled SBR (the flip and plain scans take
    it from an AudioSpecificConfig: tests/test_torch_downsampled.py), so
    the batched decoder refuses a planner parse that reports it, here
    made to."""
    streams = [_head(streams_of("he20", 1)[0], 2)]
    dec = QwirePipelinedDecoder(streams, group_streams=1, max_frames=2,
                                device="cpu")
    dec.parser.parse_qwire = lambda *a: -1      # the planner parses it
    real = batch.parse_stream_qwire
    monkeypatch.setattr(batch, "parse_stream_qwire",
                        lambda *a, **kw: real(*a, **kw)[:4] + (1,))
    with pytest.raises(NotImplementedError, match="downsampled SBR"):
        dec.decode()
