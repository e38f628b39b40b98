"""The plan-record decoders of the PyTorch port against the JAX package,
on the CPU: host plans, the compact expansion and the decoders' PCM.

``parse_stream_plans`` of both packages, leaf by leaf and exactly
(dtypes and shapes too), on the native and the Python route (forced in
both packages by setting each package's ``native.available`` False),
compact and dense, and with an AudioSpecificConfig (downsampled SBR);
the port's ``expand_sbr`` of its compact records equal to its dense
plans exactly, and within 1e-6 of
each element of the JAX ``expand_sbr`` in the golden; the PCM of
``StreamBatchDecoder`` (compact and dense), ``BatchDecoder``,
``QStreamBatchDecoder`` and ``heaac_frame_compact`` within 2 int16 LSB
of tests/data/plan_golden_jax.npz (tools/make_torch_plan_golden.py: the
JAX decoders over the first 16 frames; no JAX scan compiles here); a PS
band-mode flip raising NotImplementedError in both packages; and
``imdct_half_fft`` within 1e-5 of the peak of the JAX function's output
(eager; f32 matmul summation order)."""
import functools
import importlib.util
import os

import numpy as np
import pytest
import torch

import heaac_tpu.native as jax_native
from heaac_tpu.codec import batch as jax_batch
from heaac_tpu.ops import imdct as jax_imdct
from heaac_tpu_torch import native
from heaac_tpu_torch.codec import compact_plan, heaac_graph
from heaac_tpu_torch.codec.batch import (BatchDecoder, QStreamBatchDecoder,
                                         StreamBatchDecoder)
from heaac_tpu_torch.codec.planner import parse_stream_plans
from heaac_tpu_torch.host import split_adts_stream
from heaac_tpu_torch.ops import imdct
from test_torch_common import (  # noqa: F401 (autouse fixture)
    REPO, assert_exact, assert_peak_close, golden_tool, n,
    release_jax_memory, streams_of, t)

TOL_LSB = 2
FRAMES = 16
PARSE_FRAMES = 8    # frames of the Python-route parses (host Python)


def plan_tool():
    """tools/make_torch_plan_golden.py as a module (its KINDS, the graft
    entry's inputs; it imports the JAX package only in its writer)."""
    spec = importlib.util.spec_from_file_location(
        "make_torch_plan_golden",
        os.path.join(REPO, "tools", "make_torch_plan_golden.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


TOOL = plan_tool()


@functools.cache
def gold() -> dict:
    with np.load(TOOL.PLAN_GOLDEN) as z:
        return {k: z[k] for k in z.files}


def corrupt_he20() -> bytes:
    return golden_tool().corrupted("he20_f1_0")


def parse_input(kind: str) -> tuple:
    """(stream 0 of a kind, its ASC or None)."""
    if kind == "he20_f1_0":
        return corrupt_he20(), None
    streams, asc = TOOL.kind_streams(kind)
    return streams[0], asc


def max_lsb(a, b) -> int:
    return int(np.abs(n(a).astype(np.int32) - n(b).astype(np.int32)).max())


@pytest.fixture
def python_route(monkeypatch):
    """Both packages' plan parsers on their Python route."""
    monkeypatch.setattr(native, "available", lambda: False)
    monkeypatch.setattr(jax_native, "available", lambda: False)


def assert_same_parse(got, want, what):
    for i, name in enumerate(("core", "sbr", "ps")):
        assert set(got[i]) == set(want[i]), (what, name)
        for k in want[i]:
            g, w = np.asarray(got[i][k]), np.asarray(want[i][k])
            assert (g.dtype, g.shape) == (w.dtype, w.shape), \
                (what, name, k, g.dtype, g.shape, w.dtype, w.shape)
            np.testing.assert_array_equal(g, w, err_msg=f"{what} {name}.{k}")
    assert tuple(got[3:]) == tuple(want[3:]), what


@pytest.mark.parametrize("compact", [True, False], ids=["compact", "dense"])
@pytest.mark.parametrize("route", ["native", "python"])
@pytest.mark.parametrize("kind", ["he20", "he34", "he_v1s", "he20_f1_0",
                                  "ds"])
def test_parse_stream_plans_matches_jax(kind, route, compact, request):
    """20- and 34-band HE-AAC v2, stereo HE-AAC v1 (two lanes), a stream
    with a corrupt frame 1 (a silence frame on both routes) and
    downsampled SBR through its ASC (always the Python planner)."""
    if route == "python":
        request.getfixturevalue("python_route")
    data, asc = parse_input(kind)
    frames = FRAMES if route == "native" else PARSE_FRAMES
    got = parse_stream_plans(data, asc=asc, max_frames=frames,
                             compact=compact)
    want = jax_batch.parse_stream_plans(data, asc=asc, max_frames=frames,
                                        compact=compact)
    assert_same_parse(got, want, f"{kind} {route}")
    assert len(got[0]["coeffs"]) == frames


def expand_frames(sbr: dict, frames: int) -> list:
    return [n(compact_plan.expand_sbr({k: t(v[f]) for k, v in sbr.items()}))
            for f in range(frames)]


@pytest.mark.parametrize("kind", ["he20", "he34", "he_v1s", "ds"])
def test_expand_sbr_equals_dense_plan(kind, python_route):
    """The port's expand_sbr of its compact records (build_sbr_compact)
    equals its dense plans (build_sbr_plan) exactly, frame by frame."""
    data, asc = parse_input(kind)
    _, sbr_c, *_ = parse_stream_plans(data, asc=asc,
                                      max_frames=PARSE_FRAMES, compact=True)
    _, sbr_d, *_ = parse_stream_plans(data, asc=asc,
                                      max_frames=PARSE_FRAMES, compact=False)
    for f, got in enumerate(expand_frames(sbr_c, PARSE_FRAMES)):
        assert set(got) == set(sbr_d)
        for k, want in sbr_d.items():
            np.testing.assert_array_equal(
                got[k].astype(want.dtype), want[f],
                err_msg=f"{kind} frame {f} {k}")


def test_expand_sbr_matches_jax_golden():
    """expand_sbr of bench streams 0-1's native compact records against
    the JAX expand_sbr in the golden: integers exactly, floats within
    1e-6 of each element."""
    g = gold()
    streams, _ = TOOL.kind_streams("he20")
    sbrs = [parse_stream_plans(s, max_frames=TOOL.EXPAND_FRAMES,
                               compact=True)[1] for s in streams]
    sbr = {k: np.concatenate([s[k] for s in sbrs], 1) for k in sbrs[0]}
    frames = expand_frames(sbr, TOOL.EXPAND_FRAMES)
    for k in frames[0]:
        assert_exact(np.stack([f[k] for f in frames]), g[f"expand/{k}"],
                     f"expand.{k}", float_rtol=1e-6)


@pytest.mark.parametrize("mode", ["compact", "dense"])
@pytest.mark.parametrize("kind", list(TOOL.KINDS))
def test_stream_batch_decoder_matches_golden(kind, mode):
    streams, asc = TOOL.kind_streams(kind)
    dec = StreamBatchDecoder(streams, asc=asc, max_frames=FRAMES,
                             compact=mode == "compact", device="cpu")
    g = gold()
    p = f"{kind}_{mode}"
    assert (dec.lanes_per_stream, dec.is34, dec.ds, dec.sample_rate) == \
        tuple(int(g[f"{p}/{k}"]) for k in ("lanes", "is34", "ds", "rate"))
    assert dec.frame_counts == g[f"{p}/frame_counts"].tolist()
    pcm = dec.decode()
    assert pcm.dtype == torch.int16 and pcm.shape == g[f"{p}/pcm"].shape
    assert max_lsb(pcm, g[f"{p}/pcm"]) <= TOL_LSB
    assert dec.audio_seconds() == pytest.approx(
        len(streams) * FRAMES * (1024 << (not dec.ds)) / dec.sample_rate)


def test_compact_and_dense_scans_agree_and_pad_short_streams():
    """Compact and dense plans decode to the same PCM; a stream shorter
    than the batch's longest is padded with silence (its frame count
    kept), and ``batch`` repeats the streams."""
    streams, _ = TOOL.kind_streams("he20")
    short = b"".join(split_adts_stream(streams[1])[:5])
    outs = []
    for compact in (True, False):
        dec = StreamBatchDecoder([streams[0], short], batch=3, max_frames=8,
                                 compact=compact, device="cpu")
        assert dec.frame_counts == [8, 5, 8]
        outs.append(n(dec.decode()))
    np.testing.assert_array_equal(outs[0], outs[1])
    np.testing.assert_array_equal(outs[0][:, 0], outs[0][:, 2])
    assert max_lsb(outs[0][:5, :2], gold()["he20_compact/pcm"][:5]) <= \
        TOL_LSB


def test_batch_decoder_tiles_one_stream():
    """The JAX BatchDecoder fails on its first frame (the golden's
    record); the port's decodes B copies of the stream, equal to the
    dense StreamBatchDecoder over it and within 2 LSB of the JAX dense
    golden."""
    for i in range(2):
        assert str(gold()[f"batch_decoder_error_{i}"]).startswith(
            "TypeError: mul got incompatible shapes")
    streams, _ = TOOL.kind_streams("he20")
    data = b"".join(split_adts_stream(streams[1])[:FRAMES])
    dec = BatchDecoder(data, batch=2, device="cpu")
    assert (dec.T, dec.nl, dec.is34, dec.ds) == (FRAMES, 1, 0, 0)
    pcm = dec.decode_all()                         # [B, T * 2048, 2]
    assert pcm.dtype == torch.int16 and pcm.shape == (2, FRAMES * 2048, 2)
    ref = StreamBatchDecoder([data], batch=2, compact=False,
                             device="cpu").decode()
    np.testing.assert_array_equal(
        n(pcm), n(ref).transpose(1, 0, 3, 2).reshape(2, -1, 2))
    want = gold()["he20_dense/pcm"][:, 1]          # [T, 2, 2048]
    for b in range(2):
        assert max_lsb(pcm[b].T.reshape(2, FRAMES, 2048).transpose(0, 1),
                       want) <= TOL_LSB
    dec.warmup()
    assert dec.run() == pytest.approx(2 * FRAMES * 2048 / 48000)


def test_qstream_batch_decoder_matches_golden():
    """QStreamBatchDecoder (every stream through the Python qwire
    planner) within 2 LSB of the JAX compact golden (the JAX package
    holds the two routes equal)."""
    streams, _ = TOOL.kind_streams("he20")
    dec = QStreamBatchDecoder(streams, max_frames=FRAMES, device="cpu")
    pcm = dec.decode()
    assert pcm.shape == gold()["he20_compact/pcm"].shape
    assert max_lsb(pcm, gold()["he20_compact/pcm"]) <= TOL_LSB
    assert dec.audio_seconds() == pytest.approx(2 * FRAMES * 2048 / 48000)


def test_heaac_frame_compact_on_graft_inputs():
    """The graft entry's synthetic compact records, rebuilt by the port's
    compact_plan, equal the JAX entry's; one heaac_frame_compact step
    within 2 LSB of the JAX step in the golden."""
    import importlib
    entry = importlib.import_module("__graft_entry__").entry
    _, (jcore, jsc, jpc, _) = entry()
    B = TOOL.GRAFT_B
    got = TOOL.graft_compact_inputs(compact_plan, B)
    for g_, w in zip(got, (jcore, jsc, jpc)):
        assert set(g_) == set(w)
        for k in w:
            np.testing.assert_array_equal(g_[k], np.asarray(w[k])[:B])
    core, sc, pc = ({k: torch.from_numpy(v) for k, v in d.items()}
                    for d in got)
    pcm, (state, ph) = heaac_graph.heaac_frame_compact(
        core, sc, pc, heaac_graph.init_compact_state(B, "cpu"))
    want = gold()["graft/pcm"]
    assert pcm.shape == want.shape
    assert np.abs(n(pcm) - want).max() <= TOL_LSB
    assert n(ph["H"]).any()


@pytest.mark.parametrize("compact", [True, False], ids=["compact", "dense"])
def test_ps_band_mode_flip_raises_in_both_packages(compact):
    """Flip stream 0 (20 -> 34 bands at frame 6): the plan planners of
    both packages refuse it."""
    data = streams_of("flip", 1)[0]
    for parse in (parse_stream_plans, jax_batch.parse_stream_plans):
        with pytest.raises(NotImplementedError, match="band mode"):
            parse(data, max_frames=8, compact=compact)


@pytest.mark.parametrize("scale", [1.0, -1.0 / 1024])
def test_imdct_half_fft_matches_jax(scale):
    x = np.random.default_rng(3).standard_normal((3, 1024)).astype(
        np.float32)
    consts = imdct.imdct_fft_consts(1024, 32, scale)
    for a, b in zip(consts, jax_imdct.imdct_fft_consts(1024, 32, scale)):
        np.testing.assert_array_equal(a, b)
    got = imdct.imdct_half_fft(t(x), consts)
    want = np.asarray(jax_imdct.imdct_half_fft(x, consts))
    assert_peak_close(got, want, 1e-5, "imdct_half_fft")
    assert_peak_close(got, jax_imdct.imdct_half_ref(x, scale), 1e-5,
                      "imdct_half_ref")
