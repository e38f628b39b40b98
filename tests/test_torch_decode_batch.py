"""``heaac_tpu_torch.decode_batch`` on the CPU: the mixed list of
tools/make_torch_golden.py (20-band and 34-band HE-AAC v2, stereo HE-AAC
v1 with M/S and coupled SBR, HE-AAC with a coupling channel applied after
the IMDCT or before TNS, AAC-LC and a buffer with no sync word,
interleaved) against the committed JAX golden
(tests/data/decode_batch_golden_jax.npz, written by that tool; JAX does
not run here), within 2 int16 LSB, each output in its input's place;
a stream no batched route takes (and a flip stream whose flip decode
fails) falls back to the single-stream decoder, as in the JAX package,
and matches the JAX Decoder's golden (tests/data/single_golden_jax.npz);
the ADTS splitter equals the JAX package's."""
import logging

import numpy as np
import pytest
import torch

from heaac_tpu.bitstream.adts import split_adts_stream as jax_split
from heaac_tpu_torch import decode_batch
from heaac_tpu_torch.codec import batch
from heaac_tpu_torch.host import split_adts_stream
from heaac_tpu_torch.utils import trace
from test_torch_common import (  # noqa: F401 (autouse fixture)
    golden_tool, release_jax_memory, streams_of)

T = 8          # frames of each stream the test decodes
TOL_LSB = 2


def _head(data: bytes, frames: int) -> bytes:
    return b"".join(split_adts_stream(data)[:frames])


def test_decode_batch_cpu_matches_golden():
    tool = golden_tool()
    named = tool.batch_streams()
    with np.load(tool.BATCH_GOLDEN) as z:
        gold = {k: z[k] for k in z.files}
    assert list(gold["names"]) == [name for name, _ in named]
    outs = decode_batch([_head(d, T) if name != "garbage" else d
                         for name, d in named], device="cpu")
    assert len(outs) == len(named)
    for k, ((name, _), pcm) in enumerate(zip(named, outs)):
        assert isinstance(pcm, torch.Tensor) and pcm.device.type == "cpu"
        assert pcm.dtype == torch.int16, name
        if name == "garbage":
            assert tuple(pcm.shape) == (0, 1) and int(gold[f"n_{k}"]) == 0
            continue
        ch = tool.channels(name)
        rows = T * tool.frame_samples(name)
        assert tuple(pcm.shape) == (rows, ch), name
        want = gold[f"pcm_{k}"][:rows]
        got = pcm.numpy().astype(np.int32)
        assert np.abs(want).max() > 1000, name
        assert np.abs(got - want).max() <= TOL_LSB, name


def _single_golden(name: str, frames: int):
    tool = golden_tool()
    with np.load(tool.SINGLE_GOLDEN) as z:
        return z[f"pcm_{name}"][:frames * 2048].astype(np.int32)


def _fallbacks(caplog) -> list:
    return [r.getMessage() for r in caplog.records
            if "fell back to the single-stream decoder" in r.getMessage()]


def test_decode_batch_names_the_stream_it_cannot_take(caplog):
    """A 20-band stream whose frame 0 has a corrupted byte: the native
    probe refuses it, the Python prober cannot decode frame 0 (an AAC-LC
    bucket), and the LC planner fails on it; decode_batch falls back to
    the single-stream decoder, which drops frame 0 and decodes the rest,
    as the JAX decode_batch does (its golden records the fallback)."""
    tool = golden_tool()
    with np.load(tool.LC_GOLDEN) as z:
        assert int(z["single_he20_f0_0"]) == 1
    streams = [b"no sync word here", _head(streams_of("he20", 1)[0], 4),
               _head(tool.corrupted("he20_f0_0"), 4)]
    caplog.set_level(logging.INFO, logger="heaac_tpu_torch")
    with trace.recording() as rec:
        outs = decode_batch(streams, device="cpu")
    probe = next(s for s in rec.spans if s.name == "probe")
    assert probe.attrs == dict(native=1, python=1)
    assert [s.attrs["stream"] for s in rec.spans if s.name == "single"] \
        == [2]
    assert sorted((s.attrs["key"][0], s.attrs.get("error"))
                  for s in rec.spans if s.name == "bucket") == [
        ("he", None), ("lc", "BitstreamError")]
    assert [rec.counters[k] for k in ("probe.native", "probe.python",
                                      "single.fallbacks")] == [1, 1, 1]
    assert [m.split(":")[1] for m in _fallbacks(caplog)] == [" stream 2 fell "
                                                             "back to the "
                                                             "single-stream "
                                                             "decoder"]
    stats = [r.single_stats for r in caplog.records
             if hasattr(r, "single_stats")]
    assert [(st["stream"], st["frames"], st["dropped"]) for st in stats] \
        == [(2, 4, 1)]
    assert tuple(outs[0].shape) == (0, 1)
    assert tuple(outs[1].shape) == (4 * 2048, 2)
    want = _single_golden("he20_f0_0", 3)
    assert isinstance(outs[2], torch.Tensor) and outs[2].dtype == torch.int16
    assert tuple(outs[2].shape) == want.shape
    assert np.abs(want).max() > 1000
    assert np.abs(outs[2].numpy().astype(np.int32) - want).max() <= TOL_LSB


def test_failed_flip_decode_names_the_stream(monkeypatch, caplog):
    """A flip stream fails its batched decode on the band-mode flip; when
    its flip decode fails too, decode_batch logs both, naming the stream,
    and decodes it with the single-stream decoder, as the JAX package
    does: within 2 int16 LSB of the JAX Decoder's golden."""
    cause = RuntimeError("flip decode failed")

    def fail(*a, **kw):
        raise cause

    monkeypatch.setattr(batch, "decode_qwire_flip_stream", fail)
    frames = 8                           # flip stream 0 flips at frame 6
    streams = [_head(streams_of("he20", 1)[0], 4),
               _head(streams_of("flip", 1)[0], frames)]
    caplog.set_level(logging.INFO, logger="heaac_tpu_torch")
    with trace.recording() as rec:
        outs = decode_batch(streams, device="cpu")
    by_id = {s.id: s for s in rec.spans}
    assert [(s.name, by_id[s.parent].name, s.attrs.get("error"))
            for s in rec.spans if s.name in ("flip", "single")] == [
        ("flip", "bucket.retry", "RuntimeError"),
        ("single", "bucket.retry", None)]
    assert [rec.counters[k] for k in ("bucket.bisections", "flip.decodes",
                                      "single.fallbacks")] == [1, 1, 1]
    msgs = [r.getMessage() for r in caplog.records]
    assert "decode_batch: flip-scan decode of stream 1 failed (RuntimeError: " \
        "flip decode failed); using the single-stream decoder" in msgs
    assert _fallbacks(caplog) == [
        "decode_batch: stream 1 fell back to the single-stream decoder: "
        "NotImplementedError: PS band mode changes mid-stream"]
    want = _single_golden("flip_0", frames)
    assert tuple(outs[1].shape) == want.shape
    assert np.abs(outs[1].numpy().astype(np.int32) - want).max() <= TOL_LSB
    assert tuple(outs[0].shape) == (4 * 2048, 2)


@pytest.mark.parametrize("case", ["clean", "leading_garbage",
                                  "corrupt_header", "truncated_tail",
                                  "bad_rate_index"])
def test_split_adts_stream_matches_jax(case):
    data = bytearray(_head(streams_of("he34", 1)[0], 6))
    rng = np.random.default_rng(len(case))
    if case == "leading_garbage":
        # no 0xFF in the noise; a sync word whose header gives length 1
        data = bytearray(rng.integers(0, 255, 300).astype(np.uint8)
                         .tobytes()) + b"\xff\xf1\x50\x80\x00\x20\x00" + data
    elif case == "corrupt_header":
        flen = ((data[3] & 3) << 11) | (data[4] << 3) | (data[5] >> 5)
        data[flen + 3] &= 0xFC                 # frame 1 length < 7
        data[flen + 4] = data[flen + 5] = 0
    elif case == "truncated_tail":
        data = data[:-57]
    elif case == "bad_rate_index":
        data[2] = (data[2] & 0xC3) | (13 << 2)  # index 13: no rate
    got = split_adts_stream(bytes(data))
    want = jax_split(bytes(data))
    assert got == want
    assert len(want) >= 4
