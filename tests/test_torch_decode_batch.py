"""``heaac_tpu_torch.decode_batch`` on the CPU: the mixed list of
tools/make_torch_golden.py (20-band and 34-band HE-AAC v2, stereo HE-AAC
v1 with M/S and coupled SBR, HE-AAC with a coupling channel applied after
the IMDCT or before TNS, AAC-LC and a buffer with no sync word,
interleaved) against the committed JAX golden
(tests/data/decode_batch_golden_jax.npz, written by that tool; JAX does
not run here), within 2 int16 LSB, each output in its input's place;
streams the port cannot take (what the JAX package decodes with its
single-stream decoder) raise NotImplementedError naming them, also when
a flip stream's flip decode fails; the ADTS splitter equals the JAX
package's."""
import numpy as np
import pytest
import torch

from heaac_tpu.bitstream.adts import split_adts_stream as jax_split
from heaac_tpu_torch import decode_batch
from heaac_tpu_torch.codec import batch
from heaac_tpu_torch.host import split_adts_stream
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


def test_decode_batch_names_the_stream_it_cannot_take():
    """A 20-band stream whose frame 0 has a corrupted byte: the native
    probe refuses it, the Python prober cannot parse frame 0 (an AAC-LC
    bucket), and the LC planner fails on it; the JAX package decodes it
    with its single-stream decoder (its golden records the fallback),
    which is not ported."""
    tool = golden_tool()
    with np.load(tool.LC_GOLDEN) as z:
        assert int(z["single_he20_f0_0"]) == 1
    streams = [b"no sync word here", _head(streams_of("he20", 1)[0], 4),
               tool.corrupted("he20_f0_0")]
    with pytest.raises(NotImplementedError, match=r"^stream 2:") as ei:
        decode_batch(streams, device="cpu")
    assert ei.value.__cause__ is not None


def test_failed_flip_decode_names_the_stream(monkeypatch):
    """A flip stream fails its batched decode on the band-mode flip; when
    its flip decode fails too, decode_batch raises NotImplementedError
    naming the stream, chained to that failure and not raised while
    handling it."""
    cause = RuntimeError("flip decode failed")

    def fail(*a, **kw):
        raise cause

    monkeypatch.setattr(batch, "decode_qwire_flip_stream", fail)
    streams = [_head(streams_of("he20", 1)[0], 4),
               _head(streams_of("flip", 4)[3], 4)]
    with pytest.raises(NotImplementedError, match=r"^stream 1:") as ei:
        decode_batch(streams, device="cpu")
    assert ei.value.__cause__ is cause
    assert ei.value.__suppress_context__ and ei.value.__context__ is None


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
