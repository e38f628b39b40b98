"""The port's PipelinedStreamBatchDecoder (packed, XOR-whitened plan
records; host parse of group g+1 beside the decode of group g) on the
CPU: within 2 int16 LSB of the JAX decoder's PCM in
tests/data/plan_golden_jax.npz (tools/make_torch_plan_golden.py; no JAX
scan compiles here) and exactly equal to the port's compact
StreamBatchDecoder over the same streams (the packed route unpacks to
the same records); its staging buffers reused across groups with short
streams reset to silence; the Python-planner fallback packing the same
records as the native sink; and a stream of another PS band mode
refused."""
import functools
import importlib.util
import os

import numpy as np
import pytest

from heaac_tpu_torch import native
from heaac_tpu_torch.codec.batch import (PipelinedStreamBatchDecoder,
                                         StreamBatchDecoder)
from heaac_tpu_torch.host import split_adts_stream
from test_torch_common import (  # noqa: F401 (autouse fixture)
    REPO, golden_tool, n, release_jax_memory, streams_of)

TOL_LSB = 2
FRAMES = 16


@functools.cache
def gold() -> dict:
    spec = importlib.util.spec_from_file_location(
        "make_torch_plan_golden",
        os.path.join(REPO, "tools", "make_torch_plan_golden.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    with np.load(mod.PLAN_GOLDEN) as z:
        return {k: z[k] for k in z.files}


def compact_decode(streams, frames):
    return n(StreamBatchDecoder(streams, max_frames=frames,
                                device="cpu").decode())


def test_pipelined_matches_golden_and_compact_decode():
    streams = streams_of("he20", 2)
    dec = PipelinedStreamBatchDecoder(streams, group_streams=2,
                                      max_frames=FRAMES, device="cpu")
    outs = dec.decode()
    assert len(outs) == 1 and outs[0].shape == (FRAMES, 2, 2, 2048)
    pcm = n(outs[0])
    want = gold()["pipelined/pcm"]
    assert np.abs(pcm.astype(np.int32) - want).max() <= TOL_LSB
    assert dec.frame_counts == gold()["pipelined/frame_counts"].tolist()
    np.testing.assert_array_equal(pcm, compact_decode(streams, FRAMES))
    assert dec.audio_seconds() == pytest.approx(2 * FRAMES * 2048 / 48000)


def test_pipelined_groups_reuse_staging_and_reset_short_streams():
    """Five streams in groups of two: staging set 0 serves groups 0 and
    2; the last group is one stream 3 frames long plus a padding copy of
    stream 0, so frame 3 of its lanes must read silence, not group 0's
    records."""
    bench = streams_of("he20", 5)
    short = b"".join(split_adts_stream(bench[4])[:3])
    streams = bench[:4] + [short]
    dec = PipelinedStreamBatchDecoder(streams, group_streams=2,
                                      max_frames=4, device="cpu")
    outs = [n(o) for o in dec.decode()]
    assert [o.shape for o in outs] == [(4, 2, 2, 2048)] * 3
    assert dec.frame_counts == [4, 4, 4, 4, 3]
    for g, group in enumerate((streams[:2], streams[2:4],
                               [short, streams[0]])):
        np.testing.assert_array_equal(outs[g], compact_decode(group, 4),
                                      err_msg=f"group {g}")


def test_pipelined_python_planner_packs_as_the_native_sink(monkeypatch):
    """Every stream through the Python planner and pack_records (the
    fallback for streams the native parser refuses), a stream with a
    corrupt frame 1 among them: the same PCM as the native route."""
    streams = [golden_tool().corrupted("he20_f1_0")] + streams_of("he20", 2)
    native_pcm = [n(o) for o in PipelinedStreamBatchDecoder(
        streams, group_streams=3, max_frames=8, device="cpu").decode()]
    monkeypatch.setattr(native, "available", lambda: False)
    dec = PipelinedStreamBatchDecoder(streams, group_streams=3,
                                      max_frames=8, device="cpu")
    outs = [n(o) for o in dec.decode()]
    np.testing.assert_array_equal(outs[0], native_pcm[0])
    np.testing.assert_array_equal(outs[0], compact_decode(streams, 8))
    assert dec.frame_counts == [8, 8, 8]


def test_pipelined_refuses_another_band_mode():
    streams = streams_of("he20", 1) + streams_of("he34", 1)
    dec = PipelinedStreamBatchDecoder(streams, group_streams=2,
                                      max_frames=2, device="cpu")
    with pytest.raises(ValueError, match="is34"):
        dec.decode()
