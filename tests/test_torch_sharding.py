"""PyTorch port of the parallel layer's sharding
(``heaac_tpu_torch/parallel/sharding.py``) against the JAX package.
``ShardedStreamBatchDecoder`` (the plan-record decode with its lanes cut
evenly over the devices) is held to the unsharded StreamBatchDecoder and
to tests/data/plan_golden_jax.npz (tools/make_torch_plan_golden.py).

The port cuts each stream group at stream boundaries over a list of
devices; on the CPU several "devices" are the CPU itself, each running
its own qwire scan over its lanes.  The JAX reference is
``tests/data/sharded_golden_jax.npz`` (its ShardedQwireDecoder on the
8-device CPU mesh, tools/make_torch_golden.py sharded), so no test here
compiles a JAX scan.  Tolerance: PCM within 1 int16 LSB of the golden
and of the port's unsharded QwirePipelinedDecoder (a shard runs its
matmuls at another batch width than the whole group, and on the CPU a
one-lane shard rounds 1 LSB apart from the two-lane group); the core
step within 2e-5 absolute of JAX's (which runs its matmuls at
Precision.HIGHEST) on inputs scaled to outputs of peak ~1."""
import functools

import numpy as np
import pytest
import torch

from heaac_tpu_torch.codec.batch import (QwirePipelinedDecoder,
                                         StreamBatchDecoder)
from heaac_tpu_torch.parallel.sharding import (ShardedQwireDecoder,
                                               ShardedStreamBatchDecoder,
                                               shard_bounds,
                                               sharded_core_step)
from test_torch_common import (  # noqa: F401 (autouse fixture)
    REPO, golden_tool, release_jax_memory, streams_of, t)

TOOL = golden_tool()
# the first 8 of the golden's TOOL.FRAMES frames (a decode's first frames
# do not depend on later ones): 8 lanes x 8 frames a decode
FRAMES = 8
TOL_LSB = 1
CORE_TOL = 2e-5
# case -> (streams: a golden case or (kind, count), devices, golden case
# holding the first lanes of the same streams)
CASES = {
    "he20_on_4": ("he20", 4, "he20"),
    "stereo_6_streams_on_4": (("he_v1s", 6), 4, "stereo"),
    "cce_on_8": ("cce", 8, "cce"),
    "he20_on_1": ("he20", 1, "he20"),
}


@functools.cache
def golden() -> dict:
    with np.load(TOOL.SHARDED_GOLDEN) as z:
        return {k: z[k] for k in z.files}


def case_streams(spec) -> list:
    if isinstance(spec, str):
        return TOOL.sharded_streams(spec)
    return streams_of(*spec)


@functools.cache
def unsharded(spec) -> tuple:
    """The port's QwirePipelinedDecoder on the CPU: (pcm of the one
    group, frame counts, error count)."""
    dec = QwirePipelinedDecoder(case_streams(spec), max_frames=FRAMES,
                                device="cpu")
    pcm = dec.decode()
    assert len(pcm) == 1
    return pcm[0].numpy(), dec.frame_counts, dec.error_count


def lane_counts(dec) -> list:
    return [hi - lo for lo, hi in dec.bounds]


@pytest.mark.parametrize("case", CASES)
def test_sharded_decode_matches_golden_and_unsharded(case):
    """The 20-band streams on 4 and on 1 device, 6 stereo streams (MS =
    rows_pair = 1) cut 1, 2, 1, 2 over 4 devices, and 4 coupling-channel
    streams on 8 devices, four of which get no lanes."""
    spec, ndev, gold_case = CASES[case]
    dec = ShardedQwireDecoder(case_streams(spec), devices=["cpu"] * ndev,
                              max_frames=FRAMES)
    outs = dec.decode()
    assert len(outs) == 1
    pcm = outs[0]
    assert pcm.dtype == torch.int16 and pcm.device.type == "cpu"
    ref, ref_frames, ref_errors = unsharded(spec)
    assert tuple(pcm.shape) == ref.shape == (FRAMES, dec.L, 2, 2048)
    pcm = pcm.numpy().astype(np.int32)
    gold = golden()[f"pcm_{gold_case}"][:FRAMES]
    lanes = gold.shape[1]
    d_ref = int(np.abs(pcm - ref).max())
    d_gold = int(np.abs(pcm[:, :lanes] - gold).max())
    print(f"{case}: lanes per device {lane_counts(dec)}; max LSB vs the "
          f"unsharded port {d_ref}, vs the JAX golden (lanes 0-{lanes - 1})"
          f" {d_gold}")
    assert d_ref <= TOL_LSB and d_gold <= TOL_LSB
    assert np.abs(ref).max(axis=(0, 2, 3)).min() > 0
    assert (dec.frame_counts, dec.error_count) == (ref_frames, ref_errors)
    gold_frames = golden()[f"frames_{gold_case}"]
    assert dec.frame_counts[:len(gold_frames)] == \
        np.minimum(gold_frames, FRAMES).tolist()
    assert dec.audio_seconds() == pytest.approx(
        sum(ref_frames) * 2048 / 48000, rel=1e-12)
    if case.startswith("stereo"):
        assert (dec.MS, dec.RP) == (1, 1)
        assert lane_counts(dec) == [2, 4, 2, 4]
    if case.startswith("cce"):
        assert lane_counts(dec) == [0, 2, 0, 2, 0, 2, 0, 2]


def test_sharded_decode_records_the_group_spans():
    """The base class's group loop: five 3-frame streams in groups of two
    over two CPU "devices" record group.parse (on the parse worker),
    group.parse_wait, group.upload and group.scan once for every group,
    each parse with its group's frames, and the K1 span once a frame on
    each card."""
    from heaac_tpu_torch.host import split_adts_stream
    from heaac_tpu_torch.utils import trace
    frames = 3
    streams = [b"".join(split_adts_stream(d)[:frames])
               for d in streams_of("he20", 5)]
    dec = ShardedQwireDecoder(streams, devices=["cpu", "cpu"],
                              group_streams=2)
    with trace.recording() as rec:
        outs = dec.decode()
    assert [tuple(o.shape) for o in outs] == [(frames, 2, 2, 2048)] * 3
    groups = {name: sorted(s.attrs["group"] for s in rec.spans
                           if s.name == name)
              for name in ("group.parse", "group.parse_wait",
                           "group.upload", "group.scan")}
    assert groups == {name: [0, 1, 2] for name in groups}
    parse = [s for s in rec.spans if s.name == "group.parse"]
    waits = [s for s in rec.spans if s.name == "group.parse_wait"]
    assert {s.thread for s in parse}.isdisjoint({s.thread for s in waits})
    assert sorted(s.attrs["frames"] for s in parse) == [frames, 2 * frames,
                                                        2 * frames]
    assert [s.attrs["steps"] for s in rec.spans
            if s.name == "group.scan"] == [frames] * 3
    # two cards of one lane a group: K1 once a frame on each
    assert sum(s.name == "k1" for s in rec.spans) == 3 * 2 * frames
    assert dec.frame_counts == [frames] * 5 and dec.error_count == 0


def test_shard_bounds_never_split_a_stream():
    for G in range(1, 13):
        for nl in (1, 2, 3):
            for n in range(1, 9):
                b = shard_bounds(G, nl, n)
                assert len(b) == n and b[0][0] == 0 and b[-1][1] == G * nl
                assert all(hi0 == lo1 for (_, hi0), (lo1, _) in
                           zip(b, b[1:]))
                assert all(lo % nl == 0 and lo <= hi for lo, hi in b)
                # no card holds more than one stream above another
                sizes = [(hi - lo) // nl for lo, hi in b]
                assert max(sizes) - min(sizes) <= 1


def test_lanes_not_dividing_raise_in_both_packages():
    """8 lanes over 3 devices: ValueError from both constructors (the
    JAX check runs before any compile)."""
    from heaac_tpu.parallel.sharding import (
        ShardedQwireDecoder as JaxSharded, make_mesh)
    streams = TOOL.sharded_streams("he20")
    with pytest.raises(ValueError, match="not divisible by 3 devices"):
        JaxSharded(streams, mesh=make_mesh(3), max_frames=2)
    with pytest.raises(ValueError, match="not divisible by 3 devices"):
        ShardedQwireDecoder(streams, devices=["cpu"] * 3, max_frames=2)


def test_short_last_group_counts_each_corrupt_frame_once():
    """Bench streams 1 and 2, then bench stream 0 with a corrupt frame 1,
    in groups of 2 over 2 devices: the last group is the corrupt stream
    and its padding copy.  The port counts its corrupt frame once, as
    the unsharded port does, and again once on a second decode() call.
    The JAX class parses the padding copy as a real stream and never
    resets the count: its golden shows 2, then 4."""
    files, frames = TOOL.SHARDED_ERRORS
    streams = [TOOL.corrupted(f) if f in TOOL.CORRUPT else
               open(f"{TOOL.REPO}/{f}", "rb").read() for f in files]
    ref = QwirePipelinedDecoder(streams, group_streams=2, max_frames=frames,
                                device="cpu")
    ref_pcm = [p.numpy() for p in ref.decode()]
    assert ref.error_count == 1
    dec = ShardedQwireDecoder(streams, devices=["cpu", "cpu"],
                              group_streams=2, max_frames=frames)
    counts = []
    for _ in range(2):
        pcm = dec.decode()
        counts.append(dec.error_count)
        assert [p.shape for p in pcm] == [p.shape for p in ref_pcm]
        assert max(int(np.abs(p.numpy().astype(np.int32) - r).max())
                   for p, r in zip(pcm, ref_pcm)) <= TOL_LSB
    assert counts == [ref.error_count] * 2
    assert dec.frame_counts == ref.frame_counts == [frames] * 3
    assert golden()["errors_short_group"].tolist() == [2, 4]


def test_sharded_core_step_matches_jax():
    """The core step over 16 lanes (long, start, short and stop windows,
    each after every previous window, sine and KBD) cut over two
    devices, against the JAX sharded_core_step on a 2-device mesh."""
    import jax.numpy as jnp
    from heaac_tpu.parallel.sharding import (make_mesh,
                                             sharded_core_step as jstep)
    B = 16
    rng = np.random.default_rng(11)
    # scaled so that both outputs peak near 1
    coeffs = (rng.standard_normal((B, 1024)) * 0.01).astype(np.float32)
    saved = (rng.standard_normal((B, 512)) * 0.1).astype(np.float32)
    ws = np.arange(B, dtype=np.int32) % 4
    wsp = (np.arange(B, dtype=np.int32) // 4) % 4
    kbd = (np.arange(B, dtype=np.int32) // 2) % 2
    kbdp = np.arange(B, dtype=np.int32) % 2
    j_out, j_saved = jstep(make_mesh(2))(*(jnp.asarray(a) for a in (
        coeffs, saved, ws, wsp, kbd, kbdp)))
    p_out, p_saved = sharded_core_step(["cpu", "cpu"])(
        *(t(a) for a in (coeffs, saved, ws, wsp, kbd, kbdp)))
    assert p_out.device.type == "cpu"
    for got, want in ((p_out, j_out), (p_saved, j_saved)):
        want = np.asarray(want)
        assert tuple(got.shape) == want.shape
        err = float(np.abs(got.numpy() - want).max())
        assert err <= CORE_TOL, err
        assert 0.2 < np.abs(want).max() < 5


@pytest.mark.parametrize("compact", [True, False], ids=["compact", "dense"])
def test_sharded_stream_batch_decoder_matches_unsharded(compact):
    """Bench streams 0-1 twice over (4 lanes) cut 2 and 2 over two CPU
    "devices": within 1 LSB of the unsharded StreamBatchDecoder and of
    the JAX StreamBatchDecoder in the plan golden."""
    streams = streams_of("he20", 2)
    dec = ShardedStreamBatchDecoder(streams, batch=4, devices=["cpu"] * 2,
                                    max_frames=FRAMES, compact=compact)
    assert [s[0]["coeffs"].shape[1] for s in dec.shards] == [2, 2]
    pcm = dec.decode()
    assert pcm.dtype == torch.int16 and pcm.device.type == "cpu"
    ref = StreamBatchDecoder(streams, batch=4, max_frames=FRAMES,
                             compact=compact, device="cpu").decode()
    assert pcm.shape == ref.shape == (FRAMES, 4, 2, 2048)
    pcm = pcm.numpy().astype(np.int32)
    assert int(np.abs(pcm - ref.numpy()).max()) <= TOL_LSB
    with np.load(f"{REPO}/tests/data/plan_golden_jax.npz") as z:
        gold = z["he20_compact/pcm" if compact else "he20_dense/pcm"]
    for lanes in (slice(0, 2), slice(2, 4)):
        assert int(np.abs(pcm[:, lanes] - gold[:FRAMES]).max()) <= TOL_LSB
    assert dec.frame_counts == [FRAMES] * 4
    assert dec.plan_bytes() == StreamBatchDecoder(
        streams, batch=4, max_frames=FRAMES, compact=compact,
        device="cpu").plan_bytes()


def test_sharded_stream_batch_decoder_odd_lanes_raise():
    with pytest.raises(ValueError, match="3 lanes not divisible by 2"):
        ShardedStreamBatchDecoder(streams_of("he20", 3), devices=["cpu"] * 2,
                                  max_frames=2)
