"""The port's multi-process decode (``heaac_tpu_torch/parallel/
multihost.py``): two processes of ``python -m
heaac_tpu_torch.parallel.multihost`` on the CPU with gloo, each decoding
its round-robin half of four bench streams cut to 8 frames, agree on the
all-reduced global metrics, which equal the sums of the JAX package's
per-shard QwirePipelinedDecoder counts in
tests/data/sharded_golden_jax.npz."""
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

from test_torch_common import REPO, golden_tool

TOOL = golden_tool()
TIMEOUT_S = 120           # each process's own limit: a hang fails here


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_process_gloo_decode_and_reduce(tmp_path):
    streams = TOOL.multihost_streams()
    for i, data in enumerate(streams):
        (tmp_path / f"s{i}.aac").write_bytes(data)
    port = _free_port()
    env = {**os.environ, "OMP_NUM_THREADS": "1",
           "PYTHONPATH": REPO + os.pathsep + os.environ.get("PYTHONPATH",
                                                            "")}
    procs = [subprocess.Popen(
        [sys.executable, "-m", "heaac_tpu_torch.parallel.multihost",
         "--coordinator", f"127.0.0.1:{port}", "--num-processes", "2",
         "--process-id", str(rank), "--streams-dir", str(tmp_path),
         "--device", "cpu", "--backend", "gloo"],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for rank in range(2)]
    lines = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=TIMEOUT_S)
            assert p.returncode == 0, err[-3000:]
            lines.append([json.loads(x)
                          for x in out.strip().splitlines()[-2:]])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    (info0, glob0), (info1, glob1) = lines
    gold = np.load(TOOL.SHARDED_GOLDEN)
    jax_frames = [int(gold[f"multihost_frames_{r}"].sum()) for r in range(2)]
    jax_errors = sum(int(gold[f"multihost_errors_{r}"]) for r in range(2))
    jax_audio = sum(float(gold[f"multihost_audio_{r}"]) for r in range(2))
    n = TOOL.MULTIHOST_STREAMS * TOOL.MULTIHOST_FRAMES
    for rank, (info, glob) in enumerate(lines):
        assert info.pop("decode_s") > 0
        assert info == {"process_id": rank, "device": "cpu",
                        "backend": "gloo", "streams": 2,
                        "k1_launches": {"30": 0, "50": 0},
                        "rows_launches": {"0": 0, "1": 0}}
        assert glob["process_id"] == rank and glob["num_devices"] == 2
        assert glob["process_frames"] == jax_frames[rank]
    assert {k: v for k, v in glob0.items() if k not in (
        "process_id", "process_frames")} == {
        k: v for k, v in glob1.items() if k not in (
            "process_id", "process_frames")}
    assert glob0["frames"] == n == sum(jax_frames)
    assert glob0["errors"] == 0 == jax_errors
    assert glob0["process_frames"] + glob1["process_frames"] == n
    assert glob0["audio_seconds"] == pytest.approx(n * 2048 / 48000,
                                                   rel=1e-6)
    assert glob0["audio_seconds"] == pytest.approx(jax_audio, rel=1e-6)


# one rank of the PCM test: two calls of decode_shard_and_reduce with
# pcm_out in one gloo group; writes its shard's PCM and counts
RANK = r"""
import datetime, json, sys
from pathlib import Path
import numpy as np
import torch.distributed as dist
from heaac_tpu_torch.parallel.multihost import decode_shard_and_reduce
rank, port, src, dst = int(sys.argv[1]), sys.argv[2], Path(sys.argv[3]), \
    Path(sys.argv[4])
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                        world_size=2, rank=rank,
                        timeout=datetime.timedelta(seconds=60))
paths = sorted(src.glob("*.aac"))
shard = [p.read_bytes() for i, p in enumerate(paths) if i % 2 == rank]
calls = []
for k in range(2):
    pcm, info = [], {}
    out = decode_shard_and_reduce(shard, "cpu", info_out=info, pcm_out=pcm)
    np.savez(dst / f"pcm_{rank}_{k}.npz", *[p.numpy() for p in pcm])
    calls.append(dict(out, num_devices=info["num_devices"],
                      dtypes=sorted({str(p.dtype) for p in pcm})))
(dst / f"counts_{rank}.json").write_text(json.dumps(calls))
dist.destroy_process_group()
"""


def test_two_process_pcm_out(tmp_path):
    """Each rank hands back its round-robin shard's PCM, in input order,
    call after call: equal bit for bit to one process's decode_batch on
    the CPU, within the four-card cell's limits of the benchmark's plain
    reference, and the reduced counts equal the reference's plain sums."""
    from hebench.check import compare, judge, reference
    from hebench.ref import multihost as ref

    from heaac_tpu_torch import decode_batch

    streams = TOOL.multihost_streams()
    src, dst = tmp_path / "in", tmp_path / "out"
    src.mkdir()
    dst.mkdir()
    for i, data in enumerate(streams):
        (src / f"s{i}.aac").write_bytes(data)
    port = _free_port()
    env = {**os.environ, "OMP_NUM_THREADS": "1",
           "PYTHONPATH": REPO + os.pathsep + os.environ.get("PYTHONPATH",
                                                            "")}
    procs = [subprocess.Popen(
        [sys.executable, "-c", RANK, str(rank), str(port), str(src),
         str(dst)], cwd=REPO, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for rank in range(2)]
    try:
        for p in procs:
            _, err = p.communicate(timeout=TIMEOUT_S)
            assert p.returncode == 0, err[-3000:]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    want = decode_batch(streams, device="cpu")
    got = [None] * len(streams)
    for rank in range(2):
        idx = ref.shard(len(streams), 2, rank)
        first = None
        for k in range(2):
            z = np.load(dst / f"pcm_{rank}_{k}.npz")
            pcm = [z[f"arr_{j}"] for j in range(len(z.files))]
            assert len(pcm) == len(idx)
            if first is None:
                first = pcm
            for a, b in zip(pcm, first):
                np.testing.assert_array_equal(a, b)
        for i, p in zip(idx, first):
            got[i] = p
    for g, w in zip(got, want):
        assert g.dtype == np.int16 and g.shape == tuple(w.shape)
        np.testing.assert_array_equal(g, w.numpy())
    frames = ref.frame_counts(streams)
    assert [g.shape[0] for g in got] == [ref.pcm_rows(f) for f in frames]
    plain = ref.global_counts(frames, 2, 48000)
    for rank in range(2):
        calls = json.loads((dst / f"counts_{rank}.json").read_text())
        for c in calls:
            assert c.pop("dtypes") == ["torch.int16"]
            assert ref.counts_agree(c, plain), (c, plain)
    limits = json.load(open(os.path.join(
        REPO, "hebench", "mixes", "multihost_4096.json")))["limits"]
    ok, rows = judge(compare(got, reference(streams, workers=1)), limits)
    assert ok, rows
