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
                        "k1_launches": {"30": 0, "50": 0}}
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
