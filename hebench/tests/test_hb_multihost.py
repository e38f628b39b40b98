"""The multi-process kind (``traffic/multihost.py``) on the CPU: two gloo
ranks over a few short streams, whole through the harness, untraced
and traced; its readers on synthetic data; the plain reference of the
deployment (``ref/multihost.py``); and its faults: a rank that raises
ends the run, killing every rank, within its limits; a rank that hands
back another stream's PCM, or counts that differ from the plain sums,
make the run not correct; a program whose ranks hand back no PCM is
refused before any rank starts."""
import json
import multiprocessing as mp
import time

import numpy as np
import pytest

from hebench import harness
from hebench.devtrace import Trace
from hebench.ref import multihost as ref
from hebench.tests._cpu import run_cell
from hebench.tests.conftest import ROOT

CELL = "v2_multihost_4chip"
SMALL = {"config": {"streams": 4},
         "mix": {"ranks": 2, "backend": "gloo", "frames": 4,
                 "check_streams": 4}}
METRICS = {"rank_decode_ms.multihost", "allreduce_wait_ms.multihost",
           "pcm_host_ms.multihost", "parse_wait_ms.multihost",
           "device_idle_pct.multihost"}
HERE = "hebench.tests.test_hb_multihost"


def small(**mix) -> dict:
    return {"config": SMALL["config"], "mix": dict(SMALL["mix"], **mix)}


@pytest.mark.parametrize("trace", [0, 1])
def test_cell_on_two_gloo_ranks(trace, capsys):
    line = run_cell(capsys, CELL, trace=trace, overrides=SMALL)
    assert line["correct"] is True, line["checks"]
    assert line["failed"] == 0
    if trace:
        assert set(line["metrics"]) == METRICS
        assert line["attempted"] == 3 * 4     # three traced calls
        assert line["metrics"]["rank_decode_ms.multihost"]["value"] > \
            line["metrics"]["pcm_host_ms.multihost"]["value"] > 0
        assert line["device"]["busy_s"] == 0       # no card: no device op
    else:
        assert set(line["metrics"]) == {"realtime_x", "setup_s"}
        assert line["attempted"] % 4 == 0 and line["attempted"] >= 4
    assert not mp.active_children()


def test_readers_on_synthetic_data():
    spans = [{"multihost.decode": 100.0, "multihost.allreduce": 2.0,
              "multihost.pcm": 10.0, "group.parse_wait": 30.0},
             {"multihost.decode": 300.0, "multihost.allreduce": 6.0,
              "multihost.pcm": 20.0, "group.parse_wait": 50.0},
             None, {}]
    want = {"rank_decode_ms.multihost": 200.0,
            "allreduce_wait_ms.multihost": 4.0,
            "pcm_host_ms.multihost": 15.0, "parse_wait_ms.multihost": 40.0}
    for name, v in want.items():
        read = harness.load_reader(ROOT, name)
        assert read({"spans": spans}) == pytest.approx(v)
        # a program that records no such span: nothing to read
        assert read({"spans": [{}, None]}) is None
        assert read({}) is None
    read = harness.load_reader(ROOT, "device_idle_pct.multihost")
    tr = Trace(window_ns=None, dev_start=np.array([0, 50]),
               dev_end=np.array([25, 75]), dev_name=["a", "b"],
               host_start=np.zeros(0, np.int64),
               host_end=np.zeros(0, np.int64), host_name=[], wall_s=2e-7)
    assert read({"trace": tr}) == pytest.approx(75.0)
    assert read({}) is None


def test_plain_reference():
    assert [ref.rank_of(i, 4) for i in range(6)] == [0, 1, 2, 3, 0, 1]
    assert ref.shard(10, 4, 1) == [1, 5, 9]
    assert sorted(sum((ref.shard(10, 4, r) for r in range(4)), [])) == \
        list(range(10))
    assert ref.pcm_rows(50) == 102400
    want = ref.global_counts([50, 50, 49], 4, 48000)
    assert want == dict(frames=149, errors=0,
                        audio_seconds=149 * 2048 / 48000, devices=4)
    got = dict(frames=149, errors=0, num_devices=4,
               audio_seconds=sum(f * 2048 / 48000 for f in (49, 50, 50)))
    assert ref.counts_agree(got, want)
    for k, v in (("frames", 148), ("errors", 1), ("num_devices", 3),
                 ("audio_seconds", want["audio_seconds"] * (1 + 1e-6))):
        assert not ref.counts_agree(dict(got, **{k: v}), want)
    config = json.load(open(f"{ROOT}/hebench/configs/heaacv2_48k_4card.json"))
    assert config["streams"] == 4096 and config["ranks"]["count"] == 4
    assert len(ref.shard(config["streams"], 4, 3)) == 1024


# faults, each made inside a rank by its ``rank_init`` hook
def raise_on_rank1(rank: int) -> None:
    """Rank 1 raises in its first call after the warm-up."""
    if rank != 1:
        return
    from heaac_tpu_torch.parallel import multihost
    real, calls = multihost.decode_shard_and_reduce, []

    def fault(*a, **k):
        calls.append(1)
        if len(calls) == 2:
            raise RuntimeError("a fault on rank 1")
        return real(*a, **k)
    multihost.decode_shard_and_reduce = fault


def swap_pcm_on_rank0(rank: int) -> None:
    """Rank 0 hands back each stream's PCM in its neighbour's place."""
    if rank != 0:
        return
    from heaac_tpu_torch.parallel import multihost
    real = multihost.decode_shard_and_reduce

    def swapped(*a, pcm_out=None, **k):
        pcm: list = []
        out = real(*a, pcm_out=pcm, **k)
        pcm_out.extend(pcm[1:] + pcm[:1])
        return out
    multihost.decode_shard_and_reduce = swapped


def lose_a_frame(rank: int) -> None:
    """Every rank's all-reduce comes back one frame short."""
    import torch.distributed as dist
    real = dist.all_reduce

    def short(t, *a, **k):
        work = real(t, *a, **k)
        t[0] -= 1
        return work
    dist.all_reduce = short


def test_rank_that_raises_ends_the_run():
    t = time.perf_counter()
    with pytest.raises(RuntimeError, match="(?s)rank 1 failed.*a fault on "
                                           "rank 1"):
        harness.run(["--workload", CELL, "--seed", "3000000011",
                     "--seconds", "1", "--trace", "0"], time.perf_counter(),
                    root=ROOT, device="cpu", workers=1,
                    overrides=small(rank_init=f"{HERE}:raise_on_rank1"))
    assert time.perf_counter() - t < 120
    assert not mp.active_children()


@pytest.mark.parametrize("fault", ["swap_pcm_on_rank0", "lose_a_frame"])
def test_fault_is_not_correct(fault, capsys):
    line = run_cell(capsys, CELL, overrides=small(
        rank_init=f"{HERE}:{fault}"))
    assert line["correct"] is False, line["checks"]
    if fault == "lose_a_frame":
        assert line["failed"] == line["attempted"]
    assert not mp.active_children()


def test_program_without_pcm_out_is_refused(monkeypatch):
    """The parent commit's rank hands back no PCM: the run stops before
    it makes a stream or starts a rank."""
    from heaac_tpu_torch.parallel import multihost

    def old(streams_local, device="cuda", info_out=None):
        raise AssertionError("called")
    monkeypatch.setattr(multihost, "decode_shard_and_reduce", old)
    t = time.perf_counter()
    with pytest.raises(SystemExit, match="pcm_out"):
        harness.run(["--workload", CELL, "--seed", "1", "--seconds", "1",
                     "--trace", "0"], time.perf_counter(), root=ROOT,
                    device="cpu", workers=1, overrides=SMALL)
    assert time.perf_counter() - t < 10
    assert not mp.active_children()
