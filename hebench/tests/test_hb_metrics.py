"""Metric arithmetic: percentiles, the device trace reduction on
synthetic traces, K1's bytes and bounds, and a measuring run without
a card."""
import os
import subprocess
import sys

import numpy as np
import pytest

from hebench import arith
from hebench.devtrace import NO_HOST_OP, Trace, union
from hebench.tests.conftest import ROOT


def test_percentile_over_all_samples():
    v = list(range(1, 101))
    assert arith.percentile(v, 95) == pytest.approx(95.05)
    assert arith.percentile([7.0], 95) == 7.0
    with pytest.raises(ValueError):
        arith.percentile([], 95)


def test_union():
    s, e = union(np.array([5, 0, 2, 20]), np.array([8, 3, 4, 25]))
    assert s.tolist() == [0, 5, 20] and e.tolist() == [4, 8, 25]


def synthetic() -> Trace:
    # window 0-100 ns; kernels at 10-20, 15-30 (overlap), 50-60; a copy
    # at 70-75; host: op A 0-40 holding op B 5-35, op C 40-100
    return Trace(window_ns=(0, 100),
                 dev_start=np.array([10, 15, 50, 70]),
                 dev_end=np.array([20, 30, 60, 75]),
                 dev_name=["k_a", "k_b", "k_a", "Memcpy HtoD"],
                 host_start=np.array([0, 5, 40]),
                 host_end=np.array([40, 35, 100]),
                 host_name=["A", "B", "C"])


def test_busy_idle_launches():
    tr = synthetic()
    assert tr.busy_s() == pytest.approx(35e-9)     # 10-30, 50-60, 70-75
    assert tr.window_s == pytest.approx(100e-9)
    assert tr.launches() == 3                      # the copy is no launch
    assert tr.launches("k_a") == 2
    assert tr.kernel_durations_s("k_a").tolist() == pytest.approx(
        [10e-9, 10e-9])
    assert tr.device_ops()[0] == ["k_a", pytest.approx(20e-9)]


def test_idle_gaps_named_by_innermost_host_op():
    tr = synthetic()
    gaps = dict((n, v) for n, v in tr.idle_gaps())
    # gaps 0-10 (mid 5: B starts at 5, innermost), 30-50 (mid 40: C),
    # 60-70 (mid 65: C), 75-100 (mid 87: C)
    assert gaps == {"C": pytest.approx(55e-9), "B": pytest.approx(10e-9)}
    assert tr.name_at(np.array([200]))[0] == NO_HOST_OP


def test_card_only_trace():
    """Without host operations the window is the host's wall, the busy
    time the union of every device operation, and no gap is named."""
    tr = synthetic()
    tr = Trace(window_ns=None, dev_start=tr.dev_start, dev_end=tr.dev_end,
               dev_name=tr.dev_name, host_start=np.zeros(0, np.int64),
               host_end=np.zeros(0, np.int64), host_name=[], wall_s=2e-7)
    assert tr.window_s == pytest.approx(200e-9)
    assert tr.busy_s() == pytest.approx(35e-9)
    assert tr.launches() == 3
    assert tr.idle_gaps() == []


def test_samples_per_frame():
    """The batch kind's rows a frame: 2,048 where SBR doubles the core's
    rate, 1,024 for an AAC-LC configuration (core rate = output rate)."""
    from hebench.harness import load_json
    from hebench.traffic.batch import samples_per_frame
    v1s = load_json(ROOT, "hebench", "configs", "heaacv1_stereo_48k.json")
    v2 = load_json(ROOT, "hebench", "configs", "heaacv2_48k.json")
    assert samples_per_frame(v1s) == samples_per_frame(v2) == 2048
    assert samples_per_frame(dict(v1s, core_rate=48000)) == 1024


def test_k1_bounds():
    assert arith.k1_bytes(512, 30) == 16426040
    assert arith.k1_bound_s(512, 30) * 1e6 == pytest.approx(4.903, abs=5e-4)
    assert arith.k1_bound_s(512, 50) * 1e6 == pytest.approx(7.202, abs=5e-4)
    assert arith.roofline_pct(4.903e-6, 9.806e-6) == pytest.approx(
        50.0, abs=0.01)
    assert arith.roofline_pct(1.0, 0.0) is None


def test_k1_total_bound_is_the_sum_of_its_launches():
    """Bytes are linear in a launch's lanes: 2 launches of 256 lanes and
    one of 512 bound alike, as the sum of their own bounds."""
    assert arith.k1_bound_total_s(512 * 50, 100, 30) == pytest.approx(
        100 * arith.k1_bound_s(256, 30))
    assert arith.k1_bound_total_s(512 * 50, 50, 50) == pytest.approx(
        50 * arith.k1_bound_s(512, 50))
    assert arith.K1_NAPB == {20: 30, 34: 50}


def test_k1_reader():
    """The share from the traced kernels and the frames decoded, with no
    record from the program; nothing to read where K1 did not run."""
    from hebench.harness import load_reader
    read = load_reader(ROOT, "k1_roofline_pct")
    each = int(arith.k1_bound_s(256, 30) * 2e9)     # twice its bound
    tr = Trace(window_ns=None, dev_start=np.array([0, 10**6]),
               dev_end=np.array([each, 10**6 + each]),
               dev_name=["ps_decorrelate_kernel"] * 2,
               host_start=np.zeros(0, np.int64),
               host_end=np.zeros(0, np.int64), host_name=[], wall_s=1.0)
    data = {"trace": tr, "k1_lane_frames": 512, "k1_napb": 30}
    assert read(data) == pytest.approx(50.0, rel=1e-3)
    tr.dev_name = ["other_kernel"] * 2
    assert read(data) is None
    assert read({}) is None


def test_single_stream_rate_reader():
    """The traced run's window rate: audio over wall, nothing without a
    window."""
    from hebench.harness import load_reader
    read = load_reader(ROOT, "realtime_x.single")
    assert read({"window_audio_s": 200.0, "window_wall_s": 50.0}) == 4.0
    assert read({}) is None


def test_no_card_no_result():
    """Without a card the command prints no result and fails."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    r = subprocess.run([sys.executable, "hebench/run.py", "--workload",
                        "v1s_stream_b1", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert r.stdout.strip() == ""
    assert "is_available() is False" in r.stderr
