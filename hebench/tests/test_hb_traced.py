"""A traced run (``--trace 1``) of each cell on the CPU: correct, with
the device fields and a breakdown, every per-layer metric of the cell
that has something to read on the CPU, and an error on stderr for one
that has not (K1 runs only on the card; a cell without PS names no K1
metric at all)."""
import json
import time

import pytest

from hebench import harness
from hebench.tests._cpu import SMALL, batch_data
from hebench.tests.conftest import ROOT

METRICS = {
    "v2_batch_512": {"parse_us_per_frame.batch", "scan_ms_per_step.batch",
                     "device_idle_pct.batch", "launches_per_step.batch"},
    "v1s_stream_b1": {"realtime_x.single", "device_idle_pct.single",
                      "launches_per_frame.single"},
    "v1s_batch_256": {"parse_us_per_frame.batch", "scan_ms_per_step.batch",
                      "device_idle_pct.batch", "launches_per_step.batch"},
}


@pytest.mark.parametrize("cell", sorted(METRICS))
def test_traced_run(cell, monkeypatch, capsys):
    data = batch_data(monkeypatch)
    rc = harness.run(["--workload", cell, "--seed", "3000000009",
                      "--seconds", "1", "--trace", "1"],
                     time.perf_counter(), root=ROOT, device="cpu",
                     workers=1, overrides=SMALL[cell])
    cap = capsys.readouterr()
    assert rc == 0, cap.err[-2000:]
    line = json.loads(cap.out.strip().splitlines()[-1])
    assert line["correct"] is True, line["checks"]
    assert set(line["metrics"]) == METRICS[cell]
    assert line["device"]["window_s"] > 0
    assert line["device"]["busy_s"] == 0          # no card: no device op
    assert line["breakdown"]["idle_gaps"], "the host-op trace names gaps"
    if cell == "v2_batch_512":
        assert ("error: per-layer metric k1_roofline_pct applies to this "
                "cell, but its reader found nothing") in cap.err
        assert line["metrics"]["scan_ms_per_step.batch"]["value"] > 0
        assert line["attempted"] == 2 * SMALL[cell]["config"]["streams"]
        # K1's inputs: every (lane, frame) of 4 mono 50-frame streams at
        # the 20-band configuration's 30 allpass bands
        assert (data["k1_lane_frames"], data["k1_napb"]) == (4 * 50, 30)
    if cell == "v1s_batch_256":
        assert "k1_roofline_pct" not in cap.err
        assert not {"k1_lane_frames", "k1_napb"} & set(data)
        assert line["metrics"]["scan_ms_per_step.batch"]["value"] > 0
        assert line["attempted"] == 2 * SMALL[cell]["mix"]["streams"]
