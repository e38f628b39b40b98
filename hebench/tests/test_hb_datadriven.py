"""A cell of an existing traffic kind is data alone: in a copy of the
benchmark, a new configuration file, a new mix file, a new per-layer
reader and a new entry of BENCHMARK.json give a cell that the harness
runs and a metric it reports, with no code edited."""
import json
import os
import shutil

from hebench.tests._cpu import run_cell
from hebench.tests.conftest import ROOT


def test_new_cell_config_and_metric_from_files(tmp_path, capsys):
    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(ROOT, "hebench"), root / "hebench",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    os.symlink(os.path.join(ROOT, "heaac_tpu_torch"),
               root / "heaac_tpu_torch")
    bench = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    cfg = json.load(open(root / "hebench/configs/heaacv1_stereo_48k.json"))
    cfg.update(name="heaacv1_stereo_48k_b", frames_per_stream=50)
    (root / "hebench/configs/heaacv1_stereo_48k_b.json").write_text(
        json.dumps(cfg))
    mix = json.load(open(root / "hebench/mixes/stream_b1.json"))
    mix.update(streams=2, frames=3, check_streams=2, trace_streams=1)
    (root / "hebench/mixes/stream_short.json").write_text(json.dumps(mix))
    (root / "hebench/metrics/traced_frames.single.py").write_text(
        "def read(data):\n    return data.get('frames')\n")
    bench["configs"].append(dict(bench["configs"][1],
                                 name="heaacv1_stereo_48k_b",
                                 file="hebench/configs/"
                                      "heaacv1_stereo_48k_b.json"))
    bench["workloads"].append({"name": "v1s_short",
                               "config": "heaacv1_stereo_48k_b",
                               "traffic": "stream_short", "chips": 1,
                               "why": "a test cell"})
    bench["per_layer"].append({"name": "traced_frames.single",
                               "unit": "frames", "better": "higher",
                               "source": "program_counter",
                               "layer": "device", "moves": "frame_p95_ms",
                               "workloads": ["v1s_short"]})
    for m in bench["end_to_end"]:
        if "workloads" in m:
            m["workloads"].append("v1s_short")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    line = run_cell(capsys, "v1s_short", trace=1, root=str(root),
                    overrides={})
    assert line["correct"] is True
    assert line["metrics"]["traced_frames.single"]["value"] == 3
    assert "launches_per_frame.single" not in line["metrics"]
    line = run_cell(capsys, "v1s_short", trace=0, root=str(root),
                    overrides={})
    assert set(line["metrics"]) == {"realtime_x", "frame_p95_ms",
                                    "setup_s"}
