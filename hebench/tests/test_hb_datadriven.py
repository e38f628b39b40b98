"""A cell of an existing traffic kind is data alone: in a copy of the
benchmark, a new configuration file, a new mix file, a new per-layer
reader and a new entry of BENCHMARK.json give a cell that the harness
runs and a metric it reports, with no code edited."""
import json
import os
import shutil
import sys
import types

from hebench.tests._cpu import batch_data, run_cell
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


def test_batch_cell_without_ps_or_streams_from_files(tmp_path, monkeypatch,
                                                      capsys):
    """The batch kind takes an AAC-LC configuration (1,024 samples a
    frame, no ``ps_bands``, no ``streams``) from its files alone: the
    streams a call from the mix, and a generator module (here the cores
    as they are, registered by name) in place of a new ``hebench/gen``
    file."""
    gen = types.ModuleType("hebench.gen.lc_core_test")
    gen.make = lambda cores, i, seed, invf_modes, p: b"".join(
        f for f, _ in cores[i % len(cores)])
    monkeypatch.setitem(sys.modules, gen.__name__, gen)
    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(ROOT, "hebench"), root / "hebench",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    os.symlink(os.path.join(ROOT, "heaac_tpu_torch"),
               root / "heaac_tpu_torch")
    bench = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    cfg = {"name": "aaclc_mono_24k", "core_rate": 24000, "core_channels": 1,
           "output_rate": 24000, "output_channels": 1,
           "frames_per_stream": 50,
           "generator": {"kind": "lc_core_test",
                         "cores": "hebench/data/cores/mono_{i}.aac",
                         "n_cores": 8}}
    (root / "hebench/configs/aaclc_mono_24k.json").write_text(
        json.dumps(cfg))
    mix = json.load(open(root / "hebench/mixes/batch_512.json"))
    mix.update(streams=2, check_streams=2)
    (root / "hebench/mixes/lc_batch_2.json").write_text(json.dumps(mix))
    bench["configs"].append(dict(bench["configs"][0], name="aaclc_mono_24k",
                                 file="hebench/configs/aaclc_mono_24k.json"))
    bench["workloads"].append({"name": "lc_batch_2",
                               "config": "aaclc_mono_24k",
                               "traffic": "lc_batch_2", "chips": 1,
                               "why": "a test cell"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if m["name"] in ("realtime_x", "device_idle_pct.batch",
                         "launches_per_step.batch"):
            m["workloads"].append("lc_batch_2")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    line = run_cell(capsys, "lc_batch_2", root=str(root), overrides={})
    assert line["correct"] is True, line["checks"]
    assert line["failed"] == 0
    assert set(line["metrics"]) == {"realtime_x", "setup_s"}
    data = batch_data(monkeypatch)
    line = run_cell(capsys, "lc_batch_2", trace=1, root=str(root),
                    overrides={})
    assert line["correct"] is True, line["checks"]
    assert set(line["metrics"]) == {"device_idle_pct.batch",
                                    "launches_per_step.batch"}
    # no K1 inputs without PS; no qwire parse walk or scan for an LC bucket
    assert not {"k1_lane_frames", "parse_walk_s", "scan_s"} & set(data)
