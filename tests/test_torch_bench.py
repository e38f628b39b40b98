"""The port's benchmark entry (``heaac_tpu_torch.bench``) and its
regression gate (``heaac_tpu_torch.bench_gate``) against the repo root's
``bench.py`` and ``tools/bench_gate.py``, on the CPU.

- Streams: the port's ``make_distinct_streams`` equals bench.py's byte
  for byte on streams 0-7 and on REDRAW, the first index whose first
  draw cannot be coded (so it takes the re-drawn SBR seed).
- Parse-only: on 4 of those streams (16 frames), the port's host parse
  walk gives the JAX ``QwirePipelinedDecoder._parse_group`` walk's wire
  bytes, frame counts, audio seconds and wire bytes per frame-lane
  exactly, in one group and in two (native parse only, no decode).
- The JSON line of a run on the CPU at 4 lanes x 16 frames, and the
  error line and exit 1 without a card.
- The gate: tools/bench_gate.py's cases (tests/test_bench_gate.py) with
  a device on every line, and its refusals: no baseline, a baseline
  naming no device (a BENCH_r*.json of the repo root) or another card.
"""
import ast
import json
import math
import os
import pathlib
import subprocess

import pytest
import torch

from heaac_tpu.codec import qwire as jax_qwire
from heaac_tpu.codec.batch import QwirePipelinedDecoder as JaxQwireDecoder
from heaac_tpu_torch import bench, bench_gate
from heaac_tpu_torch.codec.batch import QwirePipelinedDecoder
from heaac_tpu_torch.io import heaac_testgen as tg
from test_torch_common import REPO, release_jax_memory  # noqa: F401

REDRAW = 2292        # first stream whose first SBR draw cannot be coded
CHECKED = list(range(8)) + [REDRAW]
FRAMES = 16
FIELDS = ("metric", "value", "unit", "best_x", "median_x", "parse_only_x",
          "parse_us_per_frame", "device_only_x", "wire_bytes_per_frame_lane",
          "mfu_f32", "batch", "reps", "group", "device")


def root_make_distinct_streams():
    """bench.py's make_distinct_streams, compiled from its source without
    running bench.py's module-level set-up (a JAX compilation cache
    under /tmp)."""
    path = os.path.join(REPO, "bench.py")
    with open(path) as f:
        tree = ast.parse(f.read())
    fn = next(n for n in tree.body if isinstance(n, ast.FunctionDef)
              and n.name == "make_distinct_streams")
    ns = {"__file__": path}
    exec(compile(ast.Module(body=[fn], type_ignores=[]), path, "exec"), ns)
    return ns["make_distinct_streams"]


def with_placeholders(cache: pathlib.Path) -> pathlib.Path:
    """A cache directory holding empty files for streams 8..REDRAW-1, so
    that a maker generates only the streams compared."""
    cache.mkdir()
    for i in range(8, REDRAW):
        (cache / f"s{i}.aac").write_bytes(b"")
    return cache


@pytest.fixture(scope="module")
def made(tmp_path_factory):
    """{"port": streams, "jax": streams}: 0..REDRAW from each maker."""
    root = tmp_path_factory.mktemp("bench_streams")
    port = bench.make_distinct_streams(
        REDRAW + 1, with_placeholders(root / "port"))
    jax_cache = with_placeholders(root / "jax")
    real_path = pathlib.Path

    def redirect(*parts):        # bench.py's fixed cache directory
        if parts == ("/tmp/heaac_bench_distinct",):
            return real_path(jax_cache)
        return real_path(*parts)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pathlib, "Path", redirect)
        jax = root_make_distinct_streams()(REDRAW + 1)
    return {"port": port, "jax": jax}


@pytest.mark.parametrize("i", CHECKED)
def test_distinct_streams_equal_bench_py(made, i):
    assert len(made["port"][i]) > 1000
    assert made["port"][i] == made["jax"][i]


def test_redraw_index_needs_a_redraw():
    cores = [(bench.CORES_DIR / f"lc_core_24k_{k}.aac").read_bytes()
             for k in range(8)]
    w = tg.SbrStreamWriter(core_rate=24000, is_cpe=False, env_hi_shift=-12,
                           seed=1000 + 7 * REDRAW, invf_modes=(0, 1, 2, 3),
                           ps_writer=tg.PsStreamWriter(seed=2000 + 5 * REDRAW))
    with pytest.raises(ValueError):
        tg.splice_sbr_into_lc(cores[REDRAW % 8], w)


def jax_parse_only(streams: list, G: int) -> dict:
    """bench.py's parse-only loop over the JAX decoder (input order, the
    last group padded with the first streams)."""
    dec = JaxQwireDecoder(streams, group_streams=G, max_frames=FRAMES)
    B = len(streams)
    ngroups = (B + dec.G - 1) // dec.G
    dec.frame_counts = []
    wire = 0
    for gidx in range(ngroups):
        g = dec.streams[gidx * dec.G:(gidx + 1) * dec.G]
        if len(g) < dec.G:
            g = g + dec.streams[:dec.G - len(g)]
        r = dec._parse_group(g, gidx % 2)
        if r is not None:
            wire += r[1]
    nframes = sum(dec.frame_counts[:B]) or 1
    bpfl = (wire - ngroups * len(dec._sil_payload)) / (nframes * dec.nl) \
        + 4 * jax_qwire.REC_W
    return dict(wire=wire, counts=dec.frame_counts[:B],
                audio_s=dec.audio_seconds(), bpfl=bpfl)


def port_parse_only(streams: list, G: int) -> dict:
    dec = QwirePipelinedDecoder(streams, group_streams=G,
                                max_frames=FRAMES, device="cpu")
    _, wire = bench.parse_only(dec)
    return dict(wire=wire, counts=dec.frame_counts,
                audio_s=dec.audio_seconds(),
                bpfl=bench.wire_bytes_per_frame_lane(dec, wire))


@pytest.mark.parametrize("G", [4, 2])
def test_parse_only_equals_jax(made, G):
    streams = made["port"][:4]
    got, ref = port_parse_only(streams, G), jax_parse_only(streams, G)
    assert got["counts"] == ref["counts"] == [FRAMES] * 4
    assert got["wire"] == ref["wire"] > 0
    assert got["audio_s"] == ref["audio_s"]
    assert got["bpfl"] == ref["bpfl"]


def test_run_prints_the_json_line(tmp_path, capsys):
    line, outs = bench.run(4, 1, device="cpu", max_frames=FRAMES,
                           cache_dir=tmp_path)
    out, err = capsys.readouterr()
    printed = json.loads(out.strip().splitlines()[-1])
    assert printed == line
    assert set(FIELDS) <= set(line) and "vs_baseline" not in line
    assert line["metric"] == bench.METRIC and line["unit"] == "x_realtime"
    assert (line["batch"], line["reps"], line["group"]) == (4, 1, 4)
    assert line["device"] == {"name": "cpu", "power_limit_w": None}
    assert line["mfu_f32"] is None            # no card, no FP32 peak
    for key in FIELDS[1:-1]:
        if key not in ("unit", "mfu_f32"):
            assert math.isfinite(line[key]) and line[key] >= 0, key
    assert line["value"] > 0 and line["device_only_x"] > 0
    flops = float(err.split("(FlopCounterMode): ")[1].split(";")[0])
    assert flops > 0                          # the IMDCT / QMF products
    assert len(outs) == 1 and tuple(outs[0].shape) == (FRAMES, 4, 2, 2048)
    assert int(outs[0].abs().amax(dim=(0, 2, 3)).min()) > 0


def test_no_card_prints_the_error_line_and_exits_1(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert bench.main([]) == 1
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["value"] == 0.0 and "torch.cuda.is_available" in \
        line["error"]


@pytest.mark.parametrize("smi, want", [
    ("NVIDIA H100 80GB HBM3, 700.00, 1980\n",
     {"name": "NVIDIA H100 80GB HBM3", "power_limit_w": 700.0,
      "max_sm_clock_mhz": 1980.0}),
    ("NVIDIA H100 80GB HBM3, [N/A], [N/A]\n",
     {"name": "NVIDIA H100 80GB HBM3", "power_limit_w": None,
      "max_sm_clock_mhz": None})])
def test_card_info_reads_nvidia_smi(monkeypatch, smi, want):
    def fake_run(cmd, **kw):
        assert cmd[1] == "--query-gpu=name,power.limit,clocks.max.sm"
        return subprocess.CompletedProcess(cmd, 0, stdout=smi)
    monkeypatch.setattr(subprocess, "run", fake_run)
    assert bench.card_info(torch.device("cuda", 0)) == want


def test_f32_peak_flops(monkeypatch):
    class Props:
        multi_processor_count = 132
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda dev: Props)
    # H100 SXM: 132 SMs x 128 lanes x 2 x 1.98 GHz
    assert bench.f32_peak_flops(torch.device("cuda", 0), 1980.0) == \
        132 * 128 * 2 * 1980e6


CARD = {"name": "NVIDIA H100 80GB HBM3", "power_limit_w": 700.0}
BASE = {
    "metric": bench.METRIC,
    "value": 9000.0, "parse_only_x": 10000.0, "device_only_x": 90000.0,
    "wire_bytes_per_frame_lane": 400.0, "parse_us_per_frame": 4.2,
    "device": CARD,
}
GATE_CASES = {
    # tests/test_bench_gate.py's cases
    "pass_when_equal": (BASE, BASE, False, 0),
    "pass_when_equal_wrapped": (BASE, BASE, True, 0),
    "fail_on_headline_regression": ({**BASE, "value": 7000.0}, BASE, False,
                                    1),
    # headline within noise, device-only down 29%
    "fail_on_device_only_regression": (
        {**BASE, "value": 8800.0, "device_only_x": 64000.0}, BASE, False, 1),
    "fail_on_wire_growth": ({**BASE, "wire_bytes_per_frame_lane": 480.0},
                            BASE, False, 1),
    "fail_on_parse_slowdown": ({**BASE, "parse_us_per_frame": 5.0}, BASE,
                               False, 1),
    "tolerance_window": ({**BASE, "value": 8200.0}, BASE, False, 0),  # -8.9%
    "headline_only_baseline": (
        BASE, {"metric": bench.METRIC, "value": 9100.0, "device": CARD},
        True, 0),
    # the port's baseline rule
    "baseline_without_device": (BASE, {k: v for k, v in BASE.items()
                                       if k != "device"}, False, 2),
    "baseline_from_another_card": (
        BASE, {**BASE, "device": {"name": "NVIDIA A100-SXM4-80GB",
                                  "power_limit_w": 400.0}}, False, 2),
    "new_line_without_device": ({k: v for k, v in BASE.items()
                                 if k != "device"}, BASE, False, 2),
}


def _write(tmp_path, name, payload, wrap=False):
    p = tmp_path / name
    p.write_text(json.dumps({"parsed": payload} if wrap else payload))
    return str(p)


@pytest.mark.parametrize("case", list(GATE_CASES))
def test_gate(tmp_path, case):
    new, base, wrap, rc = GATE_CASES[case]
    assert bench_gate.main([_write(tmp_path, "new.json", new), "--baseline",
                            _write(tmp_path, "base.json", base, wrap)]) == rc


def test_gate_refuses_a_tpu_bench_record(tmp_path):
    # BENCH_r05.json: the JAX bench.py's line on a TPU, names no device
    new = _write(tmp_path, "new.json", BASE)
    assert bench_gate.main(
        [new, "--baseline", os.path.join(REPO, "BENCH_r05.json")]) == 2


def test_gate_takes_no_baseline_from_the_repo_root(tmp_path, monkeypatch,
                                                   capsys):
    # the JAX gate would pick the newest BENCH_r*.json; this one needs
    # --baseline, and a file it cannot read is refused too
    (tmp_path / "BENCH_r10.json").write_text(json.dumps({"parsed": BASE}))
    monkeypatch.chdir(tmp_path)
    new = _write(tmp_path, "new.json", BASE)
    assert bench_gate.main([new]) == 2
    assert "--baseline is required" in capsys.readouterr().out
    assert bench_gate.main([new, "--baseline", "missing.json"]) == 2
    (tmp_path / "empty.json").write_text("")
    assert bench_gate.main([new, "--baseline", "empty.json"]) == 2
