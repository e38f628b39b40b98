"""One run of one benchmark cell: find the cell, its configuration, its
traffic mix and the mix's kind by name; check the card; run the kind;
judge its PCM against the reference; print the result line.

Everything that belongs to one configuration, mix or per-layer metric
is a file of its own, found by the name ``BENCHMARK.json`` gives:
  configs/<config>.json     the deployment, its generator and precision
  mixes/<traffic>.json      the traffic: its kind, parameters, limits
  traffic/<kind>.py         the code of a kind: ``run(ctx) -> Outcome``
  gen/<generator kind>.py   how the configuration's streams are made
  metrics/<metric>.py       a per-layer metric's reader: ``read(data)``
"""
from __future__ import annotations

import importlib
import importlib.util
import json
import os
import subprocess
import sys
import time
from dataclasses import dataclass, field

from .check import compare, judge, reference

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# the whole top-level module names that may not be loaded in a run
FORBIDDEN = ("jax", "jaxlib", "flax", "heaac_tpu")


@dataclass
class Context:
    root: str
    cell: dict
    config: dict
    mix: dict
    seed: int
    seconds: float
    trace: bool
    t0: float                     # perf_counter at process start
    device: str = "cuda"
    workers: int | None = None    # host processes for generation / check


@dataclass
class Outcome:
    """What a traffic kind hands back after its window."""
    attempted: int
    failed: int                   # outputs of a wrong length, every call
    e2e: dict                     # end-to-end metric name -> value
    memory_peak_bytes: int
    streams: list                 # the checked streams' ADTS bytes
    pcm: list                     # per checked stream: its PCM copies
    # for the per-layer readers; "trace" (device activity alone) gives
    # busy_s, window_s and the device operations, "gap_trace" (host
    # operations too) the named idle gaps
    data: dict = field(default_factory=dict)


def load_json(*parts) -> dict:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def find_cell(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise SystemExit(f"no workload {name!r} in BENCHMARK.json")


def applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_reader(root: str, name: str):
    """The per-layer metric's reader, ``metrics/<name>.py``."""
    path = os.path.join(root, "hebench", "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        f"hebench.metrics.{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def card_line(index: int = 0) -> str:
    """'<name>, <power limit>' from nvidia-smi, or why it is missing."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()
        return out[index] if len(out) > index else "nvidia-smi: no card"
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi: {e}"


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def log(msg: str) -> None:
    print(f"# {msg}", file=sys.stderr, flush=True)


def children() -> list:
    """The live child processes of this one, as '<pid> <name>' (Linux
    /proc; empty elsewhere)."""
    me, out = str(os.getpid()), []
    try:
        pids = [p for p in os.listdir("/proc") if p.isdigit()]
    except OSError:
        return out
    for pid in pids:
        try:
            with open(f"/proc/{pid}/stat") as f:
                stat = f.read()
        except OSError:
            continue
        name, rest = stat[stat.index("(") + 1:stat.rindex(")")], \
            stat[stat.rindex(")") + 2:].split()
        if rest[1] == me:
            out.append(f"{pid} {name}")
    return out


def setup_done(ctx: Context) -> float:
    """Set-up's seconds, from process start; logs them beside the host
    work that could run on into the window (child processes, threads)."""
    import threading

    import torch
    setup_s = time.perf_counter() - ctx.t0
    log(f"set-up: {setup_s:.3f} s; child processes {children()}; "
        f"threads {threading.active_count()}, torch intra-op "
        f"{torch.get_num_threads()}")
    return setup_s


def run(argv=None, t0: float | None = None, root: str = ROOT,
        device: str = "cuda", workers: int | None = None,
        overrides: dict | None = None) -> int:
    """The command: ``--workload --seed --seconds --trace``.  ``device``,
    ``workers`` and ``overrides`` ({"config": {...}, "mix": {...}}, keys
    laid over the files') are for the tests (a CPU run of a small cell);
    a measuring run takes the defaults."""
    import argparse
    t0 = time.perf_counter() if t0 is None else t0
    ap = argparse.ArgumentParser(prog="hebench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    bench = load_json(root, "BENCHMARK.json")
    cell = find_cell(bench, args.workload)
    config = load_json(root, "hebench", "configs", f"{cell['config']}.json")
    mix = load_json(root, "hebench", "mixes", f"{cell['traffic']}.json")
    config.update((overrides or {}).get("config", {}))
    mix.update((overrides or {}).get("mix", {}))
    kind = importlib.import_module(f"hebench.traffic.{mix['kind']}")

    import torch
    if device == "cuda":
        if not torch.cuda.is_available():
            log("torch.cuda.is_available() is False: no measurement")
            return 2
        if torch.cuda.device_count() < cell["chips"]:
            log(f"{torch.cuda.device_count()} cards, the cell asks for "
                f"{cell['chips']}: no measurement")
            return 2
        card = card_line()
        kind_name = torch.cuda.get_device_name(0)
    else:
        card, kind_name = "cpu (a test run, not a measurement)", "cpu"
    log(f"card: {card}; cell {cell['name']}, seed {args.seed}, "
        f"{args.seconds} s, trace {args.trace}")

    ctx = Context(root=root, cell=cell, config=config, mix=mix,
                  seed=args.seed, seconds=args.seconds,
                  trace=bool(args.trace), t0=t0, device=device,
                  workers=workers)
    out = kind.run(ctx)

    # the reference, once the window has closed and the program's state
    # is freed (the kind returns only host copies of the checked PCM)
    t = time.perf_counter()
    refs = reference(out.streams, workers=workers)
    got, want = [], []
    for r, copies in zip(refs, out.pcm):
        for p in copies:
            got.append(p)
            want.append(r)
    numbers = compare(got, want)
    numbers["bad_streams"] += out.failed
    correct, rows = judge(numbers, mix["limits"])
    log(f"reference: {len(refs)} streams, {len(got)} copies compared in "
        f"{time.perf_counter() - t:.3f} s")

    metrics = {}
    if args.trace:
        for m in bench["per_layer"]:
            if not applies(m, cell["name"]):
                continue
            v = load_reader(root, m["name"])(out.data)
            if v is None:
                log(f"error: per-layer metric {m['name']} applies to this "
                    f"cell, but its reader found nothing to read: it is "
                    f"left out of the result line")
            else:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        for m in bench["end_to_end"]:
            if applies(m, cell["name"]):
                metrics[m["name"]] = {"value": out.e2e[m["name"]],
                                      "unit": m["unit"]}

    found = forbidden_modules()
    if found:
        log(f"modules loaded that the port may not load: {found}")
        return 3

    dev = {"platform": "gpu" if device == "cuda" else "cpu",
           "kind": kind_name, "count": cell["chips"],
           "memory_peak_bytes": out.memory_peak_bytes}
    line = {"correct": bool(correct),
            "attempted": out.attempted, "failed": out.failed,
            "metrics": metrics, "device": dev}
    if args.trace:
        tr, gaps = out.data.get("trace"), out.data.get("gap_trace")
        if tr is not None:
            dev["busy_s"] = tr.busy_s()
            dev["window_s"] = tr.window_s
            line["breakdown"] = {
                "device_ops": tr.device_ops(),
                "idle_gaps": gaps.idle_gaps() if gaps is not None else []}
    line["checks"] = rows
    for name, r in rows.items():
        print(f"check {name}: {r['value']} (limit {r['limit']})",
              file=sys.stderr, flush=True)
    print(json.dumps(line), flush=True)
    return 0
