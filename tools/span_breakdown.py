#!/usr/bin/env python3
"""Where a benchmark cell's card idles, by the program's own spans.

    python3 tools/span_breakdown.py v2_batch_512 [--seed N] [--pairs 2]
        [--gaps 1] [--device cuda]
    python3 tools/span_breakdown.py v1s_stream_b1 ...

Makes the cell's streams as ``hebench`` does (its configuration and
traffic files, the seed), warms up, then profiles the cell's traced
unit (one ``decode_batch`` call, or ``trace_streams`` whole streams of
``decode_frame`` calls) for the card's activity alone, ``--pairs`` times
with the program's spans recorded (``utils.trace.recording``) and as
many times without, in turns (off, on, on, off, ...).  Prints one JSON
line:

  - ``wall_off_s`` / ``wall_on_s``: the traced unit's wall, recording
    off and on (what recording costs), and the launches of each (equal:
    a span launches nothing); ``span_cost_us``: one empty span's cost on
    this host, off and on;
  - ``drift_ns``: how far the profiler clock's offset from
    ``perf_counter`` moved over each recorded unit; ``ops_in_window``:
    the share of the card's operations inside the unit once its wall is
    mapped onto the profiler clock (1.0 when the spans and the card
    share a clock);
  - ``idle_spans``: the card's idle seconds, each gap between its
    operations named by the innermost span open at the gap's middle on
    the calling thread (any thread's where that has none), summed by
    name, and ``span_s``: each span name's summed seconds;
  - per unit, the span readings: for a batched call ``step_issue_ms``
    (mean ``scan.step``), ``expand_ms_per_step`` ((``expand_frame`` +
    ``expand_ps``) over the steps), ``parse_wait_ms`` and ``pcm_host_ms``
    (summed ``group.parse_wait`` and ``bucket.pcm``), and beside them
    ``scan_ms_per_step`` from ``hebench``'s own clock; for the stream
    cell ``frame_<stage>_ms``, each stage's mean a frame;
  - with ``--gaps 1``, one more recorded unit profiled with the host's
    operations too: its idle gaps named as ``hebench`` names them, a
    gap that no operation covers by ``span:<innermost span>``.

Run from the repository's root on a machine with the card; ``--device
cpu`` runs it on the CPU at the sizes given by ``--streams`` /
``--frames`` (a rehearsal: no number of it is a device number).
"""
import argparse
import contextlib
import json
import os
import statistics
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from hebench import devtrace, harness  # noqa: E402
from hebench.gen import make_streams  # noqa: E402
from hebench.ref.bitstream.adts import split_adts_stream  # noqa: E402

NONE = "(no span)"


def innermost(spans, t: np.ndarray, thread) -> list:
    """Name of the innermost span (latest start) holding each time in t,
    among ``thread``'s spans first, else among all."""
    def pick(sel):
        found = [None] * len(t)
        if not sel:
            return found
        s0 = np.array([s[1] for s in sel], np.int64)
        s1 = np.array([s[2] for s in sel], np.int64)
        order = np.argsort(s0, kind="stable")
        s0, s1 = s0[order], s1[order]
        pos = np.searchsorted(s0, t, side="right") - 1
        todo = np.flatnonzero(pos >= 0)
        while len(todo):
            hit = s1[pos[todo]] >= t[todo]
            for i in todo[hit]:
                found[i] = sel[order[pos[i]]][0]
            todo = todo[~hit]
            pos[todo] -= 1                   # the span that started before
            todo = todo[pos[todo] >= 0]
        return found
    mine = pick([s for s in spans if s[3] == thread])
    anyt = pick(spans)
    return [a or b or NONE for a, b in zip(mine, anyt)]


def mapped(rec):
    """The recording's spans as (name, start, end, thread) on the
    profiler clock."""
    return [(s.name, int(rec.to_trace_ns(s.start_ns)),
             int(rec.to_trace_ns(s.end_ns)), s.thread) for s in rec.spans]


def gaps(tr, w0: int, w1: int):
    """The card's idle gaps inside [w0, w1] -> (starts, ends)."""
    s, e = devtrace.union(np.clip(tr.dev_start, w0, w1),
                          np.clip(tr.dev_end, w0, w1))
    g0 = np.concatenate([[w0], e])
    g1 = np.concatenate([s, [w1]])
    keep = g1 > g0
    return g0[keep], g1[keep]


def idle_by_span(tr, rec, w0: int, w1: int, thread) -> dict:
    g0, g1 = gaps(tr, w0, w1)
    names = innermost(mapped(rec), (g0 + g1) // 2, thread)
    out: dict = {}
    for n, d in zip(names, g1 - g0):
        out[n] = out.get(n, 0.0) + int(d) / 1e9
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def span_seconds(rec) -> dict:
    out: dict = {}
    for s in rec.spans:
        out[s.name] = out.get(s.name, 0.0) + (s.end_ns - s.start_ns) / 1e9
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def named_gaps(tr, rec, thread, top: int = 12) -> list:
    """hebench's host-operation naming of a host-ops capture's gaps, a
    gap no operation covers named by its innermost span."""
    w0, w1 = tr.window_ns
    g0, g1 = gaps(tr, w0, w1)
    mid = (g0 + g1) // 2
    names = tr.name_at(mid)
    spans = innermost(mapped(rec), mid, thread)
    tot: dict = {}
    for n, s, d in zip(names, spans, g1 - g0):
        key = f"span:{s}" if n == devtrace.NO_HOST_OP else n
        tot[key] = tot.get(key, 0.0) + int(d) / 1e9
    return sorted(tot.items(), key=lambda kv: -kv[1])[:top]


def profiled(unit, dev, record: bool, host_ops: bool = False):
    """Run unit() under the card-only (or host-ops) profiler ->
    (Trace, Recording or None, window on the profiler clock, wall s)."""
    import torch

    from heaac_tpu_torch.utils import trace
    spans = trace.recording() if record else contextlib.nullcontext()
    with devtrace.capture(dev, host_ops=host_ops) as box, spans as rec:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        p0 = time.perf_counter_ns()
        unit()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        p1 = time.perf_counter_ns()
    window = None if rec is None else (int(rec.to_trace_ns(p0)),
                                       int(rec.to_trace_ns(p1)))
    return box["trace"], rec, window, (p1 - p0) / 1e9


def span_cost_us(n: int = 20000) -> dict:
    """Microseconds one empty span costs on this host, recording off
    and on (three nested, as a frame step opens them)."""
    from heaac_tpu_torch.utils import trace
    out = {}
    for key in ("off", "on"):
        with trace.recording() if key == "on" else contextlib.nullcontext():
            t = time.perf_counter()
            for _ in range(n // 3):
                with trace.span("a"):
                    with trace.span("b"):
                        with trace.span("c"):
                            pass
            out[key] = (time.perf_counter() - t) / (3 * (n // 3)) * 1e6
    return out


def per_name(rec, name: str) -> list:
    return [(s.end_ns - s.start_ns) / 1e6 for s in rec.spans
            if s.name == name]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("cell", choices=["v2_batch_512", "v1s_stream_b1"])
    ap.add_argument("--seed", type=int, default=3600000001)
    ap.add_argument("--pairs", type=int, default=2)
    ap.add_argument("--gaps", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--streams", type=int, default=None)
    ap.add_argument("--frames", type=int, default=None)
    ap.add_argument("--workers", type=int, default=None)
    args = ap.parse_args(argv)

    import threading

    import torch

    from heaac_tpu_torch import Decoder, decode_batch
    bench = harness.load_json(ROOT, "BENCHMARK.json")
    cell = harness.find_cell(bench, args.cell)
    cfg = harness.load_json(ROOT, "hebench", "configs",
                            f"{cell['config']}.json")
    mix = harness.load_json(ROOT, "hebench", "mixes",
                            f"{cell['traffic']}.json")
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        print("no card: nothing measured", file=sys.stderr)
        return 2
    batched = mix["kind"] == "batch"
    n = args.streams or (cfg["streams"] if batched
                         else mix["trace_streams"])
    streams = make_streams(ROOT, cfg["generator"], n, args.seed,
                           mix["invf_modes"], args.workers)
    frames = [split_adts_stream(s)[:args.frames] for s in streams]
    streams = [b"".join(f) for f in frames]

    if batched:
        def unit():
            decode_batch(streams, device=dev)
    else:
        def unit():
            for fr in frames:
                dec = Decoder(adts_probe=fr[0][:7], device=dev)
                for f in fr:
                    dec.decode_frame(f).numpy()
    unit()                                               # warm-up
    main_thread = threading.get_native_id()
    out = dict(cell=args.cell, seed=args.seed, card=harness.card_line()
               if dev.type == "cuda" else "cpu (a rehearsal)",
               torch=torch.__version__, wall_off_s=[], wall_on_s=[],
               launches_off=[], launches_on=[], drift_ns=[],
               ops_in_window=[], units=[], span_cost_us=span_cost_us())
    for k in range(2 * args.pairs):
        record = k % 4 in (1, 2)              # off, on, on, off, ...
        tr, rec, window, wall = profiled(unit, dev, record)
        out["wall_on_s" if record else "wall_off_s"].append(wall)
        out["launches_on" if record else "launches_off"].append(
            tr.launches())
        if not record:
            continue
        w0, w1 = window
        inside = ((tr.dev_start >= w0) & (tr.dev_end <= w1)).mean() \
            if len(tr.dev_start) else 1.0
        out["drift_ns"].append(rec.drift_ns)
        out["ops_in_window"].append(float(inside))
        idle = idle_by_span(tr, rec, w0, w1, main_thread)
        u = dict(window_s=(w1 - w0) / 1e9, busy_s=tr.busy_s(),
                 idle_spans=idle, span_s=span_seconds(rec),
                 counters=rec.counters)
        if batched:
            steps = per_name(rec, "scan.step")
            expand = sum(per_name(rec, "expand_frame")
                         + per_name(rec, "expand_ps"))
            u.update(step_issue_ms=statistics.fmean(steps),
                     expand_ms_per_step=expand / len(steps),
                     parse_wait_ms=sum(per_name(rec, "group.parse_wait")),
                     pcm_host_ms=sum(per_name(rec, "bucket.pcm")),
                     group_parse_ms=per_name(rec, "group.parse"),
                     steps=len(steps))
        else:
            nfr = len(per_name(rec, "decode_frame"))
            for stage in ("parse", "prep", "issue", "download"):
                u[f"frame_{stage}_ms"] = sum(
                    per_name(rec, f"frame.{stage}")) / nfr
            u["frames"] = nfr
        out["units"].append(u)
    if batched:
        from hebench.traffic.batch import _parse_and_scan
        ps = _parse_and_scan(streams, dev)
        out["scan_ms_per_step"] = ps["scan_s"] / ps["scan_steps"] * 1e3
        out["parse_us_per_frame"] = \
            ps["parse_walk_s"] / ps["parse_walk_frames"] * 1e6
    if args.gaps:
        tr, rec, _, wall = profiled(unit, dev, True, host_ops=True)
        out["gap_wall_s"] = wall
        out["idle_gaps_named"] = named_gaps(tr, rec, main_thread)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
