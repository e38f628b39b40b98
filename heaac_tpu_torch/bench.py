"""Benchmark entry of the PyTorch port: aggregate realtime factor of
HE-AAC v2 decode on one card.

    python -m heaac_tpu_torch.bench [B] [reps]         # defaults 512, 8
    HEAAC_BENCH_ALL_DISTINCT=1 python -m heaac_tpu_torch.bench 4096 3

The counterpart of the repo root's ``bench.py``, over the port's
``codec.batch.QwirePipelinedDecoder``.  B lanes, each its own byte
buffer, drawn from a pool of min(B, 512) distinct HE-AAC v2 streams (B
with ``HEAAC_BENCH_ALL_DISTINCT`` set to anything non-empty), decoded in
groups of min(B, 512) streams (``HEAAC_BENCH_GROUP`` to change it).
After one warm-up decode it measures:

- parse-only: the host parse alone of every group, walked as
  ``decode()`` walks them (ascending frame-count order, the last group
  padded, heap growth); the wire's bytes per frame-lane (heap payload
  less the shared silence template, plus the 16-byte record);
- device-only: group 0's wire uploaded once, then the qwire scan run once
  per group on it.  The scan's frame loop is Python issuing PyTorch ops,
  so this time holds that host issue as well as the card's work: it is
  the decode without parse and upload, not device time alone;
- ``reps`` sustained end-to-end decodes (parse + upload + decode,
  pipelined by group), back to back.  The headline ``value`` is the
  long-run aggregate (total audio / total wall); best, median and each
  rep's figure go to stderr too.

Every clock stops after ``torch.cuda.synchronize``.  The last line on
stdout is one JSON object with bench.py's fields: metric, value, unit,
best_x, median_x, parse_only_x, parse_us_per_frame, device_only_x,
wire_bytes_per_frame_lane, mfu_f32, batch, reps, group; and device.

Where it departs from bench.py:
  (a) no ``vs_baseline``: bench.py divides by a target set for another
      chip;
  (b) ``mfu_f32`` divides by this card's own FP32 peak: SM count x 128
      FP32 lanes (Hopper) x 2 x the maximum SM clock from nvidia-smi.
      TF32 is off (``set_f32_flags``), so the IMDCT and QMF products run
      on the FP32 cores.  null on the CPU;
  (c) the FLOPs are counted by ``torch.utils.flop_counter.FlopCounterMode``
      over one untimed scan, which counts matrix products only, where
      bench.py's XLA ``cost_analysis`` counts every op: the two are not
      one figure.  K1 (a ctypes launch, no matrix product) is not seen;
  (d) ``device``: {"name", "power_limit_w"} from ``nvidia-smi
      --query-gpu=name,power.limit`` ("cpu" and null on the CPU), which
      ``bench_gate`` holds a baseline to;
  (e) ``mfu_f32`` keeps six decimals (bench.py four), as it is small
      here;
  (f) the streams are cached in a directory of their own,
      ``<tempdir>/heaac_torch_bench_distinct``.

Without a card it prints bench.py's error line (value 0.0, ``error``)
and exits 1; it never carries on on the CPU.  ``--device cpu`` exists
for the tests.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch

from .codec.batch import QwirePipelinedDecoder
from .device import resolve
from .host import REC_W
from .io.heaac_testgen import distinct_stream

METRIC = "sustained_end_to_end_realtime_factor_heaacv2_48k_per_chip"
CORES_DIR = Path(__file__).resolve().parent.parent / "benchdata"
CACHE_DIR = Path(tempfile.gettempdir()) / "heaac_torch_bench_distinct"
INVF_MODES = (0, 1, 2, 3)      # bench.py's SBR inverse filtering draw
FP32_LANES_PER_SM = 128        # Hopper


def make_distinct_streams(n: int, cache_dir=None) -> list:
    """n distinct HE-AAC v2 streams by bench.py's recipe: the 8 bundled
    LC cores crossed with SBR writer seed 1000 + 7i (+ 1000003 per
    re-draw, at most 8 draws) and PS writer seed 2000 + 5i, inverse
    filtering modes 0-3.  Cached in ``cache_dir`` (CACHE_DIR by default)
    after the first generation (~45 ms a stream)."""
    cache = Path(cache_dir or CACHE_DIR)
    cache.mkdir(parents=True, exist_ok=True)
    cores = [(CORES_DIR / f"lc_core_24k_{i}.aac").read_bytes()
             for i in range(8)]
    for i in range(n):
        c = cache / f"s{i}.aac"
        if not c.exists():
            tmp = cache / f"s{i}.{os.getpid()}.tmp"
            tmp.write_bytes(distinct_stream(cores, i, invf_modes=INVF_MODES))
            os.replace(tmp, c)
    return [(cache / f"s{i}.aac").read_bytes() for i in range(n)]


def card_info(device: torch.device) -> dict:
    """{"name", "power_limit_w", "max_sm_clock_mhz"} of the card from
    nvidia-smi; on the CPU name "cpu" and the rest None."""
    if device.type != "cuda":
        return dict(name="cpu", power_limit_w=None, max_sm_clock_mhz=None)
    line = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True).stdout.splitlines()[device.index]
    name, power, clock = (s.strip() for s in line.rsplit(",", 2))

    def number(s: str):
        try:
            return float(s)
        except ValueError:          # "[N/A]"
            return None

    return dict(name=name, power_limit_w=number(power),
                max_sm_clock_mhz=number(clock))


def f32_peak_flops(device: torch.device, max_sm_clock_mhz: float) -> float:
    """FP32 FLOP/s of the card outside the tensor cores: SMs x 128 lanes x
    2 (a fused multiply-add) x the maximum SM clock."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return sms * FP32_LANES_PER_SM * 2 * max_sm_clock_mhz * 1e6


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def parse_only(dec: QwirePipelinedDecoder) -> tuple:
    """Host parse alone of every group, as ``decode()`` walks them ->
    (seconds, wire bytes: each group's heap cursor, summed).  Leaves
    ``dec.frame_counts`` one per stream, in input order."""
    ngroups = -(-len(dec.streams) // dec.G)
    dec.frame_counts = []
    dec.error_count = 0
    wire = 0
    t0 = time.perf_counter()
    for gidx in range(ngroups):
        wire += dec._parse_with_retry(gidx)[0]
    seconds = time.perf_counter() - t0
    dec._counts_in_input_order()
    return seconds, wire


def wire_bytes_per_frame_lane(dec: QwirePipelinedDecoder, wire: int) -> float:
    """Heap payload less each group's shared silence template, plus the
    record, per frame-lane (bench.py's formula)."""
    ngroups = -(-len(dec.streams) // dec.G)
    nframes = sum(dec.frame_counts) or 1
    return (wire - ngroups * len(dec._sil_payload)) / (nframes * dec.nl) \
        + 4 * REC_W


def device_only(dec: QwirePipelinedDecoder) -> tuple:
    """Group 0's wire uploaded once, the qwire scan run once per group on
    it -> (seconds, FLOPs of one scan's matrix products, counted by
    FlopCounterMode over one more scan, outside the timed window)."""
    from torch.utils.flop_counter import FlopCounterMode
    ngroups = -(-len(dec.streams) // dec.G)
    cur, Tg, sa, couple = dec._parse_with_retry(0)
    heap_d, recs_d, couple_d = dec._upload(0, cur, Tg, couple)
    _sync(dec.device)
    t0 = time.perf_counter()
    for _ in range(ngroups):
        dec._scan(heap_d, recs_d, sa, couple_d)
    _sync(dec.device)
    seconds = time.perf_counter() - t0
    t0 = time.perf_counter()
    with FlopCounterMode(display=False) as counter:
        dec._scan(heap_d, recs_d, sa, couple_d)
    _sync(dec.device)
    print(f"# FLOP count scan (untimed): {time.perf_counter() - t0:.3f}s",
          file=sys.stderr)
    return seconds, counter.get_total_flops()


def run(B: int = 512, reps: int = 8, device="cuda", group: int = 0,
        all_distinct: bool = False, max_frames: int | None = None,
        cache_dir=None) -> tuple:
    """The whole benchmark; prints diagnostics on stderr and the JSON line
    on stdout -> (that line as a dict, the last timed decode's pcm
    tensors).  ``group`` 0 means min(B, 512) streams a group;
    ``max_frames`` cuts every stream (the tests)."""
    dev = resolve(device)
    card = card_info(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    group = group or min(B, 512)
    t0 = time.perf_counter()
    distinct = make_distinct_streams(B if all_distinct else min(B, 512),
                                     cache_dir)
    print(f"# streams: {len(distinct)} distinct, made or read from the "
          f"cache in {time.perf_counter() - t0:.3f}s", file=sys.stderr)
    streams = [distinct[i % len(distinct)] for i in range(B)]
    dec = QwirePipelinedDecoder(streams, group_streams=min(group, B),
                                max_frames=max_frames, device=dev)
    t0 = time.perf_counter()
    dec.decode()                       # warm-up
    print(f"# warm-up decode: {time.perf_counter() - t0:.3f}s",
          file=sys.stderr)
    audio_s = dec.audio_seconds()
    ngroups = -(-B // dec.G)

    parse_s, wire = parse_only(dec)
    nframes = sum(dec.frame_counts) or 1
    parse_us = parse_s / nframes * 1e6
    parse_x = audio_s / parse_s
    wire_bpfl = wire_bytes_per_frame_lane(dec, wire)
    print(f"# parse-only: {parse_x:.0f}x ({parse_s:.3f}s, {parse_us:.1f} "
          f"us/frame/stream); wire {wire_bpfl:.0f} B/frame-lane",
          file=sys.stderr)

    dev_s, flops = device_only(dec)
    dev_x = audio_s / dev_s
    print(f"# device-only: {dev_x:.0f}x ({dev_s:.4f}s)", file=sys.stderr)
    # no peak on the CPU, nor where nvidia-smi gives no maximum clock
    peak = (f32_peak_flops(dev, card["max_sm_clock_mhz"])
            if card["max_sm_clock_mhz"] else None)
    mfu = flops * ngroups / dev_s / peak if peak else None
    print(f"# matrix-product flops/scan (FlopCounterMode): {flops:.3e}; "
          f"FP32 peak {peak} FLOP/s; MFU {mfu}", file=sys.stderr)

    walls = []
    for _ in range(reps):
        outs = None          # the previous rep's PCM is not held meanwhile
        t0 = time.perf_counter()
        outs = dec.decode()
        wall = time.perf_counter() - t0
        walls.append(wall)
        print(f"# end-to-end rep: {audio_s / wall:.0f}x ({wall:.3f}s wall, "
              f"{audio_s:.0f}s audio)", file=sys.stderr)
    sustained = audio_s * len(walls) / sum(walls)
    best = audio_s / min(walls)
    med = audio_s / sorted(walls)[len(walls) // 2]
    print(f"# sustained (aggregate over {reps} reps): {sustained:.0f}x; "
          f"best {best:.0f}x; median {med:.0f}x", file=sys.stderr)
    if dev.type == "cuda":
        print(f"# peak card memory: {torch.cuda.max_memory_allocated(dev)} "
              f"bytes; {card['name']}, {card['power_limit_w']} W",
              file=sys.stderr)
    line = {
        "metric": METRIC,
        "value": round(sustained, 2),
        "unit": "x_realtime",
        "best_x": round(best, 2),
        "median_x": round(med, 2),
        "parse_only_x": round(parse_x, 2),
        "parse_us_per_frame": round(parse_us, 3),
        "device_only_x": round(dev_x, 2),
        "wire_bytes_per_frame_lane": round(wire_bpfl, 1),
        "mfu_f32": round(mfu, 6) if mfu is not None else None,
        "batch": B,
        "reps": reps,
        "group": group,
        "device": {"name": card["name"],
                   "power_limit_w": card["power_limit_w"]},
    }
    print(json.dumps(line), flush=True)
    return line, outs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m heaac_tpu_torch.bench",
        description="Aggregate realtime factor of HE-AAC v2 decode on one "
                    "card; the last stdout line is the JSON result.")
    ap.add_argument("batch", nargs="?", type=int, default=512,
                    help="lanes (streams), default 512")
    ap.add_argument("reps", nargs="?", type=int, default=8,
                    help="timed end-to-end decodes, default 8")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cuda:N; cpu is for the tests")
    args = ap.parse_args(argv)
    try:
        resolve(args.device)
    except RuntimeError as e:
        print(json.dumps(dict(metric="aggregate_realtime_x", value=0.0,
                              unit="x_realtime",
                              error=f"device backend unavailable: {e}")),
              flush=True)
        return 1
    if args.batch < 1 or args.reps < 1:
        ap.error("batch and reps must be at least 1")
    run(args.batch, args.reps, args.device,
        group=int(os.environ.get("HEAAC_BENCH_GROUP", "0")),
        all_distinct=bool(os.environ.get("HEAAC_BENCH_ALL_DISTINCT")))
    return 0


if __name__ == "__main__":
    sys.exit(main())
