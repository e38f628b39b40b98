#!/usr/bin/env python3
"""Where the PyTorch port's decode spends its time, on one NVIDIA GPU.

    python3 tools/profile_torch_decode.py [lanes]     # default 512

Decodes the 8 bundled HE-AACv2 streams tiled to ``lanes`` lanes (one
group) with heaac_tpu_torch's QwirePipelinedDecoder on "cuda" and prints:
  - end-to-end wall and realtime factor of three decodes after a warm-up;
  - wall seconds per stage (parse, upload, scan prologue, expand_frame,
    expand_ps, heaac_frame, int16), each followed by a synchronize;
  - the host time to issue the frame loop without synchronizing;
  - under torch.profiler: device time per stage, device busy share of the
    wall, device events per frame, and the 15 ops with the most device
    time;
  - peak device memory.
"""
import os
import subprocess
import sys
import time

import torch
from torch.profiler import ProfilerActivity, profile, record_function

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _annotate(mod, name):
    """Wrap mod.name in a profiler range named stage::name."""
    fn = getattr(mod, name)

    def wrapped(*a, **k):
        with record_function("stage::" + name):
            return fn(*a, **k)
    setattr(mod, name, wrapped)


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    sys.path.insert(0, REPO)
    from heaac_tpu_torch.codec import compact_plan, qwire
    from heaac_tpu_torch.codec import heaac_graph as HG
    from heaac_tpu_torch.codec.batch import QwirePipelinedDecoder
    from heaac_tpu_torch.ops import ps as PS

    lanes = int(sys.argv[1]) if len(sys.argv) > 1 else 512
    print("card:", subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    bench = [open(os.path.join(REPO, "benchdata",
                               f"heaac_bench_stream_{i}.aac"), "rb").read()
             for i in range(8)]
    dec = QwirePipelinedDecoder([bench[i % 8] for i in range(lanes)],
                                group_streams=lanes, device="cuda")
    dec.decode()
    audio = dec.audio_seconds()
    for _ in range(3):
        t0 = time.perf_counter()
        dec.decode()
        wall = time.perf_counter() - t0
        print(f"e2e: {wall:.4f} s for {audio:.3f} s audio = "
              f"{audio / wall:.1f}x realtime", flush=True)

    sync = torch.cuda.synchronize
    stages = dict(parse=0.0, upload=0.0, prologue=0.0, expand_frame=0.0,
                  expand_ps=0.0, heaac_frame=0.0, int16=0.0)

    def timed(name, fn, *a):
        t0 = time.perf_counter()
        out = fn(*a)
        sync()
        stages[name] += time.perf_counter() - t0
        return out

    cur, Tg, sa, _ = timed("parse", dec._parse_with_retry, 0)
    heap_d, recs_d, _ = timed("upload", dec._upload, 0, cur, Tg)
    heap, rec_seq, coeffs = timed(
        "prologue", HG.decode_all_coeffs, heap_d, recs_d, sa["S"],
        sa["rate_idx"], sa["NB"], sa["MS"], sa["NS"], sa["SEC"])
    state, ph, qc = HG.init_qwire_carry(dec.L, dec.device)
    for t in range(Tg):
        meta, plan, pc, qc = timed("expand_frame", qwire.expand_frame, heap,
                                   rec_seq[t], qc)
        ps_plan, ph = timed("expand_ps", compact_plan.expand_ps, pc, ph)
        out, state = timed("heaac_frame", HG.heaac_frame,
                           dict(coeffs=coeffs[t], **meta), plan, ps_plan,
                           state)
        timed("int16", HG.to_int16, out)
    print("stage wall s (synchronized):",
          " ".join(f"{k} {v:.4f}" for k, v in stages.items()), flush=True)

    carry = HG.init_qwire_carry(dec.L, dec.device)
    sync()
    t0 = time.perf_counter()
    for t in range(Tg):
        _, carry = HG.heaac_frame_qwire(coeffs[t], rec_seq[t], heap, carry)
    issue = time.perf_counter() - t0
    sync()
    print(f"frame loop: host issue {issue:.4f} s, issue + drain "
          f"{time.perf_counter() - t0:.4f} s", flush=True)

    for mod, name in ((HG, "decode_all_coeffs"), (qwire, "expand_frame"),
                      (compact_plan, "expand_ps"), (HG, "heaac_frame"),
                      (PS, "decorrelate_seq")):
        _annotate(mod, name)
    torch.cuda.reset_peak_memory_stats()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        dec.decode()
        wall = time.perf_counter() - t0
    dev = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA
           and not e.name.startswith("stage::")]
    busy = sum(e.device_time for e in dev) / 1e6
    print(f"profiled: wall {wall:.4f} s, device busy {busy:.4f} s "
          f"({busy / wall:.3f}), device events {len(dev)} "
          f"({len(dev) / Tg:.1f} per frame)", flush=True)
    ka = prof.key_averages()
    for e in ka:
        if e.key.startswith("stage::") and e.cpu_time_total > 0:
            print(f"  {e.key}: calls {e.count}, device "
                  f"{e.device_time_total / 1e6:.4f} s", flush=True)
    top = sorted((e for e in ka if not e.key.startswith("stage::")),
                 key=lambda e: -e.self_device_time_total)[:15]
    for e in top:
        print(f"  {e.key[:64]:64s} n={e.count:7d} "
              f"device={e.self_device_time_total / 1e3:9.2f} ms")
    print(f"peak device memory {torch.cuda.max_memory_allocated() / 1e9:.3f}"
          " GB")


if __name__ == "__main__":
    main()
