#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero):
  1. card and versions (refuses to run without CUDA);
  2. build, all at once: the CUDA kernel K1 (nvcc, with ptxas's register
     and shared-memory report), the first K1 design kept as a yardstick
     (tools/k1_thread_per_band.cu) and the native parser (g++);
  3. kernel check: K1 against its plain PyTorch version, bit for bit
     (max |diff| = 0.0), at B=512 and ragged B, napb 30 and 50.  Device
     times from torch.profiler's kernel records, for K1 and the yardstick
     in turns (yardstick, K1, K1, yardstick): warm (the same inputs again,
     in L2) and cold (a 128 MB write before each launch, not counted);
     the HBM bound and its share on the cold time; the plain version's
     time with CUDA events;
  4. main path: heaac_tpu_torch.codec.batch.QwirePipelinedDecoder with
     its default device (the card) over 512 lanes, each its own byte
     buffer tiled from benchdata/heaac_bench_stream_{0..7}.aac; checks
     non-silent output, one K1 launch per frame, lanes 0-7 within 2 LSB
     of the port's CPU run and of the committed JAX golden
     (tests/data/heaac_v2_golden_jax.npz), and prints the realtime
     factor.
The line before last is the card's name and power limit (nvidia-smi), the
one before it the kernel table as JSON; the last line is the result.
"""
import ctypes
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
YARDSTICK_SRC = os.path.join(REPO, "tools", "k1_thread_per_band.cu")
LANES = 512
TOL_LSB = 2
NAMES = ("power", "in_re", "in_im", "trans", "ap", "ag", "qf")
REPS = 50
FLUSH_BYTES = 128 << 20        # > 2.5x the H100's 50 MB L2
HBM_BYTES_PER_S = 3.35e12      # H100 SXM, NVIDIA's data sheet
F32_FLOPS = 67e12              # H100 SXM f32 outside the tensor cores


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def build_all(K, native) -> str:
    """Compile every native source at once (one compiler process each);
    returns the yardstick's library path."""
    ys_so = os.path.join(native.BUILD_DIR, "libk1_thread_per_band.so")
    jobs = {
        "ps_decorrelate.cu (nvcc)": lambda: K.build(("-Xptxas", "-v")),
        "k1_thread_per_band.cu (nvcc)": lambda: native.compile_if_stale(
            ys_so, [YARDSTICK_SRC],
            [K._nvcc(), *K.NVCC_FLAGS, YARDSTICK_SRC]),
        "native parser (g++)": native.build}
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(jobs)) as ex:
        futs = {name: ex.submit(fn) for name, fn in jobs.items()}
        for name, fut in futs.items():
            print(f"build {name}: {fut.result():.2f} s compiling", flush=True)
    print(f"build wall {time.perf_counter() - t0:.2f} s", flush=True)
    return ys_so


class Yardstick:
    """The first K1 design (tools/k1_thread_per_band.cu), same contract."""

    def __init__(self, so: str):
        self.fn = ctypes.CDLL(so).k1_thread_per_band_launch
        self.fn.restype = ctypes.c_int
        self.fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 2 + [
            ctypes.c_void_p]

    def __call__(self, power, in_re, in_im, trans, ap, ag, qf):
        B, napb = power.shape[0], in_re.shape[1]
        outs = [torch.empty(s, dtype=torch.float32, device=power.device)
                for s in ((B, 32, 34), (B, napb, 32, 2), (B, 34, 3),
                          (B, napb, 3, 5, 2))]
        rc = self.fn(*(t.data_ptr() for t in (power, in_re, in_im, trans, ap,
                                              ag, qf, *outs)), B, napb,
                     torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise SystemExit(f"yardstick launch failed: CUDA error {rc}")
        return outs


def k1_args(B: int, napb: int, seed: int, K):
    inp = K.random_inputs(B, napb, seed=seed)
    return [torch.from_numpy(inp[k]).cuda() for k in NAMES]


def max_diff(got, ref) -> float:
    return max(float((a - b).abs().max()) for a, b in zip(got, ref))


def k1_bound(args, outs) -> tuple:
    """(ms, 'bytes' or 'operations'): each input read once, each output
    written once, over HBM's rate; against the f32 operations of the two
    recurrences (detector 11 per slot and band, chain 42) over f32 peak."""
    nbytes = sum(t.numel() * t.element_size() for t in (*args, *outs))
    B, napb = args[1].shape[:2]
    flops = B * 32 * (34 * 11 + napb * 42)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def device_ms(fn, kernel: str, flush=None) -> float:
    """Mean device time (ms) of the kernel whose name contains ``kernel``
    over REPS calls of fn(), from torch.profiler's CUDA kernel records.
    With ``flush`` (a tensor larger than L2) it is overwritten before each
    call, so fn reads its inputs from HBM; the flush is not counted."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(REPS):
            if flush is not None:
                flush.zero_()
            fn()
        torch.cuda.synchronize()
    ts = [e.device_time for e in prof.events()
          if e.device_type == torch.autograd.DeviceType.CUDA
          and kernel in e.name]
    # the profiler has been seen to drop a launch's record (49 of 50)
    if len(ts) < REPS // 2:
        raise SystemExit(f"profiler saw {len(ts)} launches of {kernel}, "
                         f"expected {REPS}")
    return sum(ts) / len(ts) / 1e3


def events_ms(fn, reps: int) -> float:
    """Mean CUDA-event time of fn() over reps calls, after a warm-up."""
    fn()
    torch.cuda.synchronize()
    t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def kernel_check(K, ys):
    """K1 and the yardstick against the plain version on the card, bit
    for bit; device times at B=512.  Returns ({napb: row}, max error)."""
    worst = 0.0
    for B in (1, 3, LANES + 1):
        for napb in (30, 50):
            args = k1_args(B, napb, 7 + B, K)
            err = max_diff(K.decorrelate_seq(*args),
                           K.decorrelate_plain(*args))
            print(f"K1 B={B} napb={napb}: max|diff| {err:.3e}", flush=True)
            worst = max(worst, err)
    flush = torch.empty(FLUSH_BYTES // 4, dtype=torch.float32, device="cuda")
    rows = {}
    for napb in (30, 50):
        args = k1_args(LANES, napb, napb, K)
        got = K.decorrelate_seq(*args)
        ref = K.decorrelate_plain(*args)
        err = max_diff(got, ref)
        ys_err = max_diff(ys(*args), ref)
        worst = max(worst, err)
        times = {("ys", "cold"): [], ("k1", "cold"): [],
                 ("ys", "warm"): [], ("k1", "warm"): []}
        for who in ("ys", "k1", "k1", "ys"):
            fn, name = ((lambda: ys(*args), "k1_thread_per_band_kernel")
                        if who == "ys" else
                        (lambda: K.decorrelate_seq(*args),
                         "ps_decorrelate_kernel"))
            times[who, "cold"].append(device_ms(fn, name, flush))
            times[who, "warm"].append(device_ms(fn, name))
        mean = {k: sum(v) / len(v) for k, v in times.items()}
        bound_ms, bound_by = k1_bound(args, got)
        plain_ms = events_ms(lambda: K.decorrelate_plain(*args), 5)
        rows[napb] = dict(
            max_abs_err=err, ms=mean["k1", "cold"],
            warm_ms=mean["k1", "warm"], plain_ms=plain_ms,
            bound_ms=bound_ms, bound_by=bound_by,
            share=bound_ms / mean["k1", "cold"],
            baseline_ms=mean["ys", "cold"],
            baseline_warm_ms=mean["ys", "warm"])
        geo = K.geometry(napb)
        print(f"K1 napb={napb}: block {geo.det_threads + geo.chain_threads},"
              f" shared memory {geo.smem} B, {K.ctas_per_sm(napb)} CTAs per "
              f"SM, grid {K.grid(LANES, geo)}", flush=True)
        print(f"K1 B={LANES} napb={napb}: max|diff| {err:.3e} (yardstick "
              f"{ys_err:.3e}); device ms cold {times['k1', 'cold']} warm "
              f"{times['k1', 'warm']}; yardstick cold {times['ys', 'cold']}"
              f" warm {times['ys', 'warm']}; HBM bound {bound_ms:.5f} ms "
              f"({bound_by}), cold share {rows[napb]['share']:.3f}; plain "
              f"{plain_ms:.4f} ms", flush=True)
        worst = max(worst, ys_err)
    del flush
    if worst != 0.0:
        raise SystemExit(f"K1 differs from its plain version: {worst}")
    return rows, worst


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False")
    sys.path.insert(0, REPO)
    from heaac_tpu_torch import native
    from heaac_tpu_torch.codec.batch import QwirePipelinedDecoder
    from heaac_tpu_torch.ops import ps_decorrelate as K

    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"card: {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, python {sys.version.split()[0]}",
          flush=True)

    # ---- 2. build -----------------------------------------------------------
    ys = Yardstick(build_all(K, native))

    # ---- 3. kernel check ----------------------------------------------------
    krows, worst = kernel_check(K, ys)

    # ---- 4. main path -------------------------------------------------------
    bench = [open(os.path.join(REPO, "benchdata",
                               f"heaac_bench_stream_{i}.aac"), "rb").read()
             for i in range(8)]
    streams = [bytes(bench[i % 8]) for i in range(LANES)]
    dec = QwirePipelinedDecoder(streams, group_streams=LANES)
    if dec.device.type != "cuda":
        raise SystemExit(f"default device is {dec.device}, not the card")
    t0 = time.perf_counter()
    dec.decode()                                   # warm-up (cuBLAS, consts)
    warm_s = time.perf_counter() - t0
    K.launches = 0
    t0 = time.perf_counter()
    outs = dec.decode()
    wall = time.perf_counter() - t0
    launches = K.launches
    pcm = outs[0].cpu().numpy()                    # [T, L, 2, 2048] int16
    T = pcm.shape[0]
    audio_s = dec.audio_seconds()
    print(f"main path: {LANES} lanes x {T} frames, audio {audio_s:.3f} s, "
          f"wall {wall:.3f} s (warm-up {warm_s:.3f} s), realtime "
          f"{audio_s / wall:.1f}x on {card}; K1 launches {launches}",
          flush=True)
    if launches != T:
        raise SystemExit(f"K1 launched {launches} times for {T} frames")
    peak = np.abs(pcm.astype(np.int32)).max(axis=(0, 2, 3))
    if not (peak > 0).all():
        raise SystemExit(f"silent lanes: {np.flatnonzero(peak == 0)}")

    cpu = QwirePipelinedDecoder(bench, group_streams=8, device="cpu")
    ref = cpu.decode()[0].numpy()                  # [T, 8, 2, 2048]
    d_cpu = int(np.abs(pcm[:, :8].astype(np.int32) - ref).max())
    with np.load(os.path.join(REPO, "tests", "data",
                              "heaac_v2_golden_jax.npz")) as z:
        gold = z["pcm"]                            # [Tg, 2, 2, 2048]
    d_gold = int(np.abs(pcm[:gold.shape[0], :2].astype(np.int32)
                        - gold).max())
    print(f"lanes 0-7 vs port CPU: max {d_cpu} LSB; lanes 0-1 x "
          f"{gold.shape[0]} frames vs JAX golden: max {d_gold} LSB",
          flush=True)
    if d_cpu > TOL_LSB or d_gold > TOL_LSB:
        raise SystemExit("card output differs from the references")

    row = dict(krows[30])
    row.pop("max_abs_err")
    print(json.dumps({"kernels": [{
        "name": "ps_decorrelate", "route": "cuda",
        "source": "heaac_tpu_torch/csrc/ps_decorrelate.cu",
        "replaces": "heaac_tpu/ops/ps_pallas.py:31",
        "launches": launches, "max_abs_err": worst, **row,
        "library_ms": None, "napb50": krows[50]}]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
