#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero):
  1. card and versions (refuses to run without CUDA);
  2. build the CUDA kernel and the native parser from the checkout;
  3. kernel check: the PS decorrelation kernel against its plain
     PyTorch version at B=512, napb 30 and 50 (max |diff| <= 1e-6),
     with CUDA-event times of both;
  4. main path: heaac_tpu_torch.codec.batch.QwirePipelinedDecoder on
     "cuda" over 512 lanes, each its own byte buffer tiled from
     benchdata/heaac_bench_stream_{0..7}.aac; checks non-silent output,
     that every frame went through the kernel, lanes 0-7 within 2 LSB of
     the port's CPU run and of the committed JAX golden
     (tests/data/heaac_v2_golden_jax.npz), and prints the realtime
     factor.
The line before last is the card's name and power limit (nvidia-smi), the
one before it the kernel table as JSON; the last line is the result.
"""
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
LANES = 512
TOL_LSB = 2
KERNEL_TOL = 1e-6


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of fn() over reps launches, after a warm-up."""
    fn()
    torch.cuda.synchronize()
    t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def kernel_check(K):
    """K1 against its plain version on the card; returns the B=512,
    napb=30 row (the main path's shape) plus the napb=50 error."""
    names = ("power", "in_re", "in_im", "trans", "ap", "ag", "qf")
    rows = {}
    for napb in (30, 50):
        inp = K.random_inputs(LANES, napb, seed=napb)
        args = [torch.from_numpy(inp[k]).cuda().contiguous() for k in names]
        n0 = K.launches
        got = K.decorrelate_seq(*args)
        ref = K.decorrelate_plain(*args)
        torch.cuda.synchronize()
        err = max(float((a - b).abs().max()) for a, b in zip(got, ref))
        ms = cuda_ms(lambda: K.decorrelate_seq(*args), 50)
        plain_ms = cuda_ms(lambda: K.decorrelate_plain(*args), 5)
        K.launches = n0    # comparison launches are not main-path launches
        print(f"K1 ps_decorrelate B={LANES} napb={napb}: max|diff| {err:.3e}"
              f" kernel {ms:.4f} ms plain {plain_ms:.4f} ms", flush=True)
        if not err <= KERNEL_TOL:
            raise SystemExit(f"K1 disagrees with its plain version: {err}")
        rows[napb] = (err, ms, plain_ms)
    return rows


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
    for name, mod in (("ps_decorrelate.cu (nvcc)", K),
                      ("native parser (g++)", native)):
        t0 = time.perf_counter()
        compiled = mod.build()
        print(f"build {name}: {time.perf_counter() - t0:.2f} s"
              f" ({'compiled' if compiled else 'up to date'})", flush=True)

    # ---- 3. kernel check ----------------------------------------------------
    krows = kernel_check(K)

    # ---- 4. main path -------------------------------------------------------
    bench = [open(os.path.join(REPO, "benchdata",
                               f"heaac_bench_stream_{i}.aac"), "rb").read()
             for i in range(8)]
    streams = [bytes(bench[i % 8]) for i in range(LANES)]
    dec = QwirePipelinedDecoder(streams, group_streams=LANES, device="cuda")
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
    if launches < T:
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

    err, ms, plain_ms = krows[30]
    print(json.dumps({"kernels": [{
        "name": "ps_decorrelate", "route": "cuda",
        "source": "heaac_tpu_torch/csrc/ps_decorrelate.cu",
        "replaces": "heaac_tpu/ops/ps_pallas.py:31",
        "launches": launches, "max_abs_err": max(err, krows[50][0]),
        "ms": ms, "plain_ms": plain_ms}]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
