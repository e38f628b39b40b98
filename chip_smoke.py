#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero):
  1. card and versions (refuses to run without CUDA);
  2. build, all at once: the CUDA kernels K1 and the qwire step's row
     decoders (nvcc, each with ptxas's register and shared-memory
     report), the first K1 design kept as a yardstick
     (tools/k1_thread_per_band.cu) and the native parser (g++);
  3. kernel checks: (a) K1 against its plain PyTorch version, bit for bit
     (max |diff| = 0.0), at B=512, B=256 (the width of decode_batch's
     34-band stream groups) and ragged B, napb 30 and 50.  Device
     times from torch.profiler's kernel records, for K1 and the yardstick
     in turns (yardstick, K1, K1, yardstick): warm (the same inputs again,
     in L2) and cold (a 128 MB write before each launch, not counted);
     the HBM bound and its share on the cold time; the plain version's
     time with CUDA events; (b) the row-decoder kernel
     (``ops/qwire_rows.decode_rows``) against the plain row decoders
     (``decode_rows_plain``), all 21 outputs bit for bit, on the
     arguments ``qwire.expand_frame`` hands them over the first
     GOLDEN_FRAMES frame steps of phase 4's 512 streams and of 256 stereo
     HE-AAC v1 streams (512 lanes, coupled rows), each stepped eagerly
     on the card, tiled to 256, 512 and 1024 lanes, ``pair`` off and
     on; device times from torch.profiler's kernel records over the
     recorded frames, warm and cold as K1's, the HBM bound of each
     launch's inputs and outputs and its share on the cold time, and
     the plain decoders' time with CUDA events;
  4. main path: heaac_tpu_torch.codec.batch.QwirePipelinedDecoder with
     its default device (the card) over 512 lanes, each its own byte
     buffer tiled from benchdata/heaac_bench_stream_{0..7}.aac; checks
     non-silent output, one K1 launch per frame, lanes 0-7 within 2 LSB
     of the port's CPU run and of the committed JAX golden
     (tests/data/heaac_v2_golden_jax.npz), and prints the realtime
     factor;
  5. mixed batch: heaac_tpu_torch.decode_batch with its default device
     over 512 34-band HE-AAC v2 streams (tiled from
     tests/data/heaac_v2_34band_{0..7}.aac), 512 stereo HE-AAC v1
     streams (M/S and coupled SBR, tiled from
     tests/data/heaac_v1_stereo_{0..7}.aac), 512 AAC-LC streams (tiled
     from benchdata/lc_core_24k_{0..7}.aac), the 8 bundled 20-band
     streams, 8 HE-AAC streams with a coupling channel applied after the
     IMDCT or before TNS (tests/data/heaac_cce_{after,before}_{0,1}.aac,
     twice) and one buffer with no sync word, shuffled, each its own
     byte buffer; a warm-up run, then a timed one.  Prints each bucket's
     streams, frames, wall seconds and realtime factor, and K1's launches
     at napb 30 and 50; checks that K1 ran once per frame of each stream
     group at napb 50 in the 34-band bucket and at napb 30 in the
     20-band, stereo and coupling-channel buckets (exact counts), every
     output's shape and non-silence, and streams 0-1 of each kind (the
     first "before" coupling stream) within 2 LSB of the committed JAX
     golden (tests/data/decode_batch_golden_jax.npz) and of the port's
     CPU decode_batch over their first 16 frames;
  6. stereo main path: QwirePipelinedDecoder with its default device over
     256 stereo HE-AAC v1 streams (512 lanes, one group) tiled from
     tests/data/heaac_v1_stereo_{0..7}.aac; checks device M/S (MS = 1)
     and coupled SBR rows (rows_pair = 1), one K1 launch per frame,
     non-silent lanes, lanes 0-3 within 2 LSB of the port's CPU run and
     of the JAX golden over 16 frames, and prints the realtime factor;
  7. flip path: (a) heaac_tpu_torch.decode_batch with its default device
     over a shuffled list of the 4 flip streams 0-3
     (tests/data/heaac_v2_flip_{0..3}.aac: the PS band mode flips 20 ->
     34, 34 -> 20, 20 -> 34 -> 20, 34 -> 20 -> 34), the flip + coupling
     channel stream (tests/data/heaac_flip_cce_0.aac) and the 8 bundled
     20-band streams, each its own buffer; checks that each flip stream
     went through the flip scan (its ``flip_stats`` record) and the
     20-band streams through batched buckets (``bucket_stats``), that K1
     ran exactly as those records imply (per successful HE sub-bucket
     one launch per scan step at its band mode; per flip stream one
     launch per frame at napb 30 and one at napb 50), and the first 16
     frames of each flip stream within 2 LSB of the JAX golden
     (tests/data/flip_golden_jax.npz) and of the port's CPU run; (b) the
     flip scan at full width: the 8 flip streams parsed once by the
     port's Python planner, tiled to 512 lanes (``pack_planner_frames``)
     and decoded by one ``qwire_scan_decode_flip`` call over 50 frames
     (a warm-up, then a timed run): exactly 50 K1 launches at napb 30
     and 50 at napb 50, non-silent lanes, lanes 0-7 within 2 LSB of the
     port's CPU run and of the golden over 16 frames, and the realtime
     factor beside phase 4's;
  8. the rest of decode_batch's batched routes: (a)
     heaac_tpu_torch.decode_batch with its default device over a
     shuffled list of 64 AAC-LC streams with a coupling channel (the 8
     committed tests/data/lc_cce_{after,before}_{0..3}.aac, 8 times:
     the LC planner and the coupled LC scan), two 20-band streams with a
     corrupted frame 1 (``CORRUPT`` of tools/make_torch_golden.py: the
     native probe refuses them, the Python prober buckets them HE, and
     the first of them is stream 0 of its bucket: the Python profile
     parse) and the 8 bundled 20-band streams, each its own buffer;
     checks the two buckets' ``bucket_stats`` (streams, frames, steps),
     K1's launches (exactly groups x steps at napb 30, plus one at one
     lane for each probed stream: the prober decodes its frame 0, where
     PS runs; none at 50), the
     profile parse, every output's shape and non-silence, and the first
     16 frames of streams 0-1 of each kind within 2 LSB of the JAX
     goldens (tests/data/lc_batch_golden_jax.npz,
     decode_batch_golden_jax.npz) and of the port's CPU decode_batch;
     prints the LC bucket's parse + upload and decode seconds apart;
     (b) downsampled SBR at full width: the 8 committed streams
     tests/data/heaac_ds_{0..7}.aac parsed once by the port's Python
     planner with their AudioSpecificConfig (tests/data/heaac_ds.asc),
     tiled to 512 lanes and decoded by one
     ``qwire_scan_decode(downsampled=1)`` over 50 frames (a warm-up,
     then a timed run): exactly 50 K1 launches at napb 30, non-silent
     lanes, lanes 0-7 within 2 LSB of the port's CPU run and lanes 0-3
     of the JAX golden (tests/data/downsampled_golden_jax.npz) over 16
     frames, and the realtime factor (audio at the 24 kHz core rate,
     1024 samples a frame);
  9. the single-stream ``Decoder`` on the card: K1's warm device time
     at B=1, napb 30 and 50 (its width there); (a)
     heaac_tpu_torch.decode_batch with its default device over the two
     streams whose frame 0 has a corrupted byte (``CORRUPT`` he20_f0_0,
     he34_f0_0: the Python prober cannot decode frame 0, the AAC-LC
     bucket fails, and decode_batch falls back to the single-stream
     Decoder on its device, which drops frame 0; PS never starts) and
     the 8 bundled 20-band streams, shuffled: the records
     (``bucket_stats``, ``single_stats``), K1's launches (the HE
     bucket's 50 at napb 30 and nothing at one lane), and the first 16
     frames of both fallback streams within 2 LSB of the JAX golden
     (tests/data/single_golden_jax.npz) and of the port's CPU Decoder;
     (b) ``decode_adts`` on the whole of benchdata/heaac_bench_stream_0
     .aac, tests/data/heaac_v2_34band_0.aac, heaac_v2_flip_0.aac,
     heaac_v1_stereo_1.aac and heaac_cce_after_0.aac, and
     ``Decoder(asc=)`` on heaac_ds_0.aac (50 frames each): K1 at one
     lane exactly once per frame in which PS ran, per napb (counted on
     the port's CPU run of the same stream), each stream within 2 LSB of
     the CPU run and, over its first 16 frames, of the JAX golden; per
     stream its frames, audio and wall seconds, realtime and ms per
     frame; and the device's busy share over the first stream from
     torch.profiler;
 10. the front doors: (a) ``heaac_tpu_torch.decode`` with its default
     device on three .m4a inputs built here by the port's muxer from the
     whole committed streams (``FRONT_LIST`` of
     tools/make_torch_golden.py): bench stream 0 through the ADTS->ASC
     filter (decode re-wraps it as ADTS: ``decode_adts``), the same
     frames behind an explicit-SBR AudioSpecificConfig (the
     ASC-configured Decoder) and tests/data/heaac_ds_0.aac behind
     heaac_ds.asc (downsampled SBR): K1 at one lane exactly once per
     frame in which PS ran on the port's CPU run of the same input, per
     napb, each within 2 LSB of that CPU run and, over its first 16
     frames, of the JAX golden (tests/data/front_golden_jax.npz), with
     frames, audio and wall seconds and the realtime factor; (b) the
     command line ``heaac_tpu_torch.cli.main`` in this process with its
     default device: ``--benchmark`` on benchdata/heaac_bench_stream_0.aac
     (decode_batch: K1 at napb 30 once per frame at one lane, no WARNING,
     the WAV equal to ``decode_batch([data])[0]`` byte for byte; prints
     its metrics JSON), ``--profile`` on its first frames (the Chrome
     trace names K1's kernel), ``--probe`` on the committed re-wrap and
     explicit-SBR .m4a inputs (equal to the JAX CLI's JSON in the golden)
     and ``--bit-trace`` on two frames of benchdata/lc_core_24k_0.aac
     (as many trace lines as the golden's reads);
 11. the parallel layer: (a) heaac_tpu_torch.parallel.sharding
     .ShardedQwireDecoder over phase 4's 512 streams as one group on
     ["cuda:0", "cuda:0"] (two shards of 256 lanes), a warm-up, then a
     timed run: K1 exactly twice per frame at napb 30, PCM within 1 LSB
     of phase 4's, realtime and ms a frame beside phase 4's; (b) the
     stream-aligned cut on cuda:0: 6 stereo HE-AAC v1 streams over 4
     shards (1, 2, 1, 2 streams) and the 4 coupling-channel streams of
     the sharded golden over 8 shards (four without lanes), 16 frames,
     K1 once per frame per shard with lanes, within 1 LSB of the port's
     unsharded CPU decode and of the JAX golden
     (tests/data/sharded_golden_jax.npz); (c) two processes of ``python
     -m heaac_tpu_torch.parallel.multihost`` on cuda:0 with gloo over
     the 8 bench streams: both report the same global metrics (400
     frames, 17.0667 s of audio, 200 frames each), each its device, 50
     K1 launches at napb 30 and 50 row-kernel launches at pair 0; (d)
     with two cards or more, (a) on ["cuda:0", "cuda:1"] (K1 counted on
     each card) and (c) with NCCL on one card per rank, else it prints
     that cross-card runs were not measured;
 12. the encode direction and the stream generators, host numpy: (a)
     heaac_tpu_torch.codec.encoder.AacEncoder over every case of
     tests/data/encode_golden_jax.npz (its seeded PCM: LC mono and
     stereo at three rates, window switching, rate control, the twoloop
     and anmr coders, AAC-Main, M/S, intensity, injected TNS), its bytes
     against the JAX encoder's (per case the first ADTS frame apart),
     the streams decoded by decode_batch with its default device within
     2 LSB of the port's CPU decode and the round trip above 20 dB (no
     K1: no PS); (b) 512 distinct HE-AAC v2 streams made here by
     heaac_tpu_torch.io.heaac_testgen (the 8 bench cores crossed with
     per-stream SBR and PS writer seeds, no SBR inverse filtering), the
     first 8 against the JAX generators' sha256, decoded as one group by
     QwirePipelinedDecoder with its default device, in turns with the
     first 8 of them tiled to 512 lanes (tiled, distinct, distinct,
     tiled, after a warm-up of each): K1 50 at napb 30 in each run, lanes 0-7 and 64k + 8 within
     2 LSB of the port's CPU decode, realtime and ms a frame of each run
     beside phase 4's; (c) ``cli.main`` in this
     process, WAV in, ``-b 96k --ms``, to .aac and .m4a, both decoded by
     ``heaac_tpu_torch.decode`` on the card to the same PCM, above 20 dB;
 13. the plan-record decoders (host-built per-frame plans scanned through
     the frame graph), each with its default device: (a)
     codec.batch.StreamBatchDecoder with compact plans over phase 4's 512
     streams (50 frames) and (b) the same with dense plans (prints the
     plan bytes resident on the card and the card memory the parse and
     warm-up took), each after a warm-up, timed in turns with the qwire
     decode of the same streams (qwire, compact, dense, dense, compact,
     qwire): K1 exactly 50 at napb 30 in each run, lanes 0-7 within 2 LSB
     of the port's CPU run and lanes 0-1 of the JAX golden over 16
     frames (tests/data/plan_golden_jax.npz), all 512 lanes within 2 LSB
     of the qwire PCM (this phase's and phase 4's); realtime and ms a
     frame of each run beside phase 4's; (d) StreamBatchDecoder
     over 512 lanes tiled from the 8 34-band streams, 16 frames: K1
     exactly 16 at napb 50, lanes 0-1 within 2 LSB of the golden; (e)
     BatchDecoder(batch=512) on bench stream 0 (warmup, then a timed run:
     K1 50) and QStreamBatchDecoder over the 8 bench streams, 16 frames
     (K1 16; within 2 LSB of the golden and of (a)); (f)
     parallel.sharding.ShardedStreamBatchDecoder over phase 4's streams
     on ["cuda:0", "cuda:0"], and on cuda:0 + cuda:1 with two cards, 16
     frames: K1 once a frame per shard (per card), within 1 LSB of (a);
     (g) heaac_frame_compact on the synthetic compact records of
     __graft_entry__.entry() rebuilt by the port's compact_plan
     (tools/make_torch_plan_golden.py graft_compact_inputs) at 64 lanes:
     K1 once, within 2 LSB of the port's CPU run and of the golden;
 14. the benchmark entry: ``heaac_tpu_torch.bench.run`` in this process
     with its default device over 512 distinct HE-AAC v2 streams drawn
     by bench.py's recipe (SBR inverse filtering 0-3, so held to no
     reference by LSB: phases 4 and 12 (b) hold the same decoder), 3
     timed decodes; its JSON line is printed as an earlier line: K1
     exactly 50 at napb 30 per decode (warm-up, device-only scan, the
     FLOP count's scan, each timed decode), none at 50, no silent lane,
     every number of the line finite and not negative, its device this
     card; its figures beside phase 4's realtime, and the card memory
     peak.
Beside K1's launches every path counts the row-decoder kernel's (one
launch a qwire frame step, by ``pair``; none on a path that never calls
``expand_frame``); a path whose count differs fails the run at its end,
after every phase has run and printed its counts.
Each phase prints its seconds.  The line before last is the card's name
and power limit (nvidia-smi), the one before it the kernel table as JSON;
the last line is the result.
"""
import ctypes
import importlib.util
import itertools
import json
import logging
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
PROFILE_SESSIONS = 6           # device_ms: sessions of REPS calls at most
MIXED_LANES = 512              # streams per kind in phase 5
GROUP_LANES = 256              # decode_batch's HE stream groups
CCE_COPIES = 2                 # copies of each coupling stream in phase 5
STREAM_FILES = {               # kind -> (file pattern, number of files)
    "he20": ("benchdata/heaac_bench_stream_{}.aac", 8),
    "he34": ("tests/data/heaac_v2_34band_{}.aac", 8),
    "he_v1s": ("tests/data/heaac_v1_stereo_{}.aac", 8),
    "lc": ("benchdata/lc_core_24k_{}.aac", 8),
    "cce_after": ("tests/data/heaac_cce_after_{}.aac", 2),
    "cce_before": ("tests/data/heaac_cce_before_{}.aac", 2),
}
# the phase 5 streams held to the JAX golden and the CPU port: streams
# 0-1 of each kind, the first of the dependent-coupling kind
GOLDEN_CHECKED = [(kind, i) for kind in ("he20", "he34", "lc", "he_v1s",
                                         "cce_after") for i in (0, 1)] + [
    ("cce_before", 0)]
GOLDEN_FRAMES = 16
ROWS_LANES = (GROUP_LANES, LANES, 2 * LANES)   # phase 3 (b): widths
ROWS_SEEN = {}                 # path -> the row kernel's launches by pair
ROWS_WRONG = []                # (path, launches, expected) that differ
FLIP_FILE = "tests/data/heaac_v2_flip_{}.aac"
FLIP_CCE_FILE = "tests/data/heaac_flip_cce_0.aac"
FLIP_BATCH = 4                 # flip streams 0-3 in phase 7 (a)
LC_CCE_COPIES = 8              # copies of each LC + CCE stream in phase 8
PROBED = ("he20_f1_0", "he20_f1_1")  # phase 8 (a): the Python prober's
DS_FILE = "tests/data/heaac_ds_{}.aac"
DS_ASC = "tests/data/heaac_ds.asc"
FALLBACK = ("he20_f0_0", "he34_f0_0")  # phase 9 (a): frame 0 corrupt
# phase 9 (b): streams of the single-stream golden, decoded whole
SINGLE = ("he20_0", "he34_0", "flip_0", "he_v1s_1", "cce_after_0", "ds_0")
# phase 10 (a): .m4a inputs of the front golden, built here from the
# whole committed streams (tools/make_torch_golden.py FRONT_LIST)
FRONT_M4A = ("he20_0", "he20_explicit_0", "ds_0")
PROFILE_FRAMES = 2             # phase 10 (b): frames under --profile
SHARD_TOL_LSB = 1              # phase 11: sharded vs unsharded, golden
MULTIHOST_TIMEOUT_S = 300      # phase 11 (c): each rank's own limit
BENCH_REPS = 3                 # phase 14: timed decodes
SNR_MIN_DB = 20.0              # phase 12: round-trip SNR (tests/test_io_cli.py)
# phase 12 (b): lanes held to the CPU port: 0-7 and 8 spread over the batch
DISTINCT_CHECKED = tuple(range(8)) + tuple(64 * k + 8 for k in range(8))
FLUSH_BYTES = 128 << 20        # > 2.5x the H100's 50 MB L2
HBM_BYTES_PER_S = 3.35e12      # H100 SXM, NVIDIA's data sheet
F32_FLOPS = 67e12              # H100 SXM f32 outside the tensor cores


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def ptxas_report(K, src: str) -> float:
    """Compile ``src`` with K1's nvcc flags and ``-Xptxas -v`` into a
    scratch file, for ptxas's register, stack and spill report; returns
    the seconds spent."""
    import tempfile
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        subprocess.run([K._nvcc(), *K.NVCC_FLAGS, "-Xptxas", "-v", src,
                        "-o", os.path.join(tmp, "report.so")], check=True)
    return time.perf_counter() - t0


def build_all(K, rows, native) -> str:
    """Compile every native source at once (one compiler process each);
    returns the yardstick's library path."""
    ys_so = os.path.join(native.BUILD_DIR, "libk1_thread_per_band.so")
    jobs = {
        "ps_decorrelate.cu (nvcc)": lambda: K.build(("-Xptxas", "-v")),
        "qwire_rows.cu (nvcc)": rows.build,
        "qwire_rows.cu ptxas report (nvcc)": lambda: ptxas_report(
            K, rows.SRC),
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
    call, so fn reads its inputs from HBM; the flush is not counted.

    Late in a long process the profiler has been seen to return records
    of only 22 to 45 of a session's 50 launches at B=1 (a fresh process
    sees all 50), so sessions of REPS calls are repeated, up to
    PROFILE_SESSIONS, until REPS records are in hand; fewer fails."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    ts, seen = [], []
    while len(ts) < REPS and len(seen) < PROFILE_SESSIONS:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(REPS):
                if flush is not None:
                    flush.zero_()
                fn()
            torch.cuda.synchronize()
        got = [e.device_time for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and kernel in e.name]
        seen.append(len(got))
        ts += got
    if len(seen) > 1:
        print(f"profiler records of {kernel} per session of {REPS} "
              f"launches: {seen}", flush=True)
    if len(ts) < REPS:
        raise SystemExit(f"profiler saw {seen} launches of {kernel} in "
                         f"{len(seen)} sessions of {REPS}, expected {REPS}")
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
    for B in (1, 3, GROUP_LANES, LANES + 1):
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


def reset_launches(K) -> None:
    """Zero K1's launch counts and the row-decoder kernel's."""
    from heaac_tpu_torch.ops import qwire_rows
    for counter in (K.launches, qwire_rows.launches):
        for key in counter:
            counter[key] = 0


def counts(K) -> tuple:
    """(K1's launches by napb, the row-decoder kernel's by pair) since
    reset_launches."""
    from heaac_tpu_torch.ops import qwire_rows
    return dict(K.launches), dict(qwire_rows.launches)


def rows_check(path: str, got: dict, expect: dict) -> None:
    """Print the row-decoder kernel's launches of ``path`` beside what its
    qwire frame steps imply (``expect``: pair -> steps, the pairs left
    out none); a difference is kept and fails the run at its end."""
    want = {0: 0, 1: 0, **expect}
    ROWS_SEEN[path] = got
    print(f"row kernel, {path}: launches {got}, expected {want}", flush=True)
    if got != want:
        ROWS_WRONG.append((path, got, want))


def test_helpers():
    """tests/test_torch_common.py as a module: ``leaves`` and ``lanes``,
    the tree helpers the GPU tests use."""
    spec = importlib.util.spec_from_file_location(
        "test_torch_common", os.path.join(REPO, "tests",
                                          "test_torch_common.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def stream_row_args(streams: list, frames: int) -> list:
    """The (sbr, ps, pair) arguments ``qwire.expand_frame`` hands the row
    decoders over the first ``frames`` frame steps of ``streams``, one
    QwirePipelinedDecoder group on the card, stepped eagerly with the
    plain decoders."""
    from heaac_tpu_torch.codec import heaac_graph
    from heaac_tpu_torch.codec.batch import QwirePipelinedDecoder
    from heaac_tpu_torch.ops import qwire_rows
    dec = QwirePipelinedDecoder(streams, group_streams=len(streams),
                                max_frames=frames)
    cur, T, sa, couple = dec._parse_with_retry(0)
    heap, recs, _ = dec._upload(0, cur, T, couple)
    heap, recs, coeffs = heaac_graph.decode_all_coeffs(
        heap, recs, sa["S"], sa["rate_idx"], sa["NB"], sa.get("MS", 0),
        sa["NS"], sa["SEC"])
    coeffs = coeffs.contiguous()
    seen = []

    def record(sbr, ps, pair):
        seen.append((sbr, ps, pair))
        return qwire_rows.decode_rows_plain(sbr, ps, pair)

    real = qwire_rows.decode_rows
    qwire_rows.decode_rows = record
    try:
        carry = heaac_graph.init_qwire_carry(dec.L, heap.device)
        for t in range(T):
            _, carry = heaac_graph.heaac_frame_qwire(
                coeffs[t], recs[t], heap, carry, dec.is34, dec.ds,
                sa.get("rows_pair", 0))
    finally:
        qwire_rows.decode_rows = real
    if len(seen) != T:
        raise SystemExit(f"phase 3 (b): {len(seen)} row decodes over {T} "
                         "frame steps")
    return seen


def rows_kernel_check(card: str, bench: list, stereo: list) -> dict:
    """Phase 3 (b): the row-decoder kernel against the plain row decoders
    on the regions of the main path's streams and of stereo streams, bit
    for bit, at ROWS_LANES lanes with ``pair`` off and on; device times
    per launch.  Returns the kernel table's entry."""
    from heaac_tpu_torch.ops import qwire_rows
    H = test_helpers()
    cases = {"he20": (stream_row_args([bench[i % 8] for i in range(LANES)],
                                      GOLDEN_FRAMES), False),
             "he_v1s": (stream_row_args(
                 [stereo[i % 8] for i in range(GROUP_LANES)],
                 GOLDEN_FRAMES), True)}
    flush = torch.empty(FLUSH_BYTES // 4, dtype=torch.float32, device="cuda")
    unequal, widths = [], {}
    for name, (frames, given) in cases.items():
        L = frames[0][0]["region"].shape[0]
        if {pair for _, _, pair in frames} != {given} or L != LANES:
            raise SystemExit(f"phase 3 (b) {name}: {L} lanes, pair "
                             f"{ {pair for _, _, pair in frames} }")
        for B in ROWS_LANES:
            idx = torch.arange(B, device="cuda") % L
            tiles = [(H.lanes(sbr, idx), H.lanes(ps, idx))
                     for sbr, ps, _ in frames]
            for pair in (False, True):
                for t, (sbr, ps) in enumerate(tiles):
                    got = qwire_rows.decode_rows(sbr, ps, pair)
                    want = qwire_rows.decode_rows_plain(sbr, ps, pair)
                    if len(H.leaves(got)) != 21 or not all(
                            a.dtype == b.dtype and torch.equal(a, b)
                            for a, b in zip(H.leaves(got), H.leaves(want))):
                        unequal.append((name, B, pair, t))
            it = itertools.cycle(tiles)
            launch = lambda: qwire_rows.decode_rows(  # noqa: E731
                *next(it), given)
            cold = device_ms(launch, "qwire_rows_kernel", flush)
            warm = device_ms(launch, "qwire_rows_kernel")
            plain = events_ms(lambda: qwire_rows.decode_rows_plain(
                *next(it), given), 5)
            sbr, ps = tiles[0]
            nbytes = sum(x.numel() * x.element_size() for x in H.leaves(
                (sbr, ps, qwire_rows.decode_rows(sbr, ps, given))))
            bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
            widths[f"{name}_{B}"] = dict(
                ms=cold, warm_ms=warm, plain_ms=plain, bytes=nbytes,
                bound_ms=bound_ms, bound_by="bytes", share=bound_ms / cold)
            print(f"row kernel {name} B={B} pair={int(given)}: device ms "
                  f"cold {cold:.5f} warm {warm:.5f}; HBM bound "
                  f"{bound_ms:.5f} ms ({nbytes} bytes), cold share "
                  f"{bound_ms / cold:.4f}; plain {plain:.4f} ms", flush=True)
    del flush
    checked = len(ROWS_LANES) * 2 * sum(len(f) for f, _ in cases.values())
    print(f"row kernel vs plain row decoders: {checked} launches ({len(cases)}"
          f" stream kinds x {GOLDEN_FRAMES} frames x lanes {ROWS_LANES} x "
          f"pair off and on), {len(unequal)} unequal on {card}", flush=True)
    if unequal:
        raise SystemExit(f"row kernel differs from the plain row decoders "
                         f"(kind, lanes, pair, frame): {unequal[:20]}")
    return dict(widths[f"he20_{LANES}"], widths=widths, unequal=0)


class BucketLog(logging.Handler):
    """Collects decode_batch's per-bucket records (``bucket_stats``)."""

    def __init__(self):
        super().__init__(logging.INFO)
        self.stats = []

    def emit(self, record):
        st = getattr(record, "bucket_stats", None)
        if st is not None:
            self.stats.append(st)


def golden_tool():
    """tools/make_torch_golden.py as a module: its stream list and file
    names (it imports the JAX package only inside its writers)."""
    spec = importlib.util.spec_from_file_location(
        "make_torch_golden", os.path.join(REPO, "tools",
                                          "make_torch_golden.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def read_streams() -> dict:
    """kind -> the bytes of each of its committed files."""
    return {kind: [open(os.path.join(REPO, pat.format(i)), "rb").read()
                   for i in range(nfiles)]
            for kind, (pat, nfiles) in STREAM_FILES.items()}


def mixed_batch(K, card: str, files: dict) -> dict:
    """Phase 5: decode_batch over the mixed batch on the card (default
    device); returns the K1 launch counts of the timed run."""
    from heaac_tpu_torch import decode_batch
    from heaac_tpu_torch.host import count_adts_frames, split_adts_stream
    tool = golden_tool()
    named = dict(tool.batch_streams())
    cce = [(kind, j) for kind in ("cce_after", "cce_before")
           for j in range(2)]
    items = ([("he34", i % 8) for i in range(MIXED_LANES)]
             + [("he_v1s", i % 8) for i in range(MIXED_LANES)]
             + [("lc", i % 8) for i in range(MIXED_LANES)]
             + [("he20", i) for i in range(8)] + cce * CCE_COPIES
             + [("garbage", 0)])
    order = np.random.default_rng(5).permutation(len(items))
    items = [items[k] for k in order]
    # every lane its own byte buffer
    streams = [bytes(bytearray(named["garbage"] if kind == "garbage"
                               else files[kind][i])) for kind, i in items]
    where = {}                     # (kind, file) -> first position
    for pos, it in enumerate(items):
        where.setdefault(it, pos)

    bucket_log = BucketLog()
    logger = logging.getLogger("heaac_tpu_torch")
    logger.addHandler(bucket_log)
    logger.setLevel(logging.INFO)
    t0 = time.perf_counter()
    decode_batch(streams)                          # warm-up
    warm_s = time.perf_counter() - t0
    bucket_log.stats.clear()
    reset_launches(K)
    t0 = time.perf_counter()
    outs = decode_batch(streams)
    wall = time.perf_counter() - t0
    launches, rows = counts(K)
    logger.removeHandler(bucket_log)

    frames = {kind: [count_adts_frames(d) for d in files[kind]]
              for kind in files}
    for st in bucket_log.stats:
        print(f"bucket {st['key']}: {st['streams']} streams, "
              f"{st['frames']} frames, {st['audio_s']:.3f} s of audio, "
              f"wall {st['wall_s']:.3f} s, realtime "
              f"{st['audio_s'] / st['wall_s']:.1f}x on {card}", flush=True)
    total_audio = sum(st["audio_s"] for st in bucket_log.stats)
    print(f"mixed batch: {len(streams)} streams, wall {wall:.3f} s "
          f"(warm-up {warm_s:.3f} s), realtime {total_audio / wall:.1f}x; "
          f"K1 launches napb 30: {launches[30]}, napb 50: {launches[50]}",
          flush=True)
    # one K1 launch per frame of each stream group: (kinds, streams)
    # per napb; the coupling streams of both points share one bucket
    n_of = {"he34": MIXED_LANES, "he20": 8, "he_v1s": MIXED_LANES,
            "cce": len(cce) * CCE_COPIES}
    frames["cce"] = frames["cce_after"] + frames["cce_before"]
    want = {50: ["he34"], 30: ["he20", "he_v1s", "cce"]}
    for napb, kinds in want.items():
        if any(len(set(frames[k])) != 1 for k in kinds):
            raise SystemExit(f"streams of unequal lengths among {kinds}")
        terms = [(-(-n_of[k] // GROUP_LANES), frames[k][0]) for k in kinds]
        expect = sum(g * f for g, f in terms)
        print(f"K1 napb {napb}: {launches[napb]} launches, expected "
              + " + ".join(f"{k} {g} groups x {f} frames"
                           for k, (g, f) in zip(kinds, terms))
              + f" = {expect}", flush=True)
        if launches[napb] != expect:
            raise SystemExit(f"K1 napb {napb} launched {launches[napb]} "
                             f"times, expected {expect}")
    # one row-kernel launch a step of each HE stream group, coupled rows
    # (pair 1) in the stereo bucket
    steps = {k: -(-n // GROUP_LANES) * frames[k][0] for k, n in n_of.items()}
    rows_check("phase 5", rows, {
        0: steps["he34"] + steps["he20"] + steps["cce"],
        1: steps["he_v1s"]})

    for (kind, i), pcm in zip(items, outs):
        if kind == "garbage":
            ok = tuple(pcm.shape) == (0, 1)
        else:
            spf, ch = (1024, 1) if kind == "lc" else (2048, 2)
            ok = (tuple(pcm.shape) == (frames[kind][i] * spf, ch)
                  and pcm.dtype == torch.int16 and pcm.device.type == "cpu"
                  and int(pcm.abs().max()) > 0)
        if not ok:
            raise SystemExit(f"{kind} stream {i}: output {tuple(pcm.shape)}"
                             f" {pcm.dtype}, silent or of the wrong shape")

    with np.load(tool.BATCH_GOLDEN) as z:
        gold = {str(name): z[f"pcm_{k}"] for k, name in enumerate(z["names"])}
    heads = [b"".join(split_adts_stream(files[kind][i])[:GOLDEN_FRAMES])
             for kind, i in GOLDEN_CHECKED]
    cpu = decode_batch(heads, device="cpu")
    worst = {}
    for k, (kind, i) in enumerate(GOLDEN_CHECKED):
        name = f"{kind}_{i}"
        rows = cpu[k].shape[0]
        got = outs[where[kind, i]][:rows].numpy().astype(np.int32)
        d_gold = int(np.abs(got - gold[name][:rows]).max())
        d_cpu = int(np.abs(got - cpu[k].numpy()).max())
        worst[name] = (d_gold, d_cpu)
    print(f"streams 0-1 of each kind, first {GOLDEN_FRAMES} frames, max LSB "
          f"(vs JAX golden, vs port CPU): {worst}", flush=True)
    if max(max(v) for v in worst.values()) > TOL_LSB:
        raise SystemExit("mixed batch: card output differs from the "
                         "references")
    return launches


def stereo_main_path(K, card: str, files: dict) -> int:
    """Phase 6: QwirePipelinedDecoder on the card (default device) over
    GROUP_LANES stereo HE-AAC v1 streams, one group of 2 x GROUP_LANES
    lanes; returns K1's napb-30 launches of the timed run."""
    from heaac_tpu_torch.codec.batch import QwirePipelinedDecoder
    stereo = files["he_v1s"]
    streams = [bytes(stereo[i % 8]) for i in range(GROUP_LANES)]
    dec = QwirePipelinedDecoder(streams)
    if dec.device.type != "cuda":
        raise SystemExit(f"default device is {dec.device}, not the card")
    t0 = time.perf_counter()
    dec.decode()                                   # warm-up
    warm_s = time.perf_counter() - t0
    reset_launches(K)
    t0 = time.perf_counter()
    outs = dec.decode()
    wall = time.perf_counter() - t0
    launches, rows = counts(K)
    pcm = outs[0].cpu().numpy()                    # [T, 2 x 256, 2, 2048]
    T, L = pcm.shape[:2]
    rows_check("phase 6", rows, {1: T})
    audio_s = dec.audio_seconds()
    print(f"stereo main path: {GROUP_LANES} streams, {L} lanes x {T} frames,"
          f" MS {dec.MS}, rows_pair {dec.RP}, audio {audio_s:.3f} s, wall "
          f"{wall:.3f} s (warm-up {warm_s:.3f} s), realtime "
          f"{audio_s / wall:.1f}x on {card}; K1 launches {launches}",
          flush=True)
    if (dec.MS, dec.RP, dec.nl, L) != (1, 1, 2, 2 * GROUP_LANES):
        raise SystemExit("stereo main path: not the M/S + coupled-rows "
                         "decode of one 2-lane-per-stream group")
    if launches != {30: T, 50: 0}:
        raise SystemExit(f"K1 launched {launches} times (napb: count) for "
                         f"{T} frames")
    peak = np.abs(pcm.astype(np.int32)).max(axis=(0, 2, 3))
    if not (peak > 0).all():
        raise SystemExit(f"silent lanes: {np.flatnonzero(peak == 0)}")
    cpu = QwirePipelinedDecoder(stereo[:2], group_streams=2,
                                max_frames=GOLDEN_FRAMES, device="cpu")
    ref = cpu.decode()[0].numpy()                  # [16, 4, 2, 2048]
    got = pcm[:GOLDEN_FRAMES, :4].astype(np.int32)
    d_cpu = int(np.abs(got - ref).max())
    with np.load(golden_tool().BATCH_GOLDEN) as z:
        gold = {str(name): z[f"pcm_{k}"] for k, name in enumerate(z["names"])}
    d_gold = 0
    for i in (0, 1):                   # golden [n, 2]: lanes 2i, 2i + 1
        want = gold[f"he_v1s_{i}"][:GOLDEN_FRAMES * 2048]
        for ch in (0, 1):
            lane = got[:, 2 * i + ch, 0].reshape(-1)
            d_gold = max(d_gold, int(np.abs(lane - want[:, ch]).max()))
    print(f"lanes 0-3 x {GOLDEN_FRAMES} frames vs port CPU: max {d_cpu} LSB;"
          f" vs JAX golden: max {d_gold} LSB", flush=True)
    if d_cpu > TOL_LSB or d_gold > TOL_LSB:
        raise SystemExit("stereo main path: card output differs from the "
                         "references")
    return launches[30]


class FlipLog(BucketLog):
    """decode_batch's per-bucket and per-flip-stream records."""

    def __init__(self):
        super().__init__()
        self.flips = []

    def emit(self, record):
        super().emit(record)
        st = getattr(record, "flip_stats", None)
        if st is not None:
            self.flips.append(st)


class RouteLog(FlipLog):
    """decode_batch's per-bucket, per-flip-stream and single-stream
    records, and every message."""

    def __init__(self):
        super().__init__()
        self.messages = []
        self.singles = []

    def emit(self, record):
        super().emit(record)
        self.messages.append(record.getMessage())
        st = getattr(record, "single_stats", None)
        if st is not None:
            self.singles.append(st)


def flip_gold() -> dict:
    with np.load(golden_tool().FLIP_GOLDEN) as z:
        return {k: z[k] for k in z.files if k.startswith("pcm_")}


def flip_batch(K, card: str, bench: list) -> dict:
    """Phase 7 (a): decode_batch on the card over the flip streams 0-3,
    the flip + coupling stream and the 20-band streams, shuffled; returns
    K1's launches."""
    from heaac_tpu_torch import decode_batch
    from heaac_tpu_torch.codec.batch import decode_qwire_flip_stream
    from heaac_tpu_torch.host import split_adts_stream
    flips = [(f"flip_{i}", open(os.path.join(REPO, FLIP_FILE.format(i)),
                                "rb").read()) for i in range(FLIP_BATCH)]
    flips.append(("flip_cce_0", open(os.path.join(REPO, FLIP_CCE_FILE),
                                     "rb").read()))
    items = flips + [(f"he20_{i}", d) for i, d in enumerate(bench)]
    order = np.random.default_rng(7).permutation(len(items))
    items = [items[k] for k in order]
    streams = [bytes(bytearray(d)) for _, d in items]
    flog = FlipLog()
    logger = logging.getLogger("heaac_tpu_torch")
    logger.addHandler(flog)
    logger.setLevel(logging.INFO)
    reset_launches(K)
    t0 = time.perf_counter()
    outs = decode_batch(streams)
    wall = time.perf_counter() - t0
    launches, rows = counts(K)
    logger.removeHandler(flog)
    names = [name for name, _ in items]
    flip_pos = sorted(k for k, name in enumerate(names)
                      if name.startswith("flip"))
    routed = sorted(st["stream"] for st in flog.flips)
    batched = sum(st["streams"] for st in flog.stats)
    audio = sum(st["audio_s"] for st in flog.stats + flog.flips)
    print(f"flip batch: {len(streams)} streams, wall {wall:.3f} s, audio "
          f"{audio:.3f} s, realtime {audio / wall:.1f}x on {card}; flip "
          f"scan: streams {routed} ("
          + ", ".join(f"{names[st['stream']]} {st['wall_s']:.3f} s"
                      for st in flog.flips)
          + f"); batched: {batched} streams in {len(flog.stats)} "
          f"sub-buckets; K1 launches {launches}", flush=True)
    if routed != flip_pos:
        raise SystemExit(f"flip streams at {flip_pos}, flip scan took "
                         f"{routed}")
    if batched != len(bench) or any(st["key"][0] != "he"
                                    for st in flog.stats):
        raise SystemExit(f"{batched} streams decoded batched, expected "
                         f"the {len(bench)} 20-band streams")
    expect = {30: 0, 50: 0}
    for st in flog.stats:              # one launch per scan step
        expect[50 if st["key"][3] else 30] += st["steps"]
    for st in flog.flips:              # both band modes in every frame
        expect[30] += st["frames"]
        expect[50] += st["frames"]
    print(f"K1 flip batch: {launches} launches, expected {expect} (sub-"
          "buckets: " + ", ".join(f"{st['key']} {st['streams']} streams "
                                  f"{st['steps']} steps"
                                  for st in flog.stats)
          + f"; flip streams x frames: "
          f"{[st['frames'] for st in flog.flips]})", flush=True)
    if launches != expect:
        raise SystemExit(f"K1 launched {launches}, expected {expect}")
    rows_check("phase 7 (a)", rows, {0: sum(st["steps"] for st in flog.stats)
                                     + sum(st["frames"] for st in flog.flips)})
    gold = flip_gold()
    rows = GOLDEN_FRAMES * 2048
    worst = {}
    for k in flip_pos:
        name, data = items[k]
        head = b"".join(split_adts_stream(data)[:GOLDEN_FRAMES])
        cpu = decode_qwire_flip_stream(head, device="cpu").numpy().astype(
            np.int32)
        got = outs[k].numpy().astype(np.int32)
        if got.shape != (len(split_adts_stream(data)) * 2048, 2):
            raise SystemExit(f"{name}: output {got.shape}")
        want = gold[f"pcm_{name}"]
        worst[name] = (int(np.abs(got[:rows] - want).max()),
                       int(np.abs(got[:rows] - cpu).max()),
                       int(np.abs(cpu - want).max()))
    print(f"flip streams, first {GOLDEN_FRAMES} frames, max LSB (card vs "
          f"JAX golden, card vs port CPU, port CPU vs JAX golden): {worst}",
          flush=True)
    if max(max(v) for v in worst.values()) > TOL_LSB:
        raise SystemExit("flip batch: card output differs from the "
                         "references")
    for k, (name, _) in enumerate(items):
        if int(outs[k].abs().max()) == 0:
            raise SystemExit(f"{name}: silent output")
    return launches


def planner_scan(frames: list, T: int, rate_idx: int, device,
                 downsampled: int = 0):
    """Planner frames of single-lane streams -> one scan over T frames on
    ``device``: the flip scan, or with ``downsampled`` the plain scan
    with the 32-band synthesis; returns (pcm [T, lanes, 2, N] int16 on
    the host, seconds of upload + scan)."""
    from heaac_tpu_torch.codec import heaac_graph
    from heaac_tpu_torch.codec.batch import pack_planner_frames
    from heaac_tpu_torch.host import R_W1, spec_static_args
    heap, _, recs = pack_planner_frames(frames, 1, T)
    S = -(-max(64, int((recs[..., R_W1] & 0xFFFF).max())) // 64) * 64
    sa = spec_static_args(recs)
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    heap_d = torch.from_numpy(heap).to(device)
    recs_d = torch.from_numpy(recs).to(device)
    if downsampled:
        carry = heaac_graph.init_qwire_carry(len(frames), device)
        _, pcm = heaac_graph.qwire_scan_decode(
            heap_d, recs_d, carry, 0, 1, S, rate_idx, sa["NB"], sa["MS"],
            sa["NS"], sa["SEC"])
    else:
        carry = heaac_graph.init_qwire_flip_carry(len(frames), device)
        _, pcm = heaac_graph.qwire_scan_decode_flip(
            heap_d, recs_d, carry, 0, S, rate_idx, sa["NB"], sa["NS"],
            sa["SEC"])
    if cuda:
        torch.cuda.synchronize()
    return pcm.cpu().numpy(), time.perf_counter() - t0


def flip_full_width(K, card: str, device="cuda") -> dict:
    """Phase 7 (b): the 8 flip streams tiled to LANES lanes, one flip
    scan over all frames on the card; returns K1's launches and the
    realtime factor."""
    from heaac_tpu_torch.codec.planner import parse_stream_qwire
    from heaac_tpu_torch.host import parse_adts_header
    data = [open(os.path.join(REPO, FLIP_FILE.format(i)), "rb").read()
            for i in range(8)]
    rate_idx = parse_adts_header(data[0][:7]).sampling_index
    t0 = time.perf_counter()
    parsed = [parse_stream_qwire(d, is34_out=[])[0] for d in data]
    parse_s = time.perf_counter() - t0
    T = len(parsed[0])
    lanes = [parsed[i % 8] for i in range(LANES)]
    planner_scan(lanes, T, rate_idx, device)       # warm-up
    reset_launches(K)
    pcm, wall = planner_scan(lanes, T, rate_idx, device)
    launches, rows = counts(K)
    rows_check("phase 7 (b)", rows, {0: T})
    audio_s = LANES * T * 2048 / 48000
    print(f"flip scan full width: {LANES} lanes x {T} frames, audio "
          f"{audio_s:.3f} s, upload + scan {wall:.3f} s, realtime "
          f"{audio_s / wall:.1f}x on {card} (planner parse of the 8 "
          f"streams {parse_s:.3f} s); K1 launches {launches}", flush=True)
    if launches != {30: T, 50: T}:
        raise SystemExit(f"K1 launched {launches} for {T} frames of the "
                         "flip scan (expected one per frame per napb)")
    peak = np.abs(pcm.astype(np.int32)).max(axis=(0, 2, 3))
    if not (peak > 0).all():
        raise SystemExit(f"silent lanes: {np.flatnonzero(peak == 0)}")
    cpu, _ = planner_scan([p[:GOLDEN_FRAMES] for p in parsed],
                          GOLDEN_FRAMES, rate_idx, "cpu")
    got = pcm[:GOLDEN_FRAMES, :8].astype(np.int32)
    d_cpu = int(np.abs(got - cpu).max())
    gold = flip_gold()
    rows = lambda a, i: a[:, i].transpose(0, 2, 1).reshape(-1, 2)  # noqa
    d_gold = max(int(np.abs(rows(got, i) - gold[f"pcm_flip_{i}"]).max())
                 for i in range(8))
    d_cpu_gold = max(int(np.abs(rows(cpu, i).astype(np.int32)
                                - gold[f"pcm_flip_{i}"]).max())
                     for i in range(8))
    print(f"flip lanes 0-7 x {GOLDEN_FRAMES} frames vs port CPU: max "
          f"{d_cpu} LSB; vs JAX golden: max {d_gold} LSB; port CPU vs JAX "
          f"golden: max {d_cpu_gold} LSB", flush=True)
    if max(d_cpu, d_gold, d_cpu_gold) > TOL_LSB:
        raise SystemExit("flip scan: card output differs from the "
                         "references")
    return dict(launches=launches, realtime=audio_s / wall)


def lc_prober_batch(K, card: str, bench: list) -> dict:
    """Phase 8 (a): decode_batch on the card over the LC + CCE streams,
    the streams the Python prober buckets and the 20-band streams,
    shuffled; returns K1's launches."""
    from heaac_tpu_torch import decode_batch
    from heaac_tpu_torch.host import count_adts_frames, split_adts_stream
    tool = golden_tool()
    lc_names = [f"lc_cce_{point}_{j}" for point in ("after", "before")
                for j in range(4)]
    items = ([(name, tool.named_stream(name, REPO)) for name in lc_names]
             * LC_CCE_COPIES
             + [(name, tool.corrupted(name, REPO)) for name in PROBED]
             + [(f"he20_{i}", d) for i, d in enumerate(bench)])
    # seed 3 puts a PROBED stream first among the HE streams: stream 0 of
    # the HE bucket, whose profile then comes from the Python planner
    order = np.random.default_rng(3).permutation(len(items))
    items = [items[k] for k in order]
    streams = [bytes(bytearray(d)) for _, d in items]
    flog = RouteLog()
    logger = logging.getLogger("heaac_tpu_torch")
    logger.addHandler(flog)
    logger.setLevel(logging.INFO)
    reset_launches(K)
    t0 = time.perf_counter()
    outs = decode_batch(streams)
    wall = time.perf_counter() - t0
    launches, rows = counts(K)
    logger.removeHandler(flog)
    names = [name for name, _ in items]
    he_first = next(name for name in names if name.startswith("he20"))
    profile_parse = ("qwire pipelined decode: stream 0's profile from the "
                     "Python planner" in flog.messages)
    stats = {st["key"]: st for st in flog.stats}
    for key, st in stats.items():
        print(f"bucket {key}: {st['streams']} streams, {st['frames']} "
              f"frames, {st['steps']} steps, {st['audio_s']:.3f} s of "
              f"audio, wall {st['wall_s']:.3f} s (construction "
              f"{st['init_s']:.3f} s), realtime "
              f"{st['audio_s'] / st['wall_s']:.1f}x on {card}", flush=True)
    lc = stats.get(("lc", 6, 0, 0))
    he = stats.get(("he", 6, 1, 0))
    n_lc, n_he = len(lc_names) * LC_CCE_COPIES, len(PROBED) + len(bench)
    frames = count_adts_frames(bench[0])
    if (set(stats) != {("lc", 6, 0, 0), ("he", 6, 1, 0)} or flog.flips
            or (lc["streams"], lc["frames"], lc["steps"])
            != (n_lc, n_lc * frames, frames)
            or (he["streams"], he["frames"], he["steps"])
            != (n_he, n_he * frames, frames)):
        raise SystemExit(f"phase 8 (a) buckets {stats}, flip streams "
                         f"{flog.flips}")
    print(f"LC + CCE bucket: parse + upload {lc['init_s']:.3f} s, decode "
          f"(scan, copy out) {lc['wall_s'] - lc['init_s']:.3f} s; whole "
          f"call {wall:.3f} s; first HE stream {he_first}, profile from "
          f"the Python planner: {profile_parse}", flush=True)
    # the Python prober decodes frame 0 of each probed stream, and PS runs
    # there: one K1 launch at one lane each
    expect = {30: -(-n_he // GROUP_LANES) * he["steps"] + len(PROBED),
              50: 0}
    print(f"K1 phase 8 (a): {launches} launches, expected {expect} (HE "
          f"bucket: {-(-n_he // GROUP_LANES)} group x {he['steps']} steps; "
          f"the prober's frame 0 of {len(PROBED)} streams)", flush=True)
    if launches != expect:
        raise SystemExit(f"K1 launched {launches}, expected {expect}")
    # the LC bucket and the prober's single-stream frame 0 run no qwire
    # step
    rows_check("phase 8 (a)", rows,
               {0: -(-n_he // GROUP_LANES) * he["steps"]})
    if he_first not in PROBED or not profile_parse:
        raise SystemExit("the HE bucket's stream 0 did not take its profile "
                         "from the Python planner")
    for (name, data), pcm in zip(items, outs):
        spf, ch = (2048, 2) if name.startswith("he") else (1024, 1)
        if (tuple(pcm.shape) != (count_adts_frames(data) * spf, ch)
                or int(pcm.abs().max()) == 0):
            raise SystemExit(f"{name}: output {tuple(pcm.shape)}, silent "
                             "or of the wrong shape")
    checked = [f"{kind}_{i}" for kind in ("lc_cce_after", "lc_cce_before",
                                          "he20_f1", "he20")
               for i in (0, 1)]
    gold = {}
    for path in (tool.LC_GOLDEN, tool.BATCH_GOLDEN):
        with np.load(path) as z:
            gold.update({str(name): z[f"pcm_{k}"]
                         for k, name in enumerate(z["names"])})
    data = dict(items)
    heads = [b"".join(split_adts_stream(data[name])[:GOLDEN_FRAMES])
             for name in checked]
    cpu = decode_batch(heads, device="cpu")
    worst = {}
    for k, name in enumerate(checked):
        rows = cpu[k].shape[0]
        got = outs[names.index(name)][:rows].numpy().astype(np.int32)
        worst[name] = (int(np.abs(got - gold[name][:rows]).max()),
                       int(np.abs(got - cpu[k].numpy()).max()))
    print(f"streams 0-1 of each kind, first {GOLDEN_FRAMES} frames, max LSB "
          f"(vs JAX golden, vs port CPU): {worst}", flush=True)
    if max(max(v) for v in worst.values()) > TOL_LSB:
        raise SystemExit("phase 8 (a): card output differs from the "
                         "references")
    return launches


def downsampled_full_width(K, card: str, device="cuda") -> dict:
    """Phase 8 (b): the 8 downsampled streams tiled to LANES lanes, one
    downsampled scan over all frames on the card; returns K1's launches
    and the realtime factor."""
    from heaac_tpu_torch.codec.planner import parse_stream_qwire
    asc = open(os.path.join(REPO, DS_ASC), "rb").read()
    data = [open(os.path.join(REPO, DS_FILE.format(i)), "rb").read()
            for i in range(8)]
    t0 = time.perf_counter()
    parsed = [parse_stream_qwire(d, asc=asc) for d in data]
    parse_s = time.perf_counter() - t0
    if {p[1:] for p in parsed} != {(24000, 1, 0, 1)}:
        raise SystemExit(f"downsampled streams: (rate, lanes, is34, ds) "
                         f"{[p[1:] for p in parsed]}")
    parsed = [p[0] for p in parsed]
    T = len(parsed[0])
    lanes = [parsed[i % 8] for i in range(LANES)]
    planner_scan(lanes, T, 6, device, downsampled=1)     # warm-up
    reset_launches(K)
    pcm, wall = planner_scan(lanes, T, 6, device, downsampled=1)
    launches, rows = counts(K)
    rows_check("phase 8 (b)", rows, {0: T})
    audio_s = LANES * T * 1024 / 24000
    print(f"downsampled scan full width: {LANES} lanes x {T} frames, pcm "
          f"{pcm.shape}, audio {audio_s:.3f} s, upload + scan {wall:.3f} s,"
          f" realtime {audio_s / wall:.1f}x on {card} (planner parse of the"
          f" 8 streams {parse_s:.3f} s); K1 launches {launches}", flush=True)
    if launches != {30: T, 50: 0} or pcm.shape[-1] != 1024:
        raise SystemExit(f"K1 launched {launches} for {T} frames of the "
                         f"downsampled scan (pcm {pcm.shape})")
    peak = np.abs(pcm.astype(np.int32)).max(axis=(0, 2, 3))
    if not (peak > 0).all():
        raise SystemExit(f"silent lanes: {np.flatnonzero(peak == 0)}")
    cpu, _ = planner_scan([p[:GOLDEN_FRAMES] for p in parsed],
                          GOLDEN_FRAMES, 6, "cpu", downsampled=1)
    got = pcm[:GOLDEN_FRAMES, :8].astype(np.int32)
    d_cpu = int(np.abs(got - cpu).max())
    with np.load(golden_tool().DS_GOLDEN) as z:
        gold = z["pcm"]                            # [16, 4, 2, 1024]
    d_gold = int(np.abs(got[:, :gold.shape[1]] - gold).max())
    d_cpu_gold = int(np.abs(cpu[:, :gold.shape[1]].astype(np.int32)
                            - gold).max())
    print(f"downsampled lanes 0-7 x {GOLDEN_FRAMES} frames vs port CPU: max "
          f"{d_cpu} LSB; lanes 0-3 vs JAX golden: max {d_gold} LSB; port "
          f"CPU vs JAX golden: max {d_cpu_gold} LSB", flush=True)
    if max(d_cpu, d_gold, d_cpu_gold) > TOL_LSB:
        raise SystemExit("downsampled scan: card output differs from the "
                         "references")
    return dict(launches=launches, realtime=audio_s / wall)


def single_decode(name: str, device, tool) -> tuple:
    """(pcm, output rate, wall s, frames) of a stream of the single-stream
    golden decoded whole: ``decode_adts``, or ``Decoder(asc=)`` frame by
    frame for the downsampled stream."""
    from heaac_tpu_torch import Decoder, decode_adts
    from heaac_tpu_torch.host import split_adts_stream
    data = tool.single_stream(name, REPO)
    frames = split_adts_stream(data)
    t0 = time.perf_counter()
    if name == "ds_0":
        with open(os.path.join(REPO, DS_ASC), "rb") as f:
            dec = Decoder(asc=f.read(), device=device)
        pcm = torch.cat([dec.decode_frame(fr[7:]) for fr in frames])
        rate = dec.sample_rate
    else:
        pcm, rate = decode_adts(data, device=device)
    return pcm, rate, time.perf_counter() - t0, len(frames)


def ps_frames_on_cpu(fn) -> tuple:
    """(fn()'s result, {napb: calls of decorrelate_seq}) for a CPU run,
    where the wrapper runs K1's plain version and counts no launch."""
    from heaac_tpu_torch.ops import ps as ps_ops
    calls = []
    real = ps_ops.decorrelate_seq

    def spy(*a):
        calls.append(a[1].shape[1])
        return real(*a)

    ps_ops.decorrelate_seq = spy
    try:
        out = fn()
    finally:
        ps_ops.decorrelate_seq = real
    return out, {30: calls.count(30), 50: calls.count(50)}


def stream_line(name: str, frames: int, audio_s: float, wall: float,
                card: str) -> str:
    return (f"{name}: {frames} frames, audio {audio_s:.3f} s, wall "
            f"{wall:.3f} s, realtime {audio_s / wall:.2f}x, "
            f"{1e3 * wall / frames:.2f} ms per frame on {card}")


def single_fallback_batch(K, card: str, bench: list) -> dict:
    """Phase 9 (a): decode_batch on the card over the two streams whose
    frame 0 is corrupt and the 20-band streams, shuffled: the corrupt
    ones fall back to the single-stream Decoder on the card, where PS
    never starts; returns K1's launches."""
    from heaac_tpu_torch import Decoder, decode_batch
    from heaac_tpu_torch.host import split_adts_stream
    tool = golden_tool()
    items = ([(name, tool.corrupted(name, REPO)) for name in FALLBACK]
             + [(f"he20_{i}", d) for i, d in enumerate(bench)])
    order = np.random.default_rng(9).permutation(len(items))
    items = [items[k] for k in order]
    names = [name for name, _ in items]
    flog = RouteLog()
    logger = logging.getLogger("heaac_tpu_torch")
    logger.addHandler(flog)
    logger.setLevel(logging.INFO)
    reset_launches(K)
    t0 = time.perf_counter()
    outs = decode_batch([bytes(bytearray(d)) for _, d in items])
    wall = time.perf_counter() - t0
    launches, rows = counts(K)
    logger.removeHandler(flog)
    he = {st["key"]: st for st in flog.stats}.get(("he", 6, 1, 0))
    singles = {names[st["stream"]]: st for st in flog.singles}
    for name, st in singles.items():
        print("fallback " + stream_line(name, st["frames"], st["audio_s"],
                                        st["wall_s"], card)
              + f", {st['dropped']} dropped", flush=True)
    print(f"phase 9 (a): {len(items)} streams in {wall:.3f} s; HE bucket "
          f"{he and (he['streams'], he['steps'], round(he['wall_s'], 3))}"
          f"; K1 launches {launches}", flush=True)
    if (he is None or (he["streams"], he["steps"]) != (len(bench), 50)
            or set(singles) != set(FALLBACK)
            or any(st["dropped"] != 1 for st in singles.values())):
        raise SystemExit(f"phase 9 (a): HE bucket {he}, single-stream "
                         f"decodes {singles}")
    # the batched bucket's launches only: PS never starts on the corrupt
    # streams, so the single-stream decoder runs no K1
    if launches != {30: he["steps"], 50: 0}:
        raise SystemExit(f"phase 9 (a): K1 launched {launches}, expected "
                         f"{he['steps']} at napb 30 (the batched bucket)")
    rows_check("phase 9 (a)", rows, {0: he["steps"]})
    with np.load(tool.SINGLE_GOLDEN) as z:
        gold = {name: z[f"pcm_{name}"] for name in FALLBACK}
    worst = {}
    for name in FALLBACK:
        data = dict(items)[name]
        head = b"".join(split_adts_stream(data)[:GOLDEN_FRAMES])
        cpu = Decoder(adts_probe=head[:7], device="cpu").decode(head)
        got = outs[names.index(name)][:len(cpu)].numpy().astype(np.int32)
        worst[name] = (int(np.abs(got - gold[name]).max()),
                       int(np.abs(got - cpu.numpy()).max()))
        if len(cpu) != len(gold[name]) or int(cpu.abs().max()) == 0:
            raise SystemExit(f"{name}: CPU decode {tuple(cpu.shape)}")
    print(f"fallback streams, first {GOLDEN_FRAMES} frames, max LSB (vs JAX "
          f"golden, vs port CPU): {worst}", flush=True)
    if max(max(v) for v in worst.values()) > TOL_LSB:
        raise SystemExit("phase 9 (a): card output differs from the "
                         "references")
    return launches


def single_streams(K, card: str) -> dict:
    """Phase 9 (b): each SINGLE stream decoded whole by the single-stream
    Decoder on the card; K1 at one lane exactly once per frame in which
    PS ran (counted on the CPU run), per napb; each within 2 LSB of the
    CPU run and, over its first frames, of the JAX golden.  Returns K1's
    launches summed over the streams and the device's busy share over
    the first stream."""
    from torch.profiler import ProfilerActivity, profile
    tool = golden_tool()
    gold = dict(np.load(tool.SINGLE_GOLDEN))
    for name in ("he20_0", "he34_0"):               # warm-up, both napb
        single_decode(name, "cuda", tool)
    total = {30: 0, 50: 0}
    worst = {}
    for name in SINGLE:
        (cpu, _, _, _), expect = ps_frames_on_cpu(
            lambda: single_decode(name, "cpu", tool))
        reset_launches(K)
        pcm, rate, wall, frames = single_decode(name, "cuda", tool)
        launches, rows = counts(K)
        rows_check(f"phase 9 (b) {name}", rows, {})
        print(stream_line(name, frames, pcm.shape[0] / rate, wall, card)
              + f"; K1 launches {launches}, PS frames on the CPU {expect}",
              flush=True)
        if launches != expect:
            raise SystemExit(f"{name}: K1 launched {launches}, PS ran "
                             f"{expect}")
        want = gold[f"pcm_{name}"].astype(np.int32)
        got = pcm.numpy().astype(np.int32)
        if got.shape != cpu.shape or int(cpu.abs().max()) == 0:
            raise SystemExit(f"{name}: card {got.shape}, CPU "
                             f"{tuple(cpu.shape)}")
        worst[name] = (int(np.abs(got[:len(want)] - want).max()),
                       int(np.abs(got - cpu.numpy()).max()))
        for napb in total:
            total[napb] += launches[napb]
    print(f"single-stream decodes, max LSB (first {GOLDEN_FRAMES} frames vs "
          f"JAX golden, whole stream vs port CPU): {worst}", flush=True)
    if max(max(v) for v in worst.values()) > TOL_LSB:
        raise SystemExit("phase 9 (b): card output differs from the "
                         "references")
    if not (total[30] and total[50]):
        raise SystemExit(f"phase 9 (b): K1 did not run at both napb: {total}")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        single_decode(SINGLE[0], "cuda", tool)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.device_time for e in kernels) / 1e6 / wall
    print(f"{SINGLE[0]} under torch.profiler: {len(kernels)} device records"
          f" in {wall:.3f} s, device busy {100 * busy:.2f}% of the wall",
          flush=True)
    return dict(launches=total, busy=busy)


def k1_calls(fn, key=lambda a: (a[0].shape[0], a[1].shape[1])) -> tuple:
    """(fn()'s result, [key(arguments)] of every call of K1's wrapper
    made through ``ops/ps.py`` while fn ran; by default (lanes,
    napb))."""
    from heaac_tpu_torch.ops import ps as ps_ops
    calls = []
    real = ps_ops.decorrelate_seq

    def spy(*a):
        calls.append(key(a))
        return real(*a)

    ps_ops.decorrelate_seq = spy
    try:
        out = fn()
    finally:
        ps_ops.decorrelate_seq = real
    return out, calls


def k1_per_card(fn) -> tuple:
    """(fn()'s result, K1's launches per card while fn ran): the calls of
    K1's wrapper through ``ops/ps.py`` outside a CUDA-graph capture, by
    their tensors' card, plus the launches each replay of a captured
    qwire step holds (``codec/step_graph.py``), by the graph's card."""
    from heaac_tpu_torch.codec import step_graph
    real = step_graph._StepGraph.replay
    replays = []

    def spy(self, *a):
        replays.append((str(self.heap.device),
                        sum(self.launches[0].values())))
        return real(self, *a)

    step_graph._StepGraph.replay = spy
    try:
        out, calls = k1_calls(fn, key=lambda a: (
            str(a[0].device), torch.cuda.is_current_stream_capturing()))
    finally:
        step_graph._StepGraph.replay = real
    per_card: dict = {}
    for c, n in [(c, 1) for c, capturing in calls if not capturing] + replays:
        per_card[c] = per_card.get(c, 0) + n
    return out, dict(sorted(per_card.items()))


def front_m4a_decodes(K, card: str) -> dict:
    """Phase 10 (a): ``heaac_tpu_torch.decode`` with its default device
    on FRONT_M4A, each built here by the port's muxer from the whole
    committed stream: K1 at one lane exactly once per frame in which PS
    ran on the port's CPU run of the same input, per napb; within 2 LSB
    of that CPU run and, over the first frames, of the JAX golden.
    Returns K1's launches summed over the inputs."""
    from heaac_tpu_torch import decode
    from heaac_tpu_torch.host import split_adts_stream
    from heaac_tpu_torch.io.adts import adts_to_asc
    from heaac_tpu_torch.io.mp4 import mux_m4a
    tool = golden_tool()
    gold = dict(np.load(tool.FRONT_GOLDEN))
    total = {30: 0, 50: 0}
    worst = {}
    for name in FRONT_M4A:
        rel = dict((n, r) for n, r, _ in tool.FRONT_LIST)[name]
        with open(os.path.join(REPO, rel), "rb") as f:
            nframes = len(split_adts_stream(f.read()))
        m4a = tool.front_m4a(name, adts_to_asc, mux_m4a, frames=nframes,
                             repo=REPO)
        (cpu, _), cpu_calls = k1_calls(lambda: decode(m4a, device="cpu"))
        expect = {napb: sum(1 for _, nb in cpu_calls if nb == napb)
                  for napb in (30, 50)}
        reset_launches(K)
        t0 = time.perf_counter()
        (pcm, rate), calls = k1_calls(lambda: decode(m4a))
        wall = time.perf_counter() - t0
        launches, rows = counts(K)
        rows_check(f"phase 10 (a) {name}.m4a", rows, {})
        print(stream_line(f"{name}.m4a", nframes, pcm.shape[0] / rate, wall,
                          card) + f"; K1 launches {launches}, PS frames on "
              f"the CPU {expect}, lanes {sorted(set(b for b, _ in calls))}",
              flush=True)
        if launches != expect or any(b != 1 for b, _ in calls):
            raise SystemExit(f"{name}.m4a: K1 launched {launches} (lanes "
                             f"{set(calls)}), PS ran {expect} at one lane")
        want = gold[f"pcm_{name}"].astype(np.int32)
        got = pcm.numpy().astype(np.int32)
        if got.shape != tuple(cpu.shape) or int(cpu.abs().max()) == 0 \
                or rate != int(gold[f"rate_{name}"]):
            raise SystemExit(f"{name}.m4a: card {got.shape} at {rate} Hz, "
                             f"CPU {tuple(cpu.shape)}")
        worst[name] = (int(np.abs(got[:len(want)] - want).max()),
                       int(np.abs(got - cpu.numpy()).max()))
        for napb in total:
            total[napb] += launches[napb]
    print(f"front doors, max LSB (first {GOLDEN_FRAMES} frames vs JAX "
          f"golden, whole input vs port CPU): {worst}", flush=True)
    if max(max(v) for v in worst.values()) > TOL_LSB:
        raise SystemExit("phase 10 (a): card output differs from the "
                         "references")
    if not total[30]:
        raise SystemExit(f"phase 10 (a): K1 never ran: {total}")
    return total


class WarningLog(logging.Handler):
    """Every WARNING (and above) of the port's logger."""

    def __init__(self):
        super().__init__(logging.WARNING)
        self.messages = []

    def emit(self, record):
        self.messages.append(record.getMessage())


def cli_in_process(argv) -> tuple:
    """(exit code, stdout, stderr, WARNING messages) of the port's
    ``cli.main(argv)`` run in this process, where K1's counts are
    visible."""
    import contextlib
    import io
    from heaac_tpu_torch import cli
    out, err, warns = io.StringIO(), io.StringIO(), WarningLog()
    logger = logging.getLogger("heaac_tpu_torch")
    logger.addHandler(warns)
    try:
        with contextlib.redirect_stdout(out), \
                contextlib.redirect_stderr(err):
            rc = cli.main(argv)
    finally:
        logger.removeHandler(warns)
    return rc, out.getvalue(), err.getvalue(), warns.messages


def front_cli(K, card: str) -> dict:
    """Phase 10 (b): the port's command line in-process with its default
    device: ``--benchmark`` on bench stream 0 (decode_batch: K1 at napb
    30 once per frame at the bucket's one lane, no fallback WARNING, the
    WAV equal to ``decode_batch([data])[0]`` on the card), ``--profile``
    on its first frames (the Chrome trace names K1's kernel), ``--probe``
    on the two .m4a kinds (the JAX golden's JSON) and ``--bit-trace`` on
    two frames of an AAC-LC stream (one line per read, as many as the
    golden's).  Returns K1's launches of the ``--benchmark`` run."""
    import tempfile
    from heaac_tpu_torch import decode_batch
    from heaac_tpu_torch.host import split_adts_stream
    from heaac_tpu_torch.io.wav import read_wav
    from heaac_tpu_torch.utils.trace import TRACE_FILE
    tool = golden_tool()
    gold = dict(np.load(tool.FRONT_GOLDEN))
    src = os.path.join(REPO, "benchdata", "heaac_bench_stream_0.aac")
    with open(src, "rb") as f:
        data = f.read()
    with tempfile.TemporaryDirectory() as tmp:
        wav = os.path.join(tmp, "bench0.wav")
        reset_launches(K)
        (rc, _, err, warns), calls = k1_calls(
            lambda: cli_in_process(["-i", src, wav, "--benchmark"]))
        launches, rows = counts(K)
        rows_check("phase 10 (b)", rows, {0: len(split_adts_stream(data))})
        bench = json.loads(err.splitlines()[0])
        print(f"cli --benchmark on {os.path.basename(src)}: {bench} on "
              f"{card}; K1 launches {launches}, lanes "
              f"{sorted(set(b for b, _ in calls))}", flush=True)
        frames = len(split_adts_stream(data))
        if rc != 0 or warns or launches != {30: frames, 50: 0} \
                or any(b != 1 for b, _ in calls):
            raise SystemExit(f"phase 10 (b): cli rc {rc}, warnings {warns},"
                             f" K1 {launches} for {frames} frames")
        pcm, rate = read_wav(wav)
        ref = decode_batch([data])[0].numpy()
        if rate != 48000 or not np.array_equal(pcm, ref):
            raise SystemExit(f"phase 10 (b): the WAV ({pcm.shape}, {rate} "
                             f"Hz) differs from decode_batch's "
                             f"{ref.shape}")
        head = os.path.join(tmp, "head.aac")
        with open(head, "wb") as f:
            f.write(b"".join(split_adts_stream(data)[:PROFILE_FRAMES]))
        prof = os.path.join(tmp, "prof")
        rc, _, _, warns = cli_in_process(
            ["-i", head, os.path.join(tmp, "head.wav"), "--profile", prof])
        with open(os.path.join(prof, TRACE_FILE)) as f:
            text = f.read()
        print(f"cli --profile: {len(text)} bytes of Chrome trace, K1's "
              f"kernel named {text.count('ps_decorrelate_kernel')} times",
              flush=True)
        if rc != 0 or warns or "ps_decorrelate_kernel" not in text:
            raise SystemExit(f"phase 10 (b): --profile rc {rc}, warnings "
                             f"{warns}, K1 not in the trace")
        for name in ("he20_0", "he20_explicit_0"):
            rc, out, _, _ = cli_in_process(
                ["-i", os.path.join(REPO, tool.FRONT_FILE.format(name)),
                 "--probe"])
            if rc != 0 or json.loads(out) != json.loads(
                    str(gold[f"probe_main_{name}"])):
                raise SystemExit(f"phase 10 (b): --probe of {name}.m4a: "
                                 f"{out}")
        print("cli --probe: both .m4a kinds equal the JAX golden's JSON",
              flush=True)
        with open(os.path.join(REPO, tool.TRACE_FILE), "rb") as f:
            two = b"".join(split_adts_stream(f.read())[:tool.TRACE_FRAMES])
        lc = os.path.join(tmp, "two.aac")
        with open(lc, "wb") as f:
            f.write(two)
        rc, _, err, _ = cli_in_process(
            ["-i", lc, os.path.join(tmp, "two.wav"), "--bit-trace"])
        lines = sum(1 for x in err.splitlines() if x.startswith("bit "))
        print(f"cli --bit-trace: {lines} reads, the golden {len(gold['trace'])}",
              flush=True)
        if rc != 0 or lines != len(gold["trace"]):
            raise SystemExit("phase 10 (b): --bit-trace read count differs")
    return launches


def k1_one_lane(K) -> dict:
    """K1 at B=1 (the single-stream decoder's width), warm device ms and
    its bound, per napb."""
    out = {}
    for napb in (30, 50):
        args = k1_args(1, napb, 5 + napb, K)
        outs = K.decorrelate_seq(*args)
        ms = device_ms(lambda: K.decorrelate_seq(*args),
                       "ps_decorrelate_kernel")
        bound_ms, bound_by = k1_bound(args, outs)
        out[napb] = dict(warm_ms=ms, bound_ms=bound_ms, bound_by=bound_by)
        print(f"K1 B=1 napb={napb}: warm {ms:.5f} ms, bound {bound_ms:.6f} "
              f"ms ({bound_by})", flush=True)
    return out


def sharded_full_width(K, card: str, streams: list, main: dict,
                       devices: list) -> dict:
    """Phase 11 (a), and (d) on two cards: ShardedQwireDecoder over
    phase 4's streams as one group on ``devices``; K1 exactly once per
    frame per shard at napb 30 (counted per card: ``k1_per_card``),
    PCM within SHARD_TOL_LSB of phase 4's.  Returns K1's launches, per
    card and the realtime factor."""
    from heaac_tpu_torch.parallel.sharding import ShardedQwireDecoder
    dec = ShardedQwireDecoder(streams, devices=devices, group_streams=LANES)
    t0 = time.perf_counter()
    dec.decode()                                   # warm-up
    warm_s = time.perf_counter() - t0
    reset_launches(K)
    t0 = time.perf_counter()
    outs, per_card = k1_per_card(dec.decode)
    wall = time.perf_counter() - t0
    launches, rows = counts(K)
    pcm = outs[0].numpy()
    T = pcm.shape[0]
    rows_check(f"phase 11 sharded on {'+'.join(map(str, devices))}", rows,
               {0: len(devices) * T})
    audio_s = dec.audio_seconds()
    rt = audio_s / wall
    names = [str(d) for d in dec.devices]
    print(f"sharded main path on {names}: lanes per shard "
          f"{[hi - lo for lo, hi in dec.bounds]}, {T} frames, audio "
          f"{audio_s:.3f} s, wall {wall:.3f} s (warm-up {warm_s:.3f} s), "
          f"realtime {rt:.1f}x, {1e3 * wall / T:.1f} ms a frame; phase 4 in "
          f"this call: realtime {main['rt']:.1f}x, "
          f"{1e3 * main['wall'] / T:.1f} ms a frame, on {card}; K1 launches "
          f"{launches}, per card {per_card}", flush=True)
    want_cards = {c: T * names.count(c) for c in names}
    if launches != {30: len(devices) * T, 50: 0} or per_card != want_cards:
        raise SystemExit(f"phase 11: K1 launched {launches} (per card "
                         f"{per_card}), expected {len(devices)} x {T} at "
                         f"napb 30 ({want_cards})")
    if pcm.shape != main["pcm"].shape:
        raise SystemExit(f"phase 11: pcm {pcm.shape}, phase 4's "
                         f"{main['pcm'].shape}")
    d = int(np.abs(pcm.astype(np.int32) - main["pcm"]).max())
    print(f"sharded vs phase 4's unsharded PCM: max {d} LSB", flush=True)
    if d > SHARD_TOL_LSB:
        raise SystemExit("phase 11: sharded PCM differs from phase 4's")
    return dict(launches=launches, per_card=per_card, realtime=rt)


def sharded_cut(K, card: str, files: dict) -> dict:
    """Phase 11 (b): the stream-aligned cut on cuda:0, 6 stereo streams
    over 4 shards and the sharded golden's coupling streams over 8 (four
    shards without lanes); K1 once per frame per shard with lanes,
    within SHARD_TOL_LSB of the port's unsharded CPU decode and of the
    JAX golden.  Returns K1's launches summed over both cases."""
    from heaac_tpu_torch.codec.batch import QwirePipelinedDecoder
    from heaac_tpu_torch.parallel.sharding import ShardedQwireDecoder
    tool = golden_tool()
    gold = dict(np.load(tool.SHARDED_GOLDEN))
    cases = (("stereo", files["he_v1s"][:6], 4),
             ("cce", tool.sharded_streams("cce", REPO), 8))
    total = {30: 0, 50: 0}
    for name, streams, n in cases:
        dec = ShardedQwireDecoder(streams, devices=["cuda:0"] * n,
                                  max_frames=GOLDEN_FRAMES)
        reset_launches(K)
        t0 = time.perf_counter()
        pcm = dec.decode()[0].numpy().astype(np.int32)
        wall = time.perf_counter() - t0
        launches, rows = counts(K)
        lanes = [hi - lo for lo, hi in dec.bounds]
        busy = sum(1 for x in lanes if x)
        rows_check(f"phase 11 (b) {name}", rows,
                   {int(name == "stereo"): busy * GOLDEN_FRAMES})
        cpu = QwirePipelinedDecoder(streams, max_frames=GOLDEN_FRAMES,
                                    device="cpu").decode()[0].numpy()
        want = gold[f"pcm_{name}"]
        d_cpu = int(np.abs(pcm - cpu).max())
        d_gold = int(np.abs(pcm[:, :want.shape[1]] - want).max())
        print(f"sharded {name}: {len(streams)} streams over {n} shards on "
              f"cuda:0, lanes per shard {lanes}, {GOLDEN_FRAMES} frames in "
              f"{wall:.3f} s; K1 launches {launches}; max LSB vs the port's "
              f"CPU run {d_cpu}, vs the JAX golden {d_gold}", flush=True)
        if launches != {30: busy * GOLDEN_FRAMES, 50: 0}:
            raise SystemExit(f"phase 11 (b) {name}: K1 launched {launches}, "
                             f"expected {busy} shards x {GOLDEN_FRAMES}")
        if max(d_cpu, d_gold) > SHARD_TOL_LSB or \
                np.abs(cpu).max(axis=(0, 2, 3)).min() == 0:
            raise SystemExit(f"phase 11 (b) {name}: card output differs "
                             "from the references, or a silent lane")
        for napb in total:
            total[napb] += launches[napb]
    return total


def multihost_run(card: str, bench: list, backend: str, devices) -> dict:
    """Phase 11 (c), and (d) with NCCL: two processes of ``python -m
    heaac_tpu_torch.parallel.multihost`` over the bench streams in a
    temporary directory, rank k on ``devices[k]`` (None: the module's
    default, card k).  Both must report the same global metrics, and
    each rank its device and one K1 launch per frame at napb 30.
    Returns K1's launches summed over the ranks."""
    import socket
    import tempfile
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    with tempfile.TemporaryDirectory() as tmp:
        for i, data in enumerate(bench):
            with open(os.path.join(tmp, f"s{i}.aac"), "wb") as f:
                f.write(data)
        procs = []
        t0 = time.perf_counter()
        try:
            for rank, dev in enumerate(devices):
                cmd = [sys.executable, "-m",
                       "heaac_tpu_torch.parallel.multihost",
                       "--coordinator", f"127.0.0.1:{port}",
                       "--num-processes", str(len(devices)),
                       "--process-id", str(rank), "--streams-dir", tmp,
                       "--backend", backend]
                procs.append(subprocess.Popen(
                    cmd + (["--device", dev] if dev else []), cwd=REPO,
                    stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                    text=True))
            lines = []
            for rank, p in enumerate(procs):
                out, err = p.communicate(timeout=MULTIHOST_TIMEOUT_S)
                if p.returncode != 0:
                    raise SystemExit(f"phase 11 multihost rank {rank} exited "
                                     f"{p.returncode}: {err[-2000:]}")
                lines.append([json.loads(x)
                              for x in out.strip().splitlines()[-2:]])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
        wall = time.perf_counter() - t0
    n = len(bench)
    frames = n * 50
    glob = [{k: v for k, v in g.items()
             if k not in ("process_id", "process_frames")} for _, g in lines]
    for rank, (info, g) in enumerate(lines):
        step_ms = 1e3 * info["decode_s"] / 50
        print(f"multihost rank {rank} ({backend}): {info}; {g}; decode "
              f"{step_ms:.1f} ms a frame at {n // len(devices)} lanes "
              f"(its process's first decode), realtime "
              f"{g['process_frames'] * 2048 / 48000 / info['decode_s']:.1f}x"
              f" on {card}", flush=True)
        want_dev = devices[rank] or f"cuda:{rank}"
        rows_check(f"phase 11 multihost {backend} rank {rank}",
                   {int(k): v for k, v in info["rows_launches"].items()},
                   {0: 50})
        if (info["device"], info["backend"], info["k1_launches"]) != (
                want_dev, backend, {"30": 50, "50": 0}) \
                or g["process_frames"] != frames // len(devices):
            raise SystemExit(f"phase 11 multihost rank {rank}: {info}, {g}")
    print(f"multihost ({backend}, {len(devices)} ranks): wall {wall:.3f} s "
          "from the first process's start to the last one's exit",
          flush=True)
    if glob[0] != glob[1] or glob[0] != {
            "frames": frames, "errors": 0, "audio_seconds":
            glob[0]["audio_seconds"], "num_devices": len(devices)} or \
            abs(glob[0]["audio_seconds"] - frames * 2048 / 48000) > 1e-9:
        raise SystemExit(f"phase 11 multihost: global metrics {glob}")
    return {30: sum(int(info["k1_launches"]["30"]) for info, _ in lines)}


def snr_db(pcm: np.ndarray, out: np.ndarray) -> float:
    """Round-trip SNR of decoded ``out`` against encoder input ``pcm``
    (the encoder's output is one 1024-sample frame late)."""
    ref = pcm.astype(np.float64)
    err = out[1024:1024 + len(pcm)].astype(np.float64) - ref
    return float(10 * np.log10((ref ** 2).sum() / max((err ** 2).sum(), 1)))


def first_frame_apart(a: bytes, b: bytes) -> int:
    """The first ADTS frame where two streams differ (-1: none)."""
    from heaac_tpu_torch.host import split_adts_stream
    fa, fb = split_adts_stream(a), split_adts_stream(b)
    for k, (x, y) in enumerate(zip(fa, fb)):
        if x != y:
            return k
    return -1 if len(fa) == len(fb) else min(len(fa), len(fb))


def encode_cases(K, card: str) -> None:
    """Phase 12 (a): the port's AacEncoder over every case of the encode
    golden (its PCM), bytes against the JAX encoder's; the streams
    decoded by decode_batch with its default device (the card), within
    TOL_LSB of the port's CPU decode of the same bytes, and the round
    trip above SNR_MIN_DB; then the bytes must equal the golden's."""
    from heaac_tpu_torch import decode_batch
    from heaac_tpu_torch.codec.encoder import AacEncoder
    tool = golden_tool()
    with np.load(tool.ENCODE_GOLDEN) as z:
        gold = {k: z[k] for k in z.files}
    names = list(tool.ENCODE_CASES)
    t0 = time.perf_counter()
    streams = [tool.encode_case(n, AacEncoder, gold[f"pcm_{n}"])
               for n in names]
    enc_s = time.perf_counter() - t0
    apart = {n: first_frame_apart(d, gold[f"adts_{n}"].tobytes())
             for n, d in zip(names, streams)}
    apart = {n: f for n, f in apart.items() if f >= 0}
    print(f"encoder: {len(names)} cases, {sum(map(len, streams))} bytes in "
          f"{enc_s:.3f} s on the host; bytes equal to the JAX golden in "
          f"{len(names) - len(apart)} cases"
          + (f", apart from ADTS frame {apart} (case: frame)" if apart
             else ""), flush=True)
    reset_launches(K)
    t0 = time.perf_counter()
    outs = decode_batch(streams)
    wall = time.perf_counter() - t0
    launches, rows = counts(K)
    rows_check("phase 12 (a)", rows, {})
    cpu = decode_batch(streams, device="cpu")
    rows = {}
    for n, out, ref in zip(names, outs, cpu):
        d = int(np.abs(out.numpy().astype(np.int32) - ref.numpy()).max()) \
            if out.shape == ref.shape else None
        snr = snr_db(gold[f"pcm_{n}"], out.numpy())
        rows[n] = (d, round(snr, 1))
        if d is None or d > TOL_LSB or (
                n not in tool.ENCODE_NO_SNR and not snr > SNR_MIN_DB):
            raise SystemExit(f"phase 12 (a): {n}: card {tuple(out.shape)} "
                             f"vs CPU {tuple(ref.shape)}, max {d} LSB, SNR "
                             f"{snr:.1f} dB")
    print(f"decode_batch on the card: {len(names)} streams in {wall:.3f} s "
          f"on {card}; K1 launches {launches} (AAC-LC and Main: none); "
          f"per case (max LSB vs port CPU, round-trip SNR dB; no SNR bound "
          f"for {list(tool.ENCODE_NO_SNR)}): {rows}", flush=True)
    if any(launches.values()):
        raise SystemExit(f"phase 12 (a): K1 launched {launches} on AAC-LC "
                         "and AAC-Main streams")
    if apart:
        raise SystemExit(f"phase 12 (a): encoder bytes differ from the JAX "
                         f"golden's (case: first ADTS frame apart) {apart}")


def distinct_streams(K, card: str, main4: dict) -> int:
    """Phase 12 (b): LANES distinct HE-AAC v2 streams made here by the
    port's generators (the 8 bench cores crossed with per-stream SBR and
    PS writer seeds, ``heaac_testgen.distinct_stream``), the
    first 8 against the JAX generators' sha256; decoded as one group by
    QwirePipelinedDecoder with its default device, beside the first 8
    of them tiled to LANES lanes (each its own buffer: phase 4's shape,
    with the same writer recipe) in the same phase: a warm-up of each,
    then timed runs in turns (tiled, distinct, distinct, tiled), each
    with K1 once per frame at napb 30; lanes
    DISTINCT_CHECKED within TOL_LSB of the port's CPU decode of the same
    streams.  Prints realtime and ms a frame of each run and phase 4's.
    Returns K1's napb-30 launches of the last timed distinct run."""
    import hashlib
    from heaac_tpu_torch.codec.batch import QwirePipelinedDecoder
    from heaac_tpu_torch.io import heaac_testgen
    tool = golden_tool()
    with np.load(tool.ENCODE_GOLDEN) as z:
        sha = [str(h) for h in z["distinct_sha256"]]
    cores = tool.bench_cores(REPO)
    t0 = time.perf_counter()
    streams = [heaac_testgen.distinct_stream(cores, i)
               for i in range(LANES)]
    gen_s = time.perf_counter() - t0
    got = [hashlib.sha256(d).hexdigest() for d in streams[:len(sha)]]
    print(f"generators: {LANES} distinct HE-AAC v2 streams "
          f"({len(set(streams))} distinct, {sum(map(len, streams))} bytes) "
          f"made in {gen_s:.3f} s on the host; first {len(sha)} sha256 "
          f"equal to the JAX golden's: {got == sha}", flush=True)
    if got != sha or len(set(streams)) != LANES:
        raise SystemExit("phase 12 (b): the generated streams differ from "
                         "the JAX generators' or repeat")
    tiled = [bytes(bytearray(streams[i % 8])) for i in range(LANES)]
    decs = {"distinct": QwirePipelinedDecoder(streams, group_streams=LANES),
            "tiled": QwirePipelinedDecoder(tiled, group_streams=LANES)}
    for dec in decs.values():
        dec.decode()                               # warm-up
    walls = {"distinct": [], "tiled": []}
    for run, name in enumerate(("tiled", "distinct", "distinct", "tiled")):
        reset_launches(K)
        t0 = time.perf_counter()
        outs = decs[name].decode()
        walls[name].append(time.perf_counter() - t0)
        launches, rows = counts(K)
        T = outs[0].shape[0]
        rows_check(f"phase 12 (b) run {run} {name}", rows, {0: T})
        if launches != {30: T, 50: 0} or T != 50:
            raise SystemExit(f"phase 12 (b): {name}: K1 launched "
                             f"{launches} for {T} frames of 20-band PS")
        if name == "distinct":
            pcm = outs[0].cpu().numpy()            # [T, L, 2, 2048]
            distinct30 = launches[30]
    audio_s = decs["distinct"].audio_seconds()

    def rate(w: float) -> str:
        return f"{audio_s / w:.1f}x / {1e3 * w / T:.1f} ms"

    ratio = sum(walls["tiled"]) / sum(walls["distinct"])
    print(f"distinct vs tiled, {LANES} lanes x {T} frames, realtime / ms a "
          f"frame in turns: tiled {rate(walls['tiled'][0])}, distinct "
          f"{rate(walls['distinct'][0])}, distinct "
          f"{rate(walls['distinct'][1])}, tiled {rate(walls['tiled'][1])}; "
          f"distinct at {ratio:.3f}x the tiled realtime; phase 4 (the 8 "
          f"bench streams tiled, this call) {main4['rt']:.1f}x / "
          f"{1e3 * main4['wall'] / main4['pcm'].shape[0]:.1f} ms; on {card}",
          flush=True)
    peak = np.abs(pcm.astype(np.int32)).max(axis=(0, 2, 3))
    if not (peak > 0).all():
        raise SystemExit(f"silent lanes: {np.flatnonzero(peak == 0)}")
    idx = list(DISTINCT_CHECKED)
    ref = QwirePipelinedDecoder([streams[i] for i in idx],
                                group_streams=len(idx),
                                device="cpu").decode()[0].numpy()
    d = int(np.abs(pcm[:, idx].astype(np.int32) - ref).max())
    print(f"lanes {idx} vs port CPU: max {d} LSB", flush=True)
    if d > TOL_LSB:
        raise SystemExit("phase 12 (b): card output differs from the CPU "
                         "port")
    return distinct30


def encode_cli(K, card: str) -> None:
    """Phase 12 (c): ``cli.main`` in this process, WAV in, ``-b 96k
    --ms``, to .aac and to .m4a (tests/test_io_cli.py's case: 1 s of
    24 kHz stereo tones); both decoded by ``heaac_tpu_torch.decode`` with
    its default device to the same PCM, the tone kept above SNR_MIN_DB."""
    import tempfile
    from heaac_tpu_torch import decode
    from heaac_tpu_torch.io.wav import write_wav
    rate = 24000
    t = np.arange(rate, dtype=np.float64) / rate
    pcm = np.stack([6000 * np.sin(2 * np.pi * 440 * t),
                    4000 * np.sin(2 * np.pi * 660 * t)], 1).astype(np.int16)
    outs = {}
    with tempfile.TemporaryDirectory() as tmp:
        src = os.path.join(tmp, "in.wav")
        write_wav(src, pcm, rate)
        for ext in (".aac", ".m4a"):
            dst = os.path.join(tmp, "out" + ext)
            rc, _, err, warns = cli_in_process(
                ["-i", src, "-b", "96k", "--ms", "--benchmark", dst])
            if rc != 0 or warns:
                raise SystemExit(f"phase 12 (c): cli to {ext}: rc {rc}, "
                                 f"warnings {warns}, {err}")
            with open(dst, "rb") as f:
                data = f.read()
            reset_launches(K)
            out, out_rate = decode(data)
            launches, rows = counts(K)
            rows_check(f"phase 12 (c) {ext}", rows, {})
            outs[ext] = (out.numpy(), out_rate, len(data),
                         json.loads(err.splitlines()[0]), launches)
    (a, ra, na, ma, ka), (b, rb, nb, mb, kb) = outs[".aac"], outs[".m4a"]
    snr = snr_db(pcm, a)
    print(f"cli -b 96k --ms: .aac {na} bytes {ma}, .m4a {nb} bytes {mb}; "
          f"decode on {card}: {a.shape} @ {ra} Hz and {b.shape} @ {rb} Hz, "
          f"equal {np.array_equal(a, b)}, SNR {snr:.1f} dB; K1 launches "
          f"{ka}, {kb}", flush=True)
    if (ra, rb) != (rate, rate) or not np.array_equal(a, b) \
            or not snr > SNR_MIN_DB or any(ka.values()) or any(kb.values()):
        raise SystemExit("phase 12 (c): the two containers decode apart or "
                         "the tone is lost")


def plan_tool():
    """tools/make_torch_plan_golden.py as a module: the plan golden's
    file and kinds, the graft entry's inputs (it imports the JAX package
    only inside its writer)."""
    spec = importlib.util.spec_from_file_location(
        "make_torch_plan_golden", os.path.join(REPO, "tools",
                                               "make_torch_plan_golden.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def lsb(a, b) -> int:
    return int(np.abs(np.asarray(a).astype(np.int32)
                      - np.asarray(b).astype(np.int32)).max())


def plan_decoders(K, card: str, bench: list, streams: list,
                  main4: dict) -> dict:
    """Phase 13 (a), (b), (e) and (f): the plan-record decoders over phase
    4's streams.  Returns K1's launches of each run and the PCM of (a)."""
    from heaac_tpu_torch.codec.batch import (BatchDecoder,
                                             QStreamBatchDecoder,
                                             QwirePipelinedDecoder,
                                             StreamBatchDecoder)
    from heaac_tpu_torch.parallel.sharding import ShardedStreamBatchDecoder
    tool = plan_tool()
    with np.load(tool.PLAN_GOLDEN) as z:
        gold = {k: z[k] for k in z.files}
    out = {}
    # (a), (b): compact and dense plans, timed in turns with the qwire
    # main path over the same streams
    decs = {}
    for name, compact in (("compact", True), ("dense", False)):
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        dec = StreamBatchDecoder(streams, compact=compact)
        build_s = time.perf_counter() - t0
        if dec.device.type != "cuda":
            raise SystemExit(f"default device is {dec.device}, not the card")
        t0 = time.perf_counter()
        dec.decode()                               # warm-up
        warm_s = time.perf_counter() - t0
        nbytes = dec.plan_bytes()
        held = torch.cuda.memory_allocated() - base
        peak = torch.cuda.max_memory_allocated() - base
        print(f"StreamBatchDecoder({name}): {LANES} streams parsed and "
              f"uploaded in {build_s:.3f} s, plans resident on the card "
              f"{nbytes} bytes ({nbytes / LANES / dec.T:.0f} a frame-lane), "
              f"card memory {held} bytes held, peak {peak} bytes over the "
              f"parse and warm-up ({warm_s:.3f} s)", flush=True)
        decs[name] = (dec, build_s)
    decs["qwire"] = (QwirePipelinedDecoder(streams, group_streams=LANES), 0.0)
    walls = {k: [] for k in decs}
    pcms, k1 = {}, {}
    for run, name in enumerate(("qwire", "compact", "dense", "dense",
                                "compact", "qwire")):
        dec = decs[name][0]
        reset_launches(K)
        t0 = time.perf_counter()
        pcm = dec.decode()
        torch.cuda.synchronize()
        walls[name].append(time.perf_counter() - t0)
        k1[name], rows = counts(K)
        # the plan-record decoders never call expand_frame
        rows_check(f"phase 13 (a, b) run {run} {name}", rows,
                   {0: pcm[0].shape[0]} if name == "qwire" else {})
        pcms[name] = (pcm[0] if name == "qwire" else pcm).cpu().numpy()
    T = pcms["compact"].shape[0]
    for name, (dec, build_s) in decs.items():
        audio_s = dec.audio_seconds()
        w = walls[name]
        print(f"{name}: {LANES} lanes x {T} frames, decode wall "
              + " / ".join(f"{x:.3f}" for x in w) + " s, realtime "
              + " / ".join(f"{audio_s / x:.1f}x" for x in w) + ", ms a "
              "frame " + " / ".join(f"{1e3 * x / T:.1f}" for x in w)
              + (f"; with the parse and upload ({build_s:.3f} s) "
                 f"{audio_s / (build_s + min(w)):.1f}x" if build_s else
                 " (parse and upload inside)")
              + f"; K1 {k1[name]}", flush=True)
    print(f"phase 4 in this call: realtime {main4['rt']:.1f}x, "
          f"{1e3 * main4['wall'] / T:.1f} ms a frame, on {card}", flush=True)
    for name in decs:
        if k1[name] != {30: T, 50: 0} or T != 50:
            raise SystemExit(f"phase 13: {name}: K1 launched {k1[name]} for "
                             f"{T} frames of 20-band PS")
    a = pcms["compact"]
    peak = np.abs(a.astype(np.int32)).max(axis=(0, 2, 3))
    if not (peak > 0).all():
        raise SystemExit(f"phase 13 (a): silent lanes "
                         f"{np.flatnonzero(peak == 0)}")
    cpu = {name: StreamBatchDecoder(bench, max_frames=GOLDEN_FRAMES,
                                    compact=name == "compact",
                                    device="cpu").decode().numpy()
           for name in ("compact", "dense")}
    checks = {}
    for name in ("compact", "dense"):
        p = pcms[name]
        checks[name] = (lsb(p[:GOLDEN_FRAMES, :8], cpu[name]),
                        lsb(p[:GOLDEN_FRAMES, :2],
                            gold[f"he20_{name}/pcm"][:GOLDEN_FRAMES]),
                        lsb(p, pcms["qwire"]), lsb(p, main4["pcm"]))
        print(f"{name}: lanes 0-7 x {GOLDEN_FRAMES} frames vs port CPU max "
              f"{checks[name][0]} LSB, lanes 0-1 vs JAX golden "
              f"{checks[name][1]}; all {LANES} lanes vs the qwire decode of "
              f"this phase {checks[name][2]}, vs phase 4's "
              f"{checks[name][3]}", flush=True)
    if max(max(c) for c in checks.values()) > TOL_LSB:
        raise SystemExit("phase 13 (a)/(b): card output differs from the "
                         "references")
    out.update(a=k1["compact"], b=k1["dense"], pcm_a=a)
    del decs, pcms
    torch.cuda.empty_cache()

    # (e) BatchDecoder over bench stream 0; QStreamBatchDecoder
    bd = BatchDecoder(bench[0], batch=LANES)
    t0 = time.perf_counter()
    bd.warmup()
    warm_s = time.perf_counter() - t0
    reset_launches(K)
    t0 = time.perf_counter()
    audio_s = bd.run()
    wall = time.perf_counter() - t0
    out["e_batch"], rows = counts(K)
    rows_check("phase 13 (e) BatchDecoder", rows, {})
    print(f"BatchDecoder: {LANES} copies of bench stream 0, {bd.T} frames, "
          f"wall {wall:.3f} s (warm-up {warm_s:.3f} s), realtime "
          f"{audio_s / wall:.1f}x, {1e3 * wall / bd.T:.1f} ms a frame; K1 "
          f"{out['e_batch']}", flush=True)
    if out["e_batch"] != {30: bd.T, 50: 0}:
        raise SystemExit("phase 13 (e): BatchDecoder's K1 count")
    del bd
    q = QStreamBatchDecoder(bench, max_frames=GOLDEN_FRAMES)
    reset_launches(K)
    t0 = time.perf_counter()
    qp = q.decode().cpu().numpy()
    wall = time.perf_counter() - t0
    out["e_qstream"], rows = counts(K)
    rows_check("phase 13 (e) QStreamBatchDecoder", rows, {0: GOLDEN_FRAMES})
    d = (lsb(qp[:, :2], gold["he20_compact/pcm"][:GOLDEN_FRAMES]),
         lsb(qp, a[:GOLDEN_FRAMES, :8]))
    print(f"QStreamBatchDecoder: 8 bench streams x {GOLDEN_FRAMES} frames "
          f"in {wall:.3f} s; K1 {out['e_qstream']}; lanes 0-1 vs JAX golden "
          f"max {d[0]} LSB, lanes 0-7 vs (a) {d[1]}", flush=True)
    if out["e_qstream"] != {30: GOLDEN_FRAMES, 50: 0} or max(d) > TOL_LSB:
        raise SystemExit("phase 13 (e): QStreamBatchDecoder's K1 count or "
                         "PCM")

    # (f) sharded: two shards on cuda:0, and across two cards
    out["f"] = {}
    pairs = [["cuda:0", "cuda:0"]]
    if torch.cuda.device_count() >= 2:
        pairs.append(["cuda:0", "cuda:1"])
    for devices in pairs:
        dec = ShardedStreamBatchDecoder(streams, devices=devices,
                                        max_frames=GOLDEN_FRAMES)
        reset_launches(K)
        t0 = time.perf_counter()
        pcm, calls = k1_calls(dec.decode, key=lambda x: str(x[0].device))
        wall = time.perf_counter() - t0
        rows_check(f"phase 13 (f) on {'+'.join(devices)}", counts(K)[1], {})
        per_card = {c: calls.count(c) for c in sorted(set(calls))}
        d = lsb(pcm.numpy(), a[:GOLDEN_FRAMES])
        print(f"ShardedStreamBatchDecoder on {devices}: {LANES} lanes x "
              f"{GOLDEN_FRAMES} frames in {wall:.3f} s; K1 {dict(K.launches)}"
              f", per card {per_card}; vs (a) max {d} LSB", flush=True)
        names = [str(d) for d in dec.devices]
        want = {c: GOLDEN_FRAMES * names.count(c) for c in names}
        if dict(K.launches) != {30: 2 * GOLDEN_FRAMES, 50: 0} or \
                per_card != want or d > 1:
            raise SystemExit(f"phase 13 (f) on {devices}: K1 counts or PCM "
                             "differ")
        out["f"]["+".join(devices)] = per_card
        del dec
    return out


def plan_34band(K, files: dict) -> dict:
    """Phase 13 (d): StreamBatchDecoder over LANES lanes tiled from the 8
    34-band streams, GOLDEN_FRAMES frames: K1 once a frame at napb 50;
    lanes 0-1 within TOL_LSB of the JAX golden."""
    from heaac_tpu_torch.codec.batch import StreamBatchDecoder
    with np.load(plan_tool().PLAN_GOLDEN) as z:
        gold = z["he34_compact/pcm"][:GOLDEN_FRAMES]
    streams = [bytes(bytearray(files["he34"][i % 8])) for i in range(LANES)]
    dec = StreamBatchDecoder(streams, max_frames=GOLDEN_FRAMES)
    reset_launches(K)
    t0 = time.perf_counter()
    pcm = dec.decode().cpu().numpy()
    wall = time.perf_counter() - t0
    launches, rows = counts(K)
    rows_check("phase 13 (d)", rows, {})
    d = lsb(pcm[:, :2], gold)
    print(f"StreamBatchDecoder 34-band: {LANES} lanes x {GOLDEN_FRAMES} "
          f"frames (first run) in {wall:.3f} s; K1 {launches}; lanes 0-1 vs "
          f"JAX golden max {d} LSB", flush=True)
    if launches != {30: 0, 50: GOLDEN_FRAMES} or d > TOL_LSB:
        raise SystemExit("phase 13 (d): K1 counts or PCM differ")
    return launches


def graft_frame(K) -> dict:
    """Phase 13 (g): heaac_frame_compact on the graft entry's synthetic
    compact records at 64 lanes, the card against the port's CPU run
    (within TOL_LSB) and the JAX golden's first lanes."""
    from heaac_tpu_torch.codec import compact_plan, heaac_graph
    tool = plan_tool()
    B = 64
    inputs = tool.graft_compact_inputs(compact_plan, B)
    pcms = {}
    for dev in ("cuda", "cpu"):
        core, sc, pc = ({k: torch.from_numpy(v).to(dev) for k, v in d.items()}
                        for d in inputs)
        reset_launches(K)
        pcm, _ = heaac_graph.heaac_frame_compact(
            core, sc, pc, heaac_graph.init_compact_state(B, dev))
        if "card" not in pcms:
            launches, rows = counts(K)
            rows_check("phase 13 (g)", rows, {})
        pcms["card" if "card" not in pcms else "cpu"] = pcm.cpu().numpy()
    with np.load(tool.PLAN_GOLDEN) as z:
        gold = z["graft/pcm"]
    d_cpu = float(np.abs(pcms["card"] - pcms["cpu"]).max())
    d_gold = float(np.abs(pcms["card"][:len(gold)] - gold).max())
    print(f"heaac_frame_compact on the graft entry's records, {B} lanes: "
          f"max |card - CPU| {d_cpu:.4f}, vs JAX golden (lanes "
          f"0-{len(gold) - 1}) {d_gold:.4f}, peak "
          f"{np.abs(pcms['card']).max():.1f}; K1 {launches}", flush=True)
    if max(d_cpu, d_gold) > TOL_LSB or launches != {30: 1, 50: 0}:
        raise SystemExit("phase 13 (g): graft frame differs or K1 count")
    return launches


def bench_entry(K, card: str, main4: dict) -> int:
    """Phase 14: the port's benchmark entry, ``heaac_tpu_torch.bench.run``
    in this process with its default device, LANES distinct HE-AAC v2
    streams (bench.py's recipe: SBR inverse filtering 0-3), BENCH_REPS
    timed decodes.  Its JSON line is printed by the run.  Checks K1 at
    napb 30 once per frame of every decode (the warm-up, one device-only
    scan per group, the FLOP count's scan and the timed decodes) and
    never at 50, every lane of the last decode non-silent, every number
    of the line finite and not negative, and its device this card.
    Prints its figures beside phase 4's realtime and the card memory
    peak.  Returns K1's napb-30 launches."""
    import math
    from heaac_tpu_torch import bench
    reset_launches(K)
    line, outs = bench.run(LANES, BENCH_REPS)
    launches, rows = counts(K)
    peak_mem = torch.cuda.max_memory_allocated()
    T = outs[0].shape[0]
    ngroups = -(-LANES // line["group"])
    decodes = 1 + ngroups + 1 + BENCH_REPS
    print(f"benchmark entry: {LANES} distinct streams x {T} frames, "
          f"{BENCH_REPS} reps: sustained {line['value']}x, best "
          f"{line['best_x']}x, median {line['median_x']}x, parse-only "
          f"{line['parse_only_x']}x, device-only {line['device_only_x']}x, "
          f"mfu_f32 {line['mfu_f32']}, wire "
          f"{line['wire_bytes_per_frame_lane']} B a frame-lane; card "
          f"memory peak {peak_mem} bytes; phase 4 (this call) "
          f"{main4['rt']:.1f}x; K1 {launches} over {decodes} decodes; on "
          f"{card}", flush=True)
    if T != 50 or launches != {30: decodes * T, 50: 0}:
        raise SystemExit(f"phase 14: K1 launched {launches} for {decodes} "
                         f"decodes of {T} frames of 20-band PS")
    rows_check("phase 14", rows, {0: decodes * T})
    peak = outs[0].abs().amax(dim=(0, 2, 3)).cpu().numpy()
    if not (peak > 0).all():
        raise SystemExit(f"phase 14: silent lanes {np.flatnonzero(peak == 0)}")
    numbers = [v for k, v in line.items() if k not in ("metric", "unit",
                                                        "device")]
    if not all(isinstance(v, (int, float)) and math.isfinite(v) and v >= 0
               for v in numbers):
        raise SystemExit(f"phase 14: a field is missing, negative or not "
                         f"finite: {line}")
    if not card.startswith(line["device"]["name"] + ","):
        raise SystemExit(f"phase 14: the line names {line['device']}, the "
                         f"card is {card}")
    return launches[30]


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False")
    sys.path.insert(0, REPO)
    from heaac_tpu_torch import native
    from heaac_tpu_torch.codec.batch import QwirePipelinedDecoder
    from heaac_tpu_torch.ops import ps_decorrelate as K
    from heaac_tpu_torch.ops import qwire_rows

    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"card: {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, python {sys.version.split()[0]}",
          flush=True)
    t_phase = time.perf_counter()

    def phase_done(name: str) -> None:
        nonlocal t_phase
        now = time.perf_counter()
        print(f"phase {name}: {now - t_phase:.2f} s", flush=True)
        t_phase = now

    # ---- 2. build -----------------------------------------------------------
    ys = Yardstick(build_all(K, qwire_rows, native))
    phase_done("2 build")

    # ---- 3. kernel checks ---------------------------------------------------
    krows, worst = kernel_check(K, ys)
    bench = [open(os.path.join(REPO, "benchdata",
                               f"heaac_bench_stream_{i}.aac"), "rb").read()
             for i in range(8)]
    files = read_streams()
    rows_entry = rows_kernel_check(card, bench, files["he_v1s"])
    phase_done("3 kernel checks")

    # ---- 4. main path -------------------------------------------------------
    streams = [bytes(bench[i % 8]) for i in range(LANES)]
    dec = QwirePipelinedDecoder(streams, group_streams=LANES)
    if dec.device.type != "cuda":
        raise SystemExit(f"default device is {dec.device}, not the card")
    t0 = time.perf_counter()
    dec.decode()                                   # warm-up (cuBLAS, consts)
    warm_s = time.perf_counter() - t0
    reset_launches(K)
    t0 = time.perf_counter()
    outs = dec.decode()
    wall = time.perf_counter() - t0
    launches = K.launches[30]
    rows = counts(K)[1]
    pcm = outs[0].cpu().numpy()                    # [T, L, 2, 2048] int16
    T = pcm.shape[0]
    rows_check("phase 4", rows, {0: T})
    audio_s = dec.audio_seconds()
    main_rt = audio_s / wall
    print(f"main path: {LANES} lanes x {T} frames, audio {audio_s:.3f} s, "
          f"wall {wall:.3f} s (warm-up {warm_s:.3f} s), realtime "
          f"{main_rt:.1f}x on {card}; K1 launches {launches}",
          flush=True)
    if launches != T or K.launches[50]:
        raise SystemExit(f"K1 launched {K.launches} times (napb: count) "
                         f"for {T} frames of 20-band PS")
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
    main4 = dict(pcm=pcm, wall=wall, rt=main_rt)    # phase 11 compares
    phase_done("4 main path")

    # ---- 5. mixed batch through decode_batch -------------------------------
    mixed = mixed_batch(K, card, files)
    phase_done("5 mixed batch")

    # ---- 6. stereo main path ------------------------------------------------
    stereo30 = stereo_main_path(K, card, files)
    phase_done("6 stereo main path")

    # ---- 7. flip path -------------------------------------------------------
    flip_a = flip_batch(K, card, bench)
    flip_b = flip_full_width(K, card)
    print(f"realtime: flip scan {flip_b['realtime']:.1f}x, main path "
          f"(phase 4) {main_rt:.1f}x, {LANES} lanes x 50 frames each",
          flush=True)
    phase_done("7 flip path")

    # ---- 8. LC planner, Python prober, downsampled SBR ---------------------
    lc_a = lc_prober_batch(K, card, bench)
    ds_b = downsampled_full_width(K, card)
    print(f"realtime: downsampled scan {ds_b['realtime']:.1f}x, main path "
          f"(phase 4) {main_rt:.1f}x, {LANES} lanes x 50 frames each",
          flush=True)
    phase_done("8 LC planner, prober and downsampled SBR")

    # ---- 9. the single-stream Decoder --------------------------------------
    k1_b1 = k1_one_lane(K)        # before the profile of a whole stream
    single_a = single_fallback_batch(K, card, bench)
    single_b = single_streams(K, card)
    phase_done("9 single-stream decoder")

    # ---- 10. the front doors -------------------------------------------------
    front_a = front_m4a_decodes(K, card)
    front_b = front_cli(K, card)
    phase_done("10 front doors")

    # ---- 11. the parallel layer ---------------------------------------------
    shard_a = sharded_full_width(K, card, streams, main4, ["cuda:0"] * 2)
    shard_b = sharded_cut(K, card, files)
    multi_c = multihost_run(card, bench, "gloo", ["cuda:0"] * 2)
    shard_d = multi_d = None
    if torch.cuda.device_count() >= 2:
        shard_d = sharded_full_width(K, card, streams, main4,
                                     ["cuda:0", "cuda:1"])
        multi_d = multihost_run(card, bench, "nccl", [None, None])
    else:
        print("cross-card: not measured (1 card)", flush=True)
    phase_done("11 parallel layer")

    # ---- 12. the encode direction and the stream generators ---------------
    encode_cases(K, card)
    distinct30 = distinct_streams(K, card, main4)
    encode_cli(K, card)
    phase_done("12 encoder, generators and the encode CLI")

    # ---- 13. the plan-record decoders ---------------------------------------
    plans = plan_decoders(K, card, bench, streams, main4)
    plans["d"] = plan_34band(K, files)
    plans["g"] = graft_frame(K)
    phase_done("13 plan-record decoders")

    # ---- 14. the benchmark entry --------------------------------------------
    bench30 = bench_entry(K, card, main4)
    phase_done("14 benchmark entry")

    row = dict(krows[30])
    row.pop("max_abs_err")
    print(json.dumps({"kernels": [{
        "name": "ps_decorrelate", "route": "cuda",
        "source": "heaac_tpu_torch/csrc/ps_decorrelate.cu",
        "replaces": "heaac_tpu/ops/ps_pallas.py:31",
        "launches": launches, "max_abs_err": worst, **row,
        "library_ms": None, "napb50": krows[50],
        "launches_napb50": mixed[50],
        "launches_napb50_path": "phase 5: decode_batch, 34-band bucket "
                                f"({MIXED_LANES} streams)",
        "launches_phase5_napb30": mixed[30],
        "launches_phase5_napb30_path": "phase 5: decode_batch, 20-band, "
                                       "stereo HE-AAC v1 and coupling-"
                                       "channel buckets",
        "launches_phase6_napb30": stereo30,
        "launches_phase6_napb30_path": "phase 6: QwirePipelinedDecoder, "
                                       f"{GROUP_LANES} stereo HE-AAC v1 "
                                       "streams",
        "launches_phase7a_napb30": flip_a[30],
        "launches_phase7a_napb50": flip_a[50],
        "launches_phase7a_path": "phase 7 (a): decode_batch, 4 flip "
                                 "streams, the flip + coupling stream "
                                 "and 8 20-band streams",
        "launches_phase7b_napb30": flip_b["launches"][30],
        "launches_phase7b_napb50": flip_b["launches"][50],
        "launches_phase7b_path": f"phase 7 (b): qwire_scan_decode_flip, "
                                 f"{LANES} lanes x 50 frames",
        "launches_phase8a_napb30": lc_a[30],
        "launches_phase8a_path": "phase 8 (a): decode_batch, 64 AAC-LC + "
                                 "CCE streams (no SBR: no K1), 2 streams "
                                 "the Python prober buckets and 8 20-band "
                                 "streams (one HE group)",
        "launches_phase8b_napb30": ds_b["launches"][30],
        "launches_phase8b_path": "phase 8 (b): qwire_scan_decode("
                                 f"downsampled=1), {LANES} lanes x 50 "
                                 "frames",
        "launches_phase9a_napb30": single_a[30],
        "launches_phase9a_path": "phase 9 (a): decode_batch, 2 streams "
                                 "with a corrupt frame 0 (single-stream "
                                 "Decoder, PS never starts: no K1) and 8 "
                                 "20-band streams (one HE group)",
        "launches_phase9b_napb30": single_b["launches"][30],
        "launches_phase9b_napb50": single_b["launches"][50],
        "launches_phase9b_path": "phase 9 (b): the single-stream Decoder, "
                                 "K1 at B=1 once per PS frame: "
                                 + ", ".join(SINGLE) + ", 50 frames each",
        "launches_phase10a_napb30": front_a[30],
        "launches_phase10a_napb50": front_a[50],
        "launches_phase10a_path": "phase 10 (a): heaac_tpu_torch.decode on "
                                  ".m4a inputs (" + ", ".join(FRONT_M4A)
                                  + "), K1 at B=1 once per PS frame",
        "launches_phase10b_napb30": front_b[30],
        "launches_phase10b_path": "phase 10 (b): python -m "
                                  "heaac_tpu_torch.cli --benchmark on bench "
                                  "stream 0 (decode_batch, one lane)",
        "launches_phase11a_napb30": shard_a["launches"][30],
        "launches_phase11a_path": "phase 11 (a): ShardedQwireDecoder, "
                                  f"{LANES} streams on [cuda:0, cuda:0] "
                                  "(2 shards of 256 lanes x 50 frames)",
        "launches_phase11b_napb30": shard_b[30],
        "launches_phase11b_path": "phase 11 (b): ShardedQwireDecoder on "
                                  "cuda:0, 6 stereo streams over 4 shards "
                                  "and 4 coupling streams over 8 (4 with "
                                  f"lanes), {GOLDEN_FRAMES} frames",
        "launches_phase11c_napb30": multi_c[30],
        "launches_phase11c_path": "phase 11 (c): 2 processes of "
                                  "heaac_tpu_torch.parallel.multihost on "
                                  "cuda:0 (gloo), 4 streams x 50 frames "
                                  "each",
        "launches_phase11d_napb30": shard_d and shard_d["per_card"],
        "launches_phase11d_nccl_napb30": multi_d and multi_d[30],
        "launches_phase11d_path": "phase 11 (d): (a) on [cuda:0, cuda:1], "
                                  "per card, and (c) with NCCL, one card a "
                                  "rank; null: not measured (1 card)",
        "launches_phase12b_napb30": distinct30,
        "launches_phase12b_napb30_path": "phase 12 (b): "
                                         "QwirePipelinedDecoder, "
                                         f"{LANES} distinct HE-AAC v2 "
                                         "streams made by the port's "
                                         "generators x 50 frames, the "
                                         "last timed distinct run",
        "launches_phase13a_napb30": plans["a"][30],
        "launches_phase13a_path": "phase 13 (a): StreamBatchDecoder "
                                  f"(compact), {LANES} lanes x 50 frames",
        "launches_phase13b_napb30": plans["b"][30],
        "launches_phase13b_path": "phase 13 (b): StreamBatchDecoder "
                                  f"(dense), {LANES} lanes x 50 frames",
        "launches_phase13d_napb50": plans["d"][50],
        "launches_phase13d_path": "phase 13 (d): StreamBatchDecoder, "
                                  f"{LANES} 34-band lanes x "
                                  f"{GOLDEN_FRAMES} frames",
        "launches_phase13e_napb30": [plans["e_batch"][30],
                                     plans["e_qstream"][30]],
        "launches_phase13e_path": f"phase 13 (e): BatchDecoder, {LANES} "
                                  "copies x 50 frames; QStreamBatchDecoder, "
                                  f"8 streams x {GOLDEN_FRAMES} frames",
        "launches_phase13f_napb30": plans["f"],
        "launches_phase13f_path": "phase 13 (f): ShardedStreamBatchDecoder, "
                                  f"{LANES} lanes x {GOLDEN_FRAMES} frames "
                                  "in 2 shards, per card",
        "launches_phase13g_napb30": plans["g"][30],
        "launches_phase13g_path": "phase 13 (g): heaac_frame_compact on "
                                  "the graft entry's records, 64 lanes",
        "launches_phase14_napb30": bench30,
        "launches_phase14_napb30_path": "phase 14: heaac_tpu_torch.bench, "
                                        f"{LANES} distinct streams x 50 "
                                        "frames: warm-up, device-only, FLOP "
                                        f"count and {BENCH_REPS} timed "
                                        "decodes",
        "b1": k1_b1}, {
        "name": "qwire_rows", "route": "cuda",
        "source": "heaac_tpu_torch/csrc/qwire_rows.cu",
        "replaces": "heaac_tpu_torch/ops/sbr_huff.py decode_sbr_rows + "
                    "heaac_tpu_torch/ops/ps_huff.py decode_ps_region "
                    "(plain torch ops; no pallas_call)",
        "launches": ROWS_SEEN["phase 4"][0], **rows_entry,
        "library_ms": None, "launches_by_path": ROWS_SEEN}]}))
    if ROWS_WRONG:
        raise SystemExit(f"row-kernel launches differ from the qwire frame "
                         f"steps (path, launches, expected): {ROWS_WRONG}")
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
