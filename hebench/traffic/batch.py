"""Batched closed loop: one caller runs ``heaac_tpu_torch.decode_batch``
back to back on the configuration's streams, on the card.

Set-up: the streams from the seed (in spawned processes), one warm-up
call (it builds what the program builds and compiles nothing later).
Window: calls until ``--seconds`` have passed; each call ends when its
CPU int16 PCM is returned.  ``realtime_x`` is all the audio the window's
calls returned over the wall time from the window's start to the end of
its last call.  Every stream of every call is held to its length; a
sample of streams drawn from the seed is kept from every call for the
reference.

``--trace 1``: after set-up, one call with the card's activity alone
profiled (the traced window: busy and idle shares, launches, kernel
times), one with the host's operations too (only to name the idle
gaps; recording them stretches the call about 2.2x), both checked; then,
with the harness's clock, the host parse alone of every group
(``parse_walk``) and a whole decode with the streams already probed
(``scan``), both through the decoder that ``decode_batch`` builds for
this bucket (``QwirePipelinedDecoder`` with its own grouping); left out
where the traced call had an AAC-LC bucket, which that decoder does not
serve.

Mix parameters: ``invf_modes`` (the SBR writer's inverse filtering
modes), ``check_streams``, ``limits``; ``streams``, the streams a call,
where the mix fixes them (a cell's own count, or a test's smaller one),
else the configuration's.  Any configuration that ``decode_batch``
decodes runs here: the samples a frame follow from its rates, and K1's
inputs are handed to the readers only where it has PS (``ps_bands``).
"""
from __future__ import annotations

import logging
import time

import numpy as np

from .. import harness
from ..arith import K1_NAPB
from ..gen import make_streams

# seconds into a traced run after which the call that only names the
# idle gaps (~85 s at 512 streams: a stretched call, 3.6 million records
# to read) is left out, so that a slow host still ends the run in 360 s
GAP_TRACE_UNTIL_S = 150


class _Stats(logging.Handler):
    """Collects the program's ``bucket_stats`` log records."""

    def __init__(self):
        super().__init__(logging.INFO)
        self.records = []

    def emit(self, record):
        st = getattr(record, "bucket_stats", None)
        if st is not None:
            self.records.append(st)


def samples_per_frame(cfg: dict) -> int:
    """Output samples a frame: the core's 1024, times 2 where SBR
    doubles the rate (every HE configuration), times 1 for AAC-LC."""
    return 1024 * cfg["output_rate"] // cfg["core_rate"]


def _expected_rows(streams: list, spf: int) -> list:
    from ..ref.bitstream.adts import split_adts_stream
    return [len(split_adts_stream(s)) * spf for s in streams]


def run(ctx: harness.Context) -> harness.Outcome:
    import torch

    import heaac_tpu_torch
    from heaac_tpu_torch.utils.metrics import log as prog_log

    cfg, mix = ctx.config, ctx.mix
    dev = torch.device(ctx.device)
    n = mix["streams"] if "streams" in mix else cfg["streams"]
    t = time.perf_counter()
    streams = make_streams(ctx.root, cfg["generator"], n, ctx.seed,
                           mix["invf_modes"], ctx.workers)
    harness.log(f"streams: {n} made in {time.perf_counter() - t:.3f} s")
    spf = samples_per_frame(cfg)
    rows = _expected_rows(streams, spf)
    ch = cfg["output_channels"]
    rate = cfg["output_rate"]
    rng = np.random.default_rng(ctx.seed % (1 << 63))
    sample = sorted(rng.choice(n, size=min(mix["check_streams"], n),
                               replace=False).tolist())

    def call():
        outs = heaac_tpu_torch.decode_batch(streams, device=dev)
        bad = sum(tuple(o.shape) != (r, ch) for o, r in zip(outs, rows))
        audio = sum(o.shape[0] for o in outs) / rate
        return outs, bad, audio

    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    t = time.perf_counter()
    call()                                              # warm-up
    harness.log(f"warm-up call: {time.perf_counter() - t:.3f} s")
    setup_s = harness.setup_done(ctx)

    kept = [[] for _ in sample]
    attempted = failed = 0
    data: dict = {}
    if not ctx.trace:
        audio = 0.0
        w0 = time.perf_counter()
        walls = []
        while True:
            t = time.perf_counter()
            outs, bad, a = call()
            walls.append(time.perf_counter() - t)
            attempted += n
            failed += bad
            audio += a
            for k, i in enumerate(sample):
                kept[k].append(outs[i].numpy())
            del outs
            wall = time.perf_counter() - w0
            if wall >= ctx.seconds:
                break
        harness.log(f"window: {len(walls)} calls, {audio:.3f} s of audio in "
                    f"{wall:.3f} s; calls {[round(w, 3) for w in walls]} s")
        e2e = {"realtime_x": audio / wall, "setup_s": setup_s}
    else:
        from .. import devtrace
        stats = _Stats()
        prog_log.addHandler(stats)
        prev_level = prog_log.level
        prog_log.setLevel(logging.INFO)
        traced = {}
        try:
            for key, host_ops in (("trace", False), ("gap_trace", True)):
                if host_ops and \
                        time.perf_counter() - ctx.t0 > GAP_TRACE_UNTIL_S:
                    harness.log("the call that names the idle gaps is left "
                                f"out: {GAP_TRACE_UNTIL_S} s have passed")
                    break
                stats.records.clear()
                with devtrace.capture(dev, host_ops=host_ops) as box:
                    outs, bad, audio = call()
                attempted += n
                failed += bad
                for k, i in enumerate(sample):
                    kept[k].append(outs[i].numpy())
                del outs
                data[key] = box["trace"]
                traced[key] = round(data[key].window_s, 3)
                if key == "trace":
                    data["steps"] = sum(r["steps"] for r in stats.records)
                    qwire = all(r["key"][0] != "lc" for r in stats.records)
        finally:
            prog_log.removeHandler(stats)
            prog_log.setLevel(prev_level)
        tr = data["trace"]
        harness.log(f"traced calls: {traced} s, {audio:.3f} s of audio "
                    f"each; {tr.launches()} kernel launches")
        if "ps_bands" in cfg:
            data.update(k1_lane_frames=sum(rows) // spf
                        * cfg["core_channels"],
                        k1_napb=K1_NAPB[cfg["ps_bands"]])
        if qwire:
            data.update(_parse_and_scan(streams, dev))
        e2e = {}
    peak = int(torch.cuda.max_memory_allocated(dev)) if dev.type == "cuda" \
        else 0
    return harness.Outcome(
        attempted=attempted, failed=failed, e2e=e2e,
        memory_peak_bytes=peak, streams=[streams[i] for i in sample],
        pcm=kept, data=data)


def _parse_and_scan(streams: list, dev) -> dict:
    """Harness clocks around the host parse of every group, walked as
    the decoder walks them, and around the decoder's whole ``decode()``
    (the first group's parse, the uploads and every group's scan, the
    later groups' parse overlapped with it), synchronised."""
    import torch

    from heaac_tpu_torch.codec.batch import QwirePipelinedDecoder

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    dec = QwirePipelinedDecoder(streams, device=dev)
    ngroups = len(dec.group_T)
    dec.frame_counts = []
    dec.error_count = 0
    t = time.perf_counter()
    for g in range(ngroups):
        dec._parse_with_retry(g)
    parse_s = time.perf_counter() - t
    frames = sum(dec.frame_counts)
    sync()
    t = time.perf_counter()
    outs = dec.decode()
    sync()
    scan_s = time.perf_counter() - t
    del outs
    steps = sum(dec.group_T)
    harness.log(f"parse walk: {parse_s:.4f} s for {frames} frames of "
                f"{ngroups} groups; decode: {scan_s:.4f} s for {steps} "
                f"steps")
    return dict(parse_walk_s=parse_s, parse_walk_frames=frames,
                scan_s=scan_s, scan_steps=steps)
