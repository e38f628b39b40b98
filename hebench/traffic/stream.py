"""Single-stream closed loop: one caller plays one stream at a time
through the program's single-stream ``Decoder`` on the card, frame by
frame, as a player, a radio monitor or a one-file transcoder does.

Set-up: a pool of distinct streams from the seed (in spawned
processes), split into ADTS frames; one whole stream decoded as a
warm-up.  Window: streams in order (the pool again from its start if
the window outlasts it), each with a fresh ``Decoder(adts_probe=<its
first 7 bytes>)``, ``decode_frame`` on every frame; each call ends with
its CPU int16 PCM.  The window closes at the first frame boundary after
``--seconds``.  ``frame_p95_ms`` is the 95th percentile of every call's
wall time; ``realtime_x`` all the audio returned over the wall time from
the window's start to the end of its last call (decoder construction
included).  The streams decoded whole in the window are the ones a
sample drawn from the seed is checked from.

``--trace 1``: the same window (its audio and wall handed to the
readers, for ``realtime_x.single``), then ``trace_streams`` whole
streams with the card's activity alone profiled (the traced window:
busy and idle shares, launches), then the same streams with the host's
operations too (only to name the idle gaps); the PCM of all is checked.

Mix parameters: ``streams`` (the pool), ``invf_modes`` (the SBR
writer's inverse filtering modes), ``check_streams``, ``trace_streams``,
``limits``; ``frames`` (optional) keeps each stream's first frames.
"""
from __future__ import annotations

import time

import numpy as np

from .. import harness
from ..arith import percentile
from ..gen import make_streams
from ..ref.bitstream.adts import split_adts_stream


def run(ctx: harness.Context) -> harness.Outcome:
    import torch

    from heaac_tpu_torch import Decoder

    cfg, mix = ctx.config, ctx.mix
    dev = torch.device(ctx.device)
    n = mix["streams"]
    t = time.perf_counter()
    streams = make_streams(ctx.root, cfg["generator"], n, ctx.seed,
                           mix["invf_modes"], ctx.workers)
    # ``frames`` cuts every stream to its first frames (the tests)
    frames = [split_adts_stream(s)[:mix.get("frames")] for s in streams]
    streams = [b"".join(f) for f in frames]
    harness.log(f"streams: {n} made in {time.perf_counter() - t:.3f} s")
    rate = cfg["output_rate"]

    def play(i: int) -> np.ndarray:
        fr = frames[i]
        dec = Decoder(adts_probe=fr[0][:7], device=dev)
        return np.concatenate([dec.decode_frame(f).numpy() for f in fr])

    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    t = time.perf_counter()
    play(0)                                             # warm-up
    harness.log(f"warm-up stream: {time.perf_counter() - t:.3f} s")
    setup_s = harness.setup_done(ctx)

    whole: dict = {}                  # stream index -> its PCM copies
    data: dict = {}
    times: list = []
    audio = 0.0
    w0 = time.perf_counter()
    k = 0
    done = False
    walls: list = []                  # each stream's wall, for the log
    while not done:
        i = k % n
        fr = frames[i]
        s0 = time.perf_counter()
        dec = Decoder(adts_probe=fr[0][:7], device=dev)
        out = []
        for f in fr:
            t = time.perf_counter()
            pcm = dec.decode_frame(f)
            times.append(time.perf_counter() - t)
            out.append(pcm.numpy())
            audio += pcm.shape[0] / rate
            if time.perf_counter() - w0 >= ctx.seconds:
                done = True
                break
        walls.append(round(time.perf_counter() - s0, 3))
        if len(out) == len(fr):
            whole.setdefault(i, []).append(np.concatenate(out))
        k += 1
    wall = time.perf_counter() - w0
    harness.log(f"window: {len(times)} frames of {k} streams, "
                f"{audio:.3f} s of audio in {wall:.3f} s; "
                f"frame p50 {percentile(times, 50) * 1e3:.3f} ms, "
                f"p95 over {len(times)} samples, max "
                f"{max(times) * 1e3:.3f} ms, "
                f"{sum(x > 0.05 for x in times)} frames over 50 ms; "
                f"streams {walls} s")
    e2e = {"realtime_x": audio / wall,
           "frame_p95_ms": percentile(times, 95) * 1e3,
           "setup_s": setup_s}
    data.update(window_audio_s=audio, window_wall_s=wall)
    attempted = len(times)
    if ctx.trace:
        from .. import devtrace
        m = mix["trace_streams"]
        for key, host_ops in (("trace", False), ("gap_trace", True)):
            with devtrace.capture(dev, host_ops=host_ops) as box:
                for i in range(m):
                    whole.setdefault(i, []).append(play(i))
            data[key] = box["trace"]
        tr = data["trace"]
        nfr = sum(len(frames[i]) for i in range(m))
        harness.log(f"traced: {m} streams, {nfr} frames in "
                    f"{tr.window_s:.3f} s (card only), "
                    f"{data['gap_trace'].window_s:.3f} s (host operations "
                    f"too); {tr.launches()} kernel launches")
        data["frames"] = nfr
        attempted += 2 * nfr
    peak = int(torch.cuda.max_memory_allocated(dev)) if dev.type == "cuda" \
        else 0
    rng = np.random.default_rng(ctx.seed % (1 << 63))
    done_idx = sorted(whole)
    pick = sorted(rng.choice(done_idx, size=min(mix["check_streams"],
                                                len(done_idx)),
                             replace=False).tolist()) if done_idx else []
    return harness.Outcome(
        attempted=attempted, failed=0, e2e=e2e, memory_peak_bytes=peak,
        streams=[streams[i] for i in pick], pcm=[whole[i] for i in pick],
        data=data)
