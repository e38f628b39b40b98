"""Decode over several processes: each decodes its own streams, and the
processes share exactly one collective, an all-reduce of the decode
metrics.

Counterpart of ``heaac_tpu/parallel/multihost.py``.  Streams are
independent, so each process (one per host, or one per card) parses and
decodes its shard with ``QwirePipelinedDecoder`` on its own device and
can keep the shard's int16 PCM on its own host; no audio crosses
processes.  The one all-reduce (SUM over the process
group) carries [frames, errors, audio seconds, devices], so every
process ends with the same global metrics.

Run as a module, one process per rank:

    python -m heaac_tpu_torch.parallel.multihost --coordinator HOST:PORT \\
        --num-processes N --process-id K --streams-dir DIR \\
        [--device cuda:K] [--backend nccl|gloo]

The coordinator is rank 0's TCP store (``torch.distributed``'s
``tcp://`` rendezvous).  Rank K decodes the sorted ``DIR/*.aac`` whose
index i has ``i % N == K``.  The device defaults to card K modulo the
visible cards and the backend to NCCL on a card, gloo on the CPU
(``--device cpu``).  NCCL needs a card of its own for every rank on a
host; gloo all-reduces a CPU tensor and also serves ranks that share a
card.  The last line printed is the global metrics as JSON, with
``process_id`` and ``num_devices`` (the all-reduced count of devices
that decoded, one per rank); the line before it gives the rank's device,
its K1 launches per napb, its row-decoder kernel's launches per ``pair``
and its decode seconds.

Differences from the JAX package: the process group gets its address,
size and rank from the arguments (``--cpu-devices``, XLA's virtual
devices, has no counterpart: ``--device cpu``); the metrics are reduced
in float64, where JAX sums float32 (exact counts up to 2**53 frames);
``decode_shard_and_reduce``'s ``pcm_out`` hands back the shard's PCM,
where the JAX function discards it.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import torch
import torch.distributed as dist

from ..codec.batch import QwirePipelinedDecoder
from ..device import resolve
from ..ops import ps_decorrelate, qwire_rows
from ..utils.trace import count, span


def decode_shard_and_reduce(streams_local, device="cuda",
                            info_out: dict | None = None,
                            pcm_out: list | None = None) -> dict:
    """Decode this process's streams on ``device`` (one group), then
    all-reduce the metrics over the default process group.  Returns the
    global metrics (the same on every rank): ``frames``, ``errors``,
    ``audio_seconds``, and this process's ``process_frames``.  An empty
    shard adds zeros.  With ``info_out`` it also receives
    ``num_devices``, the all-reduced count of ranks' devices, and
    ``decode_s``, this process's seconds from the decoder's construction
    to the end of its decode (the all-reduce not included).  With
    ``pcm_out`` (a list) it also receives one CPU int16 tensor [n, ch]
    per local stream, in ``streams_local``'s order, as ``decode_batch``
    gives it; the PCM reaches the host before the all-reduce.  Call
    after call in one process group reuses the process's step graphs.

    Spans: ``multihost.decode`` (attrs ``rank``, ``streams``,
    ``frames``: parse through the PCM on the host), under it
    ``multihost.pcm`` (the copy to the host and the per-stream split),
    then ``multihost.allreduce`` (the collective, with the wait for the
    slowest rank).  Counters ``multihost.calls``, ``multihost.streams``,
    ``multihost.frames`` (this process's)."""
    dev = resolve(device)
    frames = errors = 0
    audio_s = 0.0
    t0 = time.perf_counter()
    with span("multihost.decode", rank=dist.get_rank(),
              streams=len(streams_local)) as sp:
        if streams_local:
            dec = QwirePipelinedDecoder(streams_local,
                                        group_streams=len(streams_local),
                                        device=dev)
            outs = dec.decode()
            if pcm_out is not None:
                with span("multihost.pcm"):
                    pcm_out.extend(dec.stream_pcm(outs))
            del outs
            frames = int(sum(dec.frame_counts))
            errors = int(dec.error_count)
            audio_s = float(dec.audio_seconds())
        sp.set(frames=frames)
    decode_s = time.perf_counter() - t0
    count("multihost.calls")
    count("multihost.streams", len(streams_local))
    count("multihost.frames", frames)
    # NCCL reduces tensors on the card, gloo on the CPU
    where = dev if dist.get_backend() == "nccl" else torch.device("cpu")
    with span("multihost.allreduce"):
        tot = torch.tensor([frames, errors, audio_s, 1.0],
                           dtype=torch.float64, device=where)
        dist.all_reduce(tot)
        tot = tot.tolist()
    if info_out is not None:
        info_out.update(num_devices=int(tot[3]), decode_s=decode_s)
    return dict(frames=int(tot[0]), errors=int(tot[1]),
                audio_seconds=float(tot[2]), process_frames=frames)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Decode this rank's share of DIR/*.aac and all-reduce "
                    "the decode metrics over the process group.")
    ap.add_argument("--coordinator", required=True,
                    help="HOST:PORT of rank 0's TCP store")
    ap.add_argument("--num-processes", type=int, required=True)
    ap.add_argument("--process-id", type=int, required=True)
    ap.add_argument("--streams-dir", required=True)
    ap.add_argument("--device", default=None,
                    help="cuda:K modulo the visible cards by default; cpu")
    ap.add_argument("--backend", default=None,
                    help="nccl on a card, gloo on the CPU by default")
    args = ap.parse_args(argv)

    device = args.device
    if device is None:
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        device = f"cuda:{args.process_id % count}" if count else "cuda"
    dev = resolve(device)
    backend = args.backend or ("nccl" if dev.type == "cuda" else "gloo")
    if backend == "nccl":
        torch.cuda.set_device(dev)
    dist.init_process_group(
        backend, init_method=f"tcp://{args.coordinator}",
        world_size=args.num_processes, rank=args.process_id)
    try:
        paths = sorted(Path(args.streams_dir).glob("*.aac"))
        shard = [p.read_bytes() for i, p in enumerate(paths)
                 if i % args.num_processes == args.process_id]
        for counter in (ps_decorrelate.launches, qwire_rows.launches):
            for key in counter:
                counter[key] = 0
        info: dict = {}
        out = decode_shard_and_reduce(shard, dev, info_out=info)
        print(json.dumps({"process_id": args.process_id,
                          "device": str(dev), "backend": backend,
                          "streams": len(shard),
                          "k1_launches": ps_decorrelate.launches,
                          "rows_launches": qwire_rows.launches,
                          "decode_s": info["decode_s"]}), flush=True)
        out["process_id"] = args.process_id
        out["num_devices"] = info["num_devices"]
        print(json.dumps(out), flush=True)
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
