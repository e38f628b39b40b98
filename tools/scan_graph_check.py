#!/usr/bin/env python3
"""The qwire scan's CUDA-graph replay against its eager steps, on a
benchmark cell's streams.

    python3 tools/scan_graph_check.py [--seed N] [--streams 512]
        [--device cuda]

Makes ``v2_batch_512``'s streams as ``hebench`` does (its configuration
and traffic files, the seed), parses and uploads them in the groups
``decode_batch`` uses (``QwirePipelinedDecoder``), and decodes every
group three ways on the card: frame by frame as scans of one step (each
runs eagerly), as one scan (the first of its shape captures the step,
the rest replay), and as one scan again (every step replayed from the
cache).  Prints one JSON line: whether the PCM and the last carry of
each group are equal bit for bit (and the largest difference in LSB),
the ``scan.graph`` counters of each way, the capture's host seconds
(the ``scan.capture`` span), the card memory the graph holds (reserved
memory after the capturing scan less before, both after
``empty_cache``, less what the scan left allocated), and each way's
milliseconds a step (synchronised wall over the steps).

``--device cpu --streams 4`` rehearses it on the CPU, where every way
runs eagerly (no number of it is a device number).
"""
import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from hebench import harness  # noqa: E402
from hebench.gen import make_streams  # noqa: E402

CELL = "v2_batch_512"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=3700000001)
    ap.add_argument("--streams", type=int, default=None)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)

    import torch

    from heaac_tpu_torch.codec import heaac_graph, step_graph
    from heaac_tpu_torch.codec.batch import QwirePipelinedDecoder
    from heaac_tpu_torch.utils import trace

    dev = torch.device(a.device)
    cuda = dev.type == "cuda"
    if cuda and not torch.cuda.is_available():
        print(json.dumps({"error": "no CUDA card"}))
        return 1
    cell = harness.find_cell(harness.load_json(ROOT, "BENCHMARK.json"),
                             CELL)
    cfg = harness.load_json(ROOT, "hebench", "configs",
                            f"{cell['config']}.json")
    mix = harness.load_json(ROOT, "hebench", "mixes",
                            f"{cell['traffic']}.json")
    n = a.streams or cfg["streams"]
    streams = make_streams(ROOT, cfg["generator"], n, a.seed,
                           mix["invf_modes"], 8)

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    def timed(fn):
        sync()
        before = trace.snapshot()
        with trace.recording() as rec:
            t = time.perf_counter()
            out = fn()
            sync()
            wall = time.perf_counter() - t
        after = trace.snapshot()
        moved = {k: after[k] - before.get(k, 0) for k in after
                 if k.startswith("scan.graph.")
                 and after[k] != before.get(k, 0)}
        cap = [s.end_ns - s.start_ns for s in rec.spans
               if s.name == "scan.capture"]
        return out, wall, moved, [c / 1e9 for c in cap]

    dec = QwirePipelinedDecoder(streams, device=dev)
    dec.frame_counts, dec.error_count = [], 0
    out = dict(device=torch.cuda.get_device_name(dev) if cuda else "cpu",
               seed=a.seed, streams=n, groups=[])
    for g in range(len(dec.group_T)):
        cur, Tg, sa, couple = dec._parse_with_retry(g)
        heap, recs, couple = dec._upload(g % 2, cur, Tg, couple)
        L = dec.L
        args = dict(is34=dec.is34, downsampled=dec.ds, couple=couple, **sa)

        def eager():
            carry, pcm = heaac_graph.init_qwire_carry(L, dev), []
            for t in range(Tg):
                carry, p = heaac_graph.qwire_scan_decode(
                    heap, recs[t:t + 1], carry, **args)
                pcm.append(p)
            return carry, torch.cat(pcm)

        def whole():
            return heaac_graph.qwire_scan_decode(
                heap, recs, heaac_graph.init_qwire_carry(L, dev), **args)

        (ce, pe), we, ke, _ = timed(eager)
        if cuda:
            torch.cuda.empty_cache()
            r0, a0 = torch.cuda.memory_reserved(dev), \
                torch.cuda.memory_allocated(dev)
        (c1, p1), w1, k1, cap = timed(whole)
        if cuda:
            torch.cuda.empty_cache()
            held = (torch.cuda.memory_reserved(dev) - r0) \
                - (torch.cuda.memory_allocated(dev) - a0)
        (c2, p2), w2, k2, _ = timed(whole)
        leaves = lambda c: [x for x, _ in step_graph._zip(c, c)]  # noqa
        out["groups"].append(dict(
            lanes=L, steps=Tg,
            pcm_equal=[bool(torch.equal(pe, p1)), bool(torch.equal(pe, p2))],
            max_lsb=int(max((pe.int() - p1.int()).abs().max(),
                            (pe.int() - p2.int()).abs().max())),
            carry_equal=all(torch.equal(x, y) and torch.equal(x, z)
                            for x, y, z in zip(leaves(ce), leaves(c1),
                                               leaves(c2))),
            counters=[ke, k1, k2], capture_s=cap,
            graph_bytes=held if cuda else None,
            ms_per_step=[w * 1e3 / Tg for w in (we, w1, w2)]))
    print(json.dumps(out))
    return 0 if all(all(g["pcm_equal"]) and g["carry_equal"]
                    for g in out["groups"]) else 1


if __name__ == "__main__":
    sys.exit(main())
