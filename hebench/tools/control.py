"""The control of ``correct``: the reference decoded with TF32 transforms
in the program's place, judged against the float32 reference by the
cell's own numbers and limits.

    python3 hebench/tools/control.py --workload <name> --seeds 1,2,3

For each seed it makes the cell's streams as a run does, takes
``check_streams`` of them drawn from the seed (the batched kind's draw;
for the single-stream kind a draw from the first 64, the streams a
window decodes whole), decodes each with ``ref.codec.decoder.Decoder``
twice (``imdct_half_ref``, then ``imdct_half_tf32`` in the core and the
QMF banks) in spawned processes, and prints one JSON line a seed: the
compared numbers, their limits and whether the control passed (it must
not).  It needs no card.
"""
import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))


def main(argv=None) -> int:
    sys.path[:] = [ROOT] + [p for p in sys.path
                            if os.path.abspath(p or ".") != HERE]
    import numpy as np

    from hebench import check, harness
    from hebench.gen import make_streams

    ap = argparse.ArgumentParser(prog="hebench/tools/control.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--streams", type=int, default=None,
                    help="check this many streams (the tests: fewer)")
    args = ap.parse_args(argv)
    bench = harness.load_json(ROOT, "BENCHMARK.json")
    cell = harness.find_cell(bench, args.workload)
    cfg = harness.load_json(ROOT, "hebench", "configs",
                            f"{cell['config']}.json")
    mix = harness.load_json(ROOT, "hebench", "mixes",
                            f"{cell['traffic']}.json")
    n = mix.get("streams", cfg.get("streams"))
    k = args.streams or mix["check_streams"]
    failed_all = True
    for seed in (int(s) for s in args.seeds.split(",")):
        rng = np.random.default_rng(seed % (1 << 63))
        pool = n if mix["kind"] == "batch" else min(n, 64)
        pick = sorted(rng.choice(pool, size=min(k, pool),
                                 replace=False).tolist())
        streams = make_streams(ROOT, cfg["generator"], max(pick) + 1, seed,
                               mix["invf_modes"], None)
        chosen = [streams[i] for i in pick]
        want = check.reference(chosen)
        got = check.reference(chosen, tf32=True)
        numbers = check.compare(got, want)
        ok, rows = check.judge(numbers, mix["limits"])
        failed_all &= not ok
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "streams": len(chosen), "control_passed": ok,
                          "checks": rows}), flush=True)
    return 0 if failed_all else 1


if __name__ == "__main__":
    sys.exit(main())
