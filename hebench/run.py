"""Run one cell of the benchmark once and print its result line.

    python3 hebench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

(or ``python3 -m hebench.run ...``) from the root of a checkout that
holds ``BENCHMARK.json``, ``hebench/`` and the program
(``heaac_tpu_torch``).  The last line on stdout is one JSON object;
diagnostics and the compared numbers go to stderr.  Without a card, or
with fewer cards than the cell asks for, it prints no result and exits
2.
"""
import time

T0 = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
CACHE = os.path.join(ROOT, "hebench", ".cache")
# every build and kernel cache of the program at a fixed path inside
# the checkout, whatever the caller's environment says
os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE, "torch_extensions")
os.environ["USE_FLAX"] = "0"
# run as a script, this folder heads sys.path: its modules would shadow
# the standard library's; the checkout's root takes its place
sys.path[:] = [ROOT] + [p for p in sys.path
                        if os.path.abspath(p or ".") not in (HERE, ROOT)]

from hebench import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.run(sys.argv[1:], T0))
