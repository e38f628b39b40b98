"""Regression gate of the port's benchmark entry.

    python -m heaac_tpu_torch.bench 512 8 | tail -1 > new.json
    python -m heaac_tpu_torch.bench_gate new.json --baseline base.json \
        [--tolerance 0.10]

The counterpart of ``tools/bench_gate.py``: the same gated fields and
tolerance, the same exit codes.  It fails a fresh
``heaac_tpu_torch.bench`` line whose components regress beyond the
tolerance against a baseline line.  Where it departs: the baseline is
``--baseline`` only, a line that ``heaac_tpu_torch.bench`` wrote (a file
holding it, alone or wrapped as {"parsed": line}); it never picks a
``BENCH_r*.json`` from the repo root, which are another chip's runs.  A
baseline with no ``device``, or whose ``device.name`` differs from the
new line's, is refused: two cards' numbers are not one series.

Exit status: 0 = no regression beyond tolerance, 1 = regression, 2 = bad
invocation, a file that cannot be read, or a baseline refused.
"""
from __future__ import annotations

import argparse
import json
import sys

# higher-is-better component fields
GATED = ["value", "parse_only_x", "device_only_x"]
# lower-is-better fields
GATED_LOW = ["wire_bytes_per_frame_lane", "parse_us_per_frame"]


def read_line(path: str) -> dict:
    """The JSON object in ``path`` (the whole file, else its last line),
    unwrapped from {"parsed": ...}; raises OSError / ValueError."""
    with open(path) as f:
        text = f.read().strip()
    try:
        d = json.loads(text)
    except ValueError:
        d = json.loads(text.splitlines()[-1] if text else "")
    if isinstance(d, dict):
        d = d.get("parsed", d)
    if not isinstance(d, dict):
        raise ValueError("not a JSON object")
    return d


def _card(line: dict):
    dev = line.get("device")
    return dev.get("name") if isinstance(dev, dict) else None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m heaac_tpu_torch.bench_gate")
    ap.add_argument("new_json", help="file holding the fresh bench JSON line")
    ap.add_argument("--tolerance", type=float, default=0.10,
                    help="allowed fractional regression (default 0.10)")
    ap.add_argument("--baseline", default=None,
                    help="a heaac_tpu_torch.bench JSON line (required)")
    args = ap.parse_args(argv)

    if not args.baseline:
        print("bench_gate: --baseline is required (a heaac_tpu_torch.bench "
              "line from the same card)")
        return 2
    lines = {}
    for role, path in (("new", args.new_json), ("baseline", args.baseline)):
        try:
            lines[role] = read_line(path)
        except (OSError, ValueError) as e:
            print(f"bench_gate: cannot read {path}: {e}")
            return 2
    new, base = lines["new"], lines["baseline"]
    if _card(base) is None:
        print(f"bench_gate: baseline {args.baseline} names no device (not a "
              "heaac_tpu_torch.bench line): refused")
        return 2
    if _card(base) != _card(new):
        print(f"bench_gate: baseline ran on {_card(base)!r}, the new line on "
              f"{_card(new)!r}: refused")
        return 2

    print(f"bench_gate: baseline {args.baseline} ({_card(base)})")
    failed = []
    for keys, sign in ((GATED, -1), (GATED_LOW, 1)):
        for key in keys:
            b, n = base.get(key), new.get(key)
            if not b or n is None:
                continue
            delta = (n - b) / b
            bad = sign * delta > args.tolerance
            print(f"  {key:28s} {b:>12.2f} -> {n:>12.2f}  ({delta:+.1%}) "
                  f"{'REGRESSION' if bad else 'ok'}")
            if bad:
                failed.append(key)
    if failed:
        print(f"bench_gate: FAIL — component regression beyond "
              f"{args.tolerance:.0%}: {', '.join(failed)}")
        return 1
    print("bench_gate: pass")
    return 0


if __name__ == "__main__":
    sys.exit(main())
