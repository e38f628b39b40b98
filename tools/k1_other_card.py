#!/usr/bin/env python3
"""Kernel K1 on a card other than the current one.

    python3 tools/k1_other_card.py [TREE]

Imports ``heaac_tpu_torch`` from TREE (a checkout or an unpacked
``git archive``; by default the one this file is in), makes cuda:0 the
CUDA runtime's current device and runs K1
(``ops/ps_decorrelate.decorrelate_seq``) on tensors on cuda:1 at 256
lanes, napb 30 and 50, against its plain version; prints the largest
difference, and exits 1 on a difference or a CUDA error.  Needs two
cards.  K1's launcher raises the shared-memory limit on, and launches
from, the current device, so a wrapper that does not make the tensors'
card current fails here; the error may surface only at the next call
on that card (an uncaught traceback).
"""
import os
import sys

import torch

TREE = os.path.abspath(sys.argv[1] if len(sys.argv) > 1 else os.path.join(
    os.path.dirname(os.path.abspath(__file__)), os.pardir))
NAMES = ("power", "in_re", "in_im", "trans", "ap", "ag", "qf")


def main() -> int:
    if torch.cuda.device_count() < 2:
        raise SystemExit("k1_other_card: needs two CUDA cards")
    sys.path.insert(0, TREE)
    from heaac_tpu_torch.ops import ps_decorrelate as K
    print(f"K1 from {K.__file__}", flush=True)
    K.build()
    failed = False
    for napb in (30, 50):
        inp = K.random_inputs(256, napb, seed=napb)
        args = [torch.from_numpy(inp[k]).to("cuda:1") for k in NAMES]
        torch.cuda.set_device(0)
        try:
            got = K.decorrelate_seq(*args)
            torch.cuda.synchronize(1)
        except Exception as e:  # noqa: BLE001 - reported, then exit 1
            print(f"napb {napb}: {type(e).__name__}: {e}", flush=True)
            return 1       # a failed launch can poison the card's context
        err = max(float((a - b).abs().max())
                  for a, b in zip(got, K.decorrelate_plain(*args)))
        print(f"napb {napb}: launched on cuda:1, max|diff| {err}",
              flush=True)
        failed |= err != 0.0
    return int(failed)


if __name__ == "__main__":
    sys.exit(main())
