#!/usr/bin/env python3
"""Where kernel K1's time goes, on one NVIDIA GPU.

    python3 tools/k1_breakdown.py

Builds csrc/ps_decorrelate.cu as it is and in variants with one part
switched off (the detector's arithmetic, the chain's, both, the output
stores), launches each through the kernel's own geometry at B=512, napb
30 and 50, and prints torch.profiler's device time per launch (mean of
chip_smoke.REPS) three ways:
  cold   a 128 MB write before each launch (chip_smoke.py's cold: the
         inputs come from HBM and L2 is full of dirty lines);
  clean  the same write and then a 128 MB read (inputs from HBM, L2 clean);
  warm   the same inputs again (in L2).
A variant's outputs are wrong by design; only the full kernel is checked
against the plain version.  Also prints the CTAs an SM holds (CUDA
occupancy calculator) and the card's name and power limit.
"""
import ctypes
import os
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import chip_smoke as CS  # noqa: E402
from heaac_tpu_torch.native import BUILD_DIR  # noqa: E402
from heaac_tpu_torch.ops import ps_decorrelate as K  # noqa: E402

OUT = os.path.join(BUILD_DIR, "k1_breakdown")
NO_DET = ("if (t < n_det) detector(", "if (false) detector(")
NO_CHAIN = ("chain(s_in_re + u * ip,", "if (false) chain(s_in_re + u * ip,")


def variants() -> dict:
    src = open(K.SRC).read()

    def patch(*pairs):
        s = src
        for a, b in pairs:
            if a not in s:
                raise SystemExit(f"kernel source changed: {a!r} not found")
            s = s.replace(a, b)
        return s
    no_store = re.sub(r"^(\s+)store<", r"\1if (false) store<", src, flags=re.M)
    if no_store.count("if (false) store<") != 3:
        raise SystemExit("kernel source changed: expected 3 store sites")
    return {"kernel": src, "no detector arithmetic": patch(NO_DET),
            "no chain arithmetic": patch(NO_CHAIN),
            "no arithmetic": patch(NO_DET, NO_CHAIN),
            "no output stores": no_store}


def build(item) -> ctypes.CDLL:
    i, src = item
    path = os.path.join(OUT, f"v{i}.cu")
    with open(path, "w") as f:
        f.write(src)
    so = os.path.join(OUT, f"libv{i}.so")
    subprocess.run([K._nvcc(), *K.NVCC_FLAGS, path, "-o", so], check=True)
    L = ctypes.CDLL(so)
    L.ps_decorrelate_launch.restype = ctypes.c_int
    L.ps_decorrelate_launch.argtypes = [ctypes.c_void_p] * 11 + [
        ctypes.c_int] * 3 + [K.Geometry, ctypes.c_void_p]
    return L


class CleanFlush:
    """Write the flush buffer, then read it: L2 ends up full of clean
    lines."""

    def __init__(self, buf):
        self.buf = buf

    def zero_(self):
        self.buf.zero_()
        self.buf.sum()


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("k1_breakdown: torch.cuda.is_available() is False")
    print("card:", CS.card_line(), flush=True)
    os.makedirs(OUT, exist_ok=True)
    vs = variants()
    with ThreadPoolExecutor(len(vs)) as ex:
        libs = dict(zip(vs, ex.map(build, enumerate(vs.values()))))
    flush = torch.empty(CS.FLUSH_BYTES // 4, dtype=torch.float32,
                        device="cuda")
    for napb in (30, 50):
        geo = K.geometry(napb)
        args = CS.k1_args(CS.LANES, napb, napb, K)
        ref = K.decorrelate_plain(*args)
        outs = [torch.empty_like(r) for r in ref]
        bound_ms, _ = CS.k1_bound(args, outs)
        print(f"napb {napb}: block {geo.det_threads + geo.chain_threads}, "
              f"shared memory {geo.smem} B, grid {K.grid(CS.LANES, geo)}, "
              f"{K.ctas_per_sm(napb)} CTAs per SM; HBM bound "
              f"{bound_ms * 1e3:.3f} us", flush=True)
        for name, L in libs.items():
            def run(L=L):
                rc = L.ps_decorrelate_launch(
                    *(t.data_ptr() for t in (*args, *outs)), CS.LANES, napb,
                    K.grid(CS.LANES, geo), geo,
                    torch.cuda.current_stream().cuda_stream)
                if rc != 0:
                    raise SystemExit(f"{name}: CUDA error {rc}")
            run()
            torch.cuda.synchronize()
            check = (f", max|diff| {CS.max_diff(outs, ref):.1e}"
                     if name == "kernel" else "")
            us = {how: CS.device_ms(run, "ps_decorrelate_kernel", fl) * 1e3
                  for how, fl in (("cold", flush),
                                  ("clean", CleanFlush(flush)),
                                  ("warm", None))}
            print(f"  {name:24s} " + " ".join(
                f"{k} {v:7.3f} us" for k, v in us.items()) + check,
                flush=True)


if __name__ == "__main__":
    main()
