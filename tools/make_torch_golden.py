#!/usr/bin/env python
"""Write the JAX reference's PCM for the PyTorch port's GPU check.

    JAX_PLATFORMS=cpu python tools/make_torch_golden.py [out.npz]

Decodes benchdata/heaac_bench_stream_{0,1}.aac (first 16 frames each)
with the JAX package's QwirePipelinedDecoder on the CPU and stores the
int16 PCM [16, 2, 2, 2048] (frame, stream, channel, sample) compressed in
tests/data/heaac_v2_golden_jax.npz.  chip_smoke.py holds the port's GPU
output to it; tests/test_torch_golden.py regenerates it and checks it.
"""
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(REPO, "tests", "data", "heaac_v2_golden_jax.npz")
STREAMS = (0, 1)
FRAMES = 16


def golden_pcm() -> np.ndarray:
    sys.path.insert(0, REPO)
    from heaac_tpu.codec.batch import QwirePipelinedDecoder
    streams = [open(os.path.join(REPO, "benchdata",
                                 f"heaac_bench_stream_{i}.aac"), "rb").read()
               for i in STREAMS]
    dec = QwirePipelinedDecoder(streams, group_streams=len(streams),
                                max_frames=FRAMES)
    return np.asarray(dec.decode()[0]).astype(np.int16)


def main() -> None:
    out = sys.argv[1] if len(sys.argv) > 1 else GOLDEN
    os.makedirs(os.path.dirname(out), exist_ok=True)
    pcm = golden_pcm()
    np.savez_compressed(out, pcm=pcm)
    print(f"wrote {out}: pcm {pcm.shape} {pcm.dtype}")


if __name__ == "__main__":
    main()
