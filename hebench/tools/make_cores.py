"""Write the stereo AAC-LC cores under ``hebench/data/cores/``.

    python3 hebench/tools/make_cores.py

``stereo_{i}.aac``, i in 0..7: the port's encoder (``AacEncoder``) at
24 kHz, two channels, 64 kb/s, M/S on, window switching on odd i, over
a mid tone with noise and a small side tone (odd i quieter, with a
transient burst every 2048 samples): the cores of the repository's
stereo HE-AAC v1 test streams (``tools/make_torch_streams.py``
``stereo_pcm`` / ``make_stereo_stream``).  Runs once on the CPU; the
files are data, and no benchmark run encodes.  The mono cores
``mono_{i}.aac`` are copies of ``benchdata/lc_core_24k_{i}.aac``.
"""
import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
OUT = os.path.join(ROOT, "hebench", "data", "cores")
CORE_RATE = 24000
FRAMES = 50


def stereo_pcm(i: int) -> np.ndarray:
    rng = np.random.default_rng(100 + i)
    n = (FRAMES - 1) * 1024            # the encoder adds a lead-in frame
    t = np.arange(n) / CORE_RATE
    f_mid, f_side = 500 + 60 * i, 1700 + 90 * i
    if i % 2:
        mid = 0.05 * np.sin(2 * np.pi * f_mid * t) \
            + 0.005 * rng.standard_normal(n)
        side = 0.01 * np.sin(2 * np.pi * f_side * t)
        left, right = mid + side, mid - side
        for p in range(512, n - 96, 2048):
            left[p:p + 96] += np.hanning(96) * 2.0
            right[p:p + 96] += np.hanning(96) * 2.0
    else:
        mid = 0.4 * np.sin(2 * np.pi * f_mid * t) \
            + 0.05 * rng.standard_normal(n)
        side = 0.03 * np.sin(2 * np.pi * f_side * t)
        left, right = mid + side, mid - side
    return np.clip(np.stack([left, right], 1) * 3000,
                   -32768, 32767).astype(np.int16)


def main() -> None:
    sys.path.insert(0, ROOT)
    from heaac_tpu_torch.codec.encoder import AacEncoder
    os.makedirs(OUT, exist_ok=True)
    for i in range(8):
        core = AacEncoder(CORE_RATE, 2, bitrate=64000, ms=True,
                          window_switching=bool(i % 2)).encode(stereo_pcm(i))
        with open(os.path.join(OUT, f"stereo_{i}.aac"), "wb") as f:
            f.write(core)
        print(f"stereo_{i}.aac: {len(core)} bytes")


if __name__ == "__main__":
    main()
