"""The committed JAX golden (tests/data/heaac_v2_golden_jax.npz) that
chip_smoke.py holds the GPU output to: regenerated here by
tools/make_torch_golden.py's decode and compared byte for byte, and the
port's CPU decode of the same frames within 2 int16 LSB of it."""
import importlib.util
import os

import numpy as np

from heaac_tpu_torch.codec.batch import QwirePipelinedDecoder
from test_torch_common import (  # noqa: F401 (autouse fixture)
    bench_streams, release_jax_memory, REPO)

GOLDEN = os.path.join(REPO, "tests", "data", "heaac_v2_golden_jax.npz")


def _tool():
    spec = importlib.util.spec_from_file_location(
        "make_torch_golden", os.path.join(REPO, "tools",
                                          "make_torch_golden.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _committed():
    with np.load(GOLDEN) as z:
        return z["pcm"]


def test_golden_regenerates_byte_for_byte():
    pcm = _tool().golden_pcm()
    gold = _committed()
    assert pcm.dtype == gold.dtype == np.int16
    assert pcm.shape == gold.shape == (16, 2, 2, 2048)
    assert pcm.tobytes() == gold.tobytes()


def test_port_cpu_matches_golden():
    gold = _committed()
    dec = QwirePipelinedDecoder(bench_streams(2), group_streams=2,
                                max_frames=gold.shape[0], device="cpu")
    pcm = dec.decode()[0].numpy()
    assert pcm.shape == gold.shape
    assert np.abs(pcm.astype(np.int32) - gold).max() <= 2
    assert dec.audio_seconds() == 2 * 16 * 2048 / 48000
