"""The committed JAX golden (tests/data/heaac_v2_golden_jax.npz) that
chip_smoke.py holds the GPU output to: regenerated here by
tools/make_torch_golden.py's JAX scan (``golden_scan``) and compared, its
PCM byte for byte and the scan's carries after frames 8 and 16 (which
tests/test_torch_stream.py starts the port from) integers exactly and
floats within 1e-6 of each tensor's peak (XLA:CPU may vectorize another
way on another host); and the port's CPU decode of the same frames
within 2 int16 LSB of it."""
import os

import numpy as np

from heaac_tpu_torch.codec.batch import QwirePipelinedDecoder
from test_torch_common import (  # noqa: F401 (autouse fixture)
    assert_tree_close, bench_streams, golden_tool, release_jax_memory, REPO)

GOLDEN = os.path.join(REPO, "tests", "data", "heaac_v2_golden_jax.npz")


def _committed():
    with np.load(GOLDEN) as z:
        return z["pcm"]


def test_golden_regenerates_byte_for_byte():
    tool = golden_tool()
    g = tool.golden_scan()
    with np.load(GOLDEN) as z:
        gold = z["pcm"]
        carries = {k: tool.unflatten_tree(z, k)
                   for k in ("carry_mid", "carry_end")}
    pcm = g["pcm"]
    assert pcm.dtype == gold.dtype == np.int16
    assert pcm.shape == gold.shape == (16, 2, 2, 2048)
    assert pcm.tobytes() == gold.tobytes()
    for k, want in carries.items():
        assert_tree_close(g[k], want, 1e-6, k)


def test_port_cpu_matches_golden():
    gold = _committed()
    dec = QwirePipelinedDecoder(bench_streams(2), group_streams=2,
                                max_frames=gold.shape[0], device="cpu")
    pcm = dec.decode()[0].numpy()
    assert pcm.shape == gold.shape
    assert np.abs(pcm.astype(np.int32) - gold).max() <= 2
    assert dec.audio_seconds() == 2 * 16 * 2048 / 48000
