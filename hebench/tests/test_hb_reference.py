"""The plain reference (``hebench.ref``) against the JAX package's
committed single-stream goldens (read as data): bench stream 0 (HE-AAC
v2, 20-band PS), 34-band stream 0 and stereo HE-AAC v1 stream 1, 16
frames each.  Within 1 LSB: the goldens' IMDCT is a float32 matrix
product, the reference's the float64 transform, and the rounding to
int16 may fall either side."""
import os

import numpy as np
import pytest

from hebench.ref.bitstream.adts import split_adts_stream
from hebench.ref.codec.decoder import Decoder
from hebench.tests.conftest import ROOT

GOLDEN = os.path.join(ROOT, "tests", "data", "single_golden_jax.npz")
CASES = {"he20_0": "benchdata/heaac_bench_stream_0.aac",
         "he34_0": "tests/data/heaac_v2_34band_0.aac",
         "he_v1s_1": "tests/data/heaac_v1_stereo_1.aac"}
FRAMES = 16


@pytest.mark.parametrize("name", sorted(CASES))
def test_reference_matches_jax_golden(name):
    with open(os.path.join(ROOT, CASES[name]), "rb") as f:
        frames = split_adts_stream(f.read())[:FRAMES]
    dec = Decoder(adts_probe=frames[0][:7])
    pcm = np.concatenate([dec.decode_frame(f) for f in frames])
    with np.load(GOLDEN) as z:
        want = z[f"pcm_{name}"]
        assert dec.sample_rate == int(z[f"rate_{name}"])
    assert pcm.shape == want.shape
    assert np.abs(pcm.astype(np.int64) - want).max() <= 1


def test_tf32_rounding():
    from hebench.ref.ops.imdct import tf32_round
    x = np.array([1.0, 1.0 + 2.0 ** -11, 1.0 + 3 * 2.0 ** -11,
                  1.0 + 2.0 ** -10, -3.0000001], np.float32)
    got = tf32_round(x)
    # ties to even at the 10th mantissa bit; exact values stay
    assert got.tolist() == [1.0, 1.0, 1.0 + 2.0 ** -9, 1.0 + 2.0 ** -10,
                            -3.0]
