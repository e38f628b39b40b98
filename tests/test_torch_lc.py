"""The AAC-LC path of the PyTorch port against the JAX package, on the
bundled LC cores (benchdata/lc_core_24k_{0,1}.aac, first 8 frames): the
port's native whole-stream parse gives the same spectra and window
metadata as the JAX package's LcStreamBatchDecoder parse (exactly), and
``heaac_graph.lc_scan_decode`` over them is within 2 int16 LSB of the
JAX scan (``_make_lc_scan_decoder``), both started from one seeded
overlap carry ``saved`` (moved by ``codec.state``), which ends within
1e-5 of its peak (the [1024x1024] IMDCT product sums in another order
than XLA's)."""
import numpy as np

import jax.numpy as jnp
import torch

from heaac_tpu.codec.batch import LcStreamBatchDecoder as JaxLcDecoder
from heaac_tpu.codec.batch import _make_lc_scan_decoder
from heaac_tpu_torch.codec.batch import LcStreamBatchDecoder
from heaac_tpu_torch.codec.heaac_graph import lc_scan_decode
from heaac_tpu_torch.codec.state import carry_from_numpy, carry_to_numpy
from test_torch_common import (  # noqa: F401 (autouse fixture)
    assert_exact, assert_peak_close, n, release_jax_memory, streams_of)

T = 8
TOL_LSB = 2


def test_lc_parse_matches_jax():
    streams = streams_of("lc", 2)
    dec = LcStreamBatchDecoder(streams, max_frames=T, device="cpu")
    assert (dec.B, dec.T, dec.lane_block, dec.channels) == (2, T, 1, 1)
    assert dec.frame_counts == [T, T] and dec.sample_rate == 24000
    for b, st in enumerate(streams):
        core, rate, channels, lanes, couple = JaxLcDecoder._parse_one(st, T)
        assert (rate, channels, lanes, couple) == (24000, 1, 1, None)
        for k, v in core.items():
            assert_exact(n(dec.core[k])[:, b:b + 1], v, k)


def test_lc_scan_matches_jax():
    dec = LcStreamBatchDecoder(streams_of("lc", 2), max_frames=T,
                               device="cpu")
    core = {k: n(v) for k, v in dec.core.items()}
    rng = np.random.default_rng(0)
    saved0 = (rng.standard_normal((2, 512)) * 1000).astype(np.float32)
    jsaved, jpcm = _make_lc_scan_decoder()(
        {k: jnp.asarray(v.astype(np.float32 if k == "coeffs" else np.int32))
         for k, v in core.items()}, jnp.asarray(saved0))
    saved, pcm = lc_scan_decode(dec.core, carry_from_numpy(saved0, "cpu"))
    assert pcm.dtype == torch.int16
    assert tuple(pcm.shape) == (T, 2, 1024)
    assert np.abs(n(jpcm)).max() > 1000
    assert np.abs(n(pcm).astype(np.int32) - n(jpcm)).max() <= TOL_LSB
    assert_peak_close(carry_to_numpy(saved), jsaved, 1e-5, "saved")
