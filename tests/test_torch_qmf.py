"""PyTorch port of the QMF analysis / synthesis banks against
heaac_tpu.ops.qmf_jax.  Tolerance: 1e-5 of each output's peak (f32
matmul summation order)."""
import numpy as np
import pytest

import jax.numpy as jnp

from heaac_tpu.ops import qmf_jax
from heaac_tpu_torch.ops import qmf
from test_torch_common import (  # noqa: F401 (autouse fixture)
    assert_peak_close, jit_ref, release_jax_memory, t)

TOL = 1e-5


@pytest.mark.parametrize("seed", [0, 1])
def test_qmf_analysis_matches_jax(seed):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((4, 1024)) * 3000).astype(np.float32)
    hist = (rng.standard_normal((4, 288)) * 3000).astype(np.float32)
    jW, jh = jit_ref(qmf_jax.qmf_analysis)(jnp.asarray(x),
                                           jnp.asarray(hist))
    W, h = qmf.qmf_analysis(t(x), t(hist))
    assert_peak_close(W, jW, TOL, "W")
    assert_peak_close(h, jh, 0.0, "x_hist")


@pytest.mark.parametrize("seed", [0, 1])
def test_qmf_synthesis_matches_jax(seed):
    rng = np.random.default_rng(seed)
    X = (rng.standard_normal((4, 2, 38, 64)) * 100).astype(np.float32)
    v = (rng.standard_normal((4, 9, 128)) * 100).astype(np.float32)
    jout, jv = jit_ref(qmf_jax.qmf_synthesis)(jnp.asarray(X),
                                              jnp.asarray(v))
    out, pv = qmf.qmf_synthesis(t(X), t(v))
    assert_peak_close(out, jout, TOL, "pcm")
    assert_peak_close(pv, jv, TOL, "v_hist")
