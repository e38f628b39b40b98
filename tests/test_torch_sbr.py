"""PyTorch port of the SBR HF reconstruction stages against
heaac_tpu.ops.sbr_jax, stage by stage on real plans (the port's
expansion of benchdata stream frames) and seeded QMF inputs.  Each stage
gets the JAX stage's inputs, so a difference cannot propagate.  The JAX
stages run as one jitted chain (``_jax_stages``).

Tolerance: 1e-5 of each output's peak (einsum / sum order)."""
import numpy as np
import pytest

import jax.numpy as jnp

from heaac_tpu.ops import sbr_jax
from heaac_tpu_torch.ops import sbr
from test_torch_common import (  # noqa: F401 (autouse fixture)
    assert_peak_close, jit_ref, n, port_trace, release_jax_memory, t)

TOL = 1e-5
HF_ARGS = ("src_of_m", "bw_of_m", "hf_mask", "gen_slot_mask")
ENV_ARGS = ("env_onehot", "recip", "grp_mean", "freqres_sel")


def _jax_stages(W_prev, W, Y_prev, g_temp, q_temp, jp):
    """Every stage's output, each stage fed the one before it."""
    X_low = sbr_jax.lf_gen(W_prev, W, jp["xlow_new"], jp["xlow_old"])
    a0, a1 = sbr_jax.hf_inverse_filter(X_low)
    X_high = sbr_jax.hf_gen(X_low, a0, a1, *(jp[k] for k in HF_ARGS))
    e = sbr_jax.env_estimate(X_high, *(jp[k] for k in ENV_ARGS))
    g = sbr_jax.gain_calc(e, jp)
    asm = sbr_jax.hf_assemble(X_high, *g, g_temp, q_temp, jp)
    xg = sbr_jax.x_gen(X_low, asm[0], Y_prev, asm[1], jp)
    return X_low, a0, a1, X_high, e, g, asm, xg


def _plan(frame):
    return port_trace(4, 3)[frame]["plan"]


@pytest.mark.parametrize("frame", [0, 1, 2])
def test_sbr_stages_match_jax(frame):
    plan = _plan(frame)
    jp = {k: jnp.asarray(v) for k, v in plan.items()}
    pp = {k: t(v) for k, v in plan.items()}
    rng = np.random.default_rng(frame)
    B = 4
    W_prev = (rng.standard_normal((B, 32, 32, 2)) * 100).astype(np.float32)
    W = (rng.standard_normal((B, 32, 32, 2)) * 100).astype(np.float32)
    g_temp = np.abs(rng.standard_normal((B, 42, 48))).astype(np.float32)
    q_temp = np.abs(rng.standard_normal((B, 42, 48))).astype(np.float32)
    Y_prev = rng.standard_normal((B, 38, 64, 2)).astype(np.float32)

    jX_low, ja0, ja1, jX_high, je, jg, jasm, jxg = jit_ref(_jax_stages)(
        *(jnp.asarray(a) for a in (W_prev, W, Y_prev, g_temp, q_temp)), jp)

    X_low = sbr.lf_gen(t(W_prev), t(W), pp["xlow_new"], pp["xlow_old"])
    assert_peak_close(X_low, jX_low, 0.0, "lf_gen")
    X_low = t(n(jX_low))

    a0, a1 = sbr.hf_inverse_filter(X_low)
    assert_peak_close(a0, ja0, 1e-4, "alpha0")
    assert_peak_close(a1, ja1, 1e-4, "alpha1")

    X_high = sbr.hf_gen(X_low, t(n(ja0)), t(n(ja1)),
                        *(pp[k] for k in HF_ARGS))
    assert_peak_close(X_high, jX_high, TOL, "hf_gen")
    X_high = t(n(jX_high))

    e = sbr.env_estimate(X_high, *(pp[k] for k in ENV_ARGS))
    assert_peak_close(e, je, TOL, "env_estimate")

    g = sbr.gain_calc(t(n(je)), pp)
    for a, b, name in zip(g, jg, ("gain", "q_m", "s_m")):
        assert_peak_close(a, b, TOL, name)

    jY, jon, jgt, jqt = jasm
    Y, on, gt, qt = sbr.hf_assemble(X_high, *(t(n(x)) for x in jg),
                                    t(g_temp), t(q_temp), pp)
    assert_peak_close(Y, jY, TOL, "Y_m")
    assert_peak_close(on, jon, 0.0, "env_on")
    assert_peak_close(gt, jgt, TOL, "g_temp")
    assert_peak_close(qt, jqt, TOL, "q_temp")

    jX, jy = jxg
    X, y = sbr.x_gen(X_low, t(n(jY)), t(Y_prev), t(n(jon)), pp)
    assert_peak_close(X, jX, TOL, "X")
    assert_peak_close(y, jy, TOL, "y_cur")
