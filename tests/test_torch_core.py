"""PyTorch port of the core frame (IMDCT + windowing / overlap-add)
against heaac_tpu.codec.core.core_frame.

Tolerance: 1e-5 of the output's peak (the [1024x1024] f32 matmul sums in
another order than XLA's); the window-state machine itself is exact."""
import itertools

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from heaac_tpu.codec.core import _consts, core_frame as jcore_frame
from heaac_tpu_torch.codec import core
from test_torch_common import (  # noqa: F401 (autouse fixture)
    assert_peak_close, jit_ref, release_jax_memory, t)

TOL = 1e-5


@pytest.mark.parametrize("ws", [0, 1, 2, 3])
def test_core_frame_matches_jax(ws):
    """One window sequence per case; the 16 lanes cover every previous
    window sequence x sine/KBD x previous sine/KBD."""
    combos = list(itertools.product(range(4), (0, 1), (0, 1)))
    B = len(combos)
    rng = np.random.default_rng(ws)
    coeffs = (rng.standard_normal((B, 1024)) * 300).astype(np.float32)
    saved = (rng.standard_normal((B, 512)) * 1000).astype(np.float32)
    win = np.full(B, ws, np.int32)
    wsp, kbd, kbdp = (np.array(c, np.int32) for c in zip(*combos))
    m2048, m256, bank = _consts()
    j_out, j_saved = jit_ref(jcore_frame)(
        jnp.asarray(coeffs), jnp.asarray(saved), jnp.asarray(win),
        jnp.asarray(wsp), jnp.asarray(kbd), jnp.asarray(kbdp),
        m2048, m256, bank)
    p_out, p_saved = core.core_frame(
        t(coeffs), t(saved), t(win), t(wsp), t(kbd), t(kbdp),
        *core.consts(torch.device("cpu")))
    assert_peak_close(p_out, j_out, TOL, "time")
    assert_peak_close(p_saved, j_saved, TOL, "saved")
