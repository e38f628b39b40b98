"""PyTorch port of the SBR envelope/noise row decode against
heaac_tpu.ops.sbr_huff.decode_sbr_rows_jax, exactly, on seeded random
regions and control fields (every bit pattern decodes through the
complete prefix codes; overruns must flag alike): the single channel
(pair=False) and the coupled-CPE pair (pair=True, ``coupled`` drawn per
lane).  Real rows are covered through the qwire expansion tests."""
import numpy as np
import pytest

import jax.numpy as jnp

from heaac_tpu.ops import sbr_huff as jsh
from heaac_tpu_torch.ops import sbr_huff
from test_torch_common import (  # noqa: F401 (autouse fixture)
    assert_exact, release_jax_memory, t)


@pytest.mark.parametrize("seed,pair", [
    pytest.param(0, False, id="0"), pytest.param(1, False, id="1"),
    pytest.param(2, False, id="2"), pytest.param(3, True, id="pair-3"),
    pytest.param(4, True, id="pair-4")])
def test_decode_sbr_rows_matches_jax(seed, pair):
    rng = np.random.default_rng(seed)
    B = 8
    i = lambda lo, hi: rng.integers(lo, hi + 1, B).astype(np.int32)  # noqa
    n0 = i(1, 25)
    ctl = dict(
        phase=i(0, 7), rbits=i(0, 640 * 8), ne=i(0, 5), nnoise=i(1, 2),
        frbits=i(0, 31), n0=n0, n1=np.minimum(n0 * 2 - i(0, 1), 48),
        nq=i(1, 5), ampres=i(0, 1), active=rng.random(B) < 0.8)
    carry = dict(env_last=rng.integers(0, 60, (B, 2, 48)).astype(np.int32),
                 noise_last=rng.integers(0, 30, (B, 2, 5)).astype(np.int32),
                 fr_last=rng.integers(0, 2, (B, 2)).astype(np.int32))
    region = rng.integers(0, 256, (B, jsh.RW)).astype(np.uint8)
    coupled = (rng.random(B) < 0.6).astype(np.int32) * pair
    ref = jsh.decode_sbr_rows_jax(
        jnp.asarray(region), **{k: jnp.asarray(v) for k, v in ctl.items()},
        coupled=jnp.asarray(coupled),
        carry={k: jnp.asarray(v) for k, v in carry.items()}, pair=pair)
    got = sbr_huff.decode_sbr_rows(
        t(region), **{k: t(v) if k != "active" else t(v, bool)
                      for k, v in ctl.items()},
        carry={k: t(v) for k, v in carry.items()}, coupled=t(coupled),
        pair=pair)
    for k, (a, b) in enumerate(zip(got, ref)):
        assert_exact(a, b, f"output {k}")
    assert np.asarray(ref[0]).any()
    # a coupled lane decodes its second channel's rows
    assert np.asarray(ref[1]).any() == pair
