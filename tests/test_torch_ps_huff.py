"""PyTorch port of the PS parameter-region decode against
heaac_tpu.ops.ps_huff.decode_ps_region_jax, exactly, on seeded random
regions, control fields and carries (fixup, extension and persistence
branches all taken).  Real PS regions are covered through the qwire
expansion test."""
import numpy as np
import pytest

import jax.numpy as jnp

from heaac_tpu.ops import ps_huff as jph
from heaac_tpu_torch.ops import ps_huff
from test_torch_common import (  # noqa: F401 (autouse fixture)
    assert_exact, release_jax_memory, t)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_decode_ps_region_matches_jax(seed):
    rng = np.random.default_rng(seed)
    B = 8
    i = lambda lo, hi: rng.integers(lo, hi + 1, B).astype(np.int32)  # noqa
    pick = lambda vals: rng.choice(vals, B).astype(np.int32)  # noqa
    ne_pre = i(0, 4)
    ctl = dict(
        start_off=i(0, 7), rbits=i(0, jph.RW * 8), enable_iid=i(0, 1),
        iq=i(0, 1), nr_iid=pick([10, 20, 34]), enable_icc=i(0, 1),
        nr_icc=pick([10, 20, 34]), enable_ext=i(0, 1), ne_pre=ne_pre,
        penv=np.minimum(ne_pre + i(0, 1), 5), nipd=pick([5, 11, 17]),
        header=i(0, 1))
    carry = dict(
        iid_last=rng.integers(-15, 16, (B, 34)).astype(np.int32),
        icc_last=rng.integers(0, 8, (B, 34)).astype(np.int32),
        ipd_full=rng.integers(0, 8, (B, 5, 17)).astype(np.int32),
        opd_full=rng.integers(0, 8, (B, 5, 17)).astype(np.int32),
        pd_enable=i(0, 1), penv_prev=i(0, 5), ps_ok=i(0, 1))
    region = rng.integers(0, 256, (B, jph.RW)).astype(np.uint8)
    ref = jph.decode_ps_region_jax(
        jnp.asarray(region), **{k: jnp.asarray(v) for k, v in ctl.items()},
        carry={k: jnp.asarray(v) for k, v in carry.items()})
    got = ps_huff.decode_ps_region(
        t(region), **{k: t(v) for k, v in ctl.items()},
        carry={k: t(v) for k, v in carry.items()})
    for k, (a, b) in enumerate(zip(got, ref)):
        assert_exact(a, b, f"output {k}")
