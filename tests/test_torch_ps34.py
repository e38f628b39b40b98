"""The 34-band parametric stereo slice of the PyTorch port (is34=1)
against the JAX package, module by module: the hybrid analysis /
synthesis (12+8+4+4+4 sub-bands), the decorrelator and mix with K1's
plain version at napb 50 (where the JAX package runs its lax.scan pair
``ps_jax._decorrelate_scans``) on the PS plans of the committed 34-band
streams (tests/data/heaac_v2_34band_{0..3}.aac: coarse and fine IID
quantisation, with and without IPD/OPD), and the decode carry with all
50 allpass rows.  (expand_ps and expand_frame at is34=1 are tested in
tests/test_torch_expand_ps.py and tests/test_torch_qwire.py, beside
their 20-band cases.)

Tolerances as in the 20-band tests: the float stages within 1e-5 of
each output's peak; the carry moves into the port and back exactly."""
import numpy as np
import pytest

from heaac_tpu.codec import heaac_graph as jg
from heaac_tpu_torch.codec.state import carry_from_numpy, carry_to_numpy
from test_torch_common import (  # noqa: F401 (autouse fixture)
    n, release_jax_memory)
from test_torch_ps import check_decorrelate_and_mix, check_hybrid


@pytest.mark.parametrize("seed", [0, 1])
def test_hybrid_analysis_synthesis_34_match_jax(seed):
    check_hybrid(seed, 1)


@pytest.mark.parametrize("frame", [0, 2])
def test_decorrelate_and_mix_34_matches_jax(frame):
    """K1's plain version at napb 50 against ``_decorrelate_scans``.
    Not bit-exact: the allpass and transient states differ in their
    last bits (XLA compiles the scan's body as one fused loop, the port
    rounds each operation), and the mix's einsums sum in another order;
    every output is held to 1e-5 of its peak."""
    check_decorrelate_and_mix(frame, "he34", 1)


def test_carry_with_50_allpass_rows_round_trips():
    state, ph, qc = jg.init_qwire_carry(2)
    rng = np.random.default_rng(34)
    fields = {k: n(v) for k, v in state._asdict().items()}
    fields["ps_ap"] = rng.standard_normal((2, 50, 3, 5, 2)).astype(
        np.float32)
    tree = (fields, n(ph), {k: n(v) for k, v in qc.items()})
    port = carry_from_numpy(tree, "cpu")
    assert tuple(port[0].ps_ap.shape) == (2, 50, 3, 5, 2)
    back = carry_to_numpy(port)
    for got, want in zip(back, tree):
        assert set(got) == set(want)
        for k in want:
            if isinstance(want[k], dict):
                for kk in want[k]:
                    np.testing.assert_array_equal(got[k][kk], want[k][kk])
                    assert got[k][kk].dtype == want[k][kk].dtype, kk
            else:
                np.testing.assert_array_equal(got[k], want[k])
                assert got[k].dtype == want[k].dtype, k
