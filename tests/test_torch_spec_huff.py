"""PyTorch port of the raw-bits spectral Huffman decode against
heaac_tpu.ops.spec_huff.decode_spec_jax, bitwise, on the benchdata
streams' real spectral blocks: frame 0 (long windows), frame 1 (every
lane EIGHT_SHORT) and frame 2 (long and short lanes mixed)."""
import numpy as np
import pytest

import jax.numpy as jnp

from heaac_tpu.ops import spec_huff as jsp
from heaac_tpu_torch.ops import spec_huff
from test_torch_common import (  # noqa: F401 (autouse fixture)
    assert_exact, jit_ref, n, port_parse, release_jax_memory, t)


@pytest.mark.parametrize("frame", [0, 1, 2])
def test_decode_spec_bitwise(frame):
    p = port_parse(8, 3)
    rec = p["recs"][frame]                                  # [8, 4]
    mode1 = ((rec[:, 2] >> 24) & 15) == 1
    assert mode1.all()
    short = (rec[:, 3] >> 30) & 1
    assert short.any() == (frame > 0)
    w3 = rec[:, 3] * mode1
    heap = p["heap"].astype(np.int32)
    ref = jit_ref(jsp.decode_spec_jax, sampling_index=p["rate_idx"],
                  NBITS=p["NB"], with_ms=False, NS=p["NS"], SEC=p["SEC"])(
        jnp.asarray(heap), jnp.asarray(rec[:, 0]), jnp.asarray(w3))
    got = spec_huff.decode_spec(t(heap), t(rec[:, 0]), t(w3), p["rate_idx"],
                                p["NB"], NS=p["NS"], SEC=p["SEC"])
    assert np.abs(n(ref)).max() > 0
    assert_exact(n(got).view(np.int32), n(ref).view(np.int32), "coeffs")
