"""PyTorch port of the raw-bits spectral Huffman decode against
heaac_tpu.ops.spec_huff.decode_spec_jax, bitwise, on the benchdata
streams' real spectral blocks: frame 0 (long windows), frame 1 (every
lane EIGHT_SHORT) and frame 2 (long and short lanes mixed); and with the
per-bin M/S mask (``with_ms``) on the M/S pairs of the stereo HE-AAC v1
streams, long and EIGHT_SHORT (tools/make_torch_streams.py)."""
import functools

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


@functools.cache
def _ms_lanes():
    """8 M/S pair lanes of stereo streams 0 (long windows) and 1
    (window-switched: EIGHT_SHORT), 4 of each, with the JAX reference
    run once, jitted, over all 8 -> (parse, rec [8, 4], w3 [8], short
    [8] bool, (coeffs, mask) of the reference)."""
    p = port_parse(2, 8, "he_v1s")
    assert p["MS"] == 1
    rec = p["recs"].reshape(-1, 4)
    mode1 = ((rec[:, 2] >> 24) & 15) == 1
    w3 = rec[:, 3] * mode1
    ms = ((w3 >> 28) & 3) != 0
    short = ((w3 >> 30) & 1) > 0
    pick = np.concatenate([np.flatnonzero(ms & ~short)[:4],
                           np.flatnonzero(ms & short)[:4]])
    assert len(pick) == 8
    rec, w3 = rec[pick], w3[pick]
    ref = jit_ref(jsp.decode_spec_jax, sampling_index=p["rate_idx"],
                  NBITS=p["NB"], with_ms=True, NS=p["NS"], SEC=p["SEC"])(
        jnp.asarray(p["heap"].astype(np.int32)), jnp.asarray(rec[:, 0]),
        jnp.asarray(w3))
    return p, rec, w3, short[pick], (n(ref[0]), n(ref[1]))


@pytest.mark.parametrize("windows", ["long", "short"])
def test_decode_spec_ms_mask_bitwise(windows):
    """The M/S pair lanes of one window shape: coefficients bitwise and
    the mask exactly against the eager JAX reference."""
    p, rec, w3, short, ref = _ms_lanes()
    got = spec_huff.decode_spec(t(p["heap"].astype(np.int32)), t(rec[:, 0]),
                                t(w3), p["rate_idx"], p["NB"], with_ms=True,
                                NS=p["NS"], SEC=p["SEC"])
    sel = short if windows == "short" else ~short
    want_c, want_m = ref[0][sel], ref[1][sel]
    assert np.abs(want_c).max() > 0 and want_m.any()
    assert_exact(n(got[0])[sel].view(np.int32), want_c.view(np.int32),
                 "coeffs")
    assert_exact(n(got[1])[sel], want_m, "ms_mask")
