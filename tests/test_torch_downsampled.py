"""Downsampled SBR (the 32-band QMF synthesis, 1024 samples a frame) in
the PyTorch port against the JAX package, on the CPU.

``qmf_synthesis_ds`` against the JAX function, eagerly (within 1e-5 of
each output's peak: f32 matmul summation order; the history's zero
columns exactly).  tests/data/heaac_ds_{0..3}.aac with the
AudioSpecificConfig tests/data/heaac_ds.asc (tools/make_torch_streams.py)
parsed by the port's Python planner into the heap and records the JAX
planner wrote (byte for byte), then the port's ``qwire_scan_decode``
with downsampled=1 within 2 int16 LSB of the JAX
``qwire_scan_decoder(0, 1, ...)`` in tests/data/downsampled_golden_jax.npz
(tools/make_torch_golden.py; no JAX scan compiles here), from a fresh
carry and, for frames 8-15, from the JAX carry after frame 8; carries
after each half: integers exactly, floats within 1e-4 of each tensor's
peak.  The flip scan with downsampled=1 on a stream that does not flip
equals the plain scan."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from heaac_tpu.ops import qmf_jax
from heaac_tpu_torch.codec import heaac_graph
from heaac_tpu_torch.codec.batch import pack_planner_frames
from heaac_tpu_torch.codec.planner import parse_stream_qwire
from heaac_tpu_torch.codec.state import carry_from_numpy, carry_to_numpy
from heaac_tpu_torch.host import R_W1, rows_pair_static, spec_static_args
from heaac_tpu_torch.ops import qmf
from test_torch_common import (  # noqa: F401 (autouse fixture)
    assert_peak_close, assert_tree_close, golden_tool, n,
    release_jax_memory, t)

TOL_LSB = 2


@pytest.mark.parametrize("seed", [0, 1])
def test_qmf_synthesis_ds_matches_jax(seed):
    rng = np.random.default_rng(seed)
    X = (rng.standard_normal((3, 2, 38, 64)) * 100).astype(np.float32)
    v = (rng.standard_normal((3, 9, 128)) * 100).astype(np.float32)
    jout, jv = qmf_jax.qmf_synthesis_ds(jnp.asarray(X), jnp.asarray(v))
    out, pv = qmf.qmf_synthesis_ds(t(X), t(v))
    assert tuple(out.shape) == (3, 1024) and tuple(pv.shape) == (3, 9, 128)
    assert_peak_close(out, jout, 1e-5, "pcm")
    assert_peak_close(pv[..., :64], np.asarray(jv)[..., :64], 1e-5,
                      "v_hist")
    assert not pv[..., 64:].any() and not np.asarray(jv)[..., 64:].any()


def _planner_pack(frames: int):
    """The port's planner parse of the golden's streams with their ASC,
    packed -> (heap, cur, recs, static scan arguments)."""
    data, asc = golden_tool().ds_streams()
    parsed = [parse_stream_qwire(d, asc=asc, max_frames=frames)
              for d in data]
    assert {p[1:] for p in parsed} == {(24000, 1, 0, 1)}  # rate, nl, 34, ds
    heap, cur, recs = pack_planner_frames([p[0] for p in parsed], 1, frames)
    sa = spec_static_args(recs)
    S = -(-max(64, int((recs[..., R_W1] & 0xFFFF).max())) // 64) * 64
    return heap, cur, recs, dict(S=S, rate_idx=6, NB=sa["NB"], MS=sa["MS"],
                                 NS=sa["NS"], SEC=sa["SEC"],
                                 rows_pair=rows_pair_static(heap[:cur], recs))


def test_downsampled_scan_matches_jax_with_midstream_carry():
    tool = golden_tool()
    with np.load(tool.DS_GOLDEN) as z:
        g = {k: z[k] for k in z.files}
    jmid = tool.unflatten_tree(g, "carry_mid")
    jend = tool.unflatten_tree(g, "carry_end")
    assert int(g["dense_lsb"]) <= TOL_LSB      # the JAX qwire vs dense path
    frames, half = g["pcm"].shape[0], g["pcm"].shape[0] // 2
    heap, cur, recs, sa = _planner_pack(frames)
    assert bytes(heap[:cur]) == bytes(g["heap"][:cur])
    assert not g["heap"][cur:].any()
    np.testing.assert_array_equal(recs, g["recs"])
    assert tuple(g["static"]) == (0, 1, sa["S"], 6, sa["NB"], sa["MS"],
                                  sa["NS"], sa["SEC"], sa["rows_pair"])
    assert np.abs(g["pcm"]).max() > 1000
    lanes = recs.shape[1]
    c1, pcm_a = heaac_graph.qwire_scan_decode(
        t(heap), t(recs[:half]), heaac_graph.init_qwire_carry(lanes, "cpu"),
        0, 1, **sa)
    assert tuple(pcm_a.shape) == (half, lanes, 2, 1024)
    da = np.abs(n(pcm_a).astype(np.int32) - g["pcm"][:half]).max()
    assert da <= TOL_LSB, da
    assert_tree_close(carry_to_numpy(c1), jmid, 1e-4, f"after frame {half}")
    c2, pcm_b = heaac_graph.qwire_scan_decode(
        t(heap), t(recs[half:]), carry_from_numpy(jmid, "cpu"), 0, 1, **sa)
    db = np.abs(n(pcm_b).astype(np.int32) - g["pcm"][half:]).max()
    assert db <= TOL_LSB, db
    assert_tree_close(carry_to_numpy(c2), jend, 1e-4, f"after frame {frames}")


def test_flip_scan_downsampled_equals_plain_scan():
    heap, cur, recs, sa = _planner_pack(4)
    heap, recs = t(heap), t(recs[:, :1])
    _, plain = heaac_graph.qwire_scan_decode(
        heap, recs, heaac_graph.init_qwire_carry(1, "cpu"), 0, 1, **sa)
    sa.pop("MS")
    _, flip = heaac_graph.qwire_scan_decode_flip(
        heap, recs, heaac_graph.init_qwire_flip_carry(1, "cpu"), 1, **sa)
    assert tuple(flip.shape) == (4, 1, 2, 1024) and flip.dtype == torch.int16
    assert int(plain.abs().max()) > 1000
    assert torch.equal(flip, plain)
