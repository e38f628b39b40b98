"""PyTorch port of the qwire device half against heaac_tpu.codec.qwire:
the byte-token coefficient decode (bitwise) on token lanes made by the
JAX package's host emitter and on the benchdata heap, and the per-frame
side-info expansion over real frames — every integer output and the
whole carry exactly, the float plan tensors within 1e-6 of each element
(XLA's CPU division / sqrt may differ from IEEE in the last bit).
The expansion runs on 20-band streams and on the 34-band streams of
tools/make_torch_streams.py (is34=1: the band remap tables), against
expand_frame_jax's outputs stored by tools/make_torch_golden.py
(tests/data/qwire_expand_golden_jax.npz; JAX does not run for it here)."""
import numpy as np
import pytest

import jax.numpy as jnp

from heaac_tpu.codec import qwire as jq
from heaac_tpu_torch.codec import qwire
from test_torch_common import (  # noqa: F401 (autouse fixture)
    assert_exact, golden_tool, n, port_parse, port_trace, release_jax_memory,
    t)


def _token_lanes(seed: int, B: int = 8):
    rng = np.random.default_rng(seed)
    heap = b""
    recs = []
    for _ in range(B):
        q = np.zeros(1024, np.int64)
        nz = rng.choice(1024, rng.integers(20, 300), replace=False)
        q[nz] = rng.choice([-1, 1], len(nz)) * (
            rng.integers(1, 8192, len(nz)) ** (rng.random(len(nz)) * 1.2)
        ).astype(np.int64).clip(1, 8191)
        sfw = np.zeros(1024, np.uint16)
        si = rng.integers(0, 428, 32)
        sgn = rng.integers(0, 2, 32)
        for b in range(32):
            sfw[b * 32:(b + 1) * 32] = si[b] | (sgn[b] << 15)
        raw = np.zeros(1024, bool)
        rawpos = rng.choice(1024, 17, replace=False)
        raw[rawpos] = True
        coef = np.zeros(1024, np.float32)
        coef[rawpos] = rng.standard_normal(17).astype(np.float32) * 1e3
        q[rawpos] = 0
        toks, ext = jq.emit_coeff_tokens(coef, q.astype(np.int32), sfw, raw)
        payload, rec = jq.assemble_lane(toks, ext, b"")
        rec[jq.R_TOKOFF] = len(heap)
        heap += payload
        recs.append(rec)
    payload, rec = jq.silence_lane()
    rec[jq.R_TOKOFF] = len(heap)
    recs.append(rec)
    heap += payload
    return np.frombuffer(heap, np.uint8).astype(np.int32), np.stack(recs)


def _coeffs_both(heap, rec, S=640):
    ref = jq.decode_coeffs_jax(jnp.asarray(heap), jnp.asarray(rec[:, 0]),
                               jnp.asarray(rec[:, 1] & 0xFFFF), S)
    got = qwire.decode_coeffs(t(heap), t(rec[:, 0]), t(rec[:, 1] & 0xFFFF), S)
    return n(got), n(ref)


@pytest.mark.parametrize("seed", [0, 1])
def test_decode_coeffs_token_lanes_bitwise(seed):
    got, ref = _coeffs_both(*_token_lanes(seed))
    assert np.abs(ref).max() > 0
    assert_exact(got.view(np.int32), ref.view(np.int32), "coeffs")


def test_decode_coeffs_benchdata_heap_bitwise():
    """Spec-mode lanes read as tokens (garbage the scan discards) must
    still match: the clamps and fills are part of the contract."""
    p = port_parse(8, 3)
    got, ref = _coeffs_both(p["heap"].astype(np.int32),
                            p["recs"].reshape(-1, 4), p["S"])
    assert_exact(got.view(np.int32), ref.view(np.int32), "coeffs")


def check_expand_frame(kind: str):
    tool = golden_tool()
    T = tool.QWIRE_FRAMES
    p = port_parse(tool.QWIRE_STREAMS, T, kind)
    with np.load(tool.QWIRE_GOLDEN) as z:
        gold = {k[len(kind) + 1:]: z[k] for k in z.files
                if k.startswith(kind + "/")}
    # the JAX outputs came from the same native parse of the same frames
    assert_exact(p["heap"], gold["heap"], "heap")
    assert_exact(p["recs"], gold["recs"], "recs")
    pheap = t(p["heap"].astype(np.int32))
    pc = qwire.init_qcarry(tool.QWIRE_STREAMS, "cpu")
    for f in range(T):
        jout = tool.unflatten_tree(gold, f"frame_{f}")
        pout = qwire.expand_frame(pheap, t(p["recs"][f]), pc, p["is34"])
        for name, a, b in zip(("core_meta", "plan", "pc", "carry"), pout,
                              jout):
            assert_exact(a, b, f"frame {f} {name}",
                         float_rtol=1e-6 if name == "plan" else 0.0)
        pc = pout[3]
    assert n(pc["ps"]["ps_ok"]).all()
    return p


def test_expand_frame_matches_jax_over_frames():
    check_expand_frame("he20")


def test_expand_frame_34_matches_jax_over_frames():
    p = check_expand_frame("he34")
    assert p["is34"] == 1
    # the streams really carry 34-band parameters past band 20
    pcb = np.stack([fr["pc"]["pc_b"] for fr in port_trace(4, 6, "he34")])
    iid = pcb[:, :, :170].reshape(6, 4, 5, 34)
    assert np.abs(iid[..., 20:]).max() > 0
