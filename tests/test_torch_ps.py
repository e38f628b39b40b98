"""PyTorch port of parametric stereo (20-band) against
heaac_tpu.ops.ps_jax, and the plain version of kernel K1 against the JAX
scan pair (napb 30 and 50) and the Pallas kernel in interpret mode.
``check_hybrid`` and ``check_decorrelate_and_mix`` take the band mode;
tests/test_torch_ps34.py runs them at is34=1.

Tolerances: K1 1e-6 absolute (as tests/test_ps_pallas.py); the float
stages 1e-5 of each output's peak (einsum / sum order)."""
import numpy as np
import pytest

import jax.numpy as jnp

from heaac_tpu.ops import ps_jax, ps_pallas
from heaac_tpu_torch.ops import ps, ps_decorrelate as K
from test_torch_common import (  # noqa: F401 (autouse fixture)
    assert_peak_close, jit_ref, n, port_trace, release_jax_memory, t)

TOL = 1e-5
NAMES = ("power", "in_re", "in_im", "trans", "ap", "ag", "qf")


def _jax_scans(power, in_re, in_im, trans, ap, is34):
    return ps_jax._decorrelate_scans(power, in_re, in_im,
                                     dict(trans=trans), ap,
                                     ps_jax._consts(is34))


@pytest.mark.parametrize("napb", [30, 50])
def test_k1_plain_matches_jax_scans(napb):
    inp = K.random_inputs(8, napb, seed=napb)
    jtg, jout, jts, jap = jit_ref(_jax_scans, is34=int(napb == 50))(
        *(jnp.asarray(inp[k]) for k in NAMES[:5]))
    tg, out, ntr, nap = K.decorrelate_seq(*(t(inp[k]) for k in NAMES))
    for a, b in ((tg, jtg), (out, jout), (ntr, jnp.stack(jts, -1)),
                 (nap, jap)):
        np.testing.assert_allclose(n(a), n(b), rtol=0, atol=1e-6)


def test_k1_plain_matches_pallas_interpret():
    inp = K.random_inputs(8, 30, seed=3)
    ref = ps_pallas.decorrelate_seq(*(jnp.asarray(inp[k]) for k in NAMES),
                                    interpret=True)
    got = K.decorrelate_seq(*(t(inp[k]) for k in NAMES))
    for a, b in zip(got, ref):
        np.testing.assert_allclose(n(a), n(b), rtol=0, atol=1e-6)


@pytest.mark.parametrize("napb", [30, 50])
@pytest.mark.parametrize("B", [1, 2, 3, 512, 513])
def test_k1_launch_geometry(B, napb):
    """The kernel's grid, roles and shared-memory layout (computed in
    Python and passed to the launcher): every (lane, band) is computed by
    exactly one thread, shared memory fits one block, and every 16-byte
    copy is aligned at both ends and stays inside its region."""
    geo = K.geometry(napb)
    want = [("detector", b, i) for b in range(B) for i in range(34)] + [
        ("chain", b, k) for b in range(B) for k in range(napb)]
    assert sorted(K.work_items(B, napb)) == sorted(want)
    assert geo.det_threads % 32 == 0 and geo.chain_threads % 32 == 0
    assert geo.det_threads + geo.chain_threads <= 256   # __launch_bounds__
    assert geo.smem <= K.SMEM_MAX
    # float4 reads / writes of 8 consecutive staged rows hit 8 different
    # 16-byte bank groups when a row's pitch is an odd number of float4s
    assert (geo.in_pitch // 4) % 2 == 1 and (geo.out_pitch // 4) % 2 == 1

    starts = sorted((getattr(geo, r), r) for r in (
        "power", "in_re", "in_im", "ap", "tgain", "ap_out"))
    end = {r: nxt for (_, r), (nxt, _) in zip(
        starts, starts[1:] + [(geo.smem, None)])}
    sizes = dict(power=34 * 32, in_re=napb * 32, in_im=napb * 32,
                 ap=napb * 30, tgain=32 * 34, ap_out=napb * 64,
                 new_ap=napb * 30)
    moved = dict.fromkeys(sizes, 0)
    for array, off, soff, nbytes in K.copies(B, napb):
        region = "ap" if array == "new_ap" else array
        assert off % 16 == 0 and soff % 16 == 0 and nbytes % 16 == 0
        assert off + nbytes <= B * sizes[array] * 4
        assert getattr(geo, region) <= soff and soff + nbytes <= end[region]
        moved[array] += nbytes
    assert moved == {k: B * v * 4 for k, v in sizes.items()}


def test_k1_cpu_wrapper_counts_no_launch():
    before = dict(K.launches)
    for napb in (30, 50):
        K.decorrelate_seq(*(t(v) for v in K.random_inputs(2, napb).values()))
    assert K.launches == before


def check_hybrid(seed: int, is34: int):
    rng = np.random.default_rng(seed)
    L = (rng.standard_normal((4, 2, 38, 64)) * 100).astype(np.float32)
    in_buf = (rng.standard_normal((4, 5, 6, 2)) * 100).astype(np.float32)
    jl, jb = jit_ref(ps_jax.hybrid_analysis, is34=is34)(jnp.asarray(L),
                                                          jnp.asarray(in_buf))
    lb, b = ps.hybrid_analysis(t(L), t(in_buf), is34)
    assert_peak_close(lb, jl, TOL, "lbuf")
    assert_peak_close(b, jb, 0.0, "in_buf")
    buf = (rng.standard_normal((4, 91, 32, 2)) * 100).astype(np.float32)
    assert_peak_close(ps.hybrid_synthesis(t(buf), is34),
                      jit_ref(ps_jax.hybrid_synthesis, is34=is34)(
                          jnp.asarray(buf)), TOL, "hybrid_synthesis")


def check_decorrelate_and_mix(frame: int, kind: str, is34: int):
    """One frame's real PS plan (port expansion of 4 streams of ``kind``)
    with seeded signals and state -> (max |diff| over the outputs, the
    outputs' peak), after checking each within TOL of its peak."""
    plan = port_trace(4, 3, kind)[frame]["ps_plan"]
    rng = np.random.default_rng(frame)
    B = 4
    lbuf = (rng.standard_normal((B, 91, 32, 2)) * 100).astype(np.float32)
    state = dict(
        delay=(rng.standard_normal((B, 91, 14, 2)) * 100).astype(np.float32),
        ap=(rng.standard_normal((B, 50, 3, 5, 2)) * 10).astype(np.float32),
        trans=np.abs(rng.standard_normal((B, 34, 3)) * 1e4).astype(
            np.float32))
    jl, jr, js = jit_ref(ps_jax.decorrelate_and_mix, is34=is34)(
        jnp.asarray(lbuf), {k: jnp.asarray(v) for k, v in state.items()},
        {k: jnp.asarray(v) for k, v in plan.items()})
    pl, pr, pstate = ps.decorrelate_and_mix(
        t(lbuf), {k: t(v) for k, v in state.items()},
        {k: t(v) for k, v in plan.items()}, is34)
    pairs = [(pl, jl, "lmix"), (pr, jr, "rmix")] + [
        (pstate[k], js[k], k) for k in ("delay", "ap", "trans")]
    for a, b, name in pairs:
        assert_peak_close(a, b, TOL, name)
    return max(float(np.abs(n(a) - n(b)).max()) for a, b, _ in pairs)


@pytest.mark.parametrize("seed", [0, 1])
def test_hybrid_analysis_synthesis_match_jax(seed):
    check_hybrid(seed, 0)


@pytest.mark.parametrize("frame", [0, 2])
def test_decorrelate_and_mix_matches_jax(frame):
    check_decorrelate_and_mix(frame, "he20", 0)
