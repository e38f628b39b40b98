"""PyTorch port of the PS mixing prologue against
heaac_tpu.codec.compact_plan.expand_ps in both band modes (the 20-band
bench streams and the 34-band streams of tools/make_torch_streams.py),
on the PS codes of real frames, threading the carried H / phase
histories across frames.  Tolerance: exact (LUT gathers, products and one
division)."""
import numpy as np

import jax.numpy as jnp

from heaac_tpu.codec import compact_plan as jcp
from heaac_tpu_torch.codec import compact_plan
from test_torch_common import (  # noqa: F401 (autouse fixture)
    assert_exact, n, port_trace, release_jax_memory, t)


def check_expand_ps(kind: str, is34: int, T: int = 3):
    frames = port_trace(4, T, kind)
    jh = jcp.init_ps_hist(4)
    ph = compact_plan.init_ps_hist(4, "cpu")
    seen_on = 0
    for f, fr in enumerate(frames):
        pc = fr["pc"]
        # eager, as jit lets XLA contract the IPD/OPD products into
        # fused multiply-adds, which the exact comparison would see
        jplan, jh = jcp.expand_ps({k: jnp.asarray(v.astype(
            np.int8 if k == "pc_b" else np.int32)) for k, v in pc.items()},
            jh, is34)
        pplan, ph = compact_plan.expand_ps({k: t(v) for k, v in pc.items()},
                                           ph, is34)
        assert_exact(pplan, jplan, f"frame {f} plan")
        assert_exact(ph, jh, f"frame {f} hist")
        seen_on += int(n(pplan["ps_on"]).sum())
    assert seen_on > 0


def test_expand_ps_matches_jax_over_frames():
    check_expand_ps("he20", 0)


def test_expand_ps_34_matches_jax_over_frames():
    check_expand_ps("he34", 1, T=4)
