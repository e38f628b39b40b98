"""PyTorch port of the PS mixing prologue against
heaac_tpu.codec.compact_plan.expand_ps (20-band), on the PS codes of
real benchdata frames, threading the carried H / phase histories across
frames.  Tolerance: exact (LUT gathers, products and one division)."""
import numpy as np

import jax.numpy as jnp

from heaac_tpu.codec import compact_plan as jcp
from heaac_tpu_torch.codec import compact_plan
from test_torch_common import (  # noqa: F401 (autouse fixture)
    assert_exact, n, port_trace, release_jax_memory, t)


def test_expand_ps_matches_jax_over_frames():
    frames = port_trace(4, 3)
    jh = jcp.init_ps_hist(4)
    ph = compact_plan.init_ps_hist(4, "cpu")
    seen_on = 0
    for f, fr in enumerate(frames):
        pc = fr["pc"]
        jplan, jh = jcp.expand_ps({k: jnp.asarray(v.astype(
            np.int8 if k == "pc_b" else np.int32)) for k, v in pc.items()},
            jh, 0)
        pplan, ph = compact_plan.expand_ps({k: t(v) for k, v in pc.items()},
                                           ph)
        assert_exact(pplan, jplan, f"frame {f} plan")
        assert_exact(ph, jh, f"frame {f} hist")
        seen_on += int(n(pplan["ps_on"]).sum())
    assert seen_on > 0
