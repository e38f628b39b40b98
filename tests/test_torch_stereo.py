"""Stereo HE-AAC v1 in the PyTorch port against the JAX package, through
the JAX golden tests/data/heaac_v1_stereo_expand_golden_jax.npz (written
by tools/make_torch_golden.py; JAX does not run here): the scan
prologue's device M/S butterfly (``decode_all_coeffs`` with MS=1, also
where a pair's two flattened rows fall in different chunks) against
``_qwire_decode_all_coeffs``; the per-frame expansion with coupled raw
SBR rows (``qwire.expand_frame`` with rows_pair=1) against
``expand_frame_jax``; and the committed stereo streams themselves
(tools/make_torch_streams.py)."""
import functools
import importlib.util
import os

import numpy as np
import pytest

from heaac_tpu_torch.codec import compact_plan, heaac_graph, qwire
from test_torch_common import (  # noqa: F401 (autouse fixture)
    REPO, assert_exact, assert_peak_close, golden_tool, n, port_parse,
    release_jax_memory, streams_of, t)


@functools.cache
def _expand_golden():
    tool = golden_tool()
    with np.load(tool.EXPAND_GOLDEN) as z:
        return {k: z[k] for k in z.files}, tool


@pytest.mark.parametrize("chunk_rows", [3, 4096])
def test_decode_all_coeffs_ms_matches_jax(chunk_rows, monkeypatch):
    """Stereo streams 0-1, 4 frames (4 lanes: 16 flattened rows), parsed
    by the port as the golden's JAX parse, against the golden's JAX
    prologue.  At 3 rows per chunk every M/S pair's right row (r + T)
    lies in another chunk than its left row r."""
    z, tool = _expand_golden()
    T = tool.MS_FRAMES
    p = port_parse(tool.MS_STREAMS, T, "he_v1s")
    assert p["MS"] == 1
    np.testing.assert_array_equal(p["recs"], z["ms_recs"])
    np.testing.assert_array_equal(p["heap"], z["ms_heap"][:len(p["heap"])])
    w3 = p["recs"][..., 3].T.reshape(-1)          # lane-major flat rows
    left = np.flatnonzero((w3 >> 28) & 1)
    assert len(left)
    if chunk_rows < 4096:
        assert ((left // chunk_rows) != ((left + T) // chunk_rows)).all()
    monkeypatch.setattr(heaac_graph, "CHUNK_ROWS", chunk_rows)
    _, _, got = heaac_graph.decode_all_coeffs(
        t(p["heap"]), t(p["recs"]), p["S"], p["rate_idx"], p["NB"], p["MS"],
        p["NS"], p["SEC"])
    want = z["ms_coeffs"]
    assert np.abs(want).max() > 0
    assert_peak_close(got, want, 1e-6, "coeffs")


@functools.cache
def _port_expansion():
    """The port's expansion of the golden's parse, frame by frame from
    fresh carries: {"frame_mid", "frame_end", "carry_mid", "carry_end"}."""
    z, tool = _expand_golden()
    heap, recs = t(z["heap"]), t(z["recs"])
    B = recs.shape[1]
    qc = qwire.init_qcarry(B, "cpu")
    ph = compact_plan.init_ps_hist(B, "cpu")
    out = {}
    for f in range(recs.shape[0]):
        core_meta, plan, pc, qc = qwire.expand_frame(heap, recs[f], qc, 0, 1)
        ps_plan, ph = compact_plan.expand_ps(pc, ph, 0)
        if f + 1 in (tool.HALF, tool.FRAMES):
            tag = "mid" if f + 1 == tool.HALF else "end"
            out[f"frame_{tag}"] = (core_meta, plan, pc, ps_plan)
            out[f"carry_{tag}"] = (qc, ph)
    return out


def test_stereo_parse_matches_expand_golden():
    """The port's parser writes the golden's heap bytes and records."""
    z, tool = _expand_golden()
    p = port_parse(1, tool.FRAMES, "he_v1s")
    assert p["RP"] == 1 and p["MS"] == 1
    np.testing.assert_array_equal(p["recs"], z["recs"])
    np.testing.assert_array_equal(p["heap"], z["heap"])


@pytest.mark.parametrize("when", ["mid", "end"])
def test_expand_frame_rows_pair_matches_jax_golden(when):
    """Frames 8 and 16 of one coupled CPE (2 lanes): core meta, PS codes
    and every carry exactly, the float plans within 1e-6 of each
    element."""
    z, tool = _expand_golden()
    got = _port_expansion()
    want = tool.unflatten_tree(z, f"frame_{when}")
    for name, a, b in zip(("core_meta", "plan", "pc", "ps_plan"),
                          got[f"frame_{when}"], want):
        assert_exact(a, b, f"frame {when} {name}",
                     float_rtol=1e-6 if "plan" in name else 0.0)
    for name, a, b in zip(("qwire carry", "ps history"), got[f"carry_{when}"],
                          tool.unflatten_tree(z, f"carry_{when}")):
        assert_exact(a, b, f"after frame {when}: {name}", float_rtol=1e-6)
    # both channels' raw rows are live: the pan rows reach the carry
    assert n(got[f"carry_{when}"][0]["sbr_pc"]).any()


@functools.cache
def _streams_tool():
    spec = importlib.util.spec_from_file_location(
        "make_torch_streams", os.path.join(REPO, "tools",
                                           "make_torch_streams.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("i", range(8))
def test_stereo_streams_avoid_the_reference_fault(i):
    """Each committed stereo stream decodes through MS=1 and rows_pair=1
    and has no uncoupled byte-mode SBR frame after a raw-rows frame on
    its CPE: on that frame shape the JAX package writes ch1's codes into
    ch0's chain slot (ROADMAP, faults of the reference), and the port
    reproduces it."""
    tool = _streams_tool()
    p = tool.port_parse(streams_of("he_v1s", i + 1)[i])
    assert (p["nl"], p["out_nl"], p["MS"], p["RP"]) == (2, 2, 1, 1)
    assert p["frames"] == tool.STEREO_FRAMES
    assert p["rows"].any()
    assert not tool.rows_then_uncoupled_bytes(p)
