"""The AAC-LC Python planner and the coupled LC scan of the PyTorch port
against the JAX package, on the CPU.

``LcPlanningDecoder`` (AAC-LC in a PCE layout with a coupling channel
element each frame, tests/data/lc_cce_{after,before}_{j}.aac) against
the live JAX ``LcPlanningDecoder`` (host numpy, nothing compiled): the
coefficients, window integers and AFTER_IMDCT edges exactly (the JAX
decoder dequantizes frames after the first in its native element parser
where no dependent coupling channel is present, the port in Python; the
two agree bit for bit on these streams).
``decode_batch`` over the golden's list (the LC + CCE streams and two
20-band streams with a corrupted frame 1: the Python prober, and the
Python profile parse of the bucket's stream 0) within 2 int16 LSB of
the JAX golden (tests/data/lc_batch_golden_jax.npz).  The coupling mix
adds up edges with the same target."""
import numpy as np
import pytest
import torch

from heaac_tpu.codec.batch import LcPlanningDecoder as JaxLcPlanner
from heaac_tpu_torch import decode_batch
from heaac_tpu_torch.codec import heaac_graph
from heaac_tpu_torch.codec.core import consts as core_consts
from heaac_tpu_torch.codec.core import core_frame
from heaac_tpu_torch.codec.planner import LcPlanningDecoder
from heaac_tpu_torch.host import split_adts_stream
from test_torch_common import (  # noqa: F401 (autouse fixture)
    golden_tool, release_jax_memory, t)

T = 8
TOL_LSB = 2


def _plan(cls, data: bytes, frames: int):
    heads = split_adts_stream(data)[:frames]
    dec = cls(adts_probe=heads[0][:7])
    for f in heads:
        dec.decode_frame(f)
    return dec


@pytest.mark.parametrize("name", ["lc_cce_after_0", "lc_cce_before_1",
                                  "lc_cce_after_3"])
def test_lc_planner_matches_jax(name):
    data = golden_tool().named_stream(name)
    got = _plan(LcPlanningDecoder, data, T)
    want = _plan(JaxLcPlanner, data, T)
    assert (got.channels, got.sample_rate) == (want.channels,
                                               want.sample_rate) == (1, 24000)
    assert len(got.frames_core) == len(want.frames_core) == T
    assert got.frames_couple == want.frames_couple
    assert any(got.frames_couple) == name.startswith("lc_cce_after")
    for f, (g, w) in enumerate(zip(got.frames_core, want.frames_core)):
        assert set(g) == set(w)
        for k in ("ws", "wsp", "kbd", "kbdp"):
            np.testing.assert_array_equal(g[k], w[k], err_msg=f"{k} {f}")
        assert g["coeffs"].shape == (2, 1024)
        np.testing.assert_array_equal(g["coeffs"], w["coeffs"],
                                      err_msg=f"coeffs {f}")


def test_decode_batch_lc_planner_matches_golden(caplog):
    tool = golden_tool()
    named = tool.lc_streams()
    with np.load(tool.LC_GOLDEN) as z:
        gold = {k: z[k] for k in z.files}
    assert list(gold["names"]) == [name for name, _ in named]
    caplog.set_level("INFO", logger="heaac_tpu_torch")
    outs = decode_batch([b"".join(split_adts_stream(d)[:T]) for _, d in named],
                        device="cpu")
    msgs = [r.getMessage() for r in caplog.records]
    assert "qwire pipelined decode: stream 0's profile from the Python " \
        "planner" in msgs
    keys = sorted(r.bucket_stats["key"] for r in caplog.records
                  if hasattr(r, "bucket_stats"))
    assert keys == [("he", 6, 1, 0), ("lc", 6, 0, 0)]
    for k, ((name, _), pcm) in enumerate(zip(named, outs)):
        he = name.startswith("he")
        rows, ch = T * (2048 if he else 1024), 2 if he else 1
        assert tuple(pcm.shape) == (rows, ch) and pcm.dtype == torch.int16
        want = gold[f"pcm_{k}"][:rows]
        assert np.abs(want).max() > 1000, name
        assert np.abs(pcm.numpy().astype(np.int32) - want).max() <= TOL_LSB, \
            name


def test_coupling_mix_adds_duplicate_targets():
    """Lanes 2 and 3 both couple into lane 0 (and lane 2 into lane 1):
    the scan's float output mixed by hand in float64, then rounded."""
    rng = np.random.default_rng(3)
    frames, lanes = 3, 4
    coeffs = (rng.standard_normal((frames, lanes, 1024)) * 40).astype(
        np.float32)
    zeros = np.zeros((frames, lanes), np.int64)
    core = dict(coeffs=t(coeffs), ws=t(zeros), wsp=t(zeros), kbd=t(zeros),
                kbdp=t(zeros))
    etgt, esrc = np.array([0, 0, 1]), np.array([2, 3, 2])
    gains = rng.uniform(0.2, 0.9, (frames, 3)).astype(np.float32)
    saved = torch.zeros((lanes, 512))
    _, pcm = heaac_graph.lc_scan_decode(core, saved,
                                        (t(etgt), t(esrc), t(gains)))
    m2048, m256, bank = core_consts("cpu")
    ref, saved = [], torch.zeros((lanes, 512))
    for f in range(frames):
        out, saved = core_frame(core["coeffs"][f], saved, core["ws"][f],
                                core["wsp"][f], core["kbd"][f],
                                core["kbdp"][f], m2048, m256, bank)
        ref.append(out.numpy().astype(np.float64))
    ref = np.stack(ref)
    mixed = ref.copy()
    for k in range(3):
        mixed[:, etgt[k]] += gains[:, k, None] * ref[:, esrc[k]]
    assert np.abs(gains[:, 1, None] * ref[:, 3]).max() > 10   # it matters
    want = np.clip(np.rint(mixed), -32768, 32767)
    assert pcm.dtype == torch.int16
    assert np.abs(pcm.numpy() - want).max() <= 1
