"""Whole-stream parity of the PyTorch port with the JAX package on 4
benchdata streams x 8 frames: the port's native parser writes the same
heap bytes and records as heaac_tpu's QwirePipelinedDecoder._parse_group,
and the port's CPU scan is within 2 int16 LSB of qwire_scan_decoder —
also when both start frames 4-7 from the JAX scan's mid-stream carry.

Carries after each half: integers exactly, floats within 1e-4 of each
tensor's peak (the graphs sum in other orders)."""
import numpy as np

from heaac_tpu.codec import heaac_graph as jg
from heaac_tpu.codec.batch import QwirePipelinedDecoder as JaxDecoder
from heaac_tpu_torch.codec import heaac_graph
from heaac_tpu_torch.codec.batch import QwirePipelinedDecoder
from heaac_tpu_torch.codec.state import carry_from_numpy, carry_to_numpy
from test_torch_common import (  # noqa: F401 (autouse fixture)
    assert_exact, assert_peak_close, bench_streams, n, port_parse,
    release_jax_memory, t)

T, SPLIT, LANES = 8, 4, 4
TOL_LSB = 2


def _jax_np(tree):
    state, ph, qc = tree
    return (n(state._asdict()), n(ph),
            {k: n(v) for k, v in qc.items()})


def _compare_carries(got, want, what):
    for part_g, part_w, name in zip(got, want, ("state", "ps_hist", "qc")):
        flat_g, flat_w = {}, {}

        def walk(d, out, pre):
            for k, v in d.items():
                if isinstance(v, dict):
                    walk(v, out, pre + k + ".")
                else:
                    out[pre + k] = np.asarray(v)
        walk(part_g, flat_g, "")
        walk(part_w, flat_w, "")
        assert set(flat_g) == set(flat_w)
        for k, w in flat_w.items():
            if w.dtype.kind == "f":
                assert_peak_close(flat_g[k], w, 1e-4, f"{what} {name}.{k}")
            else:
                assert_exact(flat_g[k], w, f"{what} {name}.{k}")


def test_parser_matches_jax_parse_group():
    streams = bench_streams(LANES)
    jd = JaxDecoder(streams, group_streams=LANES, max_frames=T)
    jheap, jcur, jrecs = jd._parse_group(streams, 0, T)
    pd = QwirePipelinedDecoder(streams, group_streams=LANES, max_frames=T,
                               device="cpu")
    pheap, pcur, precs = pd._parse_group(streams, 0, T)
    assert pcur == jcur
    assert bytes(pheap[:pcur]) == bytes(jheap[:jcur])
    np.testing.assert_array_equal(precs[:T], jrecs[:T])
    for k in ("S", "NB", "MS", "NS", "SEC", "RP", "nl", "sample_rate",
              "rate_idx"):
        assert getattr(pd, k) == getattr(jd, k), k
    assert (pd.is34, pd.ds) == (jd.is34, jd.ds)


def test_scan_matches_jax_with_midstream_carry():
    p = port_parse(LANES, T)
    heap = p["heap"]
    heap = np.concatenate([heap, np.zeros((-len(heap)) % 4, np.uint8)])
    recs = p["recs"]
    static = (p["S"], p["rate_idx"], p["NB"], 0, p["NS"], p["SEC"])
    run = jg.qwire_scan_decoder(0, 0, *static, 0)
    heap_w = heap.view(np.float32)
    jc1, jpcm_a = run(heap_w, recs[:SPLIT].view(np.float32),
                      jg.init_qwire_carry(LANES))
    jc1_np = _jax_np(jc1)
    jc2, jpcm_b = run(heap_w, recs[SPLIT:].view(np.float32), jc1)
    jc2_np = _jax_np(jc2)

    args = (0, 0) + static
    pc1, ppcm_a = heaac_graph.qwire_scan_decode(
        t(heap, None), t(recs[:SPLIT]),
        heaac_graph.init_qwire_carry(LANES, "cpu"), *args)
    da = np.abs(n(ppcm_a).astype(np.int32) - n(jpcm_a)).max()
    assert da <= TOL_LSB, da
    assert np.abs(n(jpcm_a)).max() > 1000
    _compare_carries(carry_to_numpy(pc1), jc1_np, "after frame 4")

    mid = carry_from_numpy(jc1_np, "cpu")
    pc2, ppcm_b = heaac_graph.qwire_scan_decode(
        t(heap, None), t(recs[SPLIT:]), mid, *args)
    db = np.abs(n(ppcm_b).astype(np.int32) - n(jpcm_b)).max()
    assert db <= TOL_LSB, db
    _compare_carries(carry_to_numpy(pc2), jc2_np, "after frame 8")


def test_heap_overflow_grows_and_retries():
    """Parser return -3 (heap full): the decoder grows its staging and
    reparses; the output is the same as with a large heap."""
    streams = bench_streams(2)
    ref = QwirePipelinedDecoder(streams, group_streams=2, max_frames=4,
                                device="cpu").decode()[0].numpy()
    dec = QwirePipelinedDecoder(streams, group_streams=2, max_frames=4,
                                device="cpu")
    dec._cap = 2048
    out = dec.decode()[0].numpy()
    assert dec._cap > 2048
    np.testing.assert_array_equal(out, ref)
    assert dec.frame_counts == [4, 4]
