"""Whole-stream parity of the PyTorch port with the JAX package: on 4
benchdata streams x 8 frames the port's native parser writes the same
heap bytes and records as heaac_tpu's QwirePipelinedDecoder._parse_group;
on streams 0-1 x 16 frames the port's CPU scan is within 2 int16 LSB of
the JAX qwire scan's PCM in the committed golden
(tests/data/heaac_v2_golden_jax.npz, which tests/test_torch_golden.py
regenerates) — also when the port starts frames 8-15 from the JAX scan's
carry after frame 8, stored there beside the PCM.  ``stream_pcm``'s
per-stream split equals a plain formula bit for bit, and its results
own their storage.

Carries after each half: integers exactly, floats within 1e-4 of each
tensor's peak (the graphs sum in other orders)."""
import numpy as np
import pytest
import torch

from heaac_tpu.codec.batch import QwirePipelinedDecoder as JaxDecoder
from heaac_tpu_torch.codec import heaac_graph
from heaac_tpu_torch.codec.batch import QwirePipelinedDecoder
from heaac_tpu_torch.codec.state import carry_from_numpy, carry_to_numpy
from heaac_tpu_torch.host import split_adts_stream
from heaac_tpu_torch.utils import trace
from test_torch_common import (  # noqa: F401 (autouse fixture)
    assert_tree_close, bench_streams, golden_tool, n, port_parse,
    release_jax_memory, streams_of, t)

T, LANES = 8, 4
TOL_LSB = 2


def _golden():
    """The committed JAX scan: pcm [16, 2, 2, 2048] and its carries after
    frames 8 and 16, in carry_to_numpy's layout."""
    tool = golden_tool()
    with np.load(tool.GOLDEN) as z:
        return (z["pcm"], tool.unflatten_tree(z, "carry_mid"),
                tool.unflatten_tree(z, "carry_end"))


def test_parser_matches_jax_parse_group():
    streams = bench_streams(LANES)
    jd = JaxDecoder(streams, group_streams=LANES, max_frames=T)
    jheap, jcur, jrecs = jd._parse_group(streams, 0, T)
    pd = QwirePipelinedDecoder(streams, group_streams=LANES, max_frames=T,
                               device="cpu")
    pheap, pcur, precs, _ = pd._parse_group(streams, 0, T)
    assert pcur == jcur
    assert bytes(pheap[:pcur]) == bytes(jheap[:jcur])
    np.testing.assert_array_equal(precs[:T], jrecs[:T])
    for k in ("S", "NB", "MS", "NS", "SEC", "RP", "nl", "sample_rate",
              "rate_idx"):
        assert getattr(pd, k) == getattr(jd, k), k
    assert (pd.is34, pd.ds) == (jd.is34, jd.ds)


def test_scan_matches_jax_with_midstream_carry():
    jpcm, jmid, jend = _golden()
    frames, half = jpcm.shape[0], jpcm.shape[0] // 2
    p = port_parse(2, frames)
    heap = t(p["heap"], None)
    recs = p["recs"]
    args = (0, 0, p["S"], p["rate_idx"], p["NB"], 0, p["NS"], p["SEC"])
    assert np.abs(jpcm).max() > 1000

    pc1, ppcm_a = heaac_graph.qwire_scan_decode(
        heap, t(recs[:half]), heaac_graph.init_qwire_carry(2, "cpu"), *args)
    da = np.abs(n(ppcm_a).astype(np.int32) - jpcm[:half]).max()
    assert da <= TOL_LSB, da
    assert_tree_close(carry_to_numpy(pc1), jmid, 1e-4,
                      f"after frame {half}")

    pc2, ppcm_b = heaac_graph.qwire_scan_decode(
        heap, t(recs[half:]), carry_from_numpy(jmid, "cpu"), *args)
    db = np.abs(n(ppcm_b).astype(np.int32) - jpcm[half:]).max()
    assert db <= TOL_LSB, db
    assert_tree_close(carry_to_numpy(pc2), jend, 1e-4,
                      f"after frame {frames}")


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


def test_groups_reuse_staging_with_a_short_stream():
    """Five streams in groups of two, one of them a single frame long:
    staging set 0 serves groups 0 and 2.  Every group's PCM equals that
    group decoded alone by a fresh decoder, and the frame counts are
    exact.  Group 0 parsed again into set 0, which then holds group 2's
    full-length records, leaves silence records at the short stream's
    lane after its one frame, not group 2's."""
    bench = bench_streams(5)
    short = split_adts_stream(bench[4])[0]
    streams = bench[:4] + [short]
    dec = QwirePipelinedDecoder(streams, group_streams=2, max_frames=4,
                                device="cpu")
    outs = [n(o) for o in dec.decode()]
    assert [o.shape for o in outs] == [(4, 2, 2, 2048)] * 3
    assert dec.frame_counts == [4, 4, 4, 4, 1]
    pcm = dec.stream_pcm(dec.decode())
    assert [tuple(p.shape) for p in pcm] == [(8192, 2)] * 4 + [(2048, 2)]
    # length bucketing: the short stream first, the last group padded
    # with a copy of its first stream
    groups = [[short, bench[0]], bench[1:3], [bench[3], bench[3]]]
    assert [dec.group_of[i] for i in (4, 0, 1, 2, 3)] == [0, 0, 1, 1, 2]
    for g, group in enumerate(groups):
        alone = QwirePipelinedDecoder(group, group_streams=2, max_frames=4,
                                      device="cpu").decode()
        np.testing.assert_array_equal(outs[g], n(alone[0]),
                                      err_msg=f"group {g}")
    recs = dec._buffers(0)[3]
    lane = dec.slot_of[4] * dec.nl
    assert not np.array_equal(recs[1:, lane], dec._sil_recs[1:, lane])
    dec._parse_with_retry(0)
    np.testing.assert_array_equal(recs[1:, lane], dec._sil_recs[1:, lane])
    assert not np.array_equal(recs[0, lane], dec._sil_recs[0, lane])


def test_another_band_mode_raises():
    """A 34-band HE-AAC v2 stream in a batch whose stream 0 is 20-band:
    the decode raises ValueError (decode_batch buckets them apart)."""
    streams = streams_of("he20", 1) + streams_of("he34", 1)
    dec = QwirePipelinedDecoder(streams, group_streams=2, max_frames=2,
                                device="cpu")
    assert dec.is34 == 0
    with pytest.raises(ValueError, match="is34=1 in a batch of is34=0"):
        dec.decode()


def _stream_pcm_plain(dec, outs) -> list:
    """The per-stream split as a plain formula: each group copied to the
    host whole, then each stream's lanes permuted and reshaped there."""
    outs = [o.cpu() for o in outs]
    lps = dec.out_nl
    res = []
    for j in range(len(dec.streams)):
        pcm = outs[dec.group_of[j]]
        lane0 = dec.slot_of[j] * dec.nl
        lanes = pcm[:dec.frame_counts[j], lane0:lane0 + lps]
        if lps == 1:                             # mono core -> stereo
            res.append(lanes[:, 0].permute(0, 2, 1).reshape(-1, 2))
        else:                                    # one channel per lane
            res.append(torch.stack(
                [lanes[:, k, 0].reshape(-1) for k in range(lps)], -1))
    return res


def _with_a_one_frame_stream(kind: str) -> list:
    """Three streams of ``kind`` and the first frame of its stream 0:
    in groups of two, the short stream shares a group with a full one
    and the last group is padded."""
    streams = streams_of(kind, 3)
    return streams + [split_adts_stream(streams[0])[0]]


@pytest.mark.parametrize("kind", ["he20", "he_v1s", "cce_after"])
def test_stream_pcm_equals_the_plain_split(kind):
    """Mono core with PS (stereo out), stereo HE-AAC v1 (two output
    lanes) and a mono core with a coupling channel (its lane dropped):
    every stream's PCM equals the plain split bit for bit, cut at its
    own frame count."""
    streams = _with_a_one_frame_stream(kind)
    dec = QwirePipelinedDecoder(streams, group_streams=2, max_frames=3,
                                device="cpu")
    outs = dec.decode()
    assert dec.frame_counts == [3, 3, 3, 1]
    assert (dec.nl > dec.out_nl) == (kind == "cce_after")
    got = dec.stream_pcm(outs)
    want = _stream_pcm_plain(dec, outs)
    assert [tuple(p.shape) for p in got] == [(3 * 2048, 2)] * 3 + [
        (2048, 2)]
    assert int(torch.stack([p[:2048] for p in got]).abs().max()) > 1000
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == torch.int16
        assert torch.equal(g, w)


def test_stream_pcm_results_own_their_storage():
    """Every result owns a storage of its own bytes, none shared, none
    page-locked; CPU groups make no device-to-host copy; a second call
    leaves the first call's results as they were."""
    streams = _with_a_one_frame_stream("he20")
    dec = QwirePipelinedDecoder(streams, group_streams=2, max_frames=3,
                                device="cpu")
    outs = dec.decode()
    before = trace.snapshot()
    first = dec.stream_pcm(outs)
    after = trace.snapshot()
    for k in ("pcm.d2h_copies", "pcm.d2h_bytes"):
        assert after.get(k, 0) == before.get(k, 0)
    ptrs = set()
    for p in first:
        st = p.untyped_storage()
        assert st.nbytes() == p.numel() * p.element_size()
        assert p.storage_offset() == 0 and p.is_contiguous()
        assert not p.is_pinned()
        ptrs.add(st.data_ptr())
    assert len(ptrs) == len(first)
    kept = [p.clone() for p in first]
    second = dec.stream_pcm([torch.zeros_like(o) for o in outs])
    assert all(int(p.abs().max()) == 0 for p in second)
    for p, k in zip(first, kept):
        assert torch.equal(p, k)
