"""Tests that need an NVIDIA card (marker ``gpu``; they skip without
one): kernel K1 against its plain version at the main path's shapes, a
short main-path decode on the card against the port's CPU decode, the
same for stereo HE-AAC v1 (device M/S, coupled SBR rows),
decode_batch on the card against its CPU run for a stream of each kind,
a stream whose PS band mode flips through the flip scan, AAC-LC streams
with a coupling channel (the LC planner and the coupled LC scan) beside
an HE stream the native probe refuses (the Python prober and profile
parse), the downsampled-SBR scan, the single-stream Decoder
(``decode_adts``; K1 at one lane), ``decode_m4a`` on the committed
.m4a inputs, the parallel layer: ``ShardedQwireDecoder`` with two
shards on one card and, with two cards or more, K1 on ``cuda:1`` while
``cuda:0`` is current and the sharded decode across both cards; and the
plan-record decoders: ``StreamBatchDecoder`` (compact and dense) on
the card against its CPU runs, and ``ShardedStreamBatchDecoder`` with
two shards on one card against the unsharded decode, K1 once a frame
(per shard) at napb 30; the qwire
scan's CUDA-graph replay of its frame step against the same frames
stepped eagerly, chained scans, and the graph cache's second call; the
qwire step's row-decoder kernel against the plain row decoders on fuzzed
regions and on the regions real streams give, and ``decode_batch`` with
and without it; the PCM's one copy a group off the card
(``stream_pcm``) against its CPU split, and a first call's results
after a second call.

    python -m pytest tests/test_torch_gpu.py -q --noconftest   # on the GPU

(``--noconftest``: the GPU machine has no jax, and tests/conftest.py
imports it.)
"""
import numpy as np
import pytest
import torch

from heaac_tpu_torch import Decoder, decode_adts, decode_batch, decode_m4a
from heaac_tpu_torch.codec import heaac_graph, step_graph
from heaac_tpu_torch.codec.batch import (QwirePipelinedDecoder,
                                         StreamBatchDecoder,
                                         decode_qwire_flip_stream,
                                         pack_planner_frames)
from heaac_tpu_torch.codec.planner import parse_stream_qwire
from heaac_tpu_torch.host import R_W1, spec_static_args, split_adts_stream
from heaac_tpu_torch.ops import ps_decorrelate as K
from heaac_tpu_torch.ops import qwire_rows
from heaac_tpu_torch.parallel.sharding import (ShardedQwireDecoder,
                                               ShardedStreamBatchDecoder)
from heaac_tpu_torch.utils import trace
from test_torch_common import (bench_streams, golden_tool, lanes, leaves,
                               row_decoder_inputs, streams_of)

pytestmark = pytest.mark.gpu
NAMES = ("power", "in_re", "in_im", "trans", "ap", "ag", "qf")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is False)")
    return torch.device("cuda")


@pytest.fixture
def two_cards():
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards")
    return [torch.device("cuda", 0), torch.device("cuda", 1)]


@pytest.mark.parametrize("napb", [30, 50])
@pytest.mark.parametrize("B", [1, 3, 512, 513])
def test_k1_kernel_matches_plain(cuda, B, napb):
    """Bit for bit, also where the last tile of lanes is ragged."""
    inp = K.random_inputs(B, napb, seed=napb)
    args = [torch.from_numpy(inp[k]).to(cuda).contiguous() for k in NAMES]
    before = dict(K.launches)
    got = K.decorrelate_seq(*args)
    assert K.launches == {**before, napb: before[napb] + 1}
    ref = K.decorrelate_plain(*args)
    torch.cuda.synchronize()
    for a, b in zip(got, ref):
        assert a.shape == b.shape
        assert float((a - b).abs().max()) == 0.0


def test_main_path_on_card_matches_cpu(cuda):
    streams = bench_streams(4)
    before = K.launches[30]
    gpu = QwirePipelinedDecoder(streams, group_streams=4, max_frames=8,
                                device=cuda).decode()[0].cpu().numpy()
    assert K.launches[30] - before == 8
    cpu = QwirePipelinedDecoder(streams, group_streams=4, max_frames=8,
                                device="cpu").decode()[0].numpy()
    assert np.abs(gpu.astype(np.int32) - cpu).max() <= 2


def test_stereo_decode_on_card_matches_cpu(cuda):
    """8 stereo HE-AAC v1 streams x 8 frames (16 lanes): M/S and coupled
    SBR rows on the card, K1 once per frame, within 2 LSB of the CPU."""
    streams = streams_of("he_v1s", 8)
    before = dict(K.launches)
    dec = QwirePipelinedDecoder(streams, group_streams=8, max_frames=8,
                                device=cuda)
    gpu = dec.decode()[0].cpu().numpy()
    assert (dec.MS, dec.RP) == (1, 1)
    assert {napb: K.launches[napb] - before[napb] for napb in before} == {
        30: 8, 50: 0}
    cpu = QwirePipelinedDecoder(streams, group_streams=8, max_frames=8,
                                device="cpu").decode()[0].numpy()
    assert gpu.shape == cpu.shape == (8, 16, 2, 2048)
    assert np.abs(cpu).max(axis=(0, 2, 3)).min() > 0
    assert np.abs(gpu.astype(np.int32) - cpu).max() <= 2


def test_decode_batch_on_card_matches_cpu(cuda):
    """One 20-band, one 34-band and one LC stream (8 frames each) and a
    buffer with no sync word: the card's output within 2 LSB of the
    CPU's, K1 launched once per frame in each band mode."""
    streams = [b"".join(split_adts_stream(streams_of(kind, 1)[0])[:8])
               for kind in ("he20", "he34", "lc")] + [b"no sync word"]
    before = dict(K.launches)
    gpu = decode_batch(streams)
    assert {napb: K.launches[napb] - before[napb] for napb in before} == {
        30: 8, 50: 8}
    cpu = decode_batch(streams, device="cpu")
    assert tuple(gpu[3].shape) == tuple(cpu[3].shape) == (0, 1)
    for g, c in zip(gpu[:3], cpu[:3]):
        assert g.shape == c.shape and g.dtype == c.dtype == torch.int16
        assert int((g.int() - c.int()).abs().max()) <= 2


def test_flip_stream_on_card_matches_cpu(cuda):
    """Flip stream 2 (20 -> 34 -> 20 bands at frames 5 and 11), 12
    frames through decode_qwire_flip_stream on the card: K1 at napb 30
    and at napb 50 in every frame, within 2 LSB of the CPU."""
    data = b"".join(split_adts_stream(streams_of("flip", 3)[2])[:12])
    before = dict(K.launches)
    gpu = decode_qwire_flip_stream(data, device=cuda)
    assert {napb: K.launches[napb] - before[napb] for napb in before} == {
        30: 12, 50: 12}
    cpu = decode_qwire_flip_stream(data, device="cpu")
    assert gpu.shape == cpu.shape == (12 * 2048, 2)
    assert int(cpu.abs().max()) > 1000
    assert int((gpu.int() - cpu.int()).abs().max()) <= 2


def test_lc_planner_and_prober_on_card_match_cpu(cuda):
    """Two AAC-LC + CCE streams (after the IMDCT, before TNS) and a
    20-band stream with a corrupted frame 1 (the Python prober, then the
    Python profile parse), 8 frames each: within 2 LSB of the CPU, K1
    once per frame of the HE bucket and once for the prober's decode of
    the probed stream's frame 0 (PS runs there)."""
    tool = golden_tool()
    streams = [b"".join(split_adts_stream(tool.named_stream(name))[:8])
               for name in ("he20_f1_0", "lc_cce_after_0",
                            "lc_cce_before_1")]
    before = dict(K.launches)
    gpu = decode_batch(streams)
    assert {napb: K.launches[napb] - before[napb] for napb in before} == {
        30: 9, 50: 0}
    cpu = decode_batch(streams, device="cpu")
    for g, c, shape in zip(gpu, cpu, ((8 * 2048, 2), (8 * 1024, 1),
                                      (8 * 1024, 1))):
        assert tuple(g.shape) == tuple(c.shape) == shape
        assert int(c.abs().max()) > 1000
        assert int((g.int() - c.int()).abs().max()) <= 2


def test_downsampled_scan_on_card_matches_cpu(cuda):
    """Downsampled streams 0-1 parsed with their AudioSpecificConfig, 8
    frames through qwire_scan_decode(downsampled=1): 1024 samples a
    frame, K1 once per frame, within 2 LSB of the CPU."""
    data, asc = golden_tool().ds_streams()
    frames = [parse_stream_qwire(d, asc=asc, max_frames=8)[0]
              for d in data[:2]]
    heap, _, recs = pack_planner_frames(frames, 1, 8)
    sa = spec_static_args(recs)
    S = -(-max(64, int((recs[..., R_W1] & 0xFFFF).max())) // 64) * 64
    args = (0, 1, S, 6, sa["NB"], 0, sa["NS"], sa["SEC"])

    def run(dev):
        carry = heaac_graph.init_qwire_carry(2, dev)
        _, pcm = heaac_graph.qwire_scan_decode(
            torch.from_numpy(heap).to(dev), torch.from_numpy(recs).to(dev),
            carry, *args)
        return pcm.cpu().numpy()

    before = dict(K.launches)
    gpu = run(cuda)
    assert {napb: K.launches[napb] - before[napb] for napb in before} == {
        30: 8, 50: 0}
    cpu = run("cpu")
    assert gpu.shape == cpu.shape == (8, 2, 2, 1024)
    assert np.abs(cpu).max() > 1000
    assert np.abs(gpu.astype(np.int32) - cpu).max() <= 2


def test_single_decoder_on_card_matches_cpu(cuda):
    """The single-stream Decoder on the card (``decode_adts``, and
    ``Decoder(asc=)`` for downsampled SBR), 6 frames of a 20-band and a
    34-band HE-AAC v2 stream, a stereo HE-AAC v1 stream and a
    downsampled stream: within 2 LSB of the CPU; K1 at one lane once per
    frame in which PS runs (6 at napb 30 for the 20-band and the
    downsampled stream, 6 at napb 50)."""
    tool = golden_tool()
    heads = {name: split_adts_stream(tool.single_stream(name))[:6]
             for name in ("he20_0", "he34_0", "he_v1s_1", "ds_0")}
    with open(f"{tool.REPO}/{tool.DS_ASC}", "rb") as f:
        asc = f.read()

    def run(name, dev):
        if name == "ds_0":
            dec = Decoder(asc=asc, device=dev)
            return torch.cat([dec.decode_frame(fr[7:]) for fr in heads[name]])
        return decode_adts(b"".join(heads[name]), device=dev)[0]

    before = dict(K.launches)
    gpu = {name: run(name, cuda) for name in heads}
    assert {napb: K.launches[napb] - before[napb] for napb in before} == {
        30: 12, 50: 6}
    for name, g in gpu.items():
        c = run(name, "cpu")
        assert g.device.type == "cpu" and g.dtype == torch.int16
        assert tuple(g.shape) == tuple(c.shape)
        assert int(c.abs().max()) > 1000
        assert int((g.int() - c.int()).abs().max()) <= 2, name


def test_decode_m4a_on_card_matches_cpu(cuda, monkeypatch):
    """``decode_m4a`` on the card over the committed .m4a inputs (16
    frames: the ADTS re-wrap, explicit SBR through the ASC-configured
    Decoder with one corrupted frame dropped, downsampled SBR): within 2
    LSB of the CPU, the same rate, and K1 at one lane exactly once per
    frame in which PS ran on the CPU run (where the corrupted frame is
    dropped, PS stops: 3 frames)."""
    from heaac_tpu_torch.ops import ps as ps_ops
    tool = golden_tool()
    names = ("he20_0", "he20_explicit_bad_0", "ds_0")
    m4a = {}
    for name in names:
        with open(f"{tool.REPO}/{tool.FRONT_FILE.format(name)}", "rb") as f:
            m4a[name] = f.read()
    calls = []
    real = ps_ops.decorrelate_seq

    def spy(*a):
        if a[0].device.type == "cpu":
            calls.append((a[0].shape[0], a[1].shape[1]))
        return real(*a)

    monkeypatch.setattr(ps_ops, "decorrelate_seq", spy)
    cpu = {name: decode_m4a(m4a[name], device="cpu") for name in names}
    assert calls == [(1, 30)] * (2 * tool.FRAMES + 3)
    before = dict(K.launches)
    gpu = {name: decode_m4a(m4a[name], device=cuda) for name in names}
    assert {napb: K.launches[napb] - before[napb] for napb in before} == {
        30: len(calls), 50: 0}
    for name, (g, rate) in gpu.items():
        c, crate = cpu[name]
        assert rate == crate and g.device.type == "cpu"
        assert tuple(g.shape) == tuple(c.shape)
        assert int(c.abs().max()) > 1000
        assert int((g.int() - c.int()).abs().max()) <= 2, name


def _sharded_vs_unsharded(devices):
    """8 bench streams x 8 frames over ``devices``: (sharded pcm, the
    unsharded decode's on devices[0], K1's napb-30 launches of the
    sharded decode)."""
    streams = bench_streams(8)
    ref = QwirePipelinedDecoder(streams, max_frames=8,
                                device=devices[0]).decode()[0].cpu()
    before = K.launches[30]
    got = ShardedQwireDecoder(streams, devices=devices,
                              max_frames=8).decode()[0]
    return got, ref, K.launches[30] - before


def test_sharded_on_one_card_equals_unsharded(cuda):
    """Two shards of 4 lanes on one card: K1 once a frame per shard, the
    PCM equal to the unsharded decode's on the card."""
    got, ref, launches = _sharded_vs_unsharded([cuda, cuda])
    assert launches == 2 * 8
    assert got.device.type == "cpu" and got.shape == ref.shape
    assert torch.equal(got, ref)


def test_k1_on_second_card_matches_plain(two_cards):
    """K1 on tensors on cuda:1 while cuda:0 is the current device (the
    launcher raises the shared-memory limit on, and launches from, the
    tensors' card), bit for bit against its plain version."""
    dev = two_cards[1]
    with torch.cuda.device(two_cards[0]):
        for napb in (30, 50):
            inp = K.random_inputs(256, napb, seed=napb)
            args = [torch.from_numpy(inp[k]).to(dev) for k in NAMES]
            got = K.decorrelate_seq(*args)
            ref = K.decorrelate_plain(*args)
            torch.cuda.synchronize(dev)
            assert all(a.device == dev for a in got)
            assert all(float((a - b).abs().max()) == 0.0
                       for a, b in zip(got, ref))
            assert K.ctas_per_sm(napb, dev) > 0


def test_sharded_across_two_cards_equals_unsharded(two_cards):
    got, ref, launches = _sharded_vs_unsharded(two_cards)
    assert launches == 2 * 8
    assert torch.equal(got, ref)


def _k1_counted(fn):
    """(fn(), K1's launches at napb 30 and 50 during it)."""
    before = dict(K.launches)
    out = fn()
    return out, {k: K.launches[k] - before[k] for k in K.launches}


@pytest.mark.parametrize("compact", [True, False], ids=["compact", "dense"])
def test_stream_batch_decoder_on_card_matches_cpu(cuda, compact):
    streams = bench_streams(8)
    pcm, k1 = _k1_counted(lambda: StreamBatchDecoder(
        streams, max_frames=8, compact=compact).decode().cpu())
    assert k1 == {30: 8, 50: 0}
    ref = StreamBatchDecoder(streams, max_frames=8, compact=compact,
                             device="cpu").decode()
    assert pcm.shape == ref.shape == (8, 8, 2, 2048)
    assert int((pcm.int() - ref.int()).abs().max()) <= 2


def test_sharded_stream_batch_decoder_on_one_card(cuda):
    streams = bench_streams(8)
    ref = StreamBatchDecoder(streams, max_frames=8, device=cuda).decode()
    got, k1 = _k1_counted(lambda: ShardedStreamBatchDecoder(
        streams, devices=[cuda, cuda], max_frames=8).decode())
    assert k1 == {30: 16, 50: 0}
    assert int((got.int() - ref.cpu().int()).abs().max()) <= 1


def _wire(kind: str, n: int, T: int, dev):
    """n streams of one kind, T frames, parsed and uploaded as the
    pipelined decoder does -> (lanes, heap, recs, couple, static args)."""
    if kind == "ds":
        data, asc = golden_tool().ds_streams()
        frames = [parse_stream_qwire(d, asc=asc, max_frames=T)[0]
                  for d in data[:n]]
        heap, _, recs = pack_planner_frames(frames, 1, T)
        sa = spec_static_args(recs)
        S = -(-max(64, int((recs[..., R_W1] & 0xFFFF).max())) // 64) * 64
        return n, torch.from_numpy(heap).to(dev), \
            torch.from_numpy(recs).to(dev), None, dict(
                is34=0, downsampled=1, S=S, rate_idx=6, NB=sa["NB"],
                NS=sa["NS"], SEC=sa["SEC"])
    dec = QwirePipelinedDecoder(streams_of(kind, n), group_streams=n,
                                max_frames=T, device=dev)
    cur, Tg, sa, couple = dec._parse_with_retry(0)
    heap, recs, couple = dec._upload(0, cur, Tg, couple)
    return dec.L, heap, recs, couple, dict(is34=dec.is34,
                                           downsampled=dec.ds, **sa)


def _scan(wire, lo: int, hi: int, carry=None):
    """qwire_scan_decode over frames lo:hi of a _wire -> (carry, pcm)."""
    L, heap, recs, couple, sa = wire
    if couple is not None:
        couple = couple[:3] + (couple[3][lo:hi],)
    if carry is None:
        carry = heaac_graph.init_qwire_carry(L, heap.device)
    return heaac_graph.qwire_scan_decode(heap, recs[lo:hi], carry,
                                         couple=couple, **sa)


def _counted(fn):
    """(fn(), the scan.graph counters and the kernels' launches that
    moved)."""
    before = trace.snapshot()
    out = fn()
    after = trace.snapshot()
    return out, {k: after[k] - before.get(k, 0) for k in after
                 if k.startswith(("scan.graph.", "k1.launches.",
                                  "qwire_rows.launches."))
                 and after[k] != before.get(k, 0)}


def _leaves(carry) -> list:
    return [a for a, _ in step_graph._zip(carry, carry)]


def _eager_scan(wire, T: int):
    """The scan's prologue, then its frame step called eagerly frame by
    frame on contiguous rows, as the scan steps (the loop the graph
    replaces) -> (carry, pcm)."""
    L, heap, recs, couple, sa = wire
    heap, recs, coeffs = heaac_graph.decode_all_coeffs(
        heap, recs[:T], sa["S"], sa["rate_idx"], sa["NB"], sa.get("MS", 0),
        sa["NS"], sa["SEC"])
    coeffs = coeffs.contiguous()
    carry, out = heaac_graph.init_qwire_carry(L, heap.device), []
    for t in range(T):
        o, carry = heaac_graph.heaac_frame_qwire(
            coeffs[t], recs[t], heap, carry, sa["is34"], sa["downsampled"],
            sa.get("rows_pair", 0))
        out.append(o if couple is not None else heaac_graph.to_int16(o))
    pcm = torch.stack(out)
    if couple is not None:
        pcm = heaac_graph.to_int16(heaac_graph.couple_mix(
            pcm, *couple[:3], couple[3][:T]))
    return carry, pcm


@pytest.mark.parametrize("kind,n,T", [("he20", 8, 50), ("he_v1s", 4, 16),
                                      ("cce_after", 2, 16), ("ds", 2, 16)])
def test_graph_scan_equals_eager_steps(cuda, kind, n, T):
    """The graph-replayed scan against its frame step called eagerly
    frame by frame, bit for bit: 20-band HE-AAC v2, stereo with coupled
    SBR rows (rows_pair 1), coupling (the float output mixed after the
    loop) and downsampled SBR."""
    wire = _wire(kind, n, T, cuda)
    (c_g, pcm), k = _counted(lambda: _scan(wire, 0, T))
    eager = k.get("scan.graph.eager_steps", 0)
    assert eager <= 1 and k["scan.graph.replays"] == T - eager
    assert k.get("scan.graph.captures", 0) == eager
    assert k["k1.launches.30"] == T
    assert k[f"qwire_rows.launches.{wire[4].get('rows_pair', 0)}"] == T
    carry, ref = _eager_scan(wire, T)
    assert wire[4].get("rows_pair", 0) == (kind == "he_v1s")
    assert (wire[3] is not None) == (kind == "cce_after")
    assert int(pcm.abs().max()) > 1000
    assert torch.equal(pcm, ref)
    for a, b in zip(_leaves(c_g), _leaves(carry)):
        assert torch.equal(a, b)


def test_graph_scan_chains_and_replays_from_the_cache(cuda):
    """Two chained scans equal one long scan, and the first scan's
    returned carry is left as it was by the second; a second scan of the
    same shapes captures nothing and replays every step; K1 counts one
    launch a step either way."""
    T = 16
    wire = _wire("he20", 8, T, cuda)
    c1, p1 = _scan(wire, 0, T // 2)
    kept = [x.clone() for x in _leaves(c1)]
    c2, p2 = _scan(wire, T // 2, T, c1)
    assert all(torch.equal(a, b) for a, b in zip(kept, _leaves(c1)))
    _, whole = _scan(wire, 0, T)
    assert torch.equal(torch.cat([p1, p2]), whole)
    (c3, again), k = _counted(lambda: _scan(wire, 0, T))
    assert torch.equal(again, whole)
    assert k == {"scan.graph.replays": T, "k1.launches.30": T,
                 "qwire_rows.launches.0": T}
    assert all(torch.equal(a, b) for a, b in zip(_leaves(c2),
                                                 _leaves(c3)))


def _rows_equal(sbr, ps, pair: bool) -> None:
    """The row-decoder kernel against the plain decoders on the same
    card tensors, bit for bit, with one launch counted."""
    before = dict(qwire_rows.launches)
    got = qwire_rows.decode_rows(sbr, ps, pair)
    assert qwire_rows.launches == {**before, pair: before[pair] + 1}
    want = qwire_rows.decode_rows_plain(sbr, ps, pair)
    torch.cuda.synchronize()
    assert len(leaves(got)) == len(leaves(want)) == 21
    for k, (a, b) in enumerate(zip(leaves(got), leaves(want))):
        assert a.dtype == b.dtype and a.shape == b.shape, k
        assert torch.equal(a, b), k


@pytest.mark.parametrize("pair,wild", [(False, False), (True, False),
                                       (False, True), (True, True)],
                         ids=["sbr", "pair", "sbr-wild", "pair-wild"])
@pytest.mark.parametrize("B", [1, 8, 64])
def test_qwire_rows_kernel_matches_plain_on_fuzzed_regions(cuda, B, pair,
                                                           wild):
    """Random region bytes and controls: rows that decode, overrun their
    windows, meet codes no table holds and read past the region's end
    (clamped), on every control value the wire's fields can hold."""
    for seed in range(3):
        sbr, ps = row_decoder_inputs(B, seed=100 * B + 10 * seed + 2 * pair
                                     + wild, pair=pair, device=cuda,
                                     wild=wild)
        _rows_equal(sbr, ps, pair)


def _stream_rows(kind: str, n: int, T: int, dev) -> list:
    """The (sbr, ps, pair) arguments ``expand_frame`` gives the row
    decoders over T frames of n streams of a kind, stepped eagerly on the
    card with the plain decoders."""
    seen = []

    def record(sbr, ps, pair):
        seen.append((sbr, ps, pair))
        return qwire_rows.decode_rows_plain(sbr, ps, pair)

    real = qwire_rows.decode_rows
    qwire_rows.decode_rows = record
    try:
        _eager_scan(_wire(kind, n, T, dev), T)
    finally:
        qwire_rows.decode_rows = real
    assert len(seen) == T
    return seen


@pytest.mark.parametrize("kind,n", [("he20", 8), ("he_v1s", 4)])
def test_qwire_rows_kernel_matches_plain_on_stream_regions(cuda, kind, n):
    """The regions and controls of 16 frames of real streams: 20-band
    HE-AAC v2, and stereo HE-AAC v1's coupled pairs (pair=True), at 1,
    8 and 64 lanes (the streams' lanes tiled)."""
    frames = _stream_rows(kind, n, 16, cuda)
    assert {pair for _, _, pair in frames} == {kind == "he_v1s"}
    assert sum(int(sbr["active"].sum()) for sbr, _, _ in frames) > 0
    assert sum(int((ps["nr_iid"] > 0).sum()) for _, ps, _ in frames) > 0 \
        or kind == "he_v1s"
    for B in (1, 8, 64):
        for sbr, ps, pair in frames:
            L = sbr["region"].shape[0]
            idx = torch.arange(B, device=cuda) % L
            _rows_equal(lanes(sbr, idx), lanes(ps, idx), pair)


def test_decode_batch_with_and_without_the_row_kernel(cuda, monkeypatch):
    """A short decode_batch on the card (four 20-band and two stereo
    streams, 16 frames) under the step graph gives the same PCM with the
    row-decoder kernel as with the plain row decoders; the kernel counts
    one launch a frame step, the plain decoders none."""
    streams = [b"".join(split_adts_stream(d)[:16])
               for d in streams_of("he20", 4) + streams_of("he_v1s", 2)]

    def run():
        # a fresh graph cache: a cached graph would replay the other route
        monkeypatch.setattr(step_graph, "_graphs",
                            step_graph.collections.OrderedDict())
        return _counted(lambda: decode_batch(streams))

    got, k = run()
    monkeypatch.setattr(qwire_rows, "decode_rows",
                        qwire_rows.decode_rows_plain)
    want, k_plain = run()
    steps = k.get("scan.graph.eager_steps", 0) + k["scan.graph.replays"]
    assert k["scan.graph.replays"] > 0 and k_plain["scan.graph.replays"] > 0
    assert k["qwire_rows.launches.0"] > 0 and k["qwire_rows.launches.1"] > 0
    assert k["qwire_rows.launches.0"] + k["qwire_rows.launches.1"] == steps
    assert not any(key.startswith("qwire_rows.") for key in k_plain)
    for a, b in zip(got, want):
        assert a.shape == b.shape and int(a.abs().max()) > 1000
        assert torch.equal(a, b)


def _owns_pageable_storage(p) -> bool:
    st = p.untyped_storage()
    return (st.nbytes() == p.numel() * p.element_size()
            and not p.is_pinned() and p.device.type == "cpu")


@pytest.mark.parametrize("kind,n", [("he20", 8), ("he_v1s", 4)])
def test_stream_pcm_on_card_equals_its_cpu_split(cuda, kind, n):
    """``stream_pcm`` of a card's groups (two, one stream cut to 3 of 8
    frames) equals the CPU split of the same groups bit for bit; one
    device-to-host copy a group, of the group's output lanes; every
    result owns pageable storage of its own."""
    streams = streams_of(kind, n)
    streams[0] = b"".join(split_adts_stream(streams[0])[:3])
    dec = QwirePipelinedDecoder(streams, group_streams=n // 2, max_frames=8,
                                device=cuda)
    outs = dec.decode()
    before = trace.snapshot()
    got = dec.stream_pcm(outs)
    after = trace.snapshot()
    want = dec.stream_pcm([o.cpu() for o in outs])
    # mono core: both channels of lane 0; stereo: channel 0 of two lanes
    nbytes = sum(o.shape[0] * dec.G * o.shape[-1] * 2 * 2 for o in outs)
    assert len(outs) == 2
    assert after["pcm.d2h_copies"] - before.get("pcm.d2h_copies", 0) == 2
    assert after["pcm.d2h_bytes"] - before.get("pcm.d2h_bytes", 0) == nbytes
    assert [p.shape[0] for p in got] == [3 * 2048] + [8 * 2048] * (n - 1)
    for g, w in zip(got, want):
        assert _owns_pageable_storage(g)
        assert torch.equal(g, w)
    assert len({p.untyped_storage().data_ptr() for p in got}) == n


def test_decode_batch_results_survive_a_second_call(cuda):
    """A second ``decode_batch`` call of the same shape (its page-locked
    staging the first call's, from the host allocator's cache) leaves
    the first call's results as they were."""
    def cut(ds):
        return [b"".join(split_adts_stream(d)[:8]) for d in ds]

    he20 = streams_of("he20", 8)
    first = decode_batch(cut(he20[:4]))
    kept = [p.clone() for p in first]
    second = decode_batch(cut(he20[4:]))
    assert all(a.shape == b.shape and not torch.equal(a, b)
               for a, b in zip(first, second))
    for p, k in zip(first, kept):
        assert _owns_pageable_storage(p)
        assert torch.equal(p, k)
