"""Tests that need an NVIDIA card (marker ``gpu``; they skip without
one): kernel K1 against its plain version at the main path's shapes, a
short main-path decode on the card against the port's CPU decode, the
same for stereo HE-AAC v1 (device M/S, coupled SBR rows),
decode_batch on the card against its CPU run for a stream of each kind,
a stream whose PS band mode flips through the flip scan, AAC-LC streams
with a coupling channel (the LC planner and the coupled LC scan) beside
an HE stream the native probe refuses (the Python prober and profile
parse), the downsampled-SBR scan, the single-stream Decoder
(``decode_adts``; K1 at one lane), and ``decode_m4a`` on the committed
.m4a inputs.

    python -m pytest tests/test_torch_gpu.py -q --noconftest   # on the GPU

(``--noconftest``: the GPU machine has no jax, and tests/conftest.py
imports it.)
"""
import numpy as np
import pytest
import torch

from heaac_tpu_torch import Decoder, decode_adts, decode_batch, decode_m4a
from heaac_tpu_torch.codec import heaac_graph
from heaac_tpu_torch.codec.batch import (QwirePipelinedDecoder,
                                         decode_qwire_flip_stream,
                                         pack_planner_frames)
from heaac_tpu_torch.codec.planner import parse_stream_qwire
from heaac_tpu_torch.host import R_W1, spec_static_args, split_adts_stream
from heaac_tpu_torch.ops import ps_decorrelate as K
from test_torch_common import bench_streams, golden_tool, streams_of

pytestmark = pytest.mark.gpu
NAMES = ("power", "in_re", "in_im", "trans", "ap", "ag", "qf")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is False)")
    return torch.device("cuda")


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
