"""The port's entry point runs on the card unless the caller asks for the
CPU; whether a card is present is decided inside the test."""
import os

import pytest
import torch

from heaac_tpu_torch import (Decoder, cli, decode, decode_adts, decode_batch,
                             decode_m4a)
from heaac_tpu_torch.codec.batch import (BatchDecoder, LcStreamBatchDecoder,
                                         QStreamBatchDecoder,
                                         QwirePipelinedDecoder,
                                         StreamBatchDecoder)
from heaac_tpu_torch.host import split_adts_stream
from heaac_tpu_torch.parallel import multihost
from heaac_tpu_torch.parallel.sharding import (ShardedQwireDecoder,
                                               ShardedStreamBatchDecoder,
                                               make_devices)
from test_torch_common import REPO, bench_streams, golden_tool, streams_of


def test_decoder_defaults_to_the_card():
    """No device argument means the card: without one the constructor
    raises instead of carrying on on the CPU."""
    streams = bench_streams(1)
    if torch.cuda.is_available():
        dec = QwirePipelinedDecoder(streams, group_streams=1, max_frames=2)
        assert dec.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="is_available"):
            QwirePipelinedDecoder(streams, group_streams=1, max_frames=2)


def test_decode_batch_and_lc_decoder_default_to_the_card():
    lc = streams_of("lc", 1)
    if torch.cuda.is_available():
        assert LcStreamBatchDecoder(lc, max_frames=2).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="is_available"):
            LcStreamBatchDecoder(lc, max_frames=2)
        with pytest.raises(RuntimeError, match="is_available"):
            decode_batch(lc)


def test_single_stream_decoder_defaults_to_the_card():
    data = b"".join(split_adts_stream(bench_streams(1)[0])[:2])
    if torch.cuda.is_available():
        assert Decoder(adts_probe=data[:7]).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="is_available"):
            Decoder(adts_probe=data[:7])
        with pytest.raises(RuntimeError, match="is_available"):
            decode_adts(data)


def test_front_doors_default_to_the_card(tmp_path):
    """decode, decode_m4a and the command line's decode default to the
    card too (``--device cpu`` on the command line)."""
    path = os.path.join(REPO, golden_tool().FRONT_FILE.format(
        "he20_explicit_0"))
    with open(path, "rb") as f:
        m4a = f.read()
    out = str(tmp_path / "o.wav")
    runs = (lambda: decode(m4a)[1], lambda: decode_m4a(m4a)[1],
            lambda: cli.main(["-i", path, out]))
    if torch.cuda.is_available():
        assert [run() for run in runs] == [48000, 48000, 0]
        return
    for run in runs:
        with pytest.raises(RuntimeError, match="is_available"):
            run()


def test_parallel_layer_defaults_to_the_card(tmp_path):
    """make_devices, ShardedQwireDecoder with no devices, the multihost
    decode and its command line with no ``--device`` take the card: without
    one they raise before any decode (the command line before it joins a
    process group)."""
    streams = bench_streams(2)
    runs = (make_devices,
            lambda: ShardedQwireDecoder(streams, max_frames=2),
            lambda: multihost.decode_shard_and_reduce(streams),
            lambda: multihost.main([
                "--coordinator", "127.0.0.1:1", "--num-processes", "1",
                "--process-id", "0", "--streams-dir", str(tmp_path)]))
    if torch.cuda.is_available():
        assert make_devices()[0].type == "cuda"
        dec = ShardedQwireDecoder(bench_streams(torch.cuda.device_count()),
                                  max_frames=2)
        assert [d.type for d in dec.devices] == ["cuda"] * len(dec.devices)
        return
    for run in runs:
        with pytest.raises(RuntimeError, match="is_available"):
            run()


def test_plan_decoders_default_to_the_card():
    """The plan-record decoders with no device take the card (the sharded
    one every card): without one each constructor raises before it
    parses."""
    streams = bench_streams(2)
    makers = (lambda: StreamBatchDecoder(streams, max_frames=2),
              lambda: StreamBatchDecoder(streams, max_frames=2,
                                         compact=False),
              lambda: BatchDecoder(streams[0], batch=2),
              lambda: QStreamBatchDecoder(streams, max_frames=2),
              lambda: ShardedStreamBatchDecoder(streams, max_frames=2))
    if torch.cuda.is_available():
        for make in makers[:4]:
            assert make().device.type == "cuda"
        return
    for make in makers:
        with pytest.raises(RuntimeError, match="is_available"):
            make()
