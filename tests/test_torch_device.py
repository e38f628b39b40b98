"""The port's entry point runs on the card unless the caller asks for the
CPU; whether a card is present is decided inside the test."""
import pytest
import torch

from heaac_tpu_torch import Decoder, decode_adts, decode_batch
from heaac_tpu_torch.codec.batch import (LcStreamBatchDecoder,
                                         QwirePipelinedDecoder)
from heaac_tpu_torch.host import split_adts_stream
from test_torch_common import bench_streams, streams_of


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
