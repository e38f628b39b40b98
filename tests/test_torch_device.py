"""The port's entry point runs on the card unless the caller asks for the
CPU; whether a card is present is decided inside the test."""
import pytest
import torch

from heaac_tpu_torch.codec.batch import QwirePipelinedDecoder
from test_torch_common import bench_streams


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
