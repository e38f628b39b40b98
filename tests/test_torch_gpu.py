"""Tests that need an NVIDIA card (marker ``gpu``; they skip without
one): kernel K1 against its plain version at the main path's shapes, and
a short main-path decode on the card against the port's CPU decode.

    python -m pytest tests/test_torch_gpu.py -q --noconftest   # on the GPU

(``--noconftest``: the GPU machine has no jax, and tests/conftest.py
imports it.)
"""
import numpy as np
import pytest
import torch

from heaac_tpu_torch.codec.batch import QwirePipelinedDecoder
from heaac_tpu_torch.ops import ps_decorrelate as K
from test_torch_common import bench_streams

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
    before = K.launches
    got = K.decorrelate_seq(*args)
    assert K.launches == before + 1
    ref = K.decorrelate_plain(*args)
    torch.cuda.synchronize()
    for a, b in zip(got, ref):
        assert a.shape == b.shape
        assert float((a - b).abs().max()) == 0.0


def test_main_path_on_card_matches_cpu(cuda):
    streams = bench_streams(4)
    before = K.launches
    gpu = QwirePipelinedDecoder(streams, group_streams=4, max_frames=8,
                                device=cuda).decode()[0].cpu().numpy()
    assert K.launches - before >= 8
    cpu = QwirePipelinedDecoder(streams, group_streams=4, max_frames=8,
                                device="cpu").decode()[0].numpy()
    assert np.abs(gpu.astype(np.int32) - cpu).max() <= 2
