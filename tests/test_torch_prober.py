"""The Python prober and the Python profile parse of the PyTorch port,
on the CPU.

decode_batch buckets a stream its native probe refuses by the Python
prober (``codec.batch._python_probe``: the first frame decoded by the
single-stream ``Decoder``, here on the CPU); its (SBR, 34-band PS)
equals the JAX
decode_batch's Python probe (``Decoder.decode_frame`` of the first
frame) on every committed stream and on the corrupted ones of
tools/make_torch_golden.py, as stored in tests/data/prober_golden_jax.npz.
``QwirePipelinedDecoder`` takes its profile from the Python planner
where the native probe refuses stream 0 (here made to refuse it):
within 2 int16 LSB of the decode that read it from the native probe."""
import logging

import numpy as np
import pytest

from heaac_tpu_torch import native
from heaac_tpu_torch.codec.batch import QwirePipelinedDecoder, _python_probe
from heaac_tpu_torch.host import parse_adts_header, split_adts_stream
from test_torch_common import (  # noqa: F401 (autouse fixture)
    golden_tool, release_jax_memory, streams_of)

TOL_LSB = 2


@pytest.mark.parametrize("group", ["benchdata/", "tests/data/", "corrupt"])
def test_python_probe_matches_jax(group):
    tool = golden_tool()
    with np.load(tool.PROBE_GOLDEN) as z:
        want = {str(name): (int(s), int(i))
                for name, s, i in zip(z["names"], z["sbr"], z["is34"])}
    named = [(name, data) for name, data in tool.probe_streams()
             if name.startswith(group) or (group == "corrupt"
                                           and name in tool.CORRUPT)]
    assert len(named) >= 5 and {name for name, _ in named} <= set(want)
    for name, data in named:
        got = _python_probe(data, "cpu")
        assert tuple(map(int, got)) == want[name], name
        if group == "corrupt":
            assert native.Parser().probe(
                data, parse_adts_header(data[:7])) is None, name
    if group == "corrupt":             # both outcomes occur
        assert {want[name][0] for name, _ in named} == {0, 1}


@pytest.mark.parametrize("kind", ["he20", "cce_after"])
def test_pipelined_decoder_profile_parse_matches_native(kind, monkeypatch,
                                                        caplog):
    streams = [b"".join(split_adts_stream(d)[:4])
               for d in streams_of(kind, 2)]
    ref = QwirePipelinedDecoder(streams, group_streams=2, max_frames=4,
                                device="cpu")
    want = ref.decode()[0].numpy()
    monkeypatch.setattr(native.Parser, "probe", lambda *a: None)
    caplog.set_level(logging.INFO, logger="heaac_tpu_torch")
    dec = QwirePipelinedDecoder(streams, group_streams=2, max_frames=4,
                                device="cpu")
    assert "qwire pipelined decode: stream 0's profile from the Python " \
        "planner" in [r.getMessage() for r in caplog.records]
    for k in ("nl", "out_nl", "sample_rate", "is34", "ds"):
        assert getattr(dec, k) == getattr(ref, k), k
    got = dec.decode()[0].numpy()
    assert np.abs(want).max() > 1000
    assert np.abs(got.astype(np.int32) - want).max() <= TOL_LSB
