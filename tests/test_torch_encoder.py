"""The port's encoder (``heaac_tpu_torch.codec.encoder``) and the encode
half of its command line against the JAX package's, byte for byte.

Both encoders are host numpy, so each case runs both on the same seeded
PCM (``ENCODE_CASES`` of tools/make_torch_golden.py: mono at 44.1 and
24 kHz, stereo at 48 kHz, window switching, rate control at 48k and
96k, the twoloop and anmr coders at 64k, AAC-Main mono and stereo, M/S,
intensity and an injected TNS filter; 8 ADTS frames, 4-5 where the
rate loop runs, which costs 4-5x a frame) and the ADTS bytes must be
equal: the port's over each case's whole input to the JAX bytes in the
golden, and both encoders run here on the same input (its first 3
frames where the rate loop runs).  So must the analysis matrices and
the window decisions.  The CLI runs in-process, WAV in, ``.aac`` and
``.m4a`` out, with the encode options, on 3 frames of input.  Nothing of JAX is
compiled.  The committed golden (tests/data/encode_golden_jax.npz)
holds the JAX bytes of every case for the card run (chip_smoke.py phase
12) and tests/test_torch_nojax.py.
"""
import contextlib
import io
import json

import numpy as np
import pytest

from heaac_tpu import cli as jax_cli
from heaac_tpu.codec import encoder as jax_encoder
from heaac_tpu_torch import cli
from heaac_tpu_torch.codec import encoder
from heaac_tpu_torch.io.wav import write_wav
from test_torch_common import (  # noqa: F401 (autouse fixture)
    golden_tool, release_jax_memory)

TOOL = golden_tool()
SHORT_FRAMES = 3       # ADTS frames of the rate-loop and CLI cases


def _pcm(name: str, short: bool = False) -> np.ndarray:
    """Case ``name``'s input; its first SHORT_FRAMES frames (the encoder
    adds a lead-in frame) where ``short`` or where the rate loop runs."""
    pcm = TOOL.encode_pcm(name)
    if short or "bitrate" in TOOL.ENCODE_CASES[name][3]:
        pcm = pcm[:(SHORT_FRAMES - 1) * 1024]
    return pcm


@pytest.mark.parametrize("name", list(TOOL.ENCODE_CASES))
def test_encoder_bytes_match_jax(name):
    """The port's bytes over the case's whole input equal the JAX
    encoder's in the golden; then both encoders run here on the same
    input (its first SHORT_FRAMES frames where the rate loop runs)."""
    with np.load(TOOL.ENCODE_GOLDEN) as z:
        whole, gold = z[f"pcm_{name}"], z[f"adts_{name}"].tobytes()
    got = TOOL.encode_case(name, encoder.AacEncoder, whole)
    assert got == gold
    pcm = _pcm(name)
    if len(pcm) < len(whole):
        got = TOOL.encode_case(name, encoder.AacEncoder, pcm)
    want = TOOL.encode_case(name, jax_encoder.AacEncoder, pcm)
    assert len(got) > 7 * SHORT_FRAMES and got == want


def test_golden_holds_the_cases():
    """The golden's cases and PCM are this recipe's (the card run reads
    them from there)."""
    with np.load(TOOL.ENCODE_GOLDEN) as z:
        assert json.loads(str(z["cases"])) == json.loads(
            json.dumps(TOOL.ENCODE_CASES, sort_keys=True))
        for name in TOOL.ENCODE_CASES:
            assert np.array_equal(z[f"pcm_{name}"], TOOL.encode_pcm(name))


def test_forward_matrices_match_jax():
    got, want = encoder._forward_matrices(), jax_encoder._forward_matrices()
    assert sorted(got) == sorted(want)
    for ws in want:
        assert got[ws].dtype == want[ws].dtype
        assert np.array_equal(got[ws], want[ws])


@pytest.mark.parametrize("name", ["window_switching", "lc_stereo_48k"])
def test_window_decisions_match_jax(name):
    pcm = TOOL.encode_pcm(name).astype(np.float64)
    nframes = TOOL.encode_frames(name)
    ws, pos = encoder.decide_window_sequences(pcm, nframes)
    jws, jpos = jax_encoder.decide_window_sequences(pcm, nframes)
    assert np.array_equal(ws, jws) and np.array_equal(pos, jpos)
    # after the onset (frames 0-1), only the burst case switches to short
    # windows
    assert (encoder.EIGHT_SHORT in ws[2:]) == (name == "window_switching")


# (input case, options, output extension)
CLI_CASES = [
    ("lc_stereo_48k", ["-b", "96k", "--ms"], ".aac"),
    ("rate_96k", ["-b", "96k"], ".m4a"),
    ("main_stereo", ["--aot", "main"], ".m4a"),
    ("intensity", ["-b", "48k", "--coder", "anmr", "--intensity"], ".aac"),
]


def _run(main, argv) -> tuple:
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        rc = main(argv)
    return rc, err.getvalue()


@pytest.mark.parametrize("name,opts,ext", CLI_CASES)
def test_cli_encode_matches_jax(name, opts, ext, tmp_path):
    """``-i in.wav out.{aac,m4a}``: the same file out of both CLIs, and
    the same ``--benchmark`` keys."""
    rate = TOOL.ENCODE_CASES[name][0]
    pcm = _pcm(name, short=True)
    src = tmp_path / "in.wav"
    write_wav(str(src), pcm, rate)
    outs = []
    for main, tag in ((cli.main, "port"), (jax_cli.main, "jax")):
        dst = tmp_path / f"{tag}{ext}"
        rc, err = _run(main, ["-i", str(src), *opts, "--benchmark",
                              str(dst)])
        assert rc == 0, err
        met = json.loads(err.splitlines()[0])
        assert met["bytes"] == dst.stat().st_size
        outs.append((dst.read_bytes(), sorted(met)))
    assert outs[0] == outs[1]
