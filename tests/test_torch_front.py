"""The port's front doors on the CPU: ``decode`` / ``decode_m4a``, the
single-stream Decoder's two element parsers and its bit tracer, the
command line (``heaac_tpu_torch.cli``), the profile registry and the
decode metrics.

Held to tests/data/front_golden_jax.npz (tools/make_torch_golden.py
``front``: the JAX package's ``decode`` of the committed
tests/data/front_*.m4a inputs, its CLI's ``--probe`` JSON and its bit
trace) and to single_golden_jax.npz (its Decoder with its native
default).  Whole streams within 2 int16 LSB (measured: at most 1 LSB on
every front input, and 1 LSB on every single-golden stream with either
parser), with the rate and the dropped-frame count equal; the probe JSON
and the bit trace exactly.  Nothing of JAX is compiled: the JAX
functions called here (its Decoder, muxer, CLI probe) are numpy.
"""
import contextlib
import functools
import io
import json
import logging
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import heaac_tpu
import heaac_tpu_torch
from heaac_tpu.bitstream.reader import BitstreamError as JaxBitstreamError
from heaac_tpu.models import profiles as jax_profiles
from heaac_tpu.utils import metrics as jax_metrics
from heaac_tpu_torch import cli, decode, decode_m4a, native
from heaac_tpu_torch.bitstream import aac_syntax
from heaac_tpu_torch.bitstream.adts import parse_adts_header
from heaac_tpu_torch.bitstream.reader import (BitReader, BitstreamError,
                                              TracingBitReader)
from heaac_tpu_torch.codec import batch as batch_mod
from heaac_tpu_torch.codec import decoder as decoder_mod
from heaac_tpu_torch.codec.decoder import Decoder
from heaac_tpu_torch.host import split_adts_stream
from heaac_tpu_torch.io.bitwriter import BitWriter
from heaac_tpu_torch.io.mp4 import mux_m4a
from heaac_tpu_torch.io.wav import read_wav, write_wav
from heaac_tpu_torch.models import profiles
from heaac_tpu_torch.utils import metrics, trace
from test_torch_common import (  # noqa: F401 (autouse fixture)
    REPO, golden_tool, release_jax_memory, streams_of)

TOL_LSB = 2
TOOL = golden_tool()
FRONT = [name for name, _, _ in TOOL.FRONT_LIST]


@functools.cache
def _golden() -> dict:
    with np.load(TOOL.FRONT_GOLDEN) as z:
        return {k: z[k] for k in z.files}


def _m4a_path(name: str) -> str:
    return os.path.join(REPO, TOOL.FRONT_FILE.format(name))


def _read(path: str) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def _lsb(pcm, want) -> int:
    return int(np.abs(np.asarray(pcm, np.int32) - want.astype(np.int32)
                      ).max())


def _recording(monkeypatch, module, name="Decoder") -> list:
    """Replace ``module.<name>`` with a Decoder subclass that records
    each instance."""
    made = []
    base = getattr(module, name)

    class Recorded(base):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            made.append(self)

    monkeypatch.setattr(module, name, Recorded)
    return made


@pytest.mark.parametrize("name", FRONT)
def test_decode_matches_jax_golden(name, monkeypatch):
    """``decode`` of each .m4a input (the ADTS re-wrap for he20_0 and
    lc_0, the ASC-configured Decoder for the explicit-SBR and
    downsampled ones; he20_explicit_bad_0 drops its corrupted frame):
    within 2 LSB of the JAX package's decode, the rate and error_count
    equal."""
    gold = _golden()
    made = _recording(monkeypatch, heaac_tpu_torch)
    rewrapped = []
    real = heaac_tpu_torch.decode_adts

    def spy(data, device="cuda"):
        rewrapped.append(data)
        return real(data, device=device)

    monkeypatch.setattr(heaac_tpu_torch, "decode_adts", spy)
    pcm, rate = decode(_read(_m4a_path(name)), device="cpu")
    want = gold[f"pcm_{name}"]
    assert pcm.dtype == torch.int16 and pcm.device.type == "cpu"
    assert tuple(pcm.shape) == want.shape and np.abs(want).max() > 1000
    assert _lsb(pcm, want) <= TOL_LSB
    assert rate == int(gold[f"rate_{name}"])
    assert len(made) == 1
    assert made[0].error_count == int(gold[f"errors_{name}"])
    assert bool(rewrapped) == (name in ("he20_0", "lc_0"))


def test_corrupted_frame_raises_bitstream_error():
    """The corrupted frame of the explicit twin raises BitstreamError in
    the port's ASC-configured Decoder (the golden tool checks the JAX
    one), so decode_m4a drops and counts it."""
    from heaac_tpu_torch.io.mp4 import demux_m4a
    t = demux_m4a(_read(_m4a_path("he20_explicit_bad_0")))
    dec = Decoder(asc=t.asc, device="cpu")
    k = TOOL.FRONT_CORRUPT[0]
    for f in t.frames[:k]:
        dec.decode_frame(f)
    with pytest.raises(BitstreamError):
        dec.decode_frame(t.frames[k])


def _pce_m4a() -> tuple:
    """An .m4a of lc_cce_after_0's first 4 frames behind an ASC of channel
    config 0 that carries the stream's own PCE (the layout its frames
    signal in-band): (asc, m4a bytes)."""
    frames = split_adts_stream(streams_of("cce_after", 1)[0])[:4]
    raw = [f[7:] for f in frames]
    br = BitReader(raw[0])
    assert br.get(3) == 5                       # the frame starts with a PCE
    start = br.pos
    br.skip(4)                                  # element_instance_tag
    aac_syntax.parse_pce_layout(br)
    hdr = parse_adts_header(BitReader(frames[0]))
    bw = BitWriter()
    for n, v in ((5, hdr.object_type), (4, hdr.sampling_index), (4, 0),
                 (3, 0)):
        bw.put(n, v)
    bw.put_bits_from(raw[0], start, br.pos - start)
    bw.align()
    asc = bw.bytes()
    return asc, mux_m4a(raw, asc, hdr.sample_rate, 2)


def test_channel_config_0_asc_raises_in_both_packages():
    """A fault of the reference, reproduced: Decoder(asc=) refuses channel
    config 0 before it reads the ASC's PCE (heaac_tpu/codec/decoder.py:56
    with _configure, l.71-73), so neither package's decode_m4a decodes an
    .m4a whose track carries a PCE layout."""
    asc, m4a = _pce_m4a()
    with pytest.raises(JaxBitstreamError, match="channel config 0"):
        heaac_tpu.Decoder(asc=asc)
    with pytest.raises(BitstreamError, match="channel config 0"):
        Decoder(asc=asc, device="cpu")
    with pytest.raises(JaxBitstreamError, match="channel config 0"):
        heaac_tpu.decode_m4a(m4a)
    with pytest.raises(BitstreamError, match="channel config 0"):
        decode_m4a(m4a, device="cpu")


def test_decode_m4a_lets_other_errors_through(monkeypatch):
    """Only parse errors drop a frame: any other failure of a frame's
    decode (on the card: a CUDA or kernel error) propagates."""
    def fail(self, packet):
        raise RuntimeError("device failure")

    monkeypatch.setattr(Decoder, "decode_frame", fail)
    with pytest.raises(RuntimeError, match="device failure"):
        decode_m4a(_read(_m4a_path("he20_explicit_0")), device="cpu")


@pytest.mark.parametrize("use_native", [True, False])
def test_decoder_parsers_match_single_golden(use_native, monkeypatch):
    """``Decoder(use_native=...)`` on every stream of
    single_golden_jax.npz (made by the JAX Decoder with its native
    default): within 2 LSB (measured 1 LSB with either parser), the same
    dropped frames and rate.  The native parser runs from frame 1
    on (from frame 2 where frame 0 is dropped), except on the stream
    whose coupling channel is dependent (it is present in frame 0)."""
    with np.load(TOOL.SINGLE_GOLDEN) as z:
        gold = {k: z[k] for k in z.files}
    calls = []
    for fn in ("parse_sce", "parse_cpe"):
        real = getattr(native.Parser, fn)

        def spy(self, *a, _real=real):
            calls.append(1)
            return _real(self, *a)

        monkeypatch.setattr(native.Parser, fn, spy)
    with open(f"{TOOL.REPO}/{TOOL.DS_ASC}", "rb") as f:
        ds_asc = f.read()
    for name, _ in TOOL.SINGLE_LIST:
        frames = split_adts_stream(TOOL.single_stream(name))[:TOOL.FRAMES]
        calls.clear()
        if name == "ds_0":
            dec = Decoder(asc=ds_asc, use_native=use_native, device="cpu")
            pcm = torch.cat([dec.decode_frame(fr[7:]) for fr in frames])
        else:
            dec = Decoder(adts_probe=frames[0][:7], use_native=use_native,
                          device="cpu")
            pcm = dec.decode(b"".join(frames))
        want = gold[f"pcm_{name}"]
        assert tuple(pcm.shape) == want.shape, name
        assert _lsb(pcm, want) <= TOL_LSB, name
        assert dec.error_count == int(gold[f"errors_{name}"]), name
        assert dec.sample_rate == int(gold[f"rate_{name}"]), name
        native_frames = use_native and name != "cce_before_0"
        assert bool(calls) == native_frames, (name, len(calls))


def test_dependent_cce_mid_stream_switches_to_python(caplog):
    """A dependent coupling channel first met after frame 0 (here: the
    first-frame rule bypassed by turning the native parser back on)
    logs the JAX WARNING and switches the decoder to the Python parser;
    both packages give the same PCM through that switch."""
    frames = split_adts_stream(streams_of("cce_before", 1)[0])[:4]
    port = Decoder(adts_probe=frames[0][:7], device="cpu")
    ref = heaac_tpu.Decoder(adts_probe=frames[0][:7])
    out = [port.decode_frame(frames[0]).numpy()]
    want = [ref.decode_frame(frames[0])]
    assert not port.use_native and not ref.use_native
    port.use_native = ref.use_native = True
    with caplog.at_level(logging.WARNING, logger="heaac_tpu_torch"):
        for f in frames[1:]:
            out.append(port.decode_frame(f).numpy())
            want.append(ref.decode_frame(f))
    assert not port.use_native and not ref.use_native
    assert [r.message for r in caplog.records
            if r.name == "heaac_tpu_torch"] == [
        "dependent CCE appeared mid-stream: this frame's coupling applies "
        "post-TNS (reference order resumes next frame)"]
    assert _lsb(np.concatenate(out), np.concatenate(want)) <= TOL_LSB


def test_bit_trace_matches_golden():
    """TracingBitReader through the Decoder over the golden's frames: the
    same (pos, n, value) reads as the JAX tracer; the reader class forces
    the Python parser."""
    reads = []
    data = b"".join(split_adts_stream(_read(os.path.join(
        REPO, TOOL.TRACE_FILE)))[:TOOL.TRACE_FRAMES])
    dec = Decoder(adts_probe=data[:7], device="cpu",
                  bitreader_cls=functools.partial(
                      TracingBitReader,
                      sink=lambda pos, n, v: reads.append((pos, n, v))))
    assert not dec.use_native
    dec.decode(data)
    gold = _golden()
    assert [[p, n] for p, n, _ in reads] == gold["trace"].tolist()
    assert [f"{v:x}" for _, _, v in reads] == gold["trace_values"].tolist()


def test_native_parser_build_failure_raises(monkeypatch):
    """The port always builds the native parser: a failed build raises
    from the Decoder's constructor instead of falling back to Python."""
    def broken():
        raise subprocess.CalledProcessError(1, ["g++"])

    monkeypatch.setattr(native, "build", broken)
    data = streams_of("lc", 1)[0]
    with pytest.raises(subprocess.CalledProcessError):
        Decoder(adts_probe=data[:7], device="cpu")
    assert Decoder(adts_probe=data[:7], use_native=False,
                   device="cpu")._parser is None


# ---- the command line -------------------------------------------------------

def _main(argv) -> tuple:
    """(exit code, stdout, stderr) of cli.main(argv) run in-process."""
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = cli.main(argv)
    return rc, out.getvalue(), err.getvalue()


PROBED = [(name, _m4a_path(name)) for name in FRONT] + [
    (name, os.path.join(REPO, rel)) for name, rel in TOOL.FRONT_ADTS]


@pytest.mark.parametrize("name,path", PROBED)
def test_cli_probe_matches_golden(name, path):
    """``--probe`` JSON on every .m4a input and ADTS stream, and
    ``probe()``'s dict on the ADTS streams: equal to the JAX CLI's."""
    gold = _golden()
    rc, out, _ = _main(["-i", path, "--probe"])
    assert rc == 0
    assert json.loads(out) == json.loads(str(gold[f"probe_main_{name}"]))
    if name.endswith(".aac"):
        assert cli.probe(_read(path)) == json.loads(
            str(gold[f"probe_{name}"]))


@pytest.mark.parametrize("name", ["lc_0", "he20_explicit_0"])
def test_cli_decodes_to_wav_and_s16le(name, tmp_path):
    """WAV and s16le output on the CPU (lc_0: re-wrapped as ADTS and
    decoded by decode_batch; he20_explicit_0: the ASC-configured
    Decoder), within 2 LSB of the golden; the ``--benchmark`` keys; and
    ``--profile`` writes a Chrome trace."""
    gold = _golden()
    wav = str(tmp_path / "o.wav")
    rc, _, err = _main(["-i", _m4a_path(name), wav, "--device", "cpu",
                        "--benchmark", "--profile", str(tmp_path / "prof")])
    assert rc == 0
    pcm, rate = read_wav(wav)
    want = gold[f"pcm_{name}"]
    assert rate == int(gold[f"rate_{name}"]) and pcm.shape == want.shape
    assert _lsb(pcm, want) <= TOL_LSB
    raw = str(tmp_path / "o.pcm")
    assert _main(["-i", _m4a_path(name), "-f", "s16le", raw,
                  "--device", "cpu"])[0] == 0
    assert np.array_equal(np.fromfile(raw, "<i2").reshape(pcm.shape), pcm)
    if name == "lc_0":        # the ADTS route: decode metrics, the trace
        bench = json.loads(err.splitlines()[0])
        assert set(bench) == set(jax_metrics.DecodeMetrics().as_dict())
        assert bench["frames_decoded"] == TOOL.FRAMES
        assert bench["frames_errored"] == 0
        assert os.path.getsize(tmp_path / "prof" / trace.TRACE_FILE) > 0


def test_cli_falls_back_on_the_same_device(monkeypatch, caplog, tmp_path):
    """When decode_batch fails, the CLI logs a WARNING naming the
    exception and decodes with the single-stream Decoder on the same
    device (``--no-native``: its Python parser)."""
    def fail(streams, device="cuda"):
        raise RuntimeError("batched decode failed")

    monkeypatch.setattr(batch_mod, "decode_batch", fail)
    made = _recording(monkeypatch, decoder_mod)
    wav = str(tmp_path / "o.wav")
    with caplog.at_level(logging.WARNING, logger="heaac_tpu_torch"):
        rc, _, _ = _main(["-i", _m4a_path("lc_0"), wav, "--device", "cpu",
                          "--no-native"])
    assert rc == 0
    assert any(r.levelno == logging.WARNING
               and "batched decode failed" in r.getMessage()
               for r in caplog.records)
    assert [(d.device.type, d.use_native) for d in made] == [("cpu", False)]
    assert _lsb(read_wav(wav)[0], _golden()["pcm_lc_0"]) <= TOL_LSB


def test_cli_bit_trace_prints_every_read(tmp_path):
    """``--bit-trace``: one stderr line per read, as many as the JAX
    tracer's over the same two frames."""
    data = b"".join(split_adts_stream(_read(os.path.join(
        REPO, TOOL.TRACE_FILE)))[:TOOL.TRACE_FRAMES])
    src = tmp_path / "two.aac"
    src.write_bytes(data)
    rc, _, err = _main(["-i", str(src), str(tmp_path / "o.wav"),
                        "--device", "cpu", "--bit-trace"])
    assert rc == 0
    lines = [x for x in err.splitlines() if x.startswith("bit ")]
    assert len(lines) == len(_golden()["trace"])


def test_cli_refuses_wav_input(tmp_path):
    """The encode direction stays with the JAX package's CLI."""
    src = tmp_path / "in.wav"
    write_wav(str(src), np.zeros((16, 1), np.int16), 24000)
    rc, _, err = _main(["-i", str(src), str(tmp_path / "out.aac")])
    assert rc == 2 and "python -m heaac_tpu.cli" in err


def test_cli_module_entry():
    """``python -m heaac_tpu_torch.cli`` in a subprocess (``--probe``
    needs no device)."""
    r = subprocess.run([sys.executable, "-m", "heaac_tpu_torch.cli", "-i",
                        _m4a_path("he20_explicit_0"), "--probe"],
                       capture_output=True, text=True, cwd=REPO, timeout=120,
                       env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert r.returncode == 0, r.stderr[-2000:]
    assert json.loads(r.stdout) == json.loads(
        str(_golden()["probe_main_he20_explicit_0"]))


# ---- profile registry, metrics, tracing -------------------------------------

def test_profiles_and_metrics_match_jax():
    """The registry: the same profiles as the JAX package's, each device
    graph a module of the port, and profile_for_stream's choice for the
    configuration of each front input; DecodeMetrics' dict."""
    assert profiles.REGISTRY.keys() == jax_profiles.REGISTRY.keys()
    for key, p in profiles.REGISTRY.items():
        j = jax_profiles.REGISTRY[key]
        assert (p.name, p.long_name, p.object_types, p.sbr, p.ps,
                p.frame_samples_out, p.tools) == (
            j.name, j.long_name, j.object_types, j.sbr, j.ps,
            j.frame_samples_out, j.tools)
        assert p.device_graph.startswith("heaac_tpu_torch.")
        __import__(p.device_graph)
    for name in FRONT:
        from heaac_tpu_torch.io.mp4 import demux_m4a
        asc = demux_m4a(_read(_m4a_path(name))).asc
        dec = Decoder(asc=asc, device=None)
        jdec = heaac_tpu.Decoder(asc=asc, use_native=False)
        assert profiles.profile_for_stream(dec.m4ac).name == \
            jax_profiles.profile_for_stream(jdec.m4ac).name
    m, j = metrics.DecodeMetrics(streams=2), jax_metrics.DecodeMetrics(
        streams=2)
    for d in (m, j):
        d.frames_decoded, d.frames_errored = 50, 1
        d.audio_seconds, d.wall_seconds = 2.1333333, 0.0123456
    assert m.as_dict() == j.as_dict()
    assert metrics.log.name == "heaac_tpu_torch"
    said = []
    with trace.timed("block", said.append):
        pass
    assert said and said[0].startswith("block: ")
