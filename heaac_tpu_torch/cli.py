"""Command-line transcoder of the PyTorch port: ADTS AAC / HE-AAC / M4A
in, WAV (or raw PCM) out, decoded on the card unless ``--device cpu`` --
and WAV in, AAC (ADTS or .m4a) out, encoded on the host.

The port of ``heaac_tpu/cli.py`` (``probe``, ``_run_m4a_direct``,
``_run_encode``, ``main``; names as there): the FATE-style end-to-end
harness mirroring the reference `ffmpeg -i in.aac out.wav` decode loop
(ffmpeg.c) and its `ffmpeg -i in.wav out.aac` encode direction
(aacenc.c via the same CLI).  The encoder is host numpy
(``codec/encoder.py``), so ``--device`` does not change an encode.
Usage:

    python -m heaac_tpu_torch.cli -i in.aac out.wav
    python -m heaac_tpu_torch.cli -i in.m4a -f s16le out.pcm
    python -m heaac_tpu_torch.cli -i in.aac --probe
    python -m heaac_tpu_torch.cli -i in.aac out.wav --device cpu
    python -m heaac_tpu_torch.cli -i in.wav -b 64k out.aac
    python -m heaac_tpu_torch.cli -i in.wav --coder anmr out.m4a
"""
from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time

import numpy as np


def probe(data: bytes) -> dict:
    """Inspect an ADTS stream without decoding it (the ffprobe.c analogue):
    configuration from the headers plus a parse of the first two frames
    (the Python planner, no device) for SBR/PS fill data (aacdec.c:1650
    ext payload ids); a stream whose frames do not parse reports neither."""
    from .bitstream.adts import parse_adts_header, split_adts_stream
    from .bitstream.reader import BitReader, BitstreamError
    from .codec.planner import QwirePlanningDecoder

    frames = split_adts_stream(data)
    hdr = parse_adts_header(BitReader(frames[0][:7]))
    sbr = ps = False
    ext_rate = hdr.sample_rate
    try:
        dec = QwirePlanningDecoder(adts_probe=frames[0][:7])
        dec.decode_frame(frames[0])
        if len(frames) > 1:
            dec.decode_frame(frames[1])
        m = dec.m4ac
        sbr = m.sbr == 1
        ps = m.ps == 1
        if sbr:
            ext_rate = m.ext_sample_rate or 2 * m.sample_rate
    except (BitstreamError, ValueError, IndexError):
        # the parse errors of the Python element parser
        pass
    dur = len(frames) * (2048 if sbr and ext_rate > hdr.sample_rate
                         else 1024) / max(ext_rate, 1)
    return dict(
        format="adts",
        object_type=hdr.object_type,
        profile={1: "Main", 2: "LC", 3: "SSR", 4: "LTP"}.get(
            hdr.object_type, str(hdr.object_type)),
        core_sample_rate=hdr.sample_rate,
        output_sample_rate=ext_rate,
        channel_config=hdr.chan_config,
        sbr=sbr, ps=ps,
        codec=("HE-AACv2" if ps else "HE-AAC" if sbr else "AAC"),
        frames=len(frames),
        duration_s=round(dur, 3),
        bit_rate=round(8 * len(data) / dur) if dur else 0,
    )


def _write_pcm(path: str, fmt: str | None, pcm, rate: int) -> None:
    from .io.wav import write_wav

    fmt = fmt or ("wav" if path.endswith(".wav") else "s16le")
    if fmt == "wav":
        write_wav(path, pcm, rate)
    else:
        np.asarray(pcm, "<i2").tofile(path)


def _run_m4a_direct(args, data: bytes) -> int:
    """Decode/probe an .m4a whose ASC is not ADTS-representable
    (explicit hierarchical SBR signaling or in-band-PCE layouts)."""
    from . import decode_m4a
    from .bitstream.asc import parse_audio_specific_config
    from .io.mp4 import demux_m4a

    t = demux_m4a(data)
    c = parse_audio_specific_config(t.asc)
    if args.probe:
        out_rate = c.ext_sample_rate or c.sample_rate
        sbr = c.sbr == 1
        dur = len(t.frames) * (2048 if sbr and out_rate > c.sample_rate
                               else 1024) / max(out_rate, 1)
        print(json.dumps(dict(
            format="m4a", object_type=c.object_type,
            profile={1: "Main", 2: "LC"}.get(c.object_type,
                                             str(c.object_type)),
            core_sample_rate=c.sample_rate, output_sample_rate=out_rate,
            channel_config=c.chan_config, sbr=sbr, ps=c.ps == 1,
            codec=("HE-AACv2" if c.ps == 1 else "HE-AAC" if sbr
                   else "AAC"),
            frames=len(t.frames), duration_s=round(dur, 3),
            bit_rate=round(8 * sum(len(f) for f in t.frames) / dur)
            if dur else 0), indent=2))
        return 0
    if args.output is None:
        print("error: output path required (or use --probe)",
              file=sys.stderr)
        return 1
    pcm, rate = decode_m4a(data, device=args.device)
    _write_pcm(args.output, args.format, pcm, rate)
    print(f"decoded {len(pcm)} samples x {pcm.shape[1]} ch @ {rate} Hz",
          file=sys.stderr)
    return 0


def _run_encode(args, path: str) -> int:
    """WAV in -> AAC out (the ffmpeg encode direction, aacenc.c analogue).

    Output container by extension: .aac/.adts = ADTS byte stream
    (adtsenc.c), .m4a/.mp4 = MP4 audio track (movenc.c audio-only layout).
    """
    from .codec.encoder import AacEncoder
    from .io.wav import read_wav

    if args.output is None:
        print("error: output path required", file=sys.stderr)
        return 1
    pcm, rate = read_wav(path)
    if pcm.shape[1] > 2:
        print(f"error: {pcm.shape[1]}-channel encode not supported "
              "(mono or stereo only)", file=sys.stderr)
        return 1
    bitrate = None
    if args.bitrate:
        s = args.bitrate.lower().rstrip("bps").rstrip(" ")
        bitrate = int(float(s[:-1]) * 1000) if s.endswith("k") else int(s)
    t0 = time.time()
    enc = AacEncoder(rate, pcm.shape[1],
                     object_type=1 if args.aot == "main" else 2,
                     bitrate=bitrate, coder=args.coder,
                     ms=args.ms, intensity=args.intensity)
    adts = enc.encode(pcm)
    wall = time.time() - t0

    out = args.output
    if out.endswith((".m4a", ".mp4")):
        from .io.adts import adts_to_asc
        from .io.mp4 import mux_m4a
        asc, frames = adts_to_asc(adts)
        payload = mux_m4a(frames, asc, rate, pcm.shape[1])
    else:
        payload = adts
    with open(out, "wb") as f:
        f.write(payload)
    dur = len(pcm) / max(rate, 1)
    if args.benchmark:
        print(json.dumps(dict(wall_s=round(wall, 3),
                              realtime_x=round(dur / wall, 2) if wall else 0,
                              bytes=len(payload))), file=sys.stderr)
    print(f"encoded {len(pcm)} samples x {pcm.shape[1]} ch @ {rate} Hz -> "
          f"{len(payload)} bytes "
          f"({round(8 * len(adts) / dur) if dur else 0} b/s)",
          file=sys.stderr)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m heaac_tpu_torch.cli")
    ap.add_argument("-i", "--input", required=True,
                    help="input ADTS/.m4a file to decode, or .wav to encode")
    ap.add_argument("output", nargs="?", default=None,
                    help="output path: .wav/raw s16le pcm (decode) or "
                         ".aac/.m4a (encode)")
    ap.add_argument("--probe", action="store_true",
                    help="print stream info as JSON without decoding "
                         "(ffprobe analogue)")
    ap.add_argument("-f", "--format", choices=("wav", "s16le"), default=None)
    ap.add_argument("--benchmark", action="store_true",
                    help="print timing metrics to stderr")
    ap.add_argument("--no-native", action="store_true",
                    help="parse every element in Python in the "
                         "single-stream decoder")
    ap.add_argument("--profile", metavar="LOGDIR",
                    help="write a torch.profiler Chrome trace of the "
                         "decode into LOGDIR")
    ap.add_argument("--bit-trace", action="store_true",
                    help="log every bitstream read to stderr "
                         "(get_bits_trace analogue; forces the slow path)")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the decode (default cuda; cpu "
                         "to run without a card); an encode runs on the "
                         "host")
    enc = ap.add_argument_group("encode options (WAV input)")
    enc.add_argument("-b", "--bitrate", default=None,
                     help="target bitrate, e.g. 64k or 128000")
    enc.add_argument("--aot", choices=("lc", "main"), default="lc",
                     help="audio object type (default lc)")
    enc.add_argument("--coder", choices=("twoloop", "anmr"),
                     default="twoloop",
                     help="scalefactor/codebook search strategy")
    enc.add_argument("--ms", action="store_true",
                     help="enable mid/side stereo coding")
    enc.add_argument("--intensity", action="store_true",
                     help="enable intensity stereo coding")
    args = ap.parse_args(argv)

    from .bitstream.adts import (parse_adts_header, probe_adts,
                                 split_adts_stream)
    from .bitstream.reader import BitReader
    from .codec.decoder import Decoder
    from .device import resolve
    from .io.mp4 import Mp4Error, m4a_to_adts, probe_m4a
    from .utils.metrics import DecodeMetrics, log
    from .utils.trace import device_trace

    with open(args.input, "rb") as f:
        data = f.read()
    if data[:4] == b"RIFF" and data[8:12] == b"WAVE":
        return _run_encode(args, args.input)
    container = None
    if probe_m4a(data):
        # MP4/M4A input (the mov.c path): re-wrap the AAC track as ADTS
        # so the whole pipeline below is format-agnostic; tracks ADTS
        # cannot carry (explicit SBR signaling, the usual shape of
        # encoder-written HE-AAC .m4a files) decode via the
        # ASC-configured path instead
        container = "m4a"
        try:
            data = m4a_to_adts(data)
        except Mp4Error:
            return _run_m4a_direct(args, data)
    if probe_adts(data) is None:
        print("error: input is neither an ADTS stream nor an MP4 file",
              file=sys.stderr)
        return 1
    if args.probe:
        info = probe(data)
        if container:
            info["format"] = container
        print(json.dumps(info, indent=2))
        return 0
    if args.output is None:
        ap.error("output path required (or use --probe)")

    dev = resolve(args.device)
    hdr = parse_adts_header(BitReader(data[:7]))
    nframes = len(split_adts_stream(data))
    met = DecodeMetrics(streams=1).start()
    err_count = 0
    prof = device_trace(args.profile, dev) if args.profile \
        else contextlib.nullcontext()
    with prof:
        if args.bit_trace:
            from .bitstream.reader import TracingBitReader
            dec = Decoder(adts_probe=data[:7],
                          bitreader_cls=TracingBitReader, device=dev)
            pcm = dec.decode(data)
            err_count = dec.error_count
        else:
            try:
                # fast path: whole-stream batched decode
                from .codec.batch import decode_batch
                pcm = decode_batch([data], device=dev)[0]
            except Exception as e:
                # the batched decode failed as a whole: decode the stream
                # on the same device with the single-stream decoder
                log.warning("cli: decode_batch failed (%r); decoding with "
                            "the single-stream decoder on %s", e, dev,
                            exc_info=True)
                dec = Decoder(adts_probe=data[:7],
                              use_native=not args.no_native, device=dev)
                pcm = dec.decode(data)
                err_count = dec.error_count
    met.stop()
    # output rate: 2048-sample frames mean SBR doubled the rate
    upsampled = nframes and len(pcm) // nframes >= 2048
    sample_rate = hdr.sample_rate * (2 if upsampled else 1)
    met.frames_decoded = nframes
    met.frames_errored = err_count
    met.audio_seconds = len(pcm) / max(sample_rate, 1)

    _write_pcm(args.output, args.format, pcm, sample_rate)
    if args.benchmark:
        print(json.dumps(met.as_dict()), file=sys.stderr)
    print(f"decoded {len(pcm)} samples x {pcm.shape[1]} ch @ {sample_rate} Hz"
          f" ({err_count} frame errors)", file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
