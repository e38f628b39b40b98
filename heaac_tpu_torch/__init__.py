"""heaac_tpu_torch — the HE-AAC decoder's PyTorch port (CUDA on Hopper).

A second package beside the JAX reference ``heaac_tpu``: it takes ADTS
bytes (or an MP4 / M4A file's AAC track) in and gives int16 PCM out for
batches of independent streams (``decode_batch``: mixed HE-AAC v2 / v1
and AAC-LC batches) and for one stream at a time (``decode``,
``decode_adts``, ``decode_m4a``, ``Decoder``; the command line
``python -m heaac_tpu_torch.cli``), with
the device graph as PyTorch ops and the parametric-stereo recurrence as a
hand-written CUDA kernel (``csrc/ps_decorrelate.cu``).  The package never
imports ``jax`` or ``heaac_tpu``; it builds the JAX package's C++ parser
from source by path and reads its extracted table file as data.

Layout mirrors the JAX package so each module's counterpart is easy to
find: ``ops/`` (filterbanks, SBR, PS, Huffman decoders), ``codec/``
(frame graph, wire expansion, pipelined batch decoder), ``io/``
(ADTS, MP4 and WAV containers).
"""
from __future__ import annotations

import torch


def set_f32_flags() -> None:
    """Full-f32 matmuls and convolutions on the card: the JAX reference
    runs every matmul at Precision.HIGHEST, so TF32 stays off."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


from .codec.batch import decode_batch  # noqa: E402  (needs set_f32_flags)
from .codec.decoder import Decoder  # noqa: E402
from .utils.metrics import log  # noqa: E402


def decode_adts(data: bytes, device="cuda"):
    """Decode an ADTS byte stream with the single-stream ``Decoder`` on
    ``device`` -> (pcm int16 [samples, channels] CPU tensor, rate)."""
    from .bitstream.adts import probe_adts

    hdr = probe_adts(data)
    if hdr is None:
        raise ValueError("not an ADTS stream")
    dec = Decoder(adts_probe=data[:7], device=device)
    pcm = dec.decode(data)
    return pcm, dec.sample_rate


def decode_m4a(data: bytes, device="cuda"):
    """Decode an MP4/M4A file's AAC track on ``device`` -> (pcm int16
    [samples, channels] CPU tensor, rate).  The container path the
    reference serves with libavformat/mov.c: esds -> ASC extradata,
    sample tables -> packets.  ADTS-representable tracks re-wrap and
    decode as ADTS (``decode_adts``); explicit-signaling / PCE tracks
    decode through the ASC-configured ``Decoder``, where a frame that
    does not parse is dropped and counted (anything else, a failure on
    the card included, propagates)."""
    from .bitstream.reader import BitstreamError
    from .io.mp4 import Mp4Error, demux_m4a, m4a_to_adts

    try:
        return decode_adts(m4a_to_adts(data), device=device)
    except Mp4Error:
        pass
    t = demux_m4a(data)
    dec = Decoder(asc=t.asc, device=device)
    chunks = []
    for f in t.frames:
        try:
            chunks.append(dec.decode_frame(f))
        except (BitstreamError, ValueError, IndexError) as e:
            # the errors Decoder.decode drops a frame for, and those the
            # Python element parser raises on a malformed frame
            dec.error_count += 1
            log.warning("frame dropped: %s", e)
    pcm = torch.cat(chunks) if chunks else torch.zeros((0, 1),
                                                       dtype=torch.int16)
    # Decoder.sample_rate is the OUTPUT rate once a frame has decoded
    # (SBR doubling applied in _spectral_to_sample)
    return pcm, dec.sample_rate


def decode(data: bytes, device="cuda"):
    """Format-sniffing front door: ADTS or MP4/M4A bytes in, (pcm, rate)
    out (the av_read_frame + decode loop analogue)."""
    from .io.mp4 import probe_m4a

    if probe_m4a(data):
        return decode_m4a(data, device=device)
    return decode_adts(data, device=device)


__all__ = ["Decoder", "decode", "decode_adts", "decode_batch", "decode_m4a",
           "set_f32_flags"]
