"""heaac_tpu_torch — the HE-AAC decoder's PyTorch port (CUDA on Hopper).

A second package beside the JAX reference ``heaac_tpu``: it takes ADTS
bytes in and gives int16 PCM out for batches of independent streams
(``decode_batch``: mixed HE-AAC v2 / v1 and AAC-LC batches) and for one
stream at a time (``decode_adts``, ``Decoder``), with
the device graph as PyTorch ops and the parametric-stereo recurrence as a
hand-written CUDA kernel (``csrc/ps_decorrelate.cu``).  The package never
imports ``jax`` or ``heaac_tpu``; it builds the JAX package's C++ parser
from source by path and reads its extracted table file as data.

Layout mirrors the JAX package so each module's counterpart is easy to
find: ``ops/`` (filterbanks, SBR, PS, Huffman decoders), ``codec/``
(frame graph, wire expansion, pipelined batch decoder).
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


__all__ = ["Decoder", "decode_adts", "decode_batch", "set_f32_flags"]
