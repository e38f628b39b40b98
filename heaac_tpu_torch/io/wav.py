"""Port copy of ``heaac_tpu/io/wav.py``: the port imports nothing of the
JAX package, so it keeps its own copy.  Names as there.

Minimal WAV (RIFF) reader/writer for 16-bit PCM.
"""
from __future__ import annotations

import struct

import numpy as np


def write_wav(path: str, pcm, sample_rate: int) -> None:
    """pcm: int16 [samples, channels], a numpy array or a CPU tensor (the
    port's decoders return CPU int16 tensors)."""
    pcm = np.asarray(pcm, np.int16)
    if pcm.ndim == 1:
        pcm = pcm[:, None]
    ch = pcm.shape[1]
    data = pcm.tobytes()
    with open(path, "wb") as f:
        f.write(b"RIFF")
        f.write(struct.pack("<I", 36 + len(data)))
        f.write(b"WAVEfmt ")
        f.write(struct.pack("<IHHIIHH", 16, 1, ch, sample_rate,
                            sample_rate * ch * 2, ch * 2, 16))
        f.write(b"data")
        f.write(struct.pack("<I", len(data)))
        f.write(data)


def read_wav(path: str) -> tuple[np.ndarray, int]:
    """Returns (int16 [samples, channels], sample_rate)."""
    with open(path, "rb") as f:
        raw = f.read()
    if raw[:4] != b"RIFF" or raw[8:12] != b"WAVE":
        raise ValueError("not a WAV file")
    pos = 12
    fmt = None
    while pos + 8 <= len(raw):
        cid = raw[pos:pos + 4]
        size = struct.unpack("<I", raw[pos + 4:pos + 8])[0]
        body = raw[pos + 8:pos + 8 + size]
        if cid == b"fmt ":
            fmt = struct.unpack("<HHIIHH", body[:16])
        elif cid == b"data":
            if fmt is None or fmt[0] != 1 or fmt[5] != 16:
                raise ValueError(f"not 16-bit PCM: fmt {fmt}")
            pcm = np.frombuffer(body, np.int16).reshape(-1, fmt[1])
            return pcm, fmt[2]
        pos += 8 + size + (size & 1)
    raise ValueError("no data chunk")
