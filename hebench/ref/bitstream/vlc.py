"""Variable-length-code (Huffman) decoding for the host front-end.

The reference builds multi-level lookup tables (libavcodec/bitstream.c
``init_vlc_sparse``); here we build a single flat lookup table of size
2^max_bits mapping bit-prefixes to (symbol, length).  The AAC/SBR/PS
codebooks have max code length <= 19, so tables stay small; they are built
once per process and cached.
"""
from __future__ import annotations

import numpy as np

from .reader import BitReader, BitstreamError


class VLC:
    def __init__(self, codes: np.ndarray, bits: np.ndarray, name: str = "vlc"):
        codes = np.asarray(codes, np.uint64)
        bits = np.asarray(bits, np.int64)
        assert codes.shape == bits.shape
        self.name = name
        self.max_bits = int(bits.max())
        size = 1 << self.max_bits
        self.sym = np.full(size, -1, np.int32)
        self.len = np.zeros(size, np.int8)
        for symbol, (code, nbits) in enumerate(zip(codes.tolist(), bits.tolist())):
            if nbits == 0:
                continue
            shift = self.max_bits - nbits
            lo = code << shift
            hi = lo + (1 << shift)
            if self.sym[lo:hi].max(initial=-1) != -1:
                raise ValueError(f"{name}: overlapping codes")
            self.sym[lo:hi] = symbol
            self.len[lo:hi] = nbits
        self._sym_list = self.sym.tolist()
        self._len_list = self.len.tolist()

    def decode(self, br: BitReader) -> int:
        prefix = br.show(self.max_bits)
        sym = self._sym_list[prefix]
        if sym < 0:
            raise BitstreamError(f"invalid {self.name} code at bit {br.pos}")
        br.skip(self._len_list[prefix])
        return sym
