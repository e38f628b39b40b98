"""Port copy of ``heaac_tpu/io/bitwriter.py``: the port imports nothing
of the JAX package, so it keeps its own copy.  Names as there.

MSB-first bit writer (host side), mirror of the reference put_bits.h.
"""
from __future__ import annotations


class BitWriter:
    def __init__(self):
        self._val = 0
        self.nbits = 0

    def put(self, n: int, value: int) -> None:
        if not 0 <= value < (1 << n):
            raise ValueError(f"value {value} does not fit in {n} bits")
        self._val = (self._val << n) | value
        self.nbits += n

    def put1(self, value: int) -> None:
        self.put(1, value & 1)

    def align(self) -> int:
        pad = -self.nbits & 7
        if pad:
            self.put(pad, 0)
        return pad

    def extend(self, other: "BitWriter") -> None:
        self._val = (self._val << other.nbits) | other._val
        self.nbits += other.nbits

    def put_bits_from(self, data: bytes, start_bit: int, nbits: int) -> None:
        """Copy nbits starting at start_bit from data."""
        if not nbits:
            return
        total = 8 * len(data)
        v = int.from_bytes(data, "big")
        chunk = (v >> (total - start_bit - nbits)) & ((1 << nbits) - 1)
        self.put(nbits, chunk)

    def bytes(self) -> bytes:
        if self.nbits % 8:
            raise ValueError(f"{self.nbits} bits is not a whole byte count")
        return self._val.to_bytes(self.nbits // 8, "big")
