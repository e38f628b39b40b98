"""MSB-first bitstream reader (host side).

Semantics mirror the reference bit reader (libavcodec/get_bits.h:54-498):
big-endian, MSB-first, with position/length tracking.  This pure-Python
implementation is the reference front-end used for tests and as the spec for
the native C++ front-end; it holds the whole buffer as one big int so that
``show``/``skip`` are O(1) shifts on small frames.
"""
from __future__ import annotations


class BitReader:
    __slots__ = ("_val", "nbits", "pos")

    def __init__(self, data: bytes, start_bit: int = 0):
        self._val = int.from_bytes(data, "big")
        self.nbits = 8 * len(data)
        self.pos = start_bit

    def show(self, n: int) -> int:
        """Peek n bits without consuming (n may overrun: zero-padded)."""
        end = self.pos + n
        if end <= self.nbits:
            return (self._val >> (self.nbits - end)) & ((1 << n) - 1)
        # overrun: behave like reading past the end of a zero-padded buffer
        avail = self.nbits - self.pos
        if avail <= 0:
            return 0
        return (self._val & ((1 << avail) - 1)) << (n - avail)

    def get(self, n: int) -> int:
        v = self.show(n)
        self.pos += n
        return v

    def get1(self) -> int:
        return self.get(1)

    def skip(self, n: int) -> None:
        self.pos += n

    def align(self) -> int:
        n = -self.pos & 7
        self.pos += n
        return n

    def bits_left(self) -> int:
        return self.nbits - self.pos

    def bits_count(self) -> int:
        return self.pos


class BitstreamError(ValueError):
    """Raised on malformed bitstream input (maps to reference's -1 returns)."""


class TracingBitReader(BitReader):
    """Bit-level trace reader — analogue of the reference's TRACE-gated
    get_bits_trace (get_bits.h:620-663): every read is reported with its
    bit position, width, and value via a callback.  Debug aid for bitstream
    work; install with ``Decoder(..., bitreader_cls=TracingBitReader)`` or
    the CLI ``--bit-trace``."""
    __slots__ = ("sink",)

    def __init__(self, data: bytes, start_bit: int = 0, sink=None):
        super().__init__(data, start_bit)
        self.sink = sink

    def get(self, n: int) -> int:
        pos = self.pos
        v = super().get(n)
        (self.sink or _default_sink)(pos, n, v)
        return v

    def skip(self, n: int) -> None:
        # VLC decode consumes via show+skip; log the skipped bits too
        (self.sink or _default_sink)(self.pos, n, self.show(n))
        super().skip(n)


def _default_sink(pos: int, n: int, v: int) -> None:
    import sys
    print(f"bit {pos:7d}: {n:2d} -> {v:#x}", file=sys.stderr)
