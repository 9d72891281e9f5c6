"""Integer arithmetic (range) coder with quantized CDFs.

This is the entropy-coding backend of the paper's LLM compressor (§4.3).
It is a classic 32-bit Witten–Neal–Cleary coder operating on *integer*
CDFs so that encoding and decoding are bit-exact across platforms — this
deliberately fixes the floating-point-precision worry the paper raises in
§4.4 (float ACs are not portable; integer ones are).

A CDF for an n-symbol alphabet is an int64 numpy array of length n+1 with
``cdf[0] == 0``, strictly increasing, ``cdf[n] == total`` where
``total <= 2**MAX_TOTAL_BITS``. Every symbol must have nonzero mass
(strict monotonicity) so the coder can always represent it.

The coder runs on the host: arithmetic coding is a sequential integer
recurrence with data-dependent renormalization — there is no MXU/VPU
structure to exploit on TPU, so (like the paper / NNCP) the accelerator's
job ends at producing per-token CDFs (see kernels/ac_cdf.py).
"""
from __future__ import annotations

import numpy as np

CODE_BITS = 32
TOP = (1 << CODE_BITS) - 1          # inclusive upper bound of the range
HALF = 1 << (CODE_BITS - 1)
QUARTER = 1 << (CODE_BITS - 2)
THREE_QUARTER = HALF + QUARTER
MASK = TOP
MAX_TOTAL_BITS = 30                 # total * range must fit in 62 bits


class BitWriter:
    """MSB-first bit sink backed by a bytearray."""

    __slots__ = ("_buf", "_acc", "_nbits")

    def __init__(self) -> None:
        self._buf = bytearray()
        self._acc = 0
        self._nbits = 0

    def write(self, bit: int) -> None:
        self._acc = (self._acc << 1) | bit
        self._nbits += 1
        if self._nbits == 8:
            self._buf.append(self._acc)
            self._acc = 0
            self._nbits = 0

    def getvalue(self) -> bytes:
        if self._nbits:
            return bytes(self._buf) + bytes([self._acc << (8 - self._nbits)])
        return bytes(self._buf)

    def bit_length(self) -> int:
        return 8 * len(self._buf) + self._nbits


class BitReader:
    """MSB-first bit source; reads 0 past the end (standard AC convention)."""

    __slots__ = ("_data", "_pos", "_len")

    def __init__(self, data: bytes) -> None:
        self._data = data
        self._pos = 0
        self._len = 8 * len(data)

    def read(self) -> int:
        if self._pos >= self._len:
            self._pos += 1
            return 0
        byte = self._data[self._pos >> 3]
        bit = (byte >> (7 - (self._pos & 7))) & 1
        self._pos += 1
        return bit


class ArithmeticEncoder:
    """Streaming arithmetic encoder over integer CDFs."""

    def __init__(self) -> None:
        self._low = 0
        self._high = TOP
        self._pending = 0
        self._out = BitWriter()
        self._finished = False

    def _emit(self, bit: int) -> None:
        self._out.write(bit)
        while self._pending:
            self._out.write(bit ^ 1)
            self._pending -= 1

    def encode(self, symbol: int, cdf: np.ndarray) -> None:
        total = int(cdf[-1])
        lo_c = int(cdf[symbol])
        hi_c = int(cdf[symbol + 1])
        if hi_c <= lo_c:
            raise ValueError(f"symbol {symbol} has zero mass in CDF")
        span = self._high - self._low + 1
        self._high = self._low + span * hi_c // total - 1
        self._low = self._low + span * lo_c // total
        # Renormalize.
        while True:
            if self._high < HALF:
                self._emit(0)
            elif self._low >= HALF:
                self._emit(1)
                self._low -= HALF
                self._high -= HALF
            elif self._low >= QUARTER and self._high < THREE_QUARTER:
                self._pending += 1
                self._low -= QUARTER
                self._high -= QUARTER
            else:
                break
            self._low = (self._low << 1) & MASK
            self._high = ((self._high << 1) | 1) & MASK

    def finish(self) -> bytes:
        if not self._finished:
            self._pending += 1
            if self._low < QUARTER:
                self._emit(0)
            else:
                self._emit(1)
            self._finished = True
        return self._out.getvalue()

    def bit_length(self) -> int:
        return self._out.bit_length()


class ArithmeticDecoder:
    """Streaming arithmetic decoder; mirror image of the encoder."""

    def __init__(self, data: bytes) -> None:
        self._in = BitReader(data)
        self._low = 0
        self._high = TOP
        self._value = 0
        for _ in range(CODE_BITS):
            self._value = (self._value << 1) | self._in.read()

    def decode(self, cdf: np.ndarray) -> int:
        total = int(cdf[-1])
        span = self._high - self._low + 1
        target = ((self._value - self._low + 1) * total - 1) // span
        # cdf is sorted; find s with cdf[s] <= target < cdf[s+1].
        symbol = int(np.searchsorted(cdf, target, side="right")) - 1
        lo_c = int(cdf[symbol])
        hi_c = int(cdf[symbol + 1])
        self._high = self._low + span * hi_c // total - 1
        self._low = self._low + span * lo_c // total
        while True:
            if self._high < HALF:
                pass
            elif self._low >= HALF:
                self._low -= HALF
                self._high -= HALF
                self._value -= HALF
            elif self._low >= QUARTER and self._high < THREE_QUARTER:
                self._low -= QUARTER
                self._high -= QUARTER
                self._value -= QUARTER
            else:
                break
            self._low = (self._low << 1) & MASK
            self._high = ((self._high << 1) | 1) & MASK
            self._value = ((self._value << 1) | self._in.read()) & MASK
        return symbol


def encode_sequence(symbols, cdfs) -> bytes:
    """Encode ``symbols[i]`` with ``cdfs[i]`` (list/array of per-step CDFs)."""
    enc = ArithmeticEncoder()
    for s, cdf in zip(symbols, cdfs):
        enc.encode(int(s), cdf)
    return enc.finish()


def decode_sequence(data: bytes, cdfs) -> list[int]:
    """Decode one symbol per CDF in order (CDFs may depend on prior symbols
    only through the caller's loop — see LLMCompressor for the adaptive use)."""
    dec = ArithmeticDecoder(data)
    return [dec.decode(cdf) for cdf in cdfs]


def uniform_cdf(n: int) -> np.ndarray:
    """CDF of the uniform distribution over n symbols (used for escape coding)."""
    return np.arange(n + 1, dtype=np.int64)
