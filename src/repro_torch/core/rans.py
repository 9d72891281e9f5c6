"""Batched interleaved rANS entropy coder (codec id 1 of the container).

The host-side successor to the reference arithmetic coder in ``ac.py``.
`ac.py` is a per-stream, bit-by-bit Python loop: correct, portable, and
the throughput bottleneck of the whole system once the model runs on the
accelerator (the paper's coder cost, §4.3, is what bounds tokens/s at
scale). rANS (Duda 2014) admits a *vectorized interleaved* formulation:
the coder state of every stream in a decode batch advances with a
handful of numpy ufunc calls per token position, so host cost per token
is O(1) numpy ops amortized over B streams instead of B Python loops.

Layout and invariants
---------------------
* One independent byte stream per chunk (the container keeps per-chunk
  framing, so groups of chunks remain independently decodable).
* State: ``uint64`` vector over all B streams, normalized interval
  ``[RANS_L, 256 * RANS_L)`` with byte-wise renormalization.
* Symbol model: the same quantized integer CDFs the Pallas ``ac_cdf``
  kernel / ``core.cdf`` emit. rANS requires ``total`` to divide the
  interval bound, so **all totals must be powers of two** — which the
  quantizer guarantees (``total == 2**precision``) and the escape path
  achieves by coding uniformly over ``2**ceil(log2 V)`` (≤ 1 extra bit
  per escape vs. the AC's exact uniform-over-V; escapes are rare).
* Encoding is LIFO: ``put*`` calls only record (start, freq, bits)
  triples; ``finish()`` runs the vectorized coder backwards over the
  recorded steps, writing each stream's bytes back-to-front so the
  decoder consumes them strictly forward. Each stream is framed as
  ``u32-LE final state || renorm bytes``.
* Decoding is streaming-forward and vectorized: one masked coder step
  per token position across all active streams.

Bit-exactness: everything is integer arithmetic on int/uint64 numpy
arrays — no floats anywhere — so encode/decode are portable across
platforms by construction, same as the reference AC.
"""
from __future__ import annotations

import numpy as np

from repro_torch.obs import metrics as _metrics
from repro_torch.obs import trace as _trace

RANS_L = 1 << 23          # lower bound of the normalized state interval
_STATE_BYTES = 4          # final state flush (state < 256 * RANS_L < 2**32)
MAX_PRECISION = 23        # total = 2**bits must satisfy total <= RANS_L


def _count_flush(n_streams: int, n_bytes: int) -> None:
    """Cold-path coder telemetry — stream flushes only, never per step.
    Goes to the process-global registry: the coder has no injection point
    and flush counts are process-wide facts."""
    reg = _metrics.registry()
    reg.counter("rans.streams_flushed",
                "rANS streams materialized").inc(n_streams)
    reg.counter("rans.stream_bytes",
                "total rANS payload bytes flushed").inc(n_bytes)

_U64 = np.uint64
_U8 = np.uint8


def uniform_bits(n: int) -> int:
    """Bits of the power-of-two uniform alphabet covering n symbols
    (the rANS escape path: code uniformly over 2**uniform_bits(V))."""
    if n <= 1:
        return 1
    return int(n - 1).bit_length()


def _as_u64(a) -> np.ndarray:
    return np.asarray(a, dtype=np.int64).astype(_U64)


def _find_slots(cdfs: np.ndarray, slots: np.ndarray) -> np.ndarray:
    """Vectorized per-row symbol lookup: sym[b] s.t.
    cdfs[b, sym] <= slots[b] < cdfs[b, sym+1]."""
    n = cdfs.shape[-1] - 1
    if n <= 1024:
        # one broadsided comparison — fastest for top-K-sized alphabets
        return (cdfs[:, :-1] <= slots[:, None]).sum(axis=1).astype(
            np.int64) - 1
    out = np.empty(cdfs.shape[0], np.int64)
    for b in range(cdfs.shape[0]):  # full-vocab alphabets: log-time per row
        out[b] = np.searchsorted(cdfs[b], slots[b], side="right") - 1
    return out


class BatchedRansEncoder:
    """LIFO interleaved encoder over ``n_streams`` independent streams.

    ``put*`` records one coder step per *active* stream (masked steps
    leave a stream untouched); ``finish()`` materializes the byte
    streams. All (start, freq) pairs must come from CDFs whose total is
    ``2**bits`` with ``bits <= MAX_PRECISION`` and ``freq >= 1``.
    """

    def __init__(self, n_streams: int):
        self.n_streams = int(n_streams)
        self._steps: list[tuple] = []   # (starts u64, freqs u64, bits, mask)
        self._counts = np.zeros(self.n_streams, np.int64)

    # ------------------------------------------------------------ recording
    def put(self, starts, freqs, bits: int, mask=None) -> None:
        """Record one step: stream b encodes the slot [starts[b],
        starts[b]+freqs[b]) of a total-2**bits alphabet."""
        if not 0 < bits <= MAX_PRECISION:
            raise ValueError(f"bits {bits} out of range (1..{MAX_PRECISION})")
        # astype() below always copies, so the stored arrays are private
        starts = _as_u64(np.broadcast_to(starts, (self.n_streams,)))
        freqs = _as_u64(np.broadcast_to(freqs, (self.n_streams,)))
        if mask is not None:
            mask = np.asarray(mask, bool).copy()
            if (freqs[mask] == 0).any():
                raise ValueError("zero-frequency symbol")
            # sanitize inactive lanes so finish() never divides by zero
            freqs = np.where(mask, freqs, _U64(1))
            starts = np.where(mask, starts, _U64(0))
            self._counts[mask] += 1
        else:
            if (freqs == 0).any():
                raise ValueError("zero-frequency symbol")
            self._counts += 1
        self._steps.append((starts, freqs, int(bits), mask))

    def put_symbols(self, symbols, cdfs: np.ndarray, bits: int,
                    mask=None) -> None:
        """Record symbols[b] under per-stream CDF rows cdfs (B, n+1)."""
        symbols = np.asarray(symbols, np.int64)
        cdfs = np.asarray(cdfs, np.int64)
        starts = np.take_along_axis(cdfs, symbols[:, None], axis=1)[:, 0]
        ends = np.take_along_axis(cdfs, symbols[:, None] + 1, axis=1)[:, 0]
        self.put(starts, ends - starts, bits, mask)

    def put_uniform(self, symbols, bits: int, mask=None) -> None:
        """Record symbols[b] coded uniformly over 2**bits (freq 1)."""
        self.put(symbols, np.ones(self.n_streams, np.int64), bits, mask)

    # --------------------------------------------------------------- flush
    def finish(self) -> list[bytes]:
        """Run the coder backwards over all recorded steps and return one
        framed byte string per stream. Streams with zero recorded steps
        return ``b""`` (nothing to decode, nothing stored)."""
        with _trace.span("rans.finish"):
            return self._finish()

    def _finish(self) -> list[bytes]:
        B = self.n_streams
        # worst case 3 payload bytes per step (bits <= 23) + state flush
        cap = 3 * (int(self._counts.max()) if B else 0) + _STATE_BYTES + 8
        buf = np.zeros((B, cap), _U8)
        cur = np.full(B, cap, np.int64)
        x = np.full(B, RANS_L, _U64)
        for starts, freqs, bits, mask in reversed(self._steps):
            # renormalize: shift out low bytes while x would overflow
            x_max = ((_U64(RANS_L >> bits) << _U64(8)) * freqs)
            active = (x >= x_max) if mask is None else (mask & (x >= x_max))
            while active.any():
                idx = np.nonzero(active)[0]
                cur[idx] -= 1
                buf[idx, cur[idx]] = (x[idx] & _U64(0xFF)).astype(_U8)
                x[idx] >>= _U64(8)
                active[idx] = x[idx] >= x_max[idx]
            enc = ((x // freqs) << _U64(bits)) + (x % freqs) + starts
            x = enc if mask is None else np.where(mask, enc, x)
        out: list[bytes] = []
        for b in range(B):
            if self._counts[b] == 0:
                out.append(b"")
                continue
            state = int(x[b])
            head = bytes((state >> (8 * i)) & 0xFF
                         for i in range(_STATE_BYTES))
            out.append(head + buf[b, cur[b]:].tobytes())
        _count_flush(len(out), sum(len(s) for s in out))
        return out


def _encode_steps(steps: list[tuple[int, int, int]]) -> bytes:
    """Scalar backward coder over one stream's recorded (start, freq, bits)
    steps — byte-identical to ``BatchedRansEncoder.finish()`` for the same
    step sequence (property-tested in tests/test_rans.py)."""
    if not steps:
        return b""
    x = RANS_L
    tail = bytearray()
    for start, freq, bits in reversed(steps):
        x_max = ((RANS_L >> bits) << 8) * freq
        while x >= x_max:
            tail.append(x & 0xFF)
            x >>= 8
        x = ((x // freq) << bits) + (x % freq) + start
    tail.reverse()
    return x.to_bytes(_STATE_BYTES, "little") + bytes(tail)


class SlotRansEncoder:
    """Per-slot LIFO recorder for the continuous-batching scheduler.

    ``BatchedRansEncoder`` flushes every stream at once in ``finish()`` —
    right for lock-step groups, wrong for a slot machine where chunk
    streams complete out of order. This variant records steps per slot
    and materializes one slot's bytes the moment its chunk finishes
    (``flush_slot``), freeing the slot for refill while its neighbours
    keep coding. Output framing is byte-identical to the batched encoder.
    """

    def __init__(self, n_slots: int):
        self.n_slots = int(n_slots)
        self._steps: list[list[tuple[int, int, int]]] = \
            [[] for _ in range(self.n_slots)]

    def put(self, starts, freqs, bits: int, mask=None) -> None:
        """Record one step for every active slot (see BatchedRansEncoder)."""
        if not 0 < bits <= MAX_PRECISION:
            raise ValueError(f"bits {bits} out of range (1..{MAX_PRECISION})")
        starts = np.broadcast_to(np.asarray(starts, np.int64),
                                 (self.n_slots,))
        freqs = np.broadcast_to(np.asarray(freqs, np.int64), (self.n_slots,))
        active = (np.ones(self.n_slots, bool) if mask is None
                  else np.asarray(mask, bool))
        if (freqs[active] <= 0).any():
            raise ValueError("zero-frequency symbol")
        for b in np.nonzero(active)[0]:
            self._steps[b].append((int(starts[b]), int(freqs[b]), bits))

    def put_symbols(self, symbols, cdfs: np.ndarray, bits: int,
                    mask=None) -> None:
        symbols = np.asarray(symbols, np.int64)
        cdfs = np.asarray(cdfs, np.int64)
        starts = np.take_along_axis(cdfs, symbols[:, None], axis=1)[:, 0]
        ends = np.take_along_axis(cdfs, symbols[:, None] + 1, axis=1)[:, 0]
        self.put(starts, ends - starts, bits, mask)

    def put_uniform(self, symbols, bits: int, mask=None) -> None:
        self.put(symbols, np.ones(self.n_slots, np.int64), bits, mask)

    def pending(self, slot: int) -> int:
        """Number of recorded, unflushed steps in ``slot``."""
        return len(self._steps[slot])

    def slot_cost_bits(self, slot: int) -> float:
        """Quantized code length of the slot's recorded steps,
        sum(bits - log2 freq) — per-chunk diagnostics, read before
        ``flush_slot`` clears the record. Cold path: one numpy pass over
        the chunk, nothing per step."""
        steps = self._steps[slot]
        if not steps:
            return 0.0
        a = np.asarray(steps, np.float64)          # rows: (start, freq, bits)
        return float(a[:, 2].sum() - np.log2(a[:, 1]).sum())

    def flush_slot(self, slot: int) -> bytes:
        """Materialize and clear one slot's stream (LIFO backward pass)."""
        with _trace.span("rans.flush_slot"):
            out = _encode_steps(self._steps[slot])
            self._steps[slot] = []
            _count_flush(1, len(out))
            return out


class BatchedRansDecoder:
    """Streaming forward decoder over B independent framed streams.

    Mirror image of ``BatchedRansEncoder``: call ``get``/``get_uniform``
    in the exact order (and with the exact masks) the encoder ``put`` —
    the adaptive caller (LLMCompressor) reproduces that order because
    each decoded token feeds the model that produces the next CDF.

    Slots are individually re-attachable (``attach``/``detach``) so the
    continuous-batching scheduler can point a finished slot at the next
    chunk stream without rebuilding the decoder.
    """

    def __init__(self, streams: list[bytes]):
        B = len(streams)
        self._lens = np.array([len(s) for s in streams], np.int64)
        cap = max(int(self._lens.max(initial=0)), _STATE_BYTES)
        self._buf = np.zeros((B, cap), _U8)
        for b, s in enumerate(streams):
            if s:
                self._buf[b, :len(s)] = np.frombuffer(s, _U8)
        self._x = np.zeros(B, _U64)
        for i in range(_STATE_BYTES):
            self._x |= self._buf[:, i].astype(_U64) << _U64(8 * i)
        self._cur = np.full(B, _STATE_BYTES, np.int64)
        #: interval freqs of the most recent ``advance``/``get`` call
        #: (inactive lanes read 1) — the per-chunk diagnostics accrual
        #: reads this instead of recomputing CDF lookups (DESIGN.md §10)
        self.last_freq = np.ones(B, np.int64)

    # ------------------------------------------------- per-slot attachment
    def attach(self, slot: int, data: bytes) -> None:
        """Point ``slot`` at a fresh framed stream (state reloaded from its
        header). The other slots' positions and states are untouched."""
        n = len(data)
        if 0 < n < _STATE_BYTES:
            raise ValueError(f"stream shorter than state header ({n} bytes)")
        if n > self._buf.shape[1]:
            grown = np.zeros((self._buf.shape[0], n), _U8)
            grown[:, :self._buf.shape[1]] = self._buf
            self._buf = grown
        self._buf[slot, :n] = np.frombuffer(data, _U8)
        self._lens[slot] = n
        self._cur[slot] = _STATE_BYTES
        x = 0
        for i in range(_STATE_BYTES - 1, -1, -1):
            x = (x << 8) | int(self._buf[slot, i])
        self._x[slot] = _U64(x) if n else _U64(0)

    def detach(self, slot: int) -> None:
        """Mark ``slot`` empty (no stream attached)."""
        self._lens[slot] = 0
        self._cur[slot] = _STATE_BYTES
        self._x[slot] = _U64(0)

    def exhausted(self, slot: int) -> bool:
        """True iff the slot's stream decoded cleanly to its end: every
        byte consumed and the coder state back at its initial value —
        the rANS analogue of a well-formed EOF (decode inverts encode
        exactly, so the state must return to RANS_L)."""
        if self._lens[slot] == 0:
            return True
        return (int(self._cur[slot]) == int(self._lens[slot])
                and int(self._x[slot]) == RANS_L)

    def _renorm(self, mask: np.ndarray) -> None:
        active = mask & (self._x < _U64(RANS_L)) & (self._cur < self._lens)
        while active.any():
            idx = np.nonzero(active)[0]
            self._x[idx] = ((self._x[idx] << _U64(8))
                            | self._buf[idx, self._cur[idx]].astype(_U64))
            self._cur[idx] += 1
            active[idx] = ((self._x[idx] < _U64(RANS_L))
                           & (self._cur[idx] < self._lens[idx]))

    def peek(self, bits: int) -> np.ndarray:
        """Low ``bits`` of every stream's coder state — the slot values a
        symbol-interval lookup (host `_find_slots` or the fused on-device
        kernel) resolves to symbols. Does not consume anything."""
        return (self._x & _U64((1 << bits) - 1)).astype(np.int64)

    def advance(self, syms, starts, freqs, bits: int, mask=None) -> np.ndarray:
        """Consume one symbol per active stream given its already-resolved
        (symbol, start, freq) interval — the second half of ``get`` for
        callers that run the interval lookup elsewhere (e.g. on device in
        the fused top-k→CDF→lookup kernel). The interval MUST correspond
        to this stream's current ``peek(bits)`` slot."""
        B = self._x.shape[0]
        mask = np.ones(B, bool) if mask is None else np.asarray(mask, bool)
        slots = (self._x & _U64((1 << bits) - 1)).astype(np.int64)
        syms = np.where(mask, np.asarray(syms, np.int64), 0)
        starts = np.where(mask, np.asarray(starts, np.int64), 0)
        freqs = np.where(mask, np.asarray(freqs, np.int64), 1)
        nx = (_as_u64(freqs) * (self._x >> _U64(bits))
              + _as_u64(slots) - _as_u64(starts))
        self._x = np.where(mask, nx, self._x)
        self._renorm(mask)
        self.last_freq = freqs
        return syms

    def get(self, cdfs: np.ndarray, bits: int, mask=None) -> np.ndarray:
        """Decode one symbol per active stream under CDF rows cdfs
        (B, n+1) with total 2**bits. Inactive lanes return 0 untouched."""
        B = self._x.shape[0]
        mask = np.ones(B, bool) if mask is None else np.asarray(mask, bool)
        cdfs = np.asarray(cdfs, np.int64)
        slots = self.peek(bits)
        syms = _find_slots(cdfs, slots)
        syms = np.where(mask, syms, 0)
        starts = np.take_along_axis(cdfs, syms[:, None], axis=1)[:, 0]
        ends = np.take_along_axis(cdfs, syms[:, None] + 1, axis=1)[:, 0]
        return self.advance(syms, starts, ends - starts, bits, mask)

    def get_uniform(self, bits: int, mask=None) -> np.ndarray:
        """Decode one uniform-over-2**bits symbol per active stream."""
        B = self._x.shape[0]
        mask = np.ones(B, bool) if mask is None else np.asarray(mask, bool)
        syms = (self._x & _U64((1 << bits) - 1)).astype(np.int64)
        syms = np.where(mask, syms, 0)
        self._x = np.where(mask, self._x >> _U64(bits), self._x)
        self._renorm(mask)
        return syms


# ------------------------------------------------------- single-stream API
def encode_sequence(symbols, cdfs, bits: int) -> bytes:
    """Reference single-stream encode: symbols[i] under cdfs[i] (each a
    length-(n+1) integer CDF with total 2**bits). For tests/benchmarks;
    the compressor uses the batched classes directly."""
    enc = BatchedRansEncoder(1)
    for s, cdf in zip(symbols, cdfs):
        enc.put_symbols(np.array([int(s)]), np.asarray(cdf)[None, :], bits)
    return enc.finish()[0]


def decode_sequence(data: bytes, cdfs, bits: int) -> list[int]:
    """Reference single-stream decode, one symbol per CDF in order."""
    dec = BatchedRansDecoder([data])
    return [int(dec.get(np.asarray(cdf)[None, :], bits)[0]) for cdf in cdfs]
