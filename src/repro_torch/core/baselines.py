"""Baseline compressors from the paper's evaluation (§5.2).

Dictionary-based: gzip (DEFLATE), LZMA, Zstd-22 — stdlib / zstandard.
Entropy-based: Huffman, static (order-0) arithmetic coding, and an
order-N context-model arithmetic coder (the adaptive flavour FSE/NNCP-lite
occupy). All implemented here so every number in the paper's Table 3/5
analog is produced by this repo.

Beyond ratio reporting, this module is also the **fallback codec
registry** of the adaptive router (DESIGN.md §11): real
``compress_bytes``/``decompress_bytes`` paths for the codecs a v5
container may select per chunk when the LLM path would lose — zstd,
LZMA (raw LZMA2 stream: no xz framing, chunks are small), and raw
store. The registry is keyed by the short names the container's codec-id
table (core.compressor.CODEC_IDS) maps to; zstd availability is checked
at call time so the optional-dependency path (``HAVE_ZSTD = False``)
stays testable by monkeypatching.
"""
from __future__ import annotations

import gzip as _gzip
import heapq
import lzma as _lzma
from collections import Counter, defaultdict

import numpy as np

try:  # optional baseline — the [test] extra pulls it in, core never needs it
    import zstandard as _zstd
    HAVE_ZSTD = True
except ImportError:
    _zstd = None
    HAVE_ZSTD = False

from . import ac
from .cdf import pmf_to_cdf


# ----------------------------------------------------------- dictionary-based
def gzip_ratio(data: bytes) -> float:
    return len(data) / len(_gzip.compress(data, compresslevel=9))


def lzma_ratio(data: bytes) -> float:
    return len(data) / len(_lzma.compress(data, preset=9 | _lzma.PRESET_EXTREME))


def zstd_ratio(data: bytes, level: int = 22) -> float:
    if not HAVE_ZSTD:
        raise RuntimeError(
            "zstd baseline requires the 'zstandard' package "
            "(pip install zstandard)")
    return len(data) / len(_zstd.ZstdCompressor(level=level).compress(data))


# -------------------------------------------------------------- entropy-based
def huffman_compress(data: bytes) -> tuple[bytes, dict]:
    """Canonical Huffman over bytes. Returns (bitstream, code table)."""
    freq = Counter(data)
    if len(freq) == 1:  # degenerate
        sym = next(iter(freq))
        return bytes([sym]), {sym: "0"}
    heap = [(f, i, (s,)) for i, (s, f) in enumerate(sorted(freq.items()))]
    heapq.heapify(heap)
    codes = defaultdict(str)
    i = len(heap)
    while len(heap) > 1:
        fa, _, a = heapq.heappop(heap)
        fb, _, b = heapq.heappop(heap)
        for s in a:
            codes[s] = "0" + codes[s]
        for s in b:
            codes[s] = "1" + codes[s]
        heapq.heappush(heap, (fa + fb, i, a + b))
        i += 1
    w = ac.BitWriter()
    for byte in data:
        for c in codes[byte]:
            w.write(c == "1")
    return w.getvalue(), dict(codes)


def huffman_ratio(data: bytes) -> float:
    payload, codes = huffman_compress(data)
    # Table cost: canonical Huffman needs one code length per present symbol.
    table = len(codes) * 2
    return len(data) / (len(payload) + table)


def order0_ac_ratio(data: bytes, precision: int = 16) -> float:
    """Static arithmetic coding with an order-0 byte model (≈ FSE bound)."""
    hist = np.bincount(np.frombuffer(data, dtype=np.uint8), minlength=256)
    pmf = hist / hist.sum()
    budget = (1 << precision) - 256
    q = np.floor(pmf * budget).astype(np.int64)
    rem = budget - q.sum()
    order = np.argsort(-(pmf * budget - q))
    q[order[:rem]] += 1
    cdf = pmf_to_cdf(q + 1)
    enc = ac.ArithmeticEncoder()
    for b in data:
        enc.encode(b, cdf)
    payload = enc.finish()
    return len(data) / (len(payload) + 256 * 2)  # + model table


def orderN_ac_ratio(data: bytes, order: int = 2, precision: int = 14) -> float:
    """Adaptive order-N context-mixing arithmetic coder (small-context PPM
    flavour) — a fair stand-in for the adaptive neural baselines (NNCP/
    TRACE/PAC occupy this niche with learned contexts). Adaptive => no
    table cost; both sides update identical counts."""
    T = 1 << precision
    counts: dict[bytes, np.ndarray] = {}
    enc = ac.ArithmeticEncoder()
    ctx = b"\x00" * order
    for byte in data:
        c = counts.get(ctx)
        if c is None:
            c = np.ones(256, dtype=np.int64)
            counts[ctx] = c
        tot = int(c.sum())
        if tot >= T - 256:  # rescale to keep totals within coder precision
            c = np.maximum(c // 2, 1)
            counts[ctx] = c
        cdf = pmf_to_cdf(c)
        enc.encode(byte, cdf)
        c[byte] += 32
        ctx = (ctx + bytes([byte]))[-order:]
    return len(data) / max(1, len(enc.finish()))


# ------------------------------------------------- fallback byte codecs
# Chunk-scale streams: LZMA uses a raw LZMA2 filter chain (the xz/alone
# containers cost ~20-60 framing bytes, which swamps a 256-byte chunk);
# both sides agree on the filter spec below, so no header is needed.
_LZMA_FILTERS = [{"id": _lzma.FILTER_LZMA2, "preset": 9}]
_ZSTD_LEVEL = 19


def _zstd_compress(data: bytes) -> bytes:
    if not HAVE_ZSTD:
        raise RuntimeError(
            "zstd codec requires the 'zstandard' package "
            "(pip install zstandard)")
    return _zstd.ZstdCompressor(level=_ZSTD_LEVEL).compress(data)


def _zstd_decompress(blob: bytes) -> bytes:
    if not HAVE_ZSTD:
        raise RuntimeError(
            "zstd codec requires the 'zstandard' package "
            "(pip install zstandard)")
    return _zstd.ZstdDecompressor().decompress(blob)


def _lzma_compress(data: bytes) -> bytes:
    return _lzma.compress(data, format=_lzma.FORMAT_RAW,
                          filters=_LZMA_FILTERS)


def _lzma_decompress(blob: bytes) -> bytes:
    return _lzma.decompress(blob, format=_lzma.FORMAT_RAW,
                            filters=_LZMA_FILTERS)


#: name -> (compress_fn, decompress_fn). These are the router's fallback
#: backends; the names are wire-stable (they map to container codec ids).
BYTE_CODECS = {
    "zstd": (_zstd_compress, _zstd_decompress),
    "lzma": (_lzma_compress, _lzma_decompress),
    "raw": (lambda data: bytes(data), lambda blob: bytes(blob)),
}


def available_byte_codecs() -> list[str]:
    """Fallback codec names usable right now, best-ratio-first. Checked
    at call time, not import time, so a monkeypatched ``HAVE_ZSTD``
    (the optional-dep test path) is respected."""
    return [n for n in BYTE_CODECS if n != "zstd" or HAVE_ZSTD]


def compress_bytes(name: str, data: bytes) -> bytes:
    """Compress ``data`` with the named fallback codec. Raises KeyError
    on an unknown name and RuntimeError when zstd is requested without
    the optional ``zstandard`` package."""
    return BYTE_CODECS[name][0](data)


def decompress_bytes(name: str, blob: bytes) -> bytes:
    """Exact inverse of ``compress_bytes(name, ...)``."""
    return BYTE_CODECS[name][1](blob)


ALL_BASELINES = {
    "huffman": huffman_ratio,
    "arith_order0": order0_ac_ratio,
    "arith_order2": orderN_ac_ratio,
    "gzip": gzip_ratio,
    "lzma": lzma_ratio,
    "zstd22": zstd_ratio,
}


def available_baselines() -> list[str]:
    return [n for n in ALL_BASELINES if n != "zstd22" or HAVE_ZSTD]


def run_baselines(data: bytes, names=None) -> dict[str, float]:
    """Ratios for the requested baselines. With no explicit ``names``,
    unavailable optional backends (zstd) are silently skipped; naming one
    explicitly raises so a typo can't masquerade as a result."""
    names = names or available_baselines()
    return {n: round(ALL_BASELINES[n](data), 3) for n in names}
