"""The paper's LLM-based lossless compressor (§4), as a framework component.

Design
------
The text is tokenized, split into fixed-size **chunks** (paper §5.4), and
each chunk is coded *independently* given a fresh context. Independence is
what makes the workload batchable:

* **compress** — one teacher-forced scoring pass over a (B, C) batch of
  chunks (a prefill-shaped pjit computation) yields P(x_t | x_<t) for every
  position; each actual token is then entropy-coded with its quantized CDF.
  Model cost: one forward pass per C tokens.

* **decompress** — B chunks are decoded in lock-step: one `decode_step`
  (serve-shaped computation, KV/SSM cache) per position for the whole
  batch; the entropy decoder picks each stream's next token from the
  model CDF, which is then fed back as the next input.

Losslessness requires the *same* quantized CDFs on both sides. Both sides
run the same jitted function on the same weights with integer quantization,
so the CDFs are bit-identical (this is exactly why the paper compresses
instead of re-generating, §4.4 — we make the determinism explicit).

Beyond-paper: top-K + escape coding (see core/cdf.py) bounds host-coder
work per token at K+1 instead of |V|, at a measured ~0 ratio cost for
well-predicted text (escapes coded uniformly remain lossless).

Entropy backends (DESIGN.md §7)
-------------------------------
Two host coders share the container:

* ``codec="rans"`` (id 1, default) — batched interleaved rANS
  (core/rans.py): all B chunk-streams advance through ONE vectorized
  coder step per token position. This is the production path; host cost
  per token is a few numpy ufuncs amortized over the batch.
* ``codec="ac"`` (id 0) — the reference Witten–Neal–Cleary arithmetic
  coder (core/ac.py): per-stream Python loops, kept as the legacy /
  cross-check backend and for decoding v2 archives.

Container format (little-endian)
--------------------------------
Shared header (v3 and v4; v2 lacks the codec byte):
  magic 'LLMC' | u8 version | u8 flags | u16 chunk_size | u32 n_tokens
  u32 vocab | u16 topk (0 => full vocab) | u8 precision | u8 codec
Body (all versions): per chunk, varint byte-length + codec stream.

Version 4 appends a **seekable footer** after the body (DESIGN.md §8):
one index entry per chunk —
  u64 stream offset (from container start) | u32 stream length
  u32 valid token count | u64 xxh64(stream)
— followed by u32 encode batch (the lane count the encoder's model
program ran at; 0 = unrecorded), u64 xxh64(header || entries || encode
batch), u32 n_chunks, u32 footer length, and the end magic 'LC4F'. The
encode batch is recorded because on real models the logits are only
bit-reproducible at the *same* batch shape (XLA reduction order varies
with B), so it is the decode batch/slot count required for bit-exact
decode — advisory for batch-invariant predictors, load-bearing for
production models. The index enables random-access decode
of chunk ranges (``decompress_range``) and out-of-order chunk completion
from the service scheduler; the checksums turn silent corruption into
``ContainerError`` before the entropy coder runs on garbage.

Version 5 (DESIGN.md §11) is v4 plus **adaptive codec routing**: each
index entry carries a u8 codec tag —
  u64 offset | u32 stream length | u32 valid tokens | u8 codec | u64 xxh64
— end magic 'LC5F'. The header codec byte still names the container's
LLM *entropy* codec (ac/rans); a per-chunk tag either repeats it (the
chunk is LLM-coded) or names a fallback byte codec (zstd=2, lzma=3,
raw=4 — core/baselines.py) the router chose because the model fit was
poor. The tags live inside the hash-covered footer, so a flipped tag is
detected like any other index corruption, and decode reconstructs each
chunk with exactly the recorded backend — the router runs at encode
only, never guesses at decode. LLM-tagged chunks are grouped at the
recorded encode batch for decode; lanes are independent, so *which*
chunks share a group is free while the lane count stays load-bearing.

Version 6 (DESIGN.md §12) makes conditioning **context** first-class:
each index entry additionally carries a hash-covered context recipe —
  u64 offset | u32 length | u32 valid tokens | u8 codec
  u8 recipe kind | u16 recipe param | u64 xxh64
(28-byte entries, end magic 'LC6F') — and the footer holds a
shared-prefix dictionary section between the entries and the encode
batch (also hash-covered). The recipe declares what the model had
consumed before the chunk's first token:

  * ``none`` (0, param 0) — fresh context, exactly the v2–v5 contract;
  * ``carry(W)`` (1, param W >= 1) — the last ``min(W, C)`` tokens of
    the *previous* chunk (so a carry chunk can never be chunk 0);
  * ``shared[i]`` (2) — entry ``i`` of the shared-prefix dictionary
    (u16 count; per prefix: u8 name length | name | u16 token count |
    u32 tokens).

A lane's model input is always the self-contained sequence
[BOS, context…, chunk tokens…]; lanes are independent, so recipe +
recorded lane count make ranged decode bit-exact by construction —
a ranged chunk's carry chain is decoded forward from its chain start
to materialize the declared context, and *composition* of lanes stays
free exactly as in v5. Fallback-tagged chunks must carry recipe
``none`` (they decode without the model, and an all-fallback archive
must stay fully model-free).

The codec, version and geometry used for decode come from the container,
never from this object's configuration. Version compatibility: v2
read-only (AC implied), v3/v4/v5/v6 read/write. A bare
``LLMCompressor`` writes v3 — the wire-minimal format every ratio
benchmark measures (the v4 index costs a fixed 24 B/chunk, which
amortizes over production payloads but distorts micro-scale ratios);
the service layer (repro.service) and the ``llmc`` CLI write v4, where
seekability and integrity checking earn their bytes, v5 whenever
routing is enabled (``route != "llm"``), and v6 whenever a context
recipe is in play (``context_window``/``shared_prefix``).
"""
from __future__ import annotations

import inspect
import struct
from dataclasses import dataclass, field
from typing import Callable, Protocol

import numpy as np
import torch

from repro_torch import obs
from . import ac, rans
from .cdf import (DEFAULT_PRECISION, LogitShards, as_tensor, full_cdf,
                  full_cdf_lookup, full_logits, logits_to_cdf, to_numpy,
                  topk_cdf, topk_cdf_lookup)
from .checksum import xxh64
from .draft import SuffixDraft
from .router import (ROUTE_AUTO, ROUTE_LLM, CodecRouter, RouterConfig,
                     route_chunks)

MAGIC = b"LLMC"
VERSION_V3 = 3
VERSION_V4 = 4
VERSION_V5 = 5
VERSION_V6 = 6
VERSION = VERSION_V6                 # newest supported container version
_V2_HEADER = "<BBHIIHB"              # seed header (no codec byte)
_V3_HEADER = "<BBHIIHBB"             # v3..v6 share this header layout
_V4_ENTRY = "<QIIQ"                  # offset, stream len, valid tokens, xxh64
_V4_ENTRY_SIZE = struct.calcsize(_V4_ENTRY)
_V4_END_MAGIC = b"LC4F"
_V5_ENTRY = "<QIIBQ"                 # v4 entry + u8 per-chunk codec tag
_V5_ENTRY_SIZE = struct.calcsize(_V5_ENTRY)
_V5_END_MAGIC = b"LC5F"
_V6_ENTRY = "<QIIBBHQ"               # v5 entry + u8 recipe kind, u16 param
_V6_ENTRY_SIZE = struct.calcsize(_V6_ENTRY)
_V6_END_MAGIC = b"LC6F"
_V4_TRAILER = 12                     # u32 n_chunks | u32 footer_len | magic
_INDEXED_VERSIONS = (VERSION_V4, VERSION_V5, VERSION_V6)

# v6 per-chunk context recipes (DESIGN.md §12)
RECIPE_NONE = 0      # fresh context — the v2-v5 contract
RECIPE_CARRY = 1     # last min(param, C) tokens of the previous chunk
RECIPE_SHARED = 2    # shared-prefix dictionary entry [param]
RECIPE_NAMES = {RECIPE_NONE: "none", RECIPE_CARRY: "carry",
                RECIPE_SHARED: "shared"}
# shared-prefix dictionary wire limits (u8 name length, u16 counts)
MAX_PREFIX_TOKENS = 0xFFFF
MAX_PREFIX_NAME = 0xFF

# LLM entropy codecs — legal in the header codec byte of any version
CODEC_AC = 0
CODEC_RANS = 1
# fallback byte codecs — legal only in v5 per-chunk tags (the router's
# choices; backends live in core/baselines.py)
CODEC_ZSTD = 2
CODEC_LZMA = 3
CODEC_RAW = 4
CODEC_IDS = {"ac": CODEC_AC, "rans": CODEC_RANS}
FALLBACK_CODEC_IDS = {"zstd": CODEC_ZSTD, "lzma": CODEC_LZMA,
                      "raw": CODEC_RAW}
CODEC_NAMES = {v: k for k, v in {**CODEC_IDS,
                                 **FALLBACK_CODEC_IDS}.items()}
LLM_CODECS = frozenset(CODEC_IDS.values())


class ContainerError(ValueError):
    """Malformed, truncated, corrupt, or configuration-mismatched container.

    Everything the parser can detect raises this (a ValueError subclass),
    never a bare IndexError/struct.error from running off the end of a
    truncated blob."""


def escape_error(chunk: int, token_id: int, vocab: int) -> ContainerError:
    """The error of an escape that decoded to ``token_id`` >= ``vocab``:
    the rANS escape codes a token id uniformly over 2**uniform_bits(V)
    values, so a stream decoded under other weights or another kernel
    version than its encoder's can land on an id that is no token. It is
    caught on the host, before the id reaches the next step's embedding
    gather (on the card an out-of-range gather is a device-side assert
    that poisons the process's CUDA context)."""
    return ContainerError(
        f"chunk {chunk}: an escape decoded to token id {token_id}, outside "
        f"the model's vocabulary of {vocab} -- the archive was most likely "
        f"written with another model (weights, seed) or another kernel "
        f"version than this decoder's")


class _BadEscape(Exception):
    """Raised inside a decode group: lane ``lane`` decoded escape id
    ``token_id`` >= V. ``_decode_group`` turns it into ``escape_error``
    naming the lane's chunk."""

    def __init__(self, lane: int, token_id: int):
        super().__init__(lane, token_id)
        self.lane, self.token_id = lane, token_id


def _device_logits(x):
    """A predictor's logits where it made them: a mesh step's
    ``LogitShards`` as they are (the coder names what it reads of them:
    ``core.cdf``), anything else as a tensor."""
    return x if isinstance(x, LogitShards) else as_tensor(x)


class PredictorAdapter(Protocol):
    """What the compressor needs from a model. See serve/engine.py for the
    production implementation over the model zoo."""

    vocab_size: int
    bos_id: int

    def score_chunks(self, tokens: np.ndarray,
                     prefix: np.ndarray | None = None) -> np.ndarray:
        """tokens (B, C) int32 -> logits (B, C, V): logits[:, t] predicts
        tokens[:, t] (i.e. the model input is [BOS, x_0 .. x_{C-2}]).
        With ``prefix`` (B, P) the input is [BOS, prefix, x_0 .. x_{C-2}]
        and only the last C positions are returned — teacher-forced
        scoring under a declared context (v6 recipes)."""
        ...

    def begin_decode(self, batch: int, prefix: np.ndarray | None = None):
        """-> opaque decode state positioned to predict token 0 of each chunk.
        With ``prefix`` (B, P) the state has consumed [BOS, prefix[:, :-1]]
        — the caller feeds ``prefix[:, -1]`` as the first ``decode_step``
        input, whose logits then predict token 0 under the prefix. The
        ``prefix`` keyword is optional for adapters (its absence is
        detected by signature and the compressor falls back to feeding
        the context through ``decode_step`` one token at a time)."""
        ...

    def decode_step(self, state, prev_tokens: np.ndarray):
        """(state, prev (B,) int32) -> (logits (B, V), new state)."""
        ...


def _write_varint(out: bytearray, v: int) -> None:
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return


def _read_varint(buf: bytes, pos: int, end: int | None = None) -> tuple[int, int]:
    """Bounds-checked varint read from ``buf[pos:end]``."""
    end = len(buf) if end is None else end
    shift = 0
    val = 0
    while True:
        if pos >= end:
            raise ContainerError(
                f"truncated container: varint runs past byte {end}")
        b = buf[pos]
        pos += 1
        val |= (b & 0x7F) << shift
        if not b & 0x80:
            return val, pos
        shift += 7
        if shift > 63:
            raise ContainerError("corrupt container: varint longer than 64 bits")


# ---------------------------------------------------------------- container
@dataclass
class ChunkEntry:
    """One v4/v5 index-footer entry (also synthesized for v2/v3 at
    parse). ``codec`` is the chunk's own codec id: the container's
    entropy codec for every chunk of a v2-v4 archive, and the recorded
    per-chunk routing decision for v5 (possibly a fallback codec)."""
    offset: int          # byte offset of the stream from container start
    length: int          # stream byte length
    n_tokens: int        # valid tokens in this chunk (<= chunk_size)
    checksum: int = 0    # xxh64 of the stream bytes (0 for v2/v3)
    codec: int = -1      # per-chunk codec id (filled in at parse)
    # v6 context recipe (RECIPE_NONE for every earlier version)
    recipe_kind: int = RECIPE_NONE
    recipe_param: int = 0

    @property
    def codec_name(self) -> str:
        return CODEC_NAMES[self.codec]

    @property
    def is_llm(self) -> bool:
        return self.codec in LLM_CODECS

    @property
    def recipe_name(self) -> str:
        if self.recipe_kind == RECIPE_CARRY:
            return f"carry({self.recipe_param})"
        if self.recipe_kind == RECIPE_SHARED:
            return f"shared[{self.recipe_param}]"
        return "none"


@dataclass
class ContainerInfo:
    """Parsed header (+ index when v4) of an .llmc container."""
    version: int
    flags: int
    chunk_size: int
    n_tokens: int
    vocab: int
    topk: int
    precision: int
    codec: int
    header_size: int
    n_chunks: int
    entries: list[ChunkEntry] = field(default_factory=list)
    # v4 only: the model-program lane count the encoder ran at (0 when
    # unrecorded / v2 / v3). Bit-exact decode of non-batch-invariant
    # models requires decoding at this same batch shape.
    encode_batch: int = 0
    # v6 only: shared-prefix dictionary [(name, tokens int32)] that
    # RECIPE_SHARED entries index into.
    shared_prefixes: list[tuple[str, np.ndarray]] = field(
        default_factory=list)
    # v6 only: the context-length budget the encoder's model program ran
    # at. Like encode_batch, this is coding geometry: the decode cache is
    # sized chunk_size + ctx_budget positions, and on real models the
    # cache length changes the jitted program's reduction shapes (and so
    # the logits, bitwise) — every group must decode at the same length
    # every chunk was encoded at, context-free chunks included.
    ctx_budget: int = 0

    @property
    def codec_name(self) -> str:
        return CODEC_NAMES[self.codec]


def chunk_valid_lengths(n_tokens: int, chunk_size: int) -> np.ndarray:
    """Valid token count per chunk for a contiguous n_tokens stream.
    Zero tokens means zero chunks (an empty container has an empty body),
    so the returned array is empty — callers must not assume max()."""
    n_chunks = -(-n_tokens // chunk_size)
    ends = np.minimum(np.arange(1, n_chunks + 1) * chunk_size, n_tokens)
    starts = np.arange(n_chunks) * chunk_size
    return np.maximum(ends - starts, 0).astype(np.int64)


def read_header(blob: bytes) -> ContainerInfo:
    """Parse and validate the container header (any supported version)."""
    if len(blob) < 4 or blob[:4] != MAGIC:
        raise ContainerError("bad magic (not an LLMC container)")
    if len(blob) < 5:
        raise ContainerError("truncated container: missing version byte")
    version = blob[4]
    if version == 2:
        hdr = _V2_HEADER
    elif version == VERSION_V3 or version in _INDEXED_VERSIONS:
        hdr = _V3_HEADER
    else:
        raise ContainerError(f"unsupported container version {version}")
    hsize = 4 + struct.calcsize(hdr)
    if len(blob) < hsize:
        raise ContainerError(
            f"truncated container: {len(blob)} bytes < {hsize}-byte header")
    fields = struct.unpack(hdr, blob[4:hsize])
    if version == 2:
        _, flags, C, n, vocab, topk, precision = fields
        codec = CODEC_AC              # v2 archives predate the codec byte
    else:
        _, flags, C, n, vocab, topk, precision, codec = fields
        # the header byte names the container's LLM *entropy* codec;
        # fallback byte-codec ids (zstd/lzma/raw) are only legal in v5
        # per-chunk tags, never here
        if codec not in LLM_CODECS:
            raise ContainerError(f"unknown codec id {codec} in header "
                                 f"(entropy codec expected)")
    if C == 0:
        raise ContainerError("corrupt header: chunk_size is zero")
    # the *container's* codec decides which limits apply: a 24-bit-precision
    # AC container is legal, the same precision under rANS is not decodable
    if codec == CODEC_RANS and precision > rans.MAX_PRECISION:
        raise ContainerError(
            f"container precision {precision} exceeds rANS coder limit "
            f"{rans.MAX_PRECISION}")
    if precision < 1 or (1 << precision) <= (topk + 1 if topk else vocab):
        raise ContainerError(
            f"corrupt header: precision {precision} too small for "
            f"{'top-' + str(topk) if topk else 'vocab ' + str(vocab)} alphabet")
    n_chunks = -(-n // C)                # 0 tokens => 0 chunks
    return ContainerInfo(version, flags, C, n, vocab, topk, precision,
                         codec, hsize, n_chunks)


def _encode_prefix_dict(prefixes: list[tuple[str, np.ndarray]]) -> bytes:
    """Serialize the v6 shared-prefix dictionary: u16 count, then per
    prefix u8 name length | utf-8 name | u16 token count | u32 tokens."""
    out = bytearray(struct.pack("<H", len(prefixes)))
    for name, toks in prefixes:
        nb = name.encode("utf-8")
        toks = np.asarray(toks, np.int64).ravel()
        out += struct.pack("<B", len(nb)) + nb
        out += struct.pack("<H", toks.size)
        out += toks.astype("<u4").tobytes()
    return bytes(out)


def _parse_prefix_dict(buf: bytes,
                       vocab: int) -> list[tuple[str, np.ndarray]]:
    """Parse + validate the v6 shared-prefix dictionary section. The
    section must be consumed exactly — trailing garbage inside the
    hash-covered span is corruption, not padding."""
    if len(buf) < 2:
        raise ContainerError(
            "corrupt container: shared-prefix dictionary shorter than "
            "its count field")
    (n,) = struct.unpack_from("<H", buf, 0)
    pos = 2
    prefixes: list[tuple[str, np.ndarray]] = []
    for i in range(n):
        if pos + 1 > len(buf):
            raise ContainerError(
                f"corrupt container: shared prefix {i} truncated")
        name_len = buf[pos]
        pos += 1
        if pos + name_len + 2 > len(buf):
            raise ContainerError(
                f"corrupt container: shared prefix {i} truncated")
        try:
            name = buf[pos:pos + name_len].decode("utf-8")
        except UnicodeDecodeError:
            raise ContainerError(
                f"corrupt container: shared prefix {i} name is not utf-8")
        pos += name_len
        (nt,) = struct.unpack_from("<H", buf, pos)
        pos += 2
        if nt == 0:
            raise ContainerError(
                f"corrupt container: shared prefix {i} ({name!r}) is empty")
        if pos + 4 * nt > len(buf):
            raise ContainerError(
                f"corrupt container: shared prefix {i} claims {nt} tokens, "
                f"section ends early")
        toks = np.frombuffer(buf, dtype="<u4", count=nt,
                             offset=pos).astype(np.int32)
        pos += 4 * nt
        if toks.size and int(toks.max()) >= vocab:
            raise ContainerError(
                f"corrupt container: shared prefix {i} ({name!r}) has "
                f"token id {int(toks.max())} >= vocab {vocab}")
        prefixes.append((name, toks))
    if pos != len(buf):
        raise ContainerError(
            f"corrupt container: {len(buf) - pos} stray bytes after the "
            f"shared-prefix dictionary")
    return prefixes


def _check_recipe(i: int, kind: int, param: int, codec_tag: int,
                  n_prefixes: int) -> None:
    """Validate one chunk's context recipe against the format invariants
    (shared by read_index and write_container so they cannot drift)."""
    if kind == RECIPE_NONE:
        if param != 0:
            raise ContainerError(
                f"corrupt index: chunk {i} recipe none with param {param}")
        return
    if kind == RECIPE_CARRY:
        if param < 1:
            raise ContainerError(
                f"corrupt index: chunk {i} carry recipe with window 0")
        if i == 0:
            raise ContainerError(
                "corrupt index: chunk 0 cannot carry context "
                "(no previous chunk)")
    elif kind == RECIPE_SHARED:
        if param >= n_prefixes:
            raise ContainerError(
                f"corrupt index: chunk {i} shared-prefix recipe [{param}] "
                f"but the dictionary has {n_prefixes} entries")
    else:
        raise ContainerError(
            f"corrupt index: chunk {i} has unknown recipe kind {kind}")
    if codec_tag not in LLM_CODECS:
        raise ContainerError(
            f"corrupt index: chunk {i} is fallback-coded "
            f"({CODEC_NAMES.get(codec_tag, codec_tag)}) but declares a "
            f"context recipe — fallback chunks must be context-free")


def read_index(blob: bytes, info: ContainerInfo | None = None) -> ContainerInfo:
    """Parse + verify the v4/v5 index footer; returns info with
    ``entries`` populated. Verifies the footer checksum (which covers the
    header too) but not the per-chunk stream checksums — those are checked
    by ``parse_container``/``decompress_range`` for the chunks actually
    read. v5 entries additionally carry the per-chunk codec tag, validated
    here: a fallback id is fine, an LLM id must match the header's entropy
    codec (a v5 archive never mixes rANS and AC chunks)."""
    info = info or read_header(blob)
    if info.version == VERSION_V4:
        entry_fmt, entry_size, end_magic = \
            _V4_ENTRY, _V4_ENTRY_SIZE, _V4_END_MAGIC
    elif info.version == VERSION_V5:
        entry_fmt, entry_size, end_magic = \
            _V5_ENTRY, _V5_ENTRY_SIZE, _V5_END_MAGIC
    elif info.version == VERSION_V6:
        entry_fmt, entry_size, end_magic = \
            _V6_ENTRY, _V6_ENTRY_SIZE, _V6_END_MAGIC
    else:
        raise ContainerError(
            f"container version {info.version} has no index footer "
            f"(random access requires v4+)")
    if len(blob) < info.header_size + _V4_TRAILER:
        raise ContainerError("truncated container: missing index footer")
    if blob[-4:] != end_magic:
        raise ContainerError(
            f"truncated or corrupt container: "
            f"v{info.version} end magic missing")
    n_chunks_f, footer_len = struct.unpack("<II", blob[-12:-4])
    # v4/v5: entries + u32 encode_batch + u64 hash. v6 additionally holds
    # the variable-length shared-prefix dictionary between the entries
    # and the encode batch, and a u32 ctx_budget after it (all inside the
    # hash-covered span)
    min_len = n_chunks_f * entry_size \
        + (16 if info.version == VERSION_V6 else 12)
    if info.version == VERSION_V6:
        if footer_len < min_len:
            raise ContainerError(
                f"corrupt footer: length field {footer_len} < {min_len} "
                f"for {n_chunks_f} chunks")
        dict_len = footer_len - min_len
    else:
        if footer_len != min_len:
            raise ContainerError(
                f"corrupt footer: length field {footer_len} != {min_len} "
                f"for {n_chunks_f} chunks")
        dict_len = 0
    if n_chunks_f != info.n_chunks:
        raise ContainerError(
            f"corrupt container: footer indexes {n_chunks_f} chunks, header "
            f"implies {info.n_chunks}")
    footer_start = len(blob) - _V4_TRAILER - footer_len
    if footer_start < info.header_size:
        raise ContainerError("truncated container: footer overlaps header")
    entries_end = footer_start + n_chunks_f * entry_size
    data_end = entries_end + dict_len       # dict (v6) sits before the batch
    (encode_batch,) = struct.unpack("<I", blob[data_end:data_end + 4])
    ctx_budget = 0
    if info.version == VERSION_V6:
        (ctx_budget,) = struct.unpack("<I",
                                      blob[data_end + 4:data_end + 8])
        data_end += 4
    (footer_hash,) = struct.unpack("<Q",
                                   blob[data_end + 4:data_end + 12])
    if xxh64(blob[:info.header_size] + blob[footer_start:data_end + 4]) \
            != footer_hash:
        raise ContainerError("corrupt container: footer checksum mismatch "
                             "(header or index damaged)")
    if ctx_budget > MAX_PREFIX_TOKENS:
        raise ContainerError(
            f"corrupt footer: context budget {ctx_budget} exceeds "
            f"{MAX_PREFIX_TOKENS}")
    prefixes = _parse_prefix_dict(
        blob[entries_end:entries_end + dict_len], info.vocab) \
        if info.version == VERSION_V6 else []
    entries = []
    for i in range(n_chunks_f):
        rec = struct.unpack_from(entry_fmt, blob,
                                 footer_start + i * entry_size)
        rk = rp = 0
        if info.version == VERSION_V4:
            off, ln, nt, cks = rec
            ctag = info.codec
        else:
            if info.version == VERSION_V5:
                off, ln, nt, ctag, cks = rec
            else:
                off, ln, nt, ctag, rk, rp, cks = rec
            if ctag not in CODEC_NAMES:
                raise ContainerError(
                    f"corrupt index: chunk {i} has unknown codec id {ctag}")
            if ctag in LLM_CODECS and ctag != info.codec:
                raise ContainerError(
                    f"corrupt index: chunk {i} tagged entropy codec {ctag} "
                    f"but the container codec is {info.codec}")
        _check_recipe(i, rk, rp, ctag, len(prefixes))
        if nt > info.chunk_size:
            raise ContainerError(
                f"corrupt index: chunk {i} claims {nt} tokens "
                f"(chunk_size {info.chunk_size})")
        if off < info.header_size or off + ln > footer_start:
            raise ContainerError(
                f"corrupt index: chunk {i} stream [{off}, {off + ln}) "
                f"outside body [{info.header_size}, {footer_start})")
        entries.append(ChunkEntry(off, ln, nt, cks, ctag, rk, rp))
    if sum(e.n_tokens for e in entries) != info.n_tokens:
        raise ContainerError(
            "corrupt container: index token counts disagree with header "
            f"n_tokens {info.n_tokens}")
    # geometry floor law: the recorded budget must cover every recipe's
    # materialized context (a smaller value could never have been the
    # encoder's program length — the context wouldn't have fit)
    for i, e in enumerate(entries):
        need = 0
        if e.recipe_kind == RECIPE_CARRY:
            need = min(e.recipe_param, entries[i - 1].n_tokens)
        elif e.recipe_kind == RECIPE_SHARED:
            need = int(prefixes[e.recipe_param][1].size)
        if need > ctx_budget:
            raise ContainerError(
                f"corrupt footer: chunk {i} materializes a "
                f"{need}-token context but the recorded context "
                f"budget is {ctx_budget}")
    info.entries = entries
    info.encode_batch = encode_batch
    info.shared_prefixes = prefixes
    info.ctx_budget = ctx_budget
    return info


def parse_container(blob: bytes) -> tuple[ContainerInfo, list[bytes]]:
    """Full parse: header (+ index when v4/v5) + per-chunk streams, with
    all integrity checks. Returns (info-with-entries, streams). Every
    entry's ``codec`` is populated regardless of version, so downstream
    decode logic never special-cases the container version."""
    info = read_header(blob)
    if info.version in _INDEXED_VERSIONS:
        info = read_index(blob, info)
        # read_index validated the trailer's footer length, which for v6
        # includes the variable-size prefix dictionary — recover the body
        # end from it rather than recomputing entry sizes here
        (_, footer_len) = struct.unpack("<II", blob[-12:-4])
        body_end = len(blob) - _V4_TRAILER - footer_len
    else:
        body_end = len(blob)
    pos = info.header_size
    # every chunk's stream starts with a varint of at least one byte: a
    # header whose n_tokens claims more chunks than the body has bytes is
    # corrupt, and is refused before a per-chunk array of that size exists
    if info.n_chunks > body_end - pos:
        raise ContainerError(
            f"truncated container: header claims {info.n_chunks} chunks, "
            f"{body_end - pos} body bytes remain")
    streams: list[bytes] = []
    valid = chunk_valid_lengths(info.n_tokens, info.chunk_size)
    for i in range(info.n_chunks):
        ln, pos = _read_varint(blob, pos, body_end)
        if pos + ln > body_end:
            raise ContainerError(
                f"truncated container: chunk {i} claims {ln} bytes, "
                f"{body_end - pos} remain")
        stream = blob[pos:pos + ln]
        if info.version in _INDEXED_VERSIONS:
            e = info.entries[i]
            if e.offset != pos or e.length != ln:
                raise ContainerError(
                    f"corrupt container: chunk {i} framing ({pos}, {ln}) "
                    f"disagrees with index ({e.offset}, {e.length})")
            if xxh64(stream) != e.checksum:
                raise ContainerError(
                    f"corrupt container: chunk {i} checksum mismatch")
        else:
            info.entries.append(ChunkEntry(pos, ln, int(valid[i]),
                                           codec=info.codec))
        streams.append(stream)
        pos += ln
    return info, streams


def write_container(streams: list[bytes], *, version: int, chunk_size: int,
                    n_tokens: int, vocab: int, topk: int, precision: int,
                    codec_id: int,
                    valid_lengths: np.ndarray | None = None,
                    encode_batch: int = 0,
                    codec_tags: list[int] | None = None,
                    recipes: list[tuple[int, int]] | None = None,
                    shared_prefixes: list[tuple[str, np.ndarray]]
                    | None = None,
                    ctx_budget: int = 0) -> bytes:
    """Assemble a v3..v6 container from per-chunk codec streams (in
    chunk order — the service scheduler completes chunks out of order and
    reorders before calling this). ``encode_batch`` (v4+) records the
    model-program lane count every LLM chunk was encoded at (ragged
    groups are dead-lane padded, never shrunk) — the batch shape a
    decoder must use for bit-exact logits on non-batch-invariant models.
    ``codec_tags`` (v5+) is the per-chunk codec id list the router chose;
    it defaults to the container codec for every chunk. ``recipes`` (v6)
    is the per-chunk (kind, param) context-recipe list, defaulting to
    fresh context everywhere; ``shared_prefixes`` (v6) is the dictionary
    RECIPE_SHARED params index into. ``ctx_budget`` (v6) records the
    context-length budget the encoder's model program ran at — the
    decode-cache geometry counterpart of ``encode_batch`` (it may exceed
    the written recipes' needs when routing flipped the longest-context
    chunk to a fallback, never undercut them). Passing a feature a lower
    version cannot represent is an error."""
    if version not in (VERSION_V3,) + _INDEXED_VERSIONS:
        raise ValueError(f"cannot write container version {version}")
    if codec_tags is not None:
        if len(codec_tags) != len(streams):
            raise ValueError(
                f"{len(codec_tags)} codec tags for {len(streams)} streams")
        if version < VERSION_V5 and any(t != codec_id for t in codec_tags):
            raise ValueError(
                f"per-chunk codec tags require a v5+ container "
                f"(got version {version})")
        for t in codec_tags:
            if t not in CODEC_NAMES:
                raise ValueError(f"unknown codec id {t} in codec_tags")
            if t in LLM_CODECS and t != codec_id:
                raise ValueError(
                    f"chunk tagged entropy codec {t} but the container "
                    f"codec is {codec_id}")
    shared_prefixes = shared_prefixes or []
    if version != VERSION_V6 and (shared_prefixes or (
            recipes is not None
            and any(r != (RECIPE_NONE, 0) for r in recipes))):
        raise ValueError(
            f"context recipes / shared prefixes require a v6 container "
            f"(got version {version})")
    if recipes is not None and len(recipes) != len(streams):
        raise ValueError(
            f"{len(recipes)} recipes for {len(streams)} streams")
    if len(shared_prefixes) > 0xFFFF:
        raise ValueError("too many shared prefixes (u16 count)")
    for name, toks in shared_prefixes:
        toks = np.asarray(toks).ravel()
        if not 1 <= toks.size <= MAX_PREFIX_TOKENS:
            raise ValueError(
                f"shared prefix {name!r} has {toks.size} tokens "
                f"(1..{MAX_PREFIX_TOKENS} allowed)")
        if len(name.encode("utf-8")) > MAX_PREFIX_NAME:
            raise ValueError(f"shared prefix name {name!r} too long")
        if toks.size and not 0 <= int(toks.min()) <= int(toks.max()) < vocab:
            raise ValueError(
                f"shared prefix {name!r} has token ids outside "
                f"[0, {vocab})")
    if version != VERSION_V6 and ctx_budget:
        raise ValueError(
            f"context budget requires a v6 container (got version "
            f"{version})")
    if not 0 <= ctx_budget <= MAX_PREFIX_TOKENS:
        raise ValueError(
            f"context budget {ctx_budget} outside [0, {MAX_PREFIX_TOKENS}]")
    if version == VERSION_V6 and recipes is not None:
        for i, (rk, rp) in enumerate(recipes):
            tag = codec_id if codec_tags is None else codec_tags[i]
            _check_recipe(i, rk, rp, tag, len(shared_prefixes))
            if rk == RECIPE_CARRY and rp > 0xFFFF:
                raise ValueError(
                    f"chunk {i} carry window {rp} exceeds u16")
        vl = valid_lengths if valid_lengths is not None \
            else chunk_valid_lengths(n_tokens, chunk_size)
        need = context_budget(
            recipes, np.asarray(vl),
            [(nm, np.asarray(t).ravel()) for nm, t in shared_prefixes])
        if need > ctx_budget:
            raise ValueError(
                f"recipes materialize a {need}-token context but "
                f"ctx_budget is {ctx_budget}")
    flags = 1 if topk else 0
    out = bytearray()
    out += MAGIC
    out += struct.pack(_V3_HEADER, version, flags, chunk_size, n_tokens,
                       vocab, topk, precision, codec_id)
    header = bytes(out)
    if valid_lengths is None:
        valid_lengths = chunk_valid_lengths(n_tokens, chunk_size)
    indexed = version in _INDEXED_VERSIONS
    entries = bytearray()
    for i, (s, nv) in enumerate(zip(streams, valid_lengths)):
        _write_varint(out, len(s))
        if version == VERSION_V4:   # v3 skips the index + per-stream hash
            entries += struct.pack(_V4_ENTRY, len(out), len(s), int(nv),
                                   xxh64(s))
        elif version == VERSION_V5:
            tag = codec_id if codec_tags is None else codec_tags[i]
            entries += struct.pack(_V5_ENTRY, len(out), len(s), int(nv),
                                   tag, xxh64(s))
        elif version == VERSION_V6:
            tag = codec_id if codec_tags is None else codec_tags[i]
            rk, rp = (RECIPE_NONE, 0) if recipes is None else recipes[i]
            entries += struct.pack(_V6_ENTRY, len(out), len(s), int(nv),
                                   tag, rk, rp, xxh64(s))
        out += s
    if indexed:
        tail = bytes(entries)
        if version == VERSION_V6:
            tail += _encode_prefix_dict(shared_prefixes)
        tail += struct.pack("<I", encode_batch)
        if version == VERSION_V6:
            tail += struct.pack("<I", ctx_budget)
        footer_hash = xxh64(header + tail)
        out += tail
        out += struct.pack("<Q", footer_hash)
        out += struct.pack("<II", len(streams), len(tail) + 8)
        out += {VERSION_V4: _V4_END_MAGIC, VERSION_V5: _V5_END_MAGIC,
                VERSION_V6: _V6_END_MAGIC}[version]
    return bytes(out)


def check_container_config(info: ContainerInfo, *, vocab: int,
                           chunk_size: int, topk: int,
                           precision: int) -> None:
    """Raise ContainerError unless the container's coding geometry matches
    the decoder's configuration — shared by the grouped compressor and the
    service so the two validation paths cannot drift."""
    if info.vocab != vocab or info.chunk_size != chunk_size \
            or info.topk != topk or info.precision != precision:
        raise ContainerError(
            "compressor configuration mismatch with container "
            f"(container: vocab={info.vocab} chunk={info.chunk_size} "
            f"topk={info.topk} precision={info.precision})")


def assign_context_recipes(n_chunks: int, *, context_window: int = 0,
                           stripes: int = 1,
                           shared: bool = False) -> list[tuple[int, int]]:
    """The writer-side recipe plan: split ``n_chunks`` into ``stripes``
    contiguous carry chains. Each stripe's first chunk starts fresh
    (RECIPE_SHARED when a shared prefix is in play, RECIPE_NONE
    otherwise) and every later chunk carries the previous chunk's
    ``context_window``-token tail. Striping is what keeps decode
    parallel: one lane per chain, chains decode round-robin, so carry
    never serializes the whole archive. With ``context_window == 0``
    every chunk starts fresh (all-shared when ``shared``)."""
    head = (RECIPE_SHARED, 0) if shared else (RECIPE_NONE, 0)
    if context_window <= 0:
        return [head] * n_chunks
    stripes = max(1, min(int(stripes), n_chunks)) if n_chunks else 1
    q, r = divmod(n_chunks, stripes)
    recipes: list[tuple[int, int]] = []
    for b in range(stripes):
        ln = q + (1 if b < r else 0)
        if ln:
            recipes.append(head)
            recipes.extend([(RECIPE_CARRY, context_window)] * (ln - 1))
    return recipes


def recipe_context(recipes, chunks: np.ndarray, valid: np.ndarray, j: int,
                   shared_prefixes) -> np.ndarray:
    """Materialize chunk ``j``'s declared context from the *input* side
    (encode: all chunk tokens are known). Returns an int32 token vector,
    possibly empty."""
    kind, param = recipes[j]
    if kind == RECIPE_CARRY:
        prev = chunks[j - 1, :int(valid[j - 1])]
        return prev[max(0, prev.size - param):].astype(np.int32)
    if kind == RECIPE_SHARED:
        return np.asarray(shared_prefixes[param][1], np.int32)
    return np.zeros(0, np.int32)


def context_budget(recipes, valid, shared_prefixes) -> int:
    """The decode-length budget a recipe plan needs: the longest context
    any chunk materializes (carry windows clamp to the predecessor's
    valid length; shared recipes take the full dictionary prefix). The
    model program is sized chunk_size + budget positions for EVERY group
    of the archive — cache length is coding geometry, so one length must
    cover them all — and the v6 footer records it (``ctx_budget``)."""
    budget = 0
    for j, (kind, param) in enumerate(recipes):
        if kind == RECIPE_CARRY:
            budget = max(budget, min(int(param), int(valid[j - 1])))
        elif kind == RECIPE_SHARED:
            budget = max(budget,
                         int(np.asarray(shared_prefixes[param][1]).size))
    return budget


def container_is_model_free(info: ContainerInfo) -> bool:
    """True when every chunk is fallback-coded — such an archive decodes
    (and range-decodes) without constructing a predictor at all."""
    return bool(info.entries) and all(not e.is_llm for e in info.entries)


def _decode_fallback(idx: int, entry: ChunkEntry, stream: bytes,
                     vocab: int) -> np.ndarray:
    """Decode one fallback-tagged chunk stream; structural problems
    become ContainerError (the stream passed its checksum, so any
    failure here means a crafted/mis-tagged container)."""
    try:
        return CodecRouter.decode_fallback(entry.codec_name, stream,
                                           entry.n_tokens, vocab)
    except ValueError as e:
        raise ContainerError(f"corrupt container: chunk {idx}: {e}")


def decompress_model_free(blob: bytes) -> np.ndarray:
    """Decode an all-fallback v5/v6 archive without a model: no
    predictor, no prefix cache, no device dispatch. Raises
    ContainerError if any chunk is LLM-coded (those need a predictor)."""
    info, streams = parse_container(blob)
    if info.n_chunks == 0:
        return np.zeros(0, np.int32)
    if not container_is_model_free(info):
        raise ContainerError(
            "container has LLM-coded chunks; model-free decode needs an "
            "all-fallback archive")
    out = np.zeros(info.n_tokens, np.int32)
    C = info.chunk_size
    for i, e in enumerate(info.entries):
        out[i * C:i * C + e.n_tokens] = _decode_fallback(
            i, e, streams[i], info.vocab)
    return out


def check_chunk_range(info: ContainerInfo, chunk_start: int,
                      chunk_stop: int) -> None:
    """Bounds-validate a [chunk_start, chunk_stop) range request."""
    if chunk_start >= chunk_stop:
        raise ContainerError(
            f"invalid chunk range [{chunk_start}, {chunk_stop}): "
            + ("empty" if chunk_start == chunk_stop else "reversed")
            + " range selects no chunks")
    if chunk_start < 0 or chunk_stop > info.n_chunks:
        raise ContainerError(
            f"chunk range [{chunk_start}, {chunk_stop}) out of bounds: "
            f"container has chunks [0, {info.n_chunks})")


def decompress_range_model_free(blob: bytes, chunk_start: int,
                                chunk_stop: int | None = None) -> np.ndarray:
    """Range-decode chunks [chunk_start, chunk_stop) of an archive where
    every *requested* chunk is fallback-coded, without a model. Fallback
    chunks always carry recipe ``none`` (enforced at read and write), so
    no carry closure can pull in an LLM chunk."""
    info = read_index(blob)
    if chunk_stop is None:
        chunk_stop = chunk_start + 1
    check_chunk_range(info, chunk_start, chunk_stop)
    parts = []
    for j in range(chunk_start, chunk_stop):
        e = info.entries[j]
        if e.is_llm:
            raise ContainerError(
                f"chunk {j} is LLM-coded; model-free range decode needs "
                f"fallback-coded chunks")
        s = blob[e.offset:e.offset + e.length]
        if xxh64(s) != e.checksum:
            raise ContainerError(
                f"corrupt container: chunk {j} checksum mismatch")
        parts.append(_decode_fallback(j, e, s, info.vocab))
    return np.concatenate(parts) if parts else np.zeros(0, np.int32)


@dataclass
class CompressionStats:
    n_tokens: int = 0
    payload_bytes: int = 0
    header_bytes: int = 0
    n_escapes: int = 0
    ideal_bits: float = 0.0  # -sum log2 p from the un-quantized model
    # per-chunk obs.ChunkDiagnostics (DESIGN.md §10) — populated when the
    # compressor's registry is enabled; empty otherwise. This is the
    # signal the ROADMAP's adaptive codec router consumes: bits/token and
    # escape rate per chunk, previously computed and thrown away.
    chunks: list = field(default_factory=list)
    # per-chunk router.RouteDecision records (routed compressors only) —
    # the encode-side story of every codec tag written to the v5 index.
    routes: list = field(default_factory=list)

    @property
    def total_bytes(self) -> int:
        return self.payload_bytes + self.header_bytes


class LLMCompressor:
    """Chunked LLM-predictor + entropy-coding lossless compressor."""

    def __init__(self, predictor: PredictorAdapter, *,
                 chunk_size: int = 256,
                 topk: int = 0,
                 precision: int = DEFAULT_PRECISION,
                 decode_batch: int = 64,
                 codec: str = "rans",
                 container_version: int | None = None,
                 route: str = ROUTE_LLM,
                 router: CodecRouter | RouterConfig | None = None,
                 draft_k: int = 0,
                 draft=None,
                 context_window: int = 0,
                 context_stripes: int | None = None,
                 shared_prefix: np.ndarray | None = None,
                 shared_prefix_name: str = "shared",
                 registry: obs.MetricsRegistry | None = None):
        if topk and topk >= predictor.vocab_size:
            topk = 0
        if codec not in CODEC_IDS:
            raise ValueError(f"unknown codec {codec!r} "
                             f"(choose from {sorted(CODEC_IDS)})")
        if route not in (ROUTE_LLM, ROUTE_AUTO) \
                and route not in FALLBACK_CODEC_IDS:
            raise ValueError(
                f"unknown route {route!r} (choose 'llm', 'auto', or a "
                f"fallback codec from {sorted(FALLBACK_CODEC_IDS)})")
        self.context_window = int(context_window)
        self.context_stripes = None if context_stripes is None \
            else int(context_stripes)
        if self.context_window < 0 or self.context_window > 0xFFFF:
            raise ValueError(
                f"context_window {context_window} outside [0, 65535]")
        if shared_prefix is not None:
            shared_prefix = np.asarray(shared_prefix,
                                       np.int32).ravel()
            if not 1 <= shared_prefix.size <= MAX_PREFIX_TOKENS:
                raise ValueError(
                    f"shared_prefix has {shared_prefix.size} tokens "
                    f"(1..{MAX_PREFIX_TOKENS} allowed)")
            if not 0 <= int(shared_prefix.min()) \
                    <= int(shared_prefix.max()) < predictor.vocab_size:
                raise ValueError("shared_prefix token ids outside vocab")
        self.shared_prefix = shared_prefix
        self.shared_prefix_name = str(shared_prefix_name)
        ctx_on = self.context_window > 0 or shared_prefix is not None
        # routing needs per-chunk codec tags (v5+); context recipes need
        # v6; a plain pure-LLM compressor defaults to the wire-minimal v3
        if container_version is None:
            if ctx_on:
                container_version = VERSION_V6
            elif route == ROUTE_LLM:
                container_version = VERSION_V3
            else:
                container_version = VERSION_V5
        if container_version not in (VERSION_V3,) + _INDEXED_VERSIONS:
            raise ValueError(f"cannot write container version "
                             f"{container_version} (v2 is read-only)")
        if route != ROUTE_LLM and container_version < VERSION_V5:
            raise ValueError(
                f"route={route!r} requires a v5+ container (per-chunk "
                f"codec tags); cannot write v{container_version}")
        if ctx_on and container_version != VERSION_V6:
            raise ValueError(
                f"context_window/shared_prefix require a v6 container "
                f"(per-chunk context recipes); cannot write "
                f"v{container_version}")
        self._ctx_on = ctx_on
        self._prefix_ok = None      # lazy: begin_decode accepts prefix=?
        self.route = route
        if isinstance(router, CodecRouter):
            self.router = router
        elif isinstance(router, RouterConfig):
            self.router = CodecRouter(router)
        elif route in FALLBACK_CODEC_IDS:
            self.router = CodecRouter(RouterConfig(fallbacks=(route,)))
        else:
            self.router = CodecRouter()
        self.predictor = predictor
        self.chunk_size = int(chunk_size)
        self.topk = int(topk)
        self.precision = int(precision)
        self.decode_batch = int(decode_batch)
        self.codec = codec
        self.container_version = int(container_version)
        if (1 << precision) <= (topk + 1 if topk else predictor.vocab_size):
            raise ValueError("precision too small for alphabet")
        # only the rANS backend caps precision (AC handles up to 30 bits);
        # decoding a foreign-codec container never hits the encoder limit
        if codec == "rans" and precision > rans.MAX_PRECISION:
            raise ValueError(f"precision {precision} exceeds rANS coder "
                             f"limit {rans.MAX_PRECISION}")
        # escape symbols: AC codes exactly over V; rANS over 2**esc_bits >= V
        self._esc_bits = rans.uniform_bits(predictor.vocab_size)
        # Speculative decompression (DESIGN.md §9): draft_k > 0 turns on
        # the draft/verify/accept decode path for rANS containers when the
        # predictor exposes verify_steps/rollback (serve.ModelPredictor and
        # the table predictors do). Decoded tokens are identical either
        # way — the coded stream arbitrates every position — so this is
        # purely a wall-clock knob.
        self.draft_k = int(draft_k)
        self.draft = draft if draft is not None else SuffixDraft()
        # adaptive fallthrough: after _spec_window rounds, drop to
        # lock-step for the rest of the group if fewer than _spec_floor
        # drafted tokens per round were accepted (adversarial or
        # unpredictable streams must never pay the (K+1)-deep verify
        # forward for a 1-token/round yield indefinitely)
        self._spec_window = 8
        self._spec_floor = 0.75
        # telemetry (DESIGN.md §10): defaults to the process-global
        # registry; inject a private MetricsRegistry to isolate. Strictly
        # read-only with respect to output bytes (property-tested).
        self._registry = registry if registry is not None else obs.registry()
        self._c_cmp_tokens = self._registry.counter(
            "compress.tokens", "tokens entropy-coded (compress side)")
        self._c_cmp_escapes = self._registry.counter(
            "compress.escapes", "escape symbols emitted while encoding")
        self._c_dec_tokens = self._registry.counter(
            "decompress.tokens", "tokens entropy-decoded")
        self._c_dec_escapes = self._registry.counter(
            "decompress.escapes", "escape symbols hit while decoding")
        # router decision counters (canonical names: obs.metrics.ROUTER_*)
        self._c_route_llm = self._registry.counter(
            obs.ROUTER_CHUNKS_LLM, "chunks routed to the LLM entropy path")
        self._c_route_fb = self._registry.counter(
            obs.ROUTER_CHUNKS_FALLBACK,
            "chunks routed to a fallback byte codec")
        self._c_route_skips = self._registry.counter(
            obs.ROUTER_PROBE_SKIPS,
            "chunks that skipped LLM encode on the probe estimate")
        self._c_route_flips = self._registry.counter(
            obs.ROUTER_FLIPS,
            "chunks where LLM encode ran but the fallback stream won")

    # ------------------------------------------------------------- compress
    def compress(self, tokens: np.ndarray, *,
                 exact: bool = True) -> tuple[bytes, CompressionStats]:
        """Compress a token stream.

        exact=True (default) scores with the *decode program* (the same
        jitted step the decompressor runs), guaranteeing bit-identical CDFs
        on both sides — the lossless requirement. exact=False scores with
        the teacher-forced prefill pass: ~C× fewer model invocations and
        identical in exact arithmetic, but float reduction-order
        differences between the prefill and decode programs can flip a
        quantization bucket on rare tokens, so it is reserved for ratio
        estimation / benchmarking (see DESIGN.md §6).

        With ``route != "llm"`` (DESIGN.md §11) each chunk is first
        offered to the router: the realized best-fallback stream is
        always built, a cheap prefill probe estimates the LLM code
        length, chunks the probe rejects skip the model entirely, and
        every chunk that *was* LLM-encoded still flips to its fallback if
        the fallback stream turned out smaller — so the routed container
        is per-chunk min(LLM, best fallback) and decode follows the
        recorded tags. Only the LLM subset enters the model batch; the
        recorded encode lane count covers exactly those chunks (lane
        *composition* is free — lanes are independent — so later flips
        don't invalidate it).
        """
        tokens = np.asarray(tokens, dtype=np.int32).ravel()
        n = tokens.size
        C = self.chunk_size
        n_chunks = -(-n // C)            # 0 tokens => 0 chunks, no model
        padded = np.zeros(n_chunks * C, dtype=np.int32)
        padded[:n] = tokens
        chunks = padded.reshape(n_chunks, C)
        valid_all = chunk_valid_lengths(n, C)

        stats = CompressionStats(n_tokens=n)
        streams: list = [b""] * n_chunks
        tags = [CODEC_IDS[self.codec]] * n_chunks
        if self.route == ROUTE_LLM:
            decisions = fb = None
            llm_idx = list(range(n_chunks))
        else:
            decisions, fb = self._route_chunks(chunks, valid_all)
            llm_idx = [i for i, d in enumerate(decisions)
                       if d.codec == self.codec]
        recipes = None
        cb = 0
        if self._ctx_on and n_chunks:
            recipes = assign_context_recipes(
                n_chunks, context_window=self.context_window,
                stripes=min(self.context_stripes or self.decode_batch,
                            n_chunks),
                shared=self.shared_prefix is not None)
            # decode-length geometry for the whole archive (recorded in
            # the footer): computed from the pre-routing plan, since that
            # is the budget every group — flips included — encoded under
            cb = context_budget(recipes, valid_all,
                                self._shared_prefix_list())
        # The model program runs at ONE lane count for the whole archive:
        # batch shape is coding geometry (XLA reduction order varies with
        # B), so a ragged tail group is padded with dead lanes rather than
        # shrinking the program — and the count recorded in the v4+ footer
        # is therefore exactly what every LLM chunk was encoded at.
        with obs.span("compress.job", self._registry):
            if recipes is not None:
                # carried/shared context always scores through the decode
                # program — the declared context must be consumed exactly
                # the way decode will consume it
                B = self._compress_carried(chunks, valid_all, recipes,
                                           llm_idx, streams, stats, cb)
            else:
                B = min(self.decode_batch, len(llm_idx))
                for g in range(0, len(llm_idx), max(1, B)):
                    sel = llm_idx[g:g + B]
                    batch = chunks[sel]
                    nb = len(sel)
                    if nb < B:
                        batch = np.concatenate(
                            [batch, np.zeros((B - nb, C), np.int32)])
                    if exact:
                        with obs.span("compress.score", self._registry):
                            logits = self._score_incremental(batch)
                    else:
                        logits = _device_logits(
                            self.predictor.score_chunks(batch))
                    enc = self._encode_batch(batch[:nb], logits[:nb],
                                             valid_all[sel], sel, stats)
                    for k, j in enumerate(sel):
                        streams[j] = enc[k]
        if decisions is not None:
            self._apply_routes(decisions, fb, streams, tags, valid_all,
                               stats)
        if recipes is not None:
            # a fallback-coded chunk never consumes model context: its
            # recipe is erased so all-fallback archives stay model-free
            # (carry successors still reference its *tokens*, which decode
            # materializes host-side)
            recipes = [r if tags[i] in LLM_CODECS else (RECIPE_NONE, 0)
                       for i, r in enumerate(recipes)]
            self._annotate_context(stats, recipes)
        self._c_cmp_tokens.inc(n)
        self._c_cmp_escapes.inc(stats.n_escapes)
        self._registry.counter("compress.chunks").inc(n_chunks)
        blob = write_container(
            streams, version=self.container_version, chunk_size=C,
            n_tokens=n, vocab=self.predictor.vocab_size, topk=self.topk,
            precision=self.precision, codec_id=CODEC_IDS[self.codec],
            encode_batch=B,
            codec_tags=tags if self.container_version >= VERSION_V5
            else None,
            recipes=recipes,
            shared_prefixes=self._shared_prefix_list()
            if self.container_version == VERSION_V6 else None,
            ctx_budget=cb)
        stats.payload_bytes = sum(len(s) for s in streams)
        stats.header_bytes = len(blob) - stats.payload_bytes
        return blob, stats

    # -------------------------------------------------------------- routing
    def _route_chunks(self, chunks, valid_all):
        """Route decisions + realized fallback streams for every chunk.
        Forced-fallback routes (``route="zstd"`` etc.) skip the probe:
        every chunk goes to its best fallback. ``route="auto"`` runs one
        prefill probe over the first ``probe_tokens`` positions of all
        chunks and keeps the LLM path unless it is projected to lose by
        more than the safety margin."""
        with obs.span("compress.route", self._registry):
            return route_chunks(self.router, self.predictor, chunks,
                                valid_all, self.codec,
                                auto=self.route == ROUTE_AUTO)

    def _apply_routes(self, decisions, fb, streams, tags, valid_all,
                      stats) -> None:
        """Post-encode routing resolution: install fallback streams for
        probe-skipped / forced chunks, and flip any LLM-encoded chunk
        whose realized fallback stream is strictly smaller. Updates
        streams/tags in place and finalizes per-chunk diagnostics."""
        tel = self._registry.enabled
        by_idx = {d.chunk_index: d for d in stats.chunks}
        for i, d in enumerate(decisions):
            name, s = fb[i]
            if d.codec == self.codec and d.llm_bits_est >= 0:
                # probe-vs-realized calibration (adaptive skip margin):
                # observations land after this job's decisions were all
                # made, steering the *next* job's probe threshold
                self.router.observe(d.llm_bits_est,
                                    8.0 * len(streams[i]), len(s))
            if d.codec != self.codec:       # LLM encode never ran
                streams[i] = s
                tags[i] = FALLBACK_CODEC_IDS[name]
                self._c_route_fb.inc()
                if d.llm_bits_est >= 0:     # auto probe said skip
                    self._c_route_skips.inc()
                if tel:
                    stats.chunks.append(obs.ChunkDiagnostics(
                        chunk_index=i, n_tokens=int(valid_all[i]),
                        stream_bytes=len(s), coded_bits=8.0 * len(s),
                        codec=name))
            elif len(s) < len(streams[i]):  # LLM ran and lost: flip
                d.codec, d.flipped = name, True
                streams[i] = s
                tags[i] = FALLBACK_CODEC_IDS[name]
                self._c_route_fb.inc()
                self._c_route_flips.inc()
                if tel and i in by_idx:
                    dg = by_idx[i]
                    dg.codec, dg.stream_bytes = name, len(s)
                    dg.coded_bits = 8.0 * len(s)
            else:
                self._c_route_llm.inc()
        stats.routes = decisions
        stats.chunks.sort(key=lambda c: c.chunk_index)

    def _shared_prefix_list(self) -> list[tuple[str, np.ndarray]]:
        if self.shared_prefix is None:
            return []
        return [(self.shared_prefix_name, self.shared_prefix)]

    def _annotate_context(self, stats, recipes) -> None:
        """Stamp the final per-chunk recipe into diagnostics (v6 only;
        the field stays absent from v2-v5 sidecars)."""
        if not self._registry.enabled:
            return
        for d in stats.chunks:
            rk, rp = recipes[d.chunk_index]
            d.context = ChunkEntry(0, 0, 0, recipe_kind=rk,
                                   recipe_param=rp).recipe_name \
                if rk != RECIPE_NONE else ""

    def _compress_carried(self, chunks, valid_all, recipes, llm_idx,
                          streams, stats, budget: int = 0) -> int:
        """Encode under context recipes: chains (one per stripe) advance
        round-robin, one chunk per lane per round, each lane's model
        input being the self-contained [BOS, context, chunk] sequence its
        recipe declares. Probe-routed fallback chunks never enter the
        model — their lane is dead for that round (lanes are independent,
        so a dead lane can't perturb live ones). Returns the lane count
        recorded as the archive's encode batch."""
        n_chunks, C = chunks.shape
        llm = set(llm_idx)
        chains: list[list[int]] = []
        for j in range(n_chunks):
            if recipes[j][0] == RECIPE_CARRY and chains:
                chains[-1].append(j)
            else:
                chains.append([j])
        prefixes = self._shared_prefix_list()
        B = min(self.context_stripes or self.decode_batch, len(chains))
        for blk in range(0, len(chains), B):
            block = chains[blk:blk + B]
            for r in range(max(len(c) for c in block)):
                sel = [(lane, c[r]) for lane, c in enumerate(block)
                       if r < len(c) and c[r] in llm]
                if not sel:
                    continue
                batch = np.zeros((B, C), np.int32)
                ctx_rows: list = [None] * B
                for lane, j in sel:
                    batch[lane] = chunks[j]
                    ctx_rows[lane] = recipe_context(
                        recipes, chunks, valid_all, j, prefixes)
                L = max(c.size for c in ctx_rows if c is not None)
                ctx = ctx_len = None
                if L:
                    ctx = np.zeros((B, L), np.int32)
                    ctx_len = np.zeros(B, np.int64)
                    for lane, _ in sel:
                        c = ctx_rows[lane]
                        ctx[lane, :c.size] = c
                        ctx_len[lane] = c.size
                live = np.zeros(B, bool)
                live[[lane for lane, _ in sel]] = True
                with obs.span("compress.score", self._registry):
                    logits = self._score_incremental(batch, ctx, ctx_len,
                                                     live, budget)
                rows = [lane for lane, _ in sel]
                idxs = [j for _, j in sel]
                enc = self._encode_batch(batch[rows], logits[rows],
                                         valid_all[idxs], idxs, stats)
                for k, j in enumerate(idxs):
                    streams[j] = enc[k]
        return B

    def _accepts_prefix(self) -> bool:
        """Does predictor.begin_decode take a ``prefix`` keyword? (The
        fast prefill path — one scan dispatch instead of L decode
        steps. Detected once by signature; adapters without it get the
        token-at-a-time fallback, which is bit-identical.)"""
        if self._prefix_ok is None:
            try:
                self._prefix_ok = "prefix" in inspect.signature(
                    self.predictor.begin_decode).parameters
            except (TypeError, ValueError):
                self._prefix_ok = False
        return self._prefix_ok

    def _score_incremental(self, batch: np.ndarray, ctx=None, ctx_len=None,
                           live=None, budget: int = 0) -> torch.Tensor:
        """Teacher-forced scoring through the decode program: one call to
        the decompressor's own jitted step per position, ground-truth token
        fed back. Bit-exact with decompression by construction. With
        ``ctx`` (B, L) / ``ctx_len`` (B,), each lane first consumes its
        declared context — via the predictor's prefix prefill when
        supported and the context is lane-uniform, else fed token by
        token with per-lane offsets."""
        B, C = batch.shape
        state, prev, consumed = self._begin_group(B, C, ctx, ctx_len, live,
                                                  budget)
        # (B, C, V) logits stay where the predictor made them (a device
        # tensor for the port's models): only CDF tables cross to the host.
        # A mesh step's LogitShards are stacked as this rank's blocks and
        # handed on in their layout, so the coder reads them as the
        # decoder reads each step's
        shards = None

        def local(lg):
            nonlocal shards
            lg = _device_logits(lg)
            if isinstance(lg, LogitShards):
                shards = lg
                return lg.local
            return lg

        def done(logits):
            return logits if shards is None else shards.with_local(logits)

        if ctx is None or consumed.any():
            # fresh context, or the prefix was prefilled device-side —
            # every lane codes position t at step t. Each step's logits
            # are copied out at once: a captured step's output buffer is
            # overwritten by the next step.
            logits = None
            for t in range(C):
                lg, state = self.predictor.decode_step(state, prev)
                lg = local(lg)
                if logits is None:
                    logits = lg.new_empty((B, C, lg.shape[-1]))
                logits[:, t] = lg
                prev = batch[:, t]
            return done(logits)
        cl = np.asarray(ctx_len, np.int64)
        lanes = np.arange(B)
        logits = None
        for s in range(int(cl.max(initial=0)) + C):
            lg, state = self.predictor.decode_step(state, prev)
            lg = local(lg)
            if logits is None:
                logits = lg.new_zeros((B, C, lg.shape[-1]))
            t = s - cl                       # per-lane chunk position
            m = (t >= 0) & (t < C)
            rows = np.nonzero(m)[0]
            ri = torch.as_tensor(rows, device=lg.device)
            logits[ri, torch.as_tensor(t[rows], device=lg.device)] = lg[ri]
            nxt = np.where(m, batch[lanes, np.clip(t, 0, C - 1)], prev)
            pf = s < cl                      # lanes still consuming context
            if pf.any():
                nxt[pf] = ctx[pf, s]
            prev = nxt.astype(np.int32)
        return done(logits)

    # -------------------------------------------------------------- encode
    def _encode_batch(self, batch, logits, valid, chunk_indices, stats):
        """Entropy-encode one (nb, C) batch. ``valid`` is the per-row
        valid-token count and ``chunk_indices`` the rows' absolute chunk
        ids (the routed path encodes a non-contiguous LLM subset, so
        neither is derivable from an offset anymore)."""
        valid = np.asarray(valid, np.int64)
        ideal_rows = self._accumulate_ideal_bits(batch, logits, valid,
                                                 stats)
        if self.codec == "rans":
            streams, bits_rows, esc_rows = self._encode_batch_rans(
                batch, logits, valid, stats)
        else:
            streams, bits_rows, esc_rows = self._encode_batch_ac(
                batch, logits, valid, stats)
        if self._registry.enabled:
            h = self._registry.histogram(
                "chunk.bits_per_token",
                "realized payload bits/token per chunk")
            for b, s in enumerate(streams):
                d = obs.ChunkDiagnostics(
                    chunk_index=int(chunk_indices[b]),
                    n_tokens=int(valid[b]),
                    stream_bytes=len(s),
                    coded_bits=float(bits_rows[b]),
                    ideal_bits=float(ideal_rows[b]),
                    n_escapes=int(esc_rows[b]),
                    codec=self.codec)
                stats.chunks.append(d)
                h.observe(d.bits_per_token)
        return streams

    def _accumulate_ideal_bits(self, batch, logits, valid, stats):
        """Accumulate the un-quantized model cross-entropy into ``stats``;
        returns the per-chunk row sums (bits) for diagnostics."""
        lp = full_logits(logits).double()
        lp = lp - lp.max(dim=-1, keepdim=True).values
        lse = torch.log(torch.exp(lp).sum(dim=-1))
        tok = torch.as_tensor(batch, device=lp.device).long()
        tok_lp = torch.gather(lp, -1, tok[..., None])[..., 0]
        m = np.arange(batch.shape[1])[None, :] < valid[:, None]
        rows = to_numpy(((lse - tok_lp) * torch.as_tensor(
            m, device=lp.device)).sum(dim=1)) / np.log(2.0)
        stats.ideal_bits += float(rows.sum())
        return rows

    def _encode_batch_rans(self, batch, logits, valid, stats):
        """All B chunk-streams advance through one vectorized coder step
        per token position: vectorized top-K slot lookup, masked escape
        steps, and a single LIFO flush in finish()."""
        B, C = batch.shape
        enc = rans.BatchedRansEncoder(B)
        pos = np.arange(C)[None, :] < valid[:, None]          # (B, C) active
        tel = self._registry.enabled
        bits_rows = np.zeros(B, np.float64)
        esc_rows = np.zeros(B, np.int64)
        if self.topk:
            ids, cdfs = topk_cdf(logits, self.topk, self.precision)
            ids = to_numpy(ids)                               # (B,C,K)
            cdfs = to_numpy(cdfs).astype(np.int64)            # (B,C,K+2)
            match = ids == batch[..., None]
            has = match.any(axis=-1)
            slots = np.where(has, match.argmax(axis=-1), self.topk)
            starts = np.take_along_axis(cdfs, slots[..., None],
                                        axis=-1)[..., 0]
            ends = np.take_along_axis(cdfs, slots[..., None] + 1,
                                      axis=-1)[..., 0]
            esc_rows = (~has & pos).sum(axis=1)
            stats.n_escapes += int(esc_rows.sum())
            if tel:   # quantized code length per chunk (diagnostics only)
                fr = np.maximum((ends - starts).astype(np.float64), 1.0)
                bits_rows = ((self.precision - np.log2(fr)) * pos) \
                    .sum(axis=1) + esc_rows * self._esc_bits
            for t in range(C):
                m = pos[:, t]
                if not m.any():
                    break
                enc.put(starts[:, t], ends[:, t] - starts[:, t],
                        self.precision, m)
                em = m & ~has[:, t]
                if em.any():
                    enc.put_uniform(batch[:, t], self._esc_bits, em)
        else:
            # per-position CDFs: a (B, C, V+1) int64 tensor would be tens
            # of GB at production vocab sizes, so quantize one (B, V+1)
            # slab per step — same shape the decode path uses
            lanes = np.arange(B)
            syms_all = batch.astype(np.int64)
            for t in range(C):
                m = pos[:, t]
                if not m.any():
                    break
                cdfs = logits_to_cdf(logits[:, t], self.precision)
                enc.put_symbols(batch[:, t].astype(np.int64), cdfs,
                                self.precision, m)
                if tel:
                    sy = syms_all[:, t]
                    fr = np.maximum(
                        (cdfs[lanes, sy + 1] - cdfs[lanes, sy])
                        .astype(np.float64), 1.0)
                    bits_rows += (self.precision - np.log2(fr)) * m
        return enc.finish(), bits_rows, esc_rows

    def _encode_batch_ac(self, batch, logits, valid, stats):
        """Legacy per-stream arithmetic-coding loops (reference codec)."""
        V = self.predictor.vocab_size
        streams = []
        if self.topk:
            ids, cdfs = topk_cdf(logits, self.topk, self.precision)
            ids, cdfs = to_numpy(ids), to_numpy(cdfs).astype(np.int64)
        esc_rows = np.zeros(batch.shape[0], np.int64)
        for b in range(batch.shape[0]):
            enc = ac.ArithmeticEncoder()
            for t in range(int(valid[b])):
                sym = int(batch[b, t])
                if self.topk:
                    slot = np.nonzero(ids[b, t] == sym)[0]
                    if slot.size:
                        enc.encode(int(slot[0]), cdfs[b, t])
                    else:  # escape, then uniform over the full vocab
                        stats.n_escapes += 1
                        esc_rows[b] += 1
                        enc.encode(self.topk, cdfs[b, t])
                        enc.encode(sym, ac.uniform_cdf(V))
                else:
                    cdf = logits_to_cdf(logits[b, t], self.precision)
                    enc.encode(sym, cdf)
            streams.append(enc.finish() if valid[b] else b"")
        # the AC path is the legacy reference: stream bytes supply
        # bits/token in diagnostics, quantized code length is not accrued
        return streams, np.zeros(batch.shape[0], np.float64), esc_rows

    # ----------------------------------------------------------- decompress
    def _check_config(self, info: ContainerInfo) -> None:
        check_container_config(info, vocab=self.predictor.vocab_size,
                               chunk_size=self.chunk_size, topk=self.topk,
                               precision=self.precision)

    def decompress(self, blob: bytes) -> np.ndarray:
        info, streams = parse_container(blob)
        self._check_config(info)
        if info.n_chunks == 0:           # valid empty container
            return np.zeros(0, np.int32)
        if any(e.recipe_kind != RECIPE_NONE for e in info.entries):
            return self._decompress_carried(info, streams)
        if any(not e.is_llm for e in info.entries):
            return self._decompress_mixed(info, streams)
        valid = np.array([e.n_tokens for e in info.entries], np.int64)
        C = self.chunk_size
        out = np.zeros(info.n_chunks * C, dtype=np.int32)
        # decode at the encoder's recorded lane count (v4+); v2/v3 record
        # nothing, so decode_batch must match the encoder's — mirror its
        # min() and dead-lane padding either way
        B = info.encode_batch or min(self.decode_batch, info.n_chunks)
        with obs.span("decompress.job", self._registry):
            for i in range(0, info.n_chunks, B):
                group = streams[i:i + B]
                ng = len(group)
                v = valid[i:i + B]
                if ng < B:
                    group = group + [b""] * (B - ng)
                    v = np.concatenate([v, np.zeros(B - ng, np.int64)])
                dec_tokens = self._decode_group(group, v, info.codec,
                                                chunk_offset=i,
                                                budget=info.ctx_budget)
                out[i * C:(i + ng) * C] = dec_tokens[:ng].ravel()
        self._c_dec_tokens.inc(info.n_tokens)
        self._registry.counter("decompress.chunks").inc(info.n_chunks)
        return out[:info.n_tokens]

    def _decode_fallback_entry(self, idx: int, entry: ChunkEntry,
                               stream: bytes, vocab: int) -> np.ndarray:
        return _decode_fallback(idx, entry, stream, vocab)

    def _carried_decode(self, info: ContainerInfo, get_stream,
                        need: set[int] | None) -> dict[int, np.ndarray]:
        """The recipe-aware decode engine shared by full decompress and
        range decode of v6 archives. Chunks are organized into carry
        *chains* (a chain starts at every non-carry recipe — read_index
        guarantees chunk 0 starts one); chains decode round-robin, one
        lane per chain, in blocks of the recorded encode lane count.
        ``need`` (range decode) limits work to the requested chunks plus
        their carry closure — every chain is decoded forward only to the
        deepest requested position, which is exactly what materializes a
        ranged chunk's declared context. Fallback chunks inside a chain
        decode host-side in their round (their *tokens* may be the next
        chunk's context even though they never touch the model). Returns
        {chunk index: valid tokens}."""
        entries = info.entries
        chains: list[list[int]] = []
        for j, e in enumerate(entries):
            if e.recipe_kind == RECIPE_CARRY and chains:
                chains[-1].append(j)
            else:
                chains.append([j])
        if need is not None:
            trimmed = []
            for c in chains:
                depth = max((k for k, j in enumerate(c) if j in need),
                            default=-1)
                if depth >= 0:
                    trimmed.append(c[:depth + 1])
            chains = trimmed
        decoded: dict[int, np.ndarray] = {}
        B = info.encode_batch or min(self.decode_batch, max(1, len(chains)))
        for blk in range(0, len(chains), B):
            block = chains[blk:blk + B]
            for r in range(max((len(c) for c in block), default=0)):
                group = [b""] * B
                v = np.zeros(B, np.int64)
                ctx_rows: list = [None] * B
                sel: list[tuple[int, int]] = []
                for lane, c in enumerate(block):
                    if r >= len(c):
                        continue
                    j = c[r]
                    e = entries[j]
                    s = get_stream(j)
                    if not e.is_llm:
                        decoded[j] = self._decode_fallback_entry(
                            j, e, s, info.vocab)
                        continue
                    group[lane] = s
                    v[lane] = e.n_tokens
                    if e.recipe_kind == RECIPE_CARRY:
                        prevt = decoded[j - 1]
                        ctx_rows[lane] = prevt[
                            max(0, prevt.size - e.recipe_param):]
                    elif e.recipe_kind == RECIPE_SHARED:
                        ctx_rows[lane] = \
                            info.shared_prefixes[e.recipe_param][1]
                    sel.append((lane, j))
                if not sel:
                    continue
                L = max((c.size for c in ctx_rows if c is not None),
                        default=0)
                ctx = ctx_len = None
                if L:
                    ctx = np.zeros((B, L), np.int32)
                    ctx_len = np.zeros(B, np.int64)
                    for lane, c in enumerate(ctx_rows):
                        if c is not None:
                            ctx[lane, :c.size] = c
                            ctx_len[lane] = c.size
                toks = self._decode_group(group, v, info.codec,
                                          chunk_offset=sel[0][1],
                                          ctx=ctx, ctx_len=ctx_len,
                                          budget=info.ctx_budget,
                                          lane_chunks=dict(sel))
                for lane, j in sel:
                    decoded[j] = toks[lane, :entries[j].n_tokens].copy()
        return decoded

    def _decompress_carried(self, info: ContainerInfo,
                            streams: list) -> np.ndarray:
        """Full decode of a v6 archive with context recipes."""
        C = self.chunk_size
        with obs.span("decompress.job", self._registry):
            decoded = self._carried_decode(info, lambda j: streams[j],
                                           None)
        out = np.zeros(info.n_chunks * C, np.int32)
        for j, toks in decoded.items():
            out[j * C:j * C + toks.size] = toks
        self._c_dec_tokens.inc(info.n_tokens)
        self._registry.counter("decompress.chunks").inc(info.n_chunks)
        n_fb = sum(1 for e in info.entries if not e.is_llm)
        if n_fb:
            self._registry.counter(
                "decompress.fallback_chunks",
                "fallback-tagged chunks decoded without the model").inc(
                n_fb)
        return out[:info.n_tokens]

    def _decompress_mixed(self, info: ContainerInfo,
                          streams: list) -> np.ndarray:
        """v5 mixed-codec decode: fallback-tagged chunks decode directly
        on the host; the surviving LLM-tagged chunks are grouped at the
        recorded encode lane count, in tag order. Encode-time group
        *composition* is not (and cannot be) reconstructed — post-encode
        flips changed it — but lanes are independent, so only the lane
        count is coding geometry (DESIGN.md §8)."""
        C = self.chunk_size
        out = np.zeros(info.n_chunks * C, dtype=np.int32)
        llm_idx = [i for i, e in enumerate(info.entries) if e.is_llm]
        with obs.span("decompress.job", self._registry):
            for i, e in enumerate(info.entries):
                if e.is_llm:
                    continue
                toks = self._decode_fallback_entry(i, e, streams[i],
                                                   info.vocab)
                out[i * C:i * C + e.n_tokens] = toks
            B = info.encode_batch or min(self.decode_batch,
                                         max(1, len(llm_idx)))
            for g in range(0, len(llm_idx), B):
                sel = llm_idx[g:g + B]
                group = [streams[j] for j in sel] + [b""] * (B - len(sel))
                v = np.zeros(B, np.int64)
                v[:len(sel)] = [info.entries[j].n_tokens for j in sel]
                toks = self._decode_group(group, v, info.codec,
                                          chunk_offset=sel[0],
                                          budget=info.ctx_budget,
                                          lane_chunks=sel)
                for k, j in enumerate(sel):
                    nt = info.entries[j].n_tokens
                    out[j * C:j * C + nt] = toks[k, :nt]
        self._c_dec_tokens.inc(info.n_tokens)
        self._registry.counter("decompress.chunks").inc(info.n_chunks)
        self._registry.counter(
            "decompress.fallback_chunks",
            "fallback-tagged chunks decoded without the model").inc(
            info.n_chunks - len(llm_idx))
        return out[:info.n_tokens]

    def decompress_range(self, blob: bytes, chunk_start: int,
                         chunk_stop: int | None = None) -> np.ndarray:
        """Random-access decode of chunks [chunk_start, chunk_stop) from a
        v4 container — the index footer locates the streams, so only the
        requested chunks' bytes are read, verified, and decoded. The
        result is bit-identical to the corresponding slice of a full
        ``decompress`` (chunks are independent by construction, §5.4).

        Bit-exactness on real models needs more than chunk independence:
        logits are only reproducible at the encoder's model-program batch
        shape (XLA reduction order varies with B). So the requested chunks
        are regrouped into their *encode-time* groups — stride taken from
        the container's recorded encode batch — and each group runs at its
        encode-time lane count, with unrequested lanes left empty (masked
        out of the coder; lanes are independent, so their content never
        reaches the requested lanes' logits)."""
        info = read_index(blob)
        self._check_config(info)
        if chunk_stop is None:
            chunk_stop = chunk_start + 1
        check_chunk_range(info, chunk_start, chunk_stop)
        B = info.encode_batch or min(self.decode_batch, info.n_chunks)
        C = self.chunk_size
        out = np.zeros((chunk_stop - chunk_start) * C, dtype=np.int32)
        if any(e.recipe_kind != RECIPE_NONE for e in info.entries):
            return self._range_carried(blob, info, chunk_start, chunk_stop,
                                       out)
        if any(not e.is_llm for e in info.entries):
            return self._range_mixed(blob, info, chunk_start, chunk_stop,
                                     B, out)
        total = 0
        for g in range(chunk_start // B, (chunk_stop - 1) // B + 1):
            g_lo = g * B
            g_hi = min(g_lo + B, info.n_chunks)
            sel_lo = max(chunk_start, g_lo)
            sel_hi = min(chunk_stop, g_hi)
            group = [b""] * B               # encode-time lane count, always
            v = np.zeros(B, np.int64)
            for j in range(sel_lo, sel_hi):
                e = info.entries[j]
                s = blob[e.offset:e.offset + e.length]
                if xxh64(s) != e.checksum:
                    raise ContainerError(
                        f"corrupt container: chunk {j} checksum mismatch")
                group[j - g_lo] = s
                v[j - g_lo] = e.n_tokens
            toks = self._decode_group(group, v, info.codec,
                                      budget=info.ctx_budget,
                                      lane_chunks=range(g_lo, g_lo + B))
            for j in range(sel_lo, sel_hi):
                b = j - g_lo
                out[total:total + int(v[b])] = toks[b, :int(v[b])]
                total += int(v[b])
        return out[:total]

    def _range_carried(self, blob, info: ContainerInfo, chunk_start: int,
                       chunk_stop: int, out: np.ndarray) -> np.ndarray:
        """Range decode over a recipe-bearing v6 container: the carry
        closure (each requested chunk's chain ancestors) is decoded
        forward to materialize declared contexts — that closure, and only
        that closure, is read and checksum-verified from the blob."""
        verified: dict[int, bytes] = {}

        def get_stream(j: int) -> bytes:
            if j not in verified:
                e = info.entries[j]
                s = blob[e.offset:e.offset + e.length]
                if xxh64(s) != e.checksum:
                    raise ContainerError(
                        f"corrupt container: chunk {j} checksum mismatch")
                verified[j] = s
            return verified[j]

        need = set(range(chunk_start, chunk_stop))
        decoded = self._carried_decode(info, get_stream, need)
        total = 0
        for j in range(chunk_start, chunk_stop):
            t = decoded[j]
            out[total:total + t.size] = t
            total += t.size
        return out[:total]

    def _range_mixed(self, blob, info: ContainerInfo, chunk_start: int,
                     chunk_stop: int, B: int, out: np.ndarray) -> np.ndarray:
        """Range decode over a mixed-codec v5 container: fallback-tagged
        chunks decode individually, the requested LLM-tagged chunks are
        grouped at the recorded lane count (composition is free — see
        ``_decompress_mixed``)."""
        toks_by_chunk: dict[int, np.ndarray] = {}
        llm_sel: list[tuple[int, bytes]] = []
        for j in range(chunk_start, chunk_stop):
            e = info.entries[j]
            s = blob[e.offset:e.offset + e.length]
            if xxh64(s) != e.checksum:
                raise ContainerError(
                    f"corrupt container: chunk {j} checksum mismatch")
            if e.is_llm:
                llm_sel.append((j, s))
            else:
                toks_by_chunk[j] = self._decode_fallback_entry(
                    j, e, s, info.vocab)
        for g in range(0, len(llm_sel), B):
            grp = llm_sel[g:g + B]
            group = [s for _, s in grp] + [b""] * (B - len(grp))
            v = np.zeros(B, np.int64)
            v[:len(grp)] = [info.entries[j].n_tokens for j, _ in grp]
            toks = self._decode_group(group, v, info.codec,
                                      chunk_offset=grp[0][0],
                                      budget=info.ctx_budget,
                                      lane_chunks=[j for j, _ in grp])
            for k, (j, _) in enumerate(grp):
                toks_by_chunk[j] = toks[k, :info.entries[j].n_tokens]
        total = 0
        for j in range(chunk_start, chunk_stop):
            t = toks_by_chunk[j]
            out[total:total + t.size] = t
            total += t.size
        return out[:total]

    # Decode groups take explicit per-stream valid lengths (slot-resumable
    # form): the same inner loops serve full decompress, range decode, and
    # the continuous-batching scheduler's drain path.
    def _decode_group(self, streams, valid: np.ndarray, codec: int,
                      chunk_offset: int = 0, ctx=None, ctx_len=None,
                      budget: int = 0, lane_chunks=None):
        """``lane_chunks[lane]`` names the chunk a lane decodes (default
        ``chunk_offset + lane``), for the error of an escape outside the
        vocabulary."""
        try:
            with obs.span("decode.group", self._registry):
                if codec == CODEC_RANS:
                    if ctx is None and self.draft_k > 0 \
                            and hasattr(self.predictor, "verify_steps"):
                        # speculative decode stays context-free: a lane's
                        # draft/verify frontier and its context prefill
                        # don't compose, so recipe groups take the
                        # lock-step path
                        return self._decode_group_rans_spec(
                            streams, valid, chunk_offset, budget)
                    return self._decode_group_rans(streams, valid, ctx,
                                                   ctx_len, budget)
                return self._decode_group_ac(streams, valid, ctx, ctx_len,
                                             budget)
        except _BadEscape as e:
            chunk = chunk_offset + e.lane if lane_chunks is None \
                else lane_chunks[e.lane]
            raise escape_error(chunk, e.token_id,
                               self.predictor.vocab_size) from None

    def _escape_ids(self, dec, esc) -> np.ndarray:
        """Decode the escaped lanes' token ids (uniform over
        2**_esc_bits) and raise ``_BadEscape`` for the first active lane
        whose id is no token of the model's vocabulary."""
        u = dec.get_uniform(self._esc_bits, esc)
        bad = np.nonzero(esc & (u >= self.predictor.vocab_size))[0]
        if bad.size:
            raise _BadEscape(int(bad[0]), int(u[bad[0]]))
        return u

    def _begin_group(self, B, C, ctx=None, ctx_len=None, live=None,
                     budget: int = 0):
        """Open a decode/score group. With a context (B, L)/(B,) pair:
        when every live lane shares the full context length L and the
        predictor's ``begin_decode`` accepts a prefix, the whole context
        is prefilled in one call — the state has consumed
        [BOS, ctx[:, :-1]] and ``prev`` is ctx[:, -1]; ``consumed`` is L
        per lane. Otherwise the caller feeds the context through
        ``decode_step`` itself (``consumed`` all zero). Dead lanes are
        fed the (zero-padded) prefix too in the fast path — lanes are
        independent, so their content never reaches live lanes.

        ``budget`` is the archive-wide context budget (v6 footer field):
        the model program is sized C + budget for EVERY group, context-
        free ones included — cache length changes the jitted program's
        reduction shapes and therefore the logits bitwise, so one
        archive must run at one length on both sides."""
        L = 0 if ctx is None else int(ctx.shape[1])
        if hasattr(self.predictor, "set_decode_len"):
            self.predictor.set_decode_len(C + max(L, int(budget)))
        if L:
            cl = np.asarray(ctx_len, np.int64)
            lv = np.ones(B, bool) if live is None else np.asarray(live)
            if lv.any() and bool(np.all(cl[lv] == L)) \
                    and self._accepts_prefix():
                state = self.predictor.begin_decode(
                    B, prefix=np.ascontiguousarray(ctx, dtype=np.int32))
                prev = np.ascontiguousarray(ctx[:, -1], dtype=np.int32)
                return state, prev, np.full(B, L, np.int64)
        state = self.predictor.begin_decode(B)
        prev = np.full((B,), self.predictor.bos_id, dtype=np.int32)
        return state, prev, np.zeros(B, np.int64)

    def _coder_decode_step(self, dec, logits, m):
        """One vectorized entropy-decode step for the lanes in ``m``:
        fused on-device top-k → quantized CDF → symbol-interval lookup on
        the coder's peeked slot bits (kernels/ac_cdf.py on TPU), then one
        host ``advance``. Bit-identical to the former host path (the CDF
        integers are the same — see cdf.topk_cdf); what changed is that
        no (B, K+2) cumsum or per-row search runs on the host anymore.
        Returns decoded token ids (B,) int64 (0 on inactive lanes)."""
        slots_bits = dec.peek(self.precision)
        if self.topk:
            ids, _, slots, starts, freqs = (to_numpy(a) for a in
                                            topk_cdf_lookup(
                logits, slots_bits.astype(np.int32), self.topk,
                self.precision))
            dec.advance(slots, starts, freqs, self.precision, m)
            esc = m & (slots == self.topk)
            syms = np.take_along_axis(
                ids, np.minimum(slots, self.topk - 1)[:, None],
                axis=-1)[:, 0].astype(np.int64)
            if esc.any():
                u = self._escape_ids(dec, esc)
                syms = np.where(esc, u, syms)
                self._c_dec_escapes.inc(int(esc.sum()))
        else:
            syms, starts, freqs = (to_numpy(a) for a in full_cdf_lookup(
                logits, slots_bits.astype(np.int32), self.precision))
            syms = syms.astype(np.int64)
            dec.advance(syms, starts, freqs, self.precision, m)
        return np.where(m, syms, 0)

    def _round_cdfs(self, logits):
        """Build every CDF row a speculative round can consume in ONE
        device dispatch: ``logits`` (B, K+1, V) -> (ids (B, K+1, k) or
        None, cdf (B, K+1, A+1) int64) where A is the coded alphabet
        (top-k + escape, or V). The integers are exactly the rows the
        fused per-step lookup would build — interval search over
        identical integers is exact — so batching the build per round
        instead of per position changes dispatch count, not bits."""
        if self.topk:
            ids, cdf = topk_cdf(logits, self.topk, self.precision)
            return to_numpy(ids), to_numpy(cdf).astype(np.int64)
        return None, to_numpy(full_cdf(logits, self.precision)).astype(
            np.int64)

    def _coder_decode_host(self, dec, ids, cdf, m):
        """One vectorized entropy-decode step against PREBUILT integer CDF
        rows (``_round_cdfs``): host interval search on the peeked slot
        bits + one ``advance``. The speculative inner loop uses this so a
        round of K+1 positions costs one device dispatch total rather
        than one per position. cdf[:, -1] == 2**precision > slot always,
        so the right-edge sentinel never matches."""
        slot = dec.peek(self.precision)
        lanes = np.arange(cdf.shape[0])
        syms = (cdf[:, 1:-1] <= slot[:, None]).sum(axis=1, dtype=np.int64)
        dec.advance(syms, cdf[lanes, syms],
                    cdf[lanes, syms + 1] - cdf[lanes, syms],
                    self.precision, m)
        if ids is not None:
            esc = m & (syms == self.topk)
            syms = ids[lanes, np.minimum(syms, self.topk - 1)].astype(
                np.int64)
            if esc.any():
                u = self._escape_ids(dec, esc)
                syms = np.where(esc, u, syms)
                self._c_dec_escapes.inc(int(esc.sum()))
        return np.where(m, syms, 0)

    def _decode_group_rans(self, streams, valid, ctx=None, ctx_len=None,
                           budget: int = 0):
        """Lock-step batched decode: one model step + one fused CDF/lookup
        dispatch + one vectorized coder step per token position. With a
        context, each lane first consumes its declared prefix (prefilled
        in one call when uniform + supported, else fed per step with
        per-lane offsets) before its first coded position."""
        B, C = len(streams), self.chunk_size
        valid = np.asarray(valid, np.int64)
        dec = rans.BatchedRansDecoder(streams)
        tokens = np.zeros((B, C), dtype=np.int32)
        state, prev, consumed = self._begin_group(B, C, ctx, ctx_len,
                                                  live=valid > 0,
                                                  budget=budget)
        if ctx is None or consumed.any():
            for t in range(int(valid.max(initial=0))):
                logits, state = self.predictor.decode_step(state, prev)
                m = valid > t
                syms = self._coder_decode_step(dec, logits, m)
                nxt = np.where(m, syms, 0).astype(np.int32)
                tokens[:, t] = nxt
                prev = nxt
            return tokens
        cl = np.where(valid > 0, np.asarray(ctx_len, np.int64), 0)
        for s in range(int((cl + valid).max(initial=0))):
            logits, state = self.predictor.decode_step(state, prev)
            t = s - cl
            m = (t >= 0) & (t < valid)
            if m.any():
                syms = self._coder_decode_step(dec, logits, m)
                tokens[m, t[m]] = syms[m]
                nxt = np.where(m, syms, prev)
            else:
                nxt = prev.astype(np.int64)
            pf = s < cl
            if pf.any():
                nxt = np.asarray(nxt).copy()
                nxt[pf] = ctx[pf, s]
            prev = nxt.astype(np.int32)
        return tokens

    def _decode_group_rans_spec(self, streams, valid, chunk_offset=0,
                                budget: int = 0):
        """Speculative batched decode (DESIGN.md §9): per round, a cheap
        self-draft proposes K tokens per lane, ONE verify dispatch scores
        all K+1 positions (predictor.verify_steps — bit-identical to K+1
        lock-step calls by construction), and the rANS decoder accepts
        greedily against the coded stream. A lane keeps consuming verify
        logits while its decoded token matches its draft; the first
        mismatch still yields a correct token (the coder decoded it from
        the real stream — acceptance is exact, not probabilistic), after
        which the lane waits for the next round. Lanes that match all K
        drafts decode a bonus (K+1)-th token from the last verify slot.
        ``predictor.rollback`` then rewinds each lane's cache to its
        accepted frontier. Worst case (every draft wrong) each round
        still decodes 1 token/lane — the lock-step rate — and the
        adaptive fallthrough stops paying the deeper verify forward."""
        B, C = len(streams), self.chunk_size
        K = self.draft_k
        valid = np.asarray(valid, np.int64)
        dec = rans.BatchedRansDecoder(streams)
        tokens = np.zeros((B, C), dtype=np.int32)
        state, prev, _ = self._begin_group(B, C, budget=budget)
        pos = np.zeros(B, np.int64)
        if hasattr(self.draft, "begin_group"):
            self.draft.begin_group(chunk_offset)
        rounds = drafted_hits = offered = rollbacks = 0
        tel = self._registry.enabled
        depth_h = self._registry.histogram(
            "spec.accept_depth",
            "tokens decoded per lane per speculative round") if tel else None
        lanes = np.arange(B)
        while True:
            active = pos < valid
            if not active.any():
                break
            if rounds >= self._spec_window and \
                    drafted_hits < self._spec_floor * rounds:
                self._registry.counter(
                    "spec.lockstep_fallthroughs",
                    "groups that abandoned drafting mid-decode").inc()
                self._lockstep_tail(dec, state, prev, pos, valid, tokens)
                break
            with obs.span("decode.verify_round", self._registry):
                drafts = np.clip(
                    self.draft.propose(tokens, pos, K), 0,
                    self.predictor.vocab_size - 1).astype(np.int32)
                seq = np.concatenate([prev[:, None], drafts], axis=1)
                logits, snaps = self.predictor.verify_steps(state, seq)
                ids_a, cdf_a = self._round_cdfs(logits)
                acc = np.zeros(B, np.int64)
                chain = active.copy()
                for j in range(K + 1):
                    mj = chain & (pos + j < valid)
                    if not mj.any():
                        break
                    syms = self._coder_decode_host(
                        dec, None if ids_a is None else ids_a[:, j],
                        cdf_a[:, j], mj)
                    tokens[mj, (pos + j)[mj]] = syms[mj]
                    acc[mj] += 1
                    chain = mj & (syms == drafts[:, j]) if j < K else \
                        np.zeros(B, bool)
                # lane b resumed from the snapshot after acc[b] verify
                # inputs: [prev, d_0..d_{acc-2}] — the acc'th accepted
                # token is NOT fed back here; it is the next round's `prev`
                state = self.predictor.rollback(snaps, acc.astype(np.int32))
                pos += acc
                prev = np.where(acc > 0,
                                tokens[lanes, np.maximum(pos - 1, 0)],
                                prev).astype(np.int32)
                rounds += 1
                offered += int(active.sum()) * K
                drafted_hits += int(np.maximum(acc - 1, 0).sum())
                rollbacks += int((active & (acc < K + 1)).sum())
                if tel:
                    depth_h.observe_many(acc[active])
        self._registry.counter(
            "spec.rounds", "speculative draft/verify rounds").inc(rounds)
        self._registry.counter(
            "spec.drafted_tokens", "draft slots offered for "
            "verification").inc(offered)
        self._registry.counter(
            "spec.drafted_accepted",
            "drafted tokens accepted beyond the per-round floor of "
            "1").inc(drafted_hits)
        self._registry.counter(
            "spec.rollbacks", "lane cache rewinds (acc < K+1)").inc(
            rollbacks)
        return tokens

    def _lockstep_tail(self, dec, state, prev, pos, valid, tokens):
        """Finish a group lock-step from per-lane positions — the
        speculative path's fallthrough when drafts stop earning their
        verify depth. Mutates pos/tokens in place."""
        B = tokens.shape[0]
        lanes = np.arange(B)
        while True:
            m = pos < valid
            if not m.any():
                return
            logits, state = self.predictor.decode_step(state, prev)
            syms = self._coder_decode_step(dec, logits, m)
            tokens[m, pos[m]] = syms[m]
            pos += m
            prev = np.where(m, syms, prev).astype(np.int32)

    def _decode_group_ac(self, streams, valid, ctx=None, ctx_len=None,
                         budget: int = 0):
        """Legacy per-stream arithmetic decode (reference codec + v2),
        with the same per-lane context offsets as the rANS path."""
        V = self.predictor.vocab_size
        B, C = len(streams), self.chunk_size
        valid = np.asarray(valid, np.int64)
        decoders = [ac.ArithmeticDecoder(s) for s in streams]
        tokens = np.zeros((B, C), dtype=np.int32)
        state, prev, consumed = self._begin_group(B, C, ctx, ctx_len,
                                                  live=valid > 0,
                                                  budget=budget)
        if ctx is None or consumed.any():
            cl = np.zeros(B, np.int64)
        else:
            cl = np.where(valid > 0, np.asarray(ctx_len, np.int64), 0)
        for s in range(int((cl + valid).max(initial=0))):
            logits, state = self.predictor.decode_step(state, prev)
            tv = s - cl
            m = (tv >= 0) & (tv < valid)
            if m.any() and self.topk:
                ids, cdfs = topk_cdf(logits, self.topk, self.precision)
                ids, cdfs = to_numpy(ids), to_numpy(cdfs).astype(np.int64)
            nxt = prev.astype(np.int32).copy()
            for b in range(B):
                if not m[b]:
                    continue
                t = int(tv[b])
                if self.topk:
                    slot = decoders[b].decode(cdfs[b])
                    if slot == self.topk:  # escape
                        sym = decoders[b].decode(ac.uniform_cdf(V))
                    else:
                        sym = int(ids[b, slot])
                else:
                    cdf = logits_to_cdf(logits[b], self.precision)
                    sym = decoders[b].decode(cdf)
                tokens[b, t] = sym
                nxt[b] = sym
            pf = s < cl
            if pf.any():
                nxt[pf] = ctx[pf, s]
            prev = nxt
        return tokens

    # ------------------------------------------------------------- metrics
    @staticmethod
    def ratio(original_bytes: int, blob: bytes) -> float:
        return original_bytes / max(1, len(blob))
