"""The port's container reader under corruption: ``tests/test_container_fuzz.py``
replayed against ``repro_torch``'s ``LLMCompressor``, ``read_header`` and
``read_index``.

Every case that raises ``ContainerError`` in the JAX package must raise it
in the port: every strict prefix of a v2-v6 container, every single-bit
flip of a v4, v5 and v6 container, varint bombs, a rANS precision above
the coder's limit, unknown versions and codecs, and the semantic checks
behind recomputed checksums (codec tags, fallback framing, context
recipes, the context budget, the shared-prefix dictionary). Range decode
of every interval equals the matching slice of a full decode, and damage
to one chunk fails only the reads that touch it.

One case differs from the JAX file. Its header-flip test decodes the
top-k goldens ``v2_topk`` and ``v3_rans_topk``, which the port cannot
decode (ROADMAP P1: two rows of the table get top-k CDF points one
quantum from JAX's). The port's version flips every header bit of
``v2_full`` and ``v3_rans_full``, which it decodes exactly, and of a v3
top-k archive the port wrote itself. Where a flipped header still decodes
in the port, the JAX package must decode that blob too, to the same
tokens: a flip JAX rejects is never read silently by the port.

The fixtures are JAX's, with the port's compressor over the same
``GoldenPredictor`` table on the CPU.
"""
import pathlib
import struct

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from helpers import (GoldenPredictor, golden_self_tokens,  # noqa: E402
                     golden_tokens)
from repro.core import ContainerError as JaxContainerError  # noqa: E402
from repro.core import LLMCompressor as JaxCompressor  # noqa: E402
from repro_torch.core import (ContainerError, LLMCompressor,  # noqa: E402
                              RouterConfig, read_header, read_index)
from repro_torch.core.checksum import xxh64  # noqa: E402
from repro_torch.core.compressor import (  # noqa: E402
    _V3_HEADER, _V4_TRAILER, _V5_END_MAGIC, _V5_ENTRY, _V5_ENTRY_SIZE,
    _V6_END_MAGIC, _V6_ENTRY, _V6_ENTRY_SIZE, CODEC_RANS, MAGIC,
    RECIPE_CARRY, RECIPE_NONE)

GOLDEN = pathlib.Path(__file__).parent / "golden"


def _comp(**kw):
    return LLMCompressor(GoldenPredictor(), chunk_size=16, decode_batch=4,
                         **kw)


@pytest.fixture(scope="module")
def v4_case():
    comp = _comp(topk=8, container_version=4)
    toks = golden_tokens(100)
    blob, _ = comp.compress(toks)
    return comp, toks, blob


# ------------------------------------------------------------- truncation
@pytest.mark.parametrize("name", ["v2_topk.llmc", "v3_rans_topk.llmc",
                                  "v3_ac_topk.llmc"])
def test_every_truncation_raises_container_error(name):
    blob = (GOLDEN / name).read_bytes()
    comp = _comp(topk=8)
    for cut in range(len(blob)):
        with pytest.raises(ContainerError):
            comp.decompress(blob[:cut])


def test_every_v4_truncation_raises_container_error(v4_case):
    comp, _, blob = v4_case
    for cut in range(len(blob)):
        with pytest.raises(ContainerError):
            comp.decompress(blob[:cut])


# --------------------------------------------------------------- bit flips
def test_v4_detects_every_single_bit_flip(v4_case):
    """Exhaustive: flip each bit of the container; decompress must raise
    ContainerError every time (header+index covered by the footer hash,
    streams by per-chunk hashes, trailer by structural checks)."""
    comp, _, blob = v4_case
    for i in range(len(blob)):
        for bit in range(8):
            bad = bytearray(blob)
            bad[i] ^= 1 << bit
            with pytest.raises(ContainerError):
                comp.decompress(bytes(bad))


@pytest.fixture(scope="module")
def port_v3_topk():
    """A v3 top-k archive written by the port (the golden stream)."""
    blob, _ = _comp(topk=8, container_version=3).compress(golden_tokens())
    return blob


@pytest.mark.parametrize("name", ["v2_full.llmc", "v3_rans_full.llmc",
                                  "port_v3_topk"])
def test_header_bit_flips_never_crash(name, port_v3_topk):
    """v2/v3 have no checksums, so a few header flips (the low bits of
    n_tokens, dead flag bits) still decode. Every header flip must either
    raise ContainerError or decode; where a JAX-written golden still
    decodes in the port, JAX decodes the same blob to the same tokens."""
    topk = 8 if name == "port_v3_topk" else 0
    blob = port_v3_topk if name == "port_v3_topk" \
        else (GOLDEN / name).read_bytes()
    comp = _comp(topk=topk)
    jax_comp = JaxCompressor(GoldenPredictor(), chunk_size=16,
                             decode_batch=4, topk=topk)
    hsize = 4 + struct.calcsize(_V3_HEADER)
    decoded = 0
    for i in range(min(hsize, len(blob))):
        for bit in range(8):
            bad = bytearray(blob)
            bad[i] ^= 1 << bit
            try:
                got = comp.decompress(bytes(bad))
            except ContainerError:
                continue
            decoded += 1
            if name != "port_v3_topk":
                try:
                    ref = jax_comp.decompress(bytes(bad))
                except JaxContainerError:
                    pytest.fail(f"{name}: the port decodes the flip of "
                                f"bit {bit} of byte {i}; JAX rejects it")
                assert np.array_equal(got, ref), (name, i, bit)
    assert decoded < hsize * 8 // 2     # most header flips are caught


def test_varint_bomb_rejected():
    """A length varint that never terminates (or overflows 64 bits) must
    raise ContainerError, not hang or IndexError."""
    comp = _comp(topk=8)
    hdr = MAGIC + struct.pack(_V3_HEADER, 3, 1, 16, 100, 64, 8, 16, 1)
    with pytest.raises(ContainerError):
        comp.decompress(hdr + b"\xff" * 64)


def test_chunk_count_beyond_the_body_is_refused_first():
    """A v3 header whose n_tokens claims 2**27 chunks over a 64-byte body
    is refused before any per-chunk array of that size is made."""
    comp = _comp(topk=8)
    hdr = MAGIC + struct.pack(_V3_HEADER, 3, 1, 16, 1 << 31, 64, 8, 16, 1)
    with pytest.raises(ContainerError, match="claims 134217728 chunks"):
        comp.decompress(hdr + b"\x01\x00" * 32)


def test_rans_precision_validated_from_container():
    """A header that selects rANS at precision 24 (> rans.MAX_PRECISION)
    is rejected at parse, though the decoder was built with a legal
    precision; under the AC codec the same precision fails only on the
    config match."""
    comp = _comp(topk=8)
    hdr = MAGIC + struct.pack(_V3_HEADER, 3, 1, 16, 100, 64, 8, 24,
                              CODEC_RANS)
    with pytest.raises(ContainerError, match="rANS"):
        comp.decompress(hdr + b"\x00" * 32)
    hdr_ac = MAGIC + struct.pack(_V3_HEADER, 3, 1, 16, 100, 64, 8, 24, 0)
    with pytest.raises(ContainerError, match="mismatch"):
        comp.decompress(hdr_ac + b"\x00" * 32)


def test_unknown_version_and_codec_rejected():
    comp = _comp(topk=8)
    blob, _ = _comp(topk=8).compress(golden_tokens(20))
    bad = bytearray(blob)
    bad[4] = 9
    with pytest.raises(ContainerError, match="version"):
        comp.decompress(bytes(bad))
    bad = bytearray(blob)
    bad[19] = 7
    with pytest.raises(ContainerError, match="codec"):
        comp.decompress(bytes(bad))


# ------------------------------------------------------------ random access
def _all_ranges_match(comp, toks, blob):
    full = comp.decompress(blob)
    assert np.array_equal(full, toks)
    info = read_index(blob)
    C = info.chunk_size
    for lo in range(info.n_chunks):
        for hi in range(lo + 1, info.n_chunks + 1):
            part = comp.decompress_range(blob, lo, hi)
            assert np.array_equal(part,
                                  full[lo * C:min(hi * C, toks.size)]), \
                (lo, hi)


def test_v4_range_decode_matches_full_decode(v4_case):
    _all_ranges_match(*v4_case)


def test_range_decode_detects_chunk_corruption(v4_case):
    comp, _, blob = v4_case
    info = read_index(blob)
    e = info.entries[2]
    bad = bytearray(blob)
    bad[e.offset] ^= 0x01                  # corrupt only chunk 2's stream
    with pytest.raises(ContainerError, match="chunk 2"):
        comp.decompress_range(bytes(bad), 2, 3)
    assert np.array_equal(comp.decompress_range(bytes(bad), 0, 2),
                          comp.decompress_range(blob, 0, 2))


def test_range_decode_requires_v4_and_bounds():
    comp = _comp(topk=8)
    v3, _ = comp.compress(golden_tokens(50))
    with pytest.raises(ContainerError, match="v4"):
        comp.decompress_range(v3, 0, 1)
    comp4 = _comp(topk=8, container_version=4)
    v4, _ = comp4.compress(golden_tokens(50))
    with pytest.raises(ContainerError, match="out of bounds"):
        comp4.decompress_range(v4, 0, 99)
    with pytest.raises(ContainerError, match="empty"):
        comp4.decompress_range(v4, 1, 1)
    with pytest.raises(ContainerError, match="reversed"):
        comp4.decompress_range(v4, 3, 1)


def test_empty_and_garbage_blobs():
    comp = _comp(topk=8)
    for blob in (b"", b"LL", b"XXXX" + b"\x00" * 40, MAGIC):
        with pytest.raises(ContainerError):
            comp.decompress(blob)


# ----------------------------------------------------- v5 mixed containers
def _mixed_tokens():
    return np.concatenate([golden_self_tokens(32, seed=3),
                           golden_tokens(32, seed=4),
                           golden_self_tokens(16, seed=5),
                           golden_tokens(21, seed=6)])


@pytest.fixture(scope="module")
def v5_case():
    """A routed v5 container whose index mixes entropy-coded and fallback
    chunks, so the fuzz reaches both stream kinds and the tag bytes."""
    comp = _comp(topk=8, container_version=5, route="auto",
                 router=RouterConfig(fallbacks=("raw", "lzma")))
    toks = _mixed_tokens()
    blob, _ = comp.compress(toks)
    tags = {e.codec_name for e in read_index(blob).entries}
    assert "rans" in tags and tags != {"rans"}
    return comp, toks, blob


def test_every_v5_truncation_raises_container_error(v5_case):
    comp, _, blob = v5_case
    for cut in range(len(blob)):
        with pytest.raises(ContainerError):
            comp.decompress(blob[:cut])


def test_v5_detects_every_single_bit_flip(v5_case):
    comp, _, blob = v5_case
    for i in range(len(blob)):
        for bit in range(8):
            bad = bytearray(blob)
            bad[i] ^= 1 << bit
            with pytest.raises(ContainerError):
                comp.decompress(bytes(bad))


def _v5_tamper(blob, chunk, tag=None, stream=None):
    """Rewrite chunk ``chunk``'s codec tag and/or stream bytes in a v5
    container and RECOMPUTE every checksum, so only the semantic
    validation behind them stands between the tamper and a wrong
    decode. Same-length stream patches only."""
    assert blob[-4:] == _V5_END_MAGIC
    info = read_header(blob)
    n, footer_len = struct.unpack("<II", blob[-12:-4])
    footer_start = len(blob) - _V4_TRAILER - footer_len
    entries = [list(struct.unpack_from(_V5_ENTRY, blob,
                                       footer_start + i * _V5_ENTRY_SIZE))
               for i in range(n)]
    body = bytearray(blob[:footer_start])
    if stream is not None:
        off, ln = entries[chunk][0], entries[chunk][1]
        assert len(stream) == ln
        body[off:off + ln] = stream
        entries[chunk][4] = xxh64(bytes(stream))
    if tag is not None:
        entries[chunk][3] = tag
    ents = b"".join(struct.pack(_V5_ENTRY, *e) for e in entries)
    eb_off = footer_start + n * _V5_ENTRY_SIZE
    tail = ents + blob[eb_off:eb_off + 4]           # + u32 encode_batch
    return (bytes(body) + tail
            + struct.pack("<Q", xxh64(blob[:info.header_size] + tail))
            + struct.pack("<II", n, len(tail) + 8) + _V5_END_MAGIC)


def test_v5_semantic_validation_behind_checksums(v5_case):
    comp, _, blob = v5_case
    info = read_index(blob)
    assert _v5_tamper(blob, 0) == blob
    with pytest.raises(ContainerError, match="unknown codec id"):
        comp.decompress(_v5_tamper(blob, 0, tag=9))
    with pytest.raises(ContainerError, match="entropy codec"):
        comp.decompress(_v5_tamper(blob, 0, tag=0))
    fb = next(i for i, e in enumerate(info.entries) if not e.is_llm)
    s = bytearray(blob[info.entries[fb].offset:
                       info.entries[fb].offset + info.entries[fb].length])
    bad_width = bytes([3]) + bytes(s[1:])
    with pytest.raises(ContainerError, match="width"):
        comp.decompress(_v5_tamper(blob, fb, stream=bad_width))
    wrong_width = bytes([2 if s[0] == 1 else 1]) + bytes(s[1:])
    with pytest.raises(ContainerError, match=f"chunk {fb}"):
        comp.decompress(_v5_tamper(blob, fb, stream=wrong_width))
    other = 3 if info.entries[fb].codec == 4 else 4
    with pytest.raises(ContainerError, match=f"chunk {fb}"):
        comp.decompress(_v5_tamper(blob, fb, tag=other))


def test_v5_range_decode_matches_full_decode(v5_case):
    _all_ranges_match(*v5_case)


def test_v5_range_decode_detects_fallback_corruption(v5_case):
    comp, _, blob = v5_case
    info = read_index(blob)
    fb = next(i for i, e in enumerate(info.entries) if not e.is_llm)
    bad = bytearray(blob)
    bad[info.entries[fb].offset] ^= 0x01
    with pytest.raises(ContainerError, match=f"chunk {fb}"):
        comp.decompress_range(bytes(bad), fb, fb + 1)
    lo = 0 if fb else 1
    assert np.array_equal(comp.decompress_range(bytes(bad), lo, lo + 1),
                          comp.decompress_range(blob, lo, lo + 1))


# --------------------------------------------- v6 carried-context containers
@pytest.fixture(scope="module")
def v6_case():
    """A routed v6 container with every recipe kind at once (shared-prefix
    heads, carry chunks, fallback chunks with zeroed recipes) and a
    dictionary section in the footer."""
    comp = _comp(topk=8, container_version=6, route="auto",
                 router=RouterConfig(fallbacks=("raw", "lzma")),
                 context_window=6, context_stripes=2,
                 shared_prefix=golden_self_tokens(10, seed=9))
    toks = _mixed_tokens()
    blob, _ = comp.compress(toks)
    info = read_index(blob)
    tags = {e.codec_name for e in info.entries}
    kinds = {e.recipe_kind for e in info.entries}
    assert "rans" in tags and tags != {"rans"}
    assert RECIPE_CARRY in kinds and RECIPE_NONE in kinds
    assert len(info.shared_prefixes) == 1
    return comp, toks, blob


def test_every_v6_truncation_raises_container_error(v6_case):
    comp, _, blob = v6_case
    for cut in range(len(blob)):
        with pytest.raises(ContainerError):
            comp.decompress(blob[:cut])


def test_v6_detects_every_single_bit_flip(v6_case):
    comp, _, blob = v6_case
    for i in range(len(blob)):
        for bit in range(8):
            bad = bytearray(blob)
            bad[i] ^= 1 << bit
            with pytest.raises(ContainerError):
                comp.decompress(bytes(bad))


def _v6_tamper(blob, chunk=None, tag=None, kind=None, param=None,
               stream=None, dict_blob=None, ctx_budget=None):
    """Rewrite a chunk's codec tag / recipe fields / stream bytes, the
    shared-prefix dictionary section and/or the recorded context budget
    of a v6 container, RECOMPUTING every checksum."""
    assert blob[-4:] == _V6_END_MAGIC
    info = read_header(blob)
    n, footer_len = struct.unpack("<II", blob[-12:-4])
    footer_start = len(blob) - _V4_TRAILER - footer_len
    entries_end = footer_start + n * _V6_ENTRY_SIZE
    dict_len = footer_len - (n * _V6_ENTRY_SIZE + 16)
    d = blob[entries_end:entries_end + dict_len] \
        if dict_blob is None else dict_blob
    eb = blob[entries_end + dict_len:entries_end + dict_len + 4]
    cb = blob[entries_end + dict_len + 4:entries_end + dict_len + 8] \
        if ctx_budget is None else struct.pack("<I", ctx_budget)
    entries = [list(struct.unpack_from(_V6_ENTRY, blob,
                                       footer_start + i * _V6_ENTRY_SIZE))
               for i in range(n)]
    body = bytearray(blob[:footer_start])
    if chunk is not None:
        if stream is not None:
            off, ln = entries[chunk][0], entries[chunk][1]
            assert len(stream) == ln
            body[off:off + ln] = stream
            entries[chunk][6] = xxh64(bytes(stream))
        if tag is not None:
            entries[chunk][3] = tag
        if kind is not None:
            entries[chunk][4] = kind
        if param is not None:
            entries[chunk][5] = param
    ents = b"".join(struct.pack(_V6_ENTRY, *e) for e in entries)
    tail = ents + d + eb + cb   # u32 encode_batch + u32 ctx_budget
    return (bytes(body) + tail
            + struct.pack("<Q", xxh64(blob[:info.header_size] + tail))
            + struct.pack("<II", n, len(tail) + 8) + _V6_END_MAGIC)


def test_v6_recipe_validation_behind_checksums(v6_case):
    comp, _, blob = v6_case
    info = read_index(blob)
    assert _v6_tamper(blob) == blob
    with pytest.raises(ContainerError, match="unknown recipe kind"):
        comp.decompress(_v6_tamper(blob, 0, kind=3))
    with pytest.raises(ContainerError, match="chunk 0 cannot carry"):
        comp.decompress(_v6_tamper(blob, 0, kind=1, param=4))
    carry = next(i for i, e in enumerate(info.entries)
                 if e.recipe_kind == RECIPE_CARRY)
    with pytest.raises(ContainerError, match="window 0"):
        comp.decompress(_v6_tamper(blob, carry, param=0))
    with pytest.raises(ContainerError, match="dictionary has 1"):
        comp.decompress(_v6_tamper(blob, carry, kind=2, param=7))
    fb = next(i for i, e in enumerate(info.entries) if not e.is_llm)
    fb_kind, fb_param = (1, 4) if fb else (2, 0)
    with pytest.raises(ContainerError, match="context-free"):
        comp.decompress(_v6_tamper(blob, fb, kind=fb_kind, param=fb_param))


def test_v6_ctx_budget_validation_behind_checksums(v6_case):
    comp, _, blob = v6_case
    recorded = read_index(blob).ctx_budget
    assert recorded > 0
    with pytest.raises(ContainerError, match="materializes"):
        comp.decompress(_v6_tamper(blob, ctx_budget=0))
    with pytest.raises(ContainerError, match="exceeds"):
        comp.decompress(_v6_tamper(blob, ctx_budget=1 << 16))
    # a larger budget is legal wire-wise; the table predictor is
    # geometry-free, so the archive still round-trips
    bigger = _v6_tamper(blob, ctx_budget=recorded + 4)
    assert read_index(bigger).ctx_budget == recorded + 4
    comp.decompress(bigger)


def test_v6_dictionary_validation_behind_checksums(v6_case):
    comp, _, blob = v6_case
    vocab = read_header(blob).vocab
    bad_tok = (struct.pack("<H", 1) + struct.pack("<B", 1) + b"p"
               + struct.pack("<H", 1) + struct.pack("<I", vocab))
    with pytest.raises(ContainerError, match="vocab"):
        comp.decompress(_v6_tamper(blob, dict_blob=bad_tok))
    good = _v6_tamper(blob)
    n, footer_len = struct.unpack("<II", good[-12:-4])
    footer_start = len(good) - _V4_TRAILER - footer_len
    entries_end = footer_start + n * _V6_ENTRY_SIZE
    dict_len = footer_len - (n * _V6_ENTRY_SIZE + 16)
    d = good[entries_end:entries_end + dict_len]
    with pytest.raises(ContainerError, match="stray bytes"):
        comp.decompress(_v6_tamper(blob, dict_blob=d + b"\x00"))
    empty = (struct.pack("<H", 1) + struct.pack("<B", 1) + b"p"
             + struct.pack("<H", 0))
    with pytest.raises(ContainerError, match="empty"):
        comp.decompress(_v6_tamper(blob, dict_blob=empty))
    short = (struct.pack("<H", 1) + struct.pack("<B", 1) + b"p"
             + struct.pack("<H", 9) + struct.pack("<I", 1))
    with pytest.raises(ContainerError, match="ends early"):
        comp.decompress(_v6_tamper(blob, dict_blob=short))
    with pytest.raises(ContainerError, match="dictionary has 0"):
        comp.decompress(_v6_tamper(blob, dict_blob=struct.pack("<H", 0)))


def test_v6_range_decode_matches_full_decode(v6_case):
    _all_ranges_match(*v6_case)


def test_v6_range_decode_detects_upstream_corruption(v6_case):
    """A carried chunk's range decode fails when its chain HEAD is
    corrupt, while chunks of other chains stay readable."""
    comp, _, blob = v6_case
    info = read_index(blob)
    carry = next(i for i, e in enumerate(info.entries)
                 if e.recipe_kind == RECIPE_CARRY)
    head = max(i for i in range(carry + 1)
               if info.entries[i].recipe_kind != RECIPE_CARRY)
    assert head < carry
    bad = bytearray(blob)
    bad[info.entries[head].offset] ^= 0x01
    with pytest.raises(ContainerError, match=f"chunk {head}"):
        comp.decompress_range(bytes(bad), carry, carry + 1)
    other = next(i for i, e in enumerate(info.entries)
                 if e.recipe_kind != RECIPE_CARRY and i != head)
    assert np.array_equal(comp.decompress_range(bytes(bad), other, other + 1),
                          comp.decompress_range(blob, other, other + 1))
