"""The port's integer coding layer against the JAX package's.

rANS, arithmetic coding, xxh64 and the fallback byte codecs are integer
code copied from the JAX package: fed the same integer CDF streams they
must produce the same bytes. Container framing is held on the golden
files of ``tests/golden``.

Which goldens the port reproduces byte for byte: the LLM-coded chunks of
a golden were written by the JAX engine, and an engine is part of the
coding geometry (ROADMAP). The port's plain CDF versions take their
prefix sums in XLA's CPU order (``kernels/ref.py blocked_cumsum``), so
on the ``GoldenPredictor`` table its full-vocabulary CDF points equal
the JAX package's. Seven goldens are held exactly (decode and
re-encode): ``v3_rans_full``, ``v4_rans_full``, ``v5_rans_full``,
``v5_mixed_raw``, ``v6_mixed_raw``, ``v6_shared_full``, and
``v5_fallback_lzma`` and ``v2_full`` decode only, as in the JAX
package's own golden tests.

Open fault: ``v6_carry_topk`` (top-k CDFs) does not decode. Two rows of
the table (previous token 0 and 20) get top-k CDF points one quantum
from JAX's, and the one thing that moves them is the float32 softmax
denominator, which XLA sums with its own ``exp`` in an order no plain
order reproduces (``topk_denominators`` below). For that golden the
tests hold what the port does get right: the container parses exactly
as in JAX, and the golden input round-trips through the port's own
engine.
"""
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from helpers import (GoldenPredictor, golden_mixed_tokens,  # noqa: E402
                     golden_self_tokens, golden_text_tokens, golden_tokens)
from repro.core import ac as jac  # noqa: E402
from repro.core import baselines as jbase  # noqa: E402
from repro.core import compressor as jcomp  # noqa: E402
from repro.core import rans as jrans  # noqa: E402
from repro.core.checksum import xxh64 as jxxh64  # noqa: E402
from repro_torch.core import LLMCompressor, RouterConfig  # noqa: E402
from repro_torch.core import ac, baselines, rans  # noqa: E402
from repro_torch.core import compressor as pcomp  # noqa: E402
from repro_torch.core.checksum import xxh64  # noqa: E402

GOLDEN = pathlib.Path(__file__).parent / "golden"


def _rand_cdfs(rng, n, vocab, bits):
    pmf = rng.random((n, vocab)) + 1e-4
    q = (pmf / pmf.sum(-1, keepdims=True) * ((1 << bits) - vocab)).astype(
        np.int64) + 1
    q[np.arange(n), rng.integers(0, vocab, n)] += (1 << bits) - q.sum(-1)
    cdf = np.zeros((n, vocab + 1), np.int64)
    np.cumsum(q, axis=-1, out=cdf[:, 1:])
    return cdf


@pytest.mark.parametrize("seed,vocab,bits", [(0, 50, 16), (1, 258, 16),
                                             (2, 9, 12), (3, 1000, 20)])
def test_rans_bytes_identical(seed, vocab, bits):
    rng = np.random.default_rng(seed)
    B, T = 5, 40
    cdfs = _rand_cdfs(rng, B * T, vocab, bits).reshape(B, T, vocab + 1)
    syms = rng.integers(0, vocab, (B, T))
    valid = rng.integers(0, T + 1, B)
    out = []
    for mod in (rans, jrans):
        enc = mod.BatchedRansEncoder(B)
        for t in range(T):
            m = valid > t
            enc.put_symbols(syms[:, t], cdfs[:, t], bits, m)
            enc.put_uniform(syms[:, t] % 7, 3, m & (syms[:, t] % 2 == 0))
        out.append(enc.finish())
    assert out[0] == out[1]
    dec = rans.BatchedRansDecoder(out[0])
    for t in range(T):
        m = valid > t
        got = dec.get(cdfs[:, t], bits, m)
        assert np.array_equal(got[m], syms[m, t])
        u = dec.get_uniform(3, m & (syms[:, t] % 2 == 0))
        sel = m & (syms[:, t] % 2 == 0)
        assert np.array_equal(u[sel], syms[sel, t] % 7)


def test_slot_rans_encoder_bytes_identical():
    rng = np.random.default_rng(7)
    cdfs = _rand_cdfs(rng, 30, 20, 14)
    syms = rng.integers(0, 20, (30, 3))
    outs = []
    for mod in (rans, jrans):
        enc = mod.SlotRansEncoder(3)
        for t in range(30):
            enc.put_symbols(syms[t], np.tile(cdfs[t], (3, 1)), 14,
                            np.array([True, t % 2 == 0, t < 20]))
        outs.append([enc.flush_slot(b) for b in range(3)])
    assert outs[0] == outs[1]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ac_bytes_identical(seed):
    rng = np.random.default_rng(seed)
    cdfs = _rand_cdfs(rng, 60, 33, 16)
    syms = rng.integers(0, 33, 60)
    blob = ac.encode_sequence(list(syms), list(cdfs))
    assert blob == jac.encode_sequence(list(syms), list(cdfs))
    assert ac.decode_sequence(blob, list(cdfs)) == list(syms)


@pytest.mark.parametrize("n", [0, 1, 31, 32, 33, 100, 1000])
def test_xxh64_identical(n):
    data = np.random.default_rng(n).integers(0, 256, n).astype(
        np.uint8).tobytes()
    assert xxh64(data) == jxxh64(data)
    assert xxh64(data, seed=12345) == jxxh64(data, seed=12345)


@pytest.mark.parametrize("codec", ["raw", "lzma", "zstd"])
def test_fallback_codecs_identical(codec):
    if codec not in baselines.available_byte_codecs():
        pytest.skip(f"{codec} backend not installed")
    data = golden_text_tokens().astype(np.uint8).tobytes()
    blob = baselines.compress_bytes(codec, data)
    assert blob == jbase.compress_bytes(codec, data)
    assert jbase.decompress_bytes(codec, blob) == data


# ------------------------------------------------------------- goldens
CASES = {
    "v2_full.llmc": (dict(topk=0), golden_tokens(37, seed=77)),
    "v3_rans_full.llmc": (dict(topk=0, codec="rans"),
                          golden_tokens(37, seed=77)),
    "v4_rans_full.llmc": (dict(topk=0, codec="rans", container_version=4),
                          golden_tokens(37, seed=77)),
    "v5_rans_full.llmc": (dict(topk=0, codec="rans", container_version=5),
                          golden_tokens(37, seed=77)),
    "v5_mixed_raw.llmc": (dict(topk=8, codec="rans", container_version=5,
                               route="auto",
                               router=RouterConfig(fallbacks=("raw",))),
                          golden_mixed_tokens()),
    "v5_fallback_lzma.llmc": (dict(topk=8, codec="rans",
                                   container_version=5, route="lzma",
                                   chunk_size=64), golden_text_tokens()),
    "v6_carry_topk.llmc": (dict(topk=8, codec="rans", container_version=6,
                                context_window=8, context_stripes=2),
                           golden_self_tokens()),
    "v6_shared_full.llmc": (dict(topk=0, codec="rans", container_version=6,
                                 shared_prefix=golden_self_tokens(12,
                                                                  seed=9)),
                            golden_self_tokens(37, seed=321)),
    "v6_mixed_raw.llmc": (dict(topk=8, codec="rans", container_version=6,
                               route="auto",
                               router=RouterConfig(fallbacks=("raw",)),
                               context_window=8, context_stripes=1),
                          golden_mixed_tokens()),
}
EXACT = ["v3_rans_full.llmc", "v4_rans_full.llmc", "v5_rans_full.llmc",
         "v5_mixed_raw.llmc", "v6_mixed_raw.llmc", "v6_shared_full.llmc"]
DECODE_ONLY = ["v2_full.llmc", "v5_fallback_lzma.llmc"]
#: LLM-coded goldens (every golden but the model-free one)
LLM_CODED = sorted(set(CASES) - {"v5_fallback_lzma.llmc"})


def _comp(kw):
    base = dict(chunk_size=16, decode_batch=4)
    base.update(kw)
    return LLMCompressor(GoldenPredictor(), **base)


@pytest.mark.parametrize("name", EXACT + DECODE_ONLY)
def test_golden_decodes(name):
    kw, toks = CASES[name]
    blob = (GOLDEN / name).read_bytes()
    assert np.array_equal(_comp(kw).decompress(blob), toks)


@pytest.mark.parametrize("name", EXACT)
def test_golden_encode_byte_stable(name):
    kw, toks = CASES[name]
    blob, _ = _comp(kw).compress(toks)
    assert blob == (GOLDEN / name).read_bytes()


@pytest.mark.parametrize("name", sorted(CASES))
def test_golden_container_parses_as_in_jax(name):
    blob = (GOLDEN / name).read_bytes()
    info, streams = pcomp.parse_container(blob)
    jinfo, jstreams = jcomp.parse_container(blob)
    assert streams == jstreams
    for f in ("version", "flags", "chunk_size", "n_tokens", "vocab", "topk",
              "precision", "codec", "header_size", "n_chunks",
              "encode_batch", "ctx_budget"):
        assert getattr(info, f) == getattr(jinfo, f), f
    assert [(e.offset, e.length, e.n_tokens, e.checksum, e.codec,
             e.recipe_kind, e.recipe_param) for e in info.entries] == \
        [(e.offset, e.length, e.n_tokens, e.checksum, e.codec,
          e.recipe_kind, e.recipe_param) for e in jinfo.entries]


@pytest.mark.parametrize("name", LLM_CODED)
def test_golden_inputs_round_trip_through_the_port(name):
    """The port's own container of each LLM-coded golden's input has the
    golden's header and index geometry and decodes losslessly. This is
    all that is held for ``v6_carry_topk``, which the port cannot read
    (P1, open): at previous tokens 0 and 20 of the ``GoldenPredictor``
    table the float32 softmax denominator is 0x1.916e7ep+2 in JAX and
    0x1.916e7ap+2 in the port (row 0), 0x1.6b6d1cp+2 and 0x1.6b6d22p+2
    (row 20). The exp values differ in the last bit at 409 of 4096
    entries, but the denominator alone moves the points: JAX's
    denominator in the port's arithmetic gives JAX's CDF
    (``test_topk_cdf_differs_from_jax_only_through_the_denominator``).
    The prefix sum, the third candidate, is XLA's order already."""
    kw, toks = CASES[name]
    if name.startswith("v2"):
        kw = dict(kw, container_version=3, codec="ac")
    blob, _ = _comp(kw).compress(toks)
    assert np.array_equal(_comp(kw).decompress(blob), toks)
    ours = pcomp.read_header(blob)
    gold = pcomp.read_header((GOLDEN / name).read_bytes())
    for f in ("chunk_size", "n_tokens", "vocab", "topk", "precision",
              "n_chunks"):
        assert getattr(ours, f) == getattr(gold, f), f


def v2_full_intervals():
    """Each token of the ``v2_full`` golden input with the interval the
    JAX package and the port code it in: (position, previous token,
    symbol, JAX (lo, hi), port (lo, hi)). The coded distribution is the
    ``GoldenPredictor`` row of the previous token (BOS at a chunk start)
    over the full vocabulary, at the golden's precision."""
    from repro.core import cdf as jcdf
    from repro_torch.core import cdf as pcdf
    kw, toks = CASES["v2_full.llmc"]
    info = pcomp.read_header((GOLDEN / "v2_full.llmc").read_bytes())
    pred = GoldenPredictor()
    jc = np.asarray(jcdf.full_cdf_jit(pred._table, info.precision))
    pc = pcdf.full_cdf(torch.from_numpy(pred._table), info.precision)
    pc = pc.numpy()
    rows = []
    for i, s in enumerate(toks.tolist()):
        prev = pred.bos_id if i % info.chunk_size == 0 else int(toks[i - 1])
        rows.append((i, prev, s, (int(jc[prev, s]), int(jc[prev, s + 1])),
                     (int(pc[prev, s]), int(pc[prev, s + 1]))))
    return rows


def test_v2_full_intervals_within_one_quantum_of_jax():
    """Every interval of the v2_full input is the JAX package's exactly
    (within one quantum, as first held, and now equal) and non-empty."""
    rows = v2_full_intervals()
    assert len(rows) == CASES["v2_full.llmc"][1].size
    for _, _, _, (jlo, jhi), (lo, hi) in rows:
        assert (lo, hi) == (jlo, jhi)
        assert hi > lo


@pytest.mark.parametrize("shape", [(3, 9), (5, 16), (5, 17), (4, 64),
                                   (3, 200), (2, 4097), (2, 3, 49)])
def test_blocked_cumsum_is_xla_cumsum_bit_for_bit(shape):
    """The port's prefix sum takes XLA's CPU order: equal bits."""
    import jax.numpy as jnp
    from repro_torch.kernels import ref
    x = np.random.default_rng(sum(shape)).random(shape).astype(np.float32)
    got = ref.blocked_cumsum(torch.from_numpy(x)).numpy()
    assert np.array_equal(got, np.asarray(jnp.cumsum(jnp.asarray(x), -1)))


def topk_denominators(k=8, precision=16):
    """The top-k CDF of every ``GoldenPredictor`` row in both packages,
    and the port's CDF recomputed with JAX's float32 softmax denominator
    in its place: (JAX cdf, port cdf, port cdf with JAX's denominator,
    JAX denominators, port denominators)."""
    import jax
    import jax.numpy as jnp
    from repro.core import cdf as jcdf
    from repro_torch.kernels import ref
    table = GoldenPredictor()._table
    jcdf_rows = np.asarray(jcdf.topk_cdf_jit(table, k, precision)[1])
    jden = np.asarray(jax.jit(lambda x: jnp.sum(jnp.exp(
        x - jnp.max(x, -1, keepdims=True)), -1, keepdims=True))(table))

    def port(den=None):
        x = torch.from_numpy(table.copy())
        vals = torch.sort(x, dim=-1, descending=True, stable=True)[0][:, :k]
        m = x.max(dim=-1, keepdim=True).values
        if den is None:
            den = torch.exp(x - m).sum(dim=-1, keepdim=True)
        top_p = torch.exp(vals - m) / den
        esc = (1.0 - top_p.sum(dim=-1, keepdim=True)).clamp(0.0, 1.0)
        pmf = torch.cat([top_p, esc], dim=-1)
        pts = ref.cumulative_round(pmf / pmf.sum(dim=-1, keepdim=True),
                                   precision)
        return torch.cat([torch.zeros_like(pts[:, :1]), pts], -1), den

    pc, pden = port()
    swapped, _ = port(torch.from_numpy(jden.copy()))
    return jcdf_rows, pc.numpy(), swapped.numpy(), jden, pden.numpy()


def test_topk_cdf_differs_from_jax_only_through_the_denominator():
    """P1, open: the port's plain top-k CDF on the golden table equals
    JAX's except in rows 0 and 20, and with JAX's float32 softmax
    denominator it equals JAX's everywhere."""
    from repro_torch.kernels import ref
    jc, pc, swapped, jden, pden = topk_denominators()
    table = torch.from_numpy(GoldenPredictor()._table)
    assert np.array_equal(ref.topk_cdf(table, 8, 16)[1].numpy(), pc)
    assert np.nonzero((jc != pc).any(-1))[0].tolist() == [0, 20]
    assert np.array_equal(swapped, jc)
    assert (jden[[0, 20]] != pden[[0, 20]]).all()


def test_model_free_archive_decodes_in_both_packages():
    """Model-free (all-fallback) archives decode in both directions."""
    toks = golden_text_tokens()
    blob, _ = _comp(dict(topk=8, container_version=5, route="lzma",
                         chunk_size=64)).compress(toks)
    assert np.array_equal(jcomp.decompress_model_free(blob), toks)
    assert np.array_equal(pcomp.decompress_model_free(
        (GOLDEN / "v5_fallback_lzma.llmc").read_bytes()), toks)


if __name__ == "__main__":
    for pos, prev, sym, jax_iv, port_iv in v2_full_intervals():
        if jax_iv != port_iv:
            print(f"v2_full position {pos}: previous token {prev}, symbol "
                  f"{sym}, JAX [{jax_iv[0]}, {jax_iv[1]}), port "
                  f"[{port_iv[0]}, {port_iv[1]})")
    jc, pc, _, jden, pden = topk_denominators()
    for row in np.nonzero((jc != pc).any(-1))[0]:
        print(f"top-k row {row}: softmax denominator JAX "
              f"{float(jden[row, 0]).hex()}, port "
              f"{float(pden[row, 0]).hex()}")
