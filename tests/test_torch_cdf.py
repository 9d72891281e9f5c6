"""The port's ``core/cdf.py`` against the JAX package's ``core/cdf.py``.

Same logits (numpy, from a seed, and the ``GoldenPredictor`` table) go
through both. Top-k ids must be equal; CDF integers within one quantum
(one ulp of float reduction order can move cum * budget across a .5
boundary, test_kernels.py:17-20); the coder invariants exact.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from helpers import GoldenPredictor  # noqa: E402
from repro.core import cdf as jcdf  # noqa: E402
from repro_torch.core import cdf  # noqa: E402


def _logits(B, V, seed, scale=3.0):
    return (np.random.default_rng(seed).normal(size=(B, V)) * scale).astype(
        np.float32)


def _invariants(c, precision):
    c = np.asarray(c)
    assert (c[..., 0] == 0).all()
    assert (c[..., -1] == 1 << precision).all()
    assert (np.diff(c, axis=-1) >= 1).all()


CASES = [(4, 258, 48, 16), (3, 1000, 16, 16), (2, 64, 8, 12),
         (5, 4096, 48, 18)]


@pytest.mark.parametrize("B,V,k,prec", CASES)
def test_topk_cdf_matches_jax(B, V, k, prec):
    lg = _logits(B, V, seed=V + k)
    ids_j, cdf_j = (np.asarray(a) for a in jcdf.topk_cdf_jit(
        jnp.asarray(lg), k, prec))
    ids, c = (cdf.to_numpy(a) for a in cdf.topk_cdf(lg, k, prec))
    assert ids.dtype == np.int32 and c.dtype == np.int32
    assert np.array_equal(ids, ids_j)
    assert np.abs(c - cdf_j).max() <= 1
    _invariants(c, prec)


@pytest.mark.parametrize("B,V,k,prec", CASES)
def test_topk_quantized_matches_jax(B, V, k, prec):
    lg = _logits(B, V, seed=2 * V + k)
    ids_j, q_j = (np.asarray(a) for a in jcdf.topk_quantized_jit(
        jnp.asarray(lg), k, prec))
    ids, q = (cdf.to_numpy(a) for a in cdf.topk_quantized(lg, k, prec))
    assert np.array_equal(ids, ids_j)
    assert (q >= 1).all() and (q.sum(-1) == 1 << prec).all()
    assert np.abs(np.cumsum(q, -1) - np.cumsum(q_j, -1)).max() <= 1
    ids_b, cdf_b = cdf.build_topk_cdfs(ids, q)
    assert np.array_equal(cdf_b, cdf.to_numpy(cdf.topk_cdf(lg, k, prec)[1]))


@pytest.mark.parametrize("B,V,prec", [(4, 258, 16), (3, 1000, 16),
                                      (2, 4096, 18)])
def test_full_cdf_matches_jax(B, V, prec):
    lg = _logits(B, V, seed=V)
    want = np.asarray(jcdf.full_cdf_jit(jnp.asarray(lg), prec))
    got = cdf.to_numpy(cdf.full_cdf(lg, prec))
    assert got.shape == (B, V + 1)
    assert np.abs(got - want).max() <= 1
    _invariants(got, prec)
    host = cdf.logits_to_cdf(lg, prec)
    assert host.dtype == np.int64 and np.array_equal(host, got)
    assert np.abs(host - jcdf.logits_to_cdf(lg, prec)).max() <= 1


@pytest.mark.parametrize("k", [0, 8])
def test_golden_table_cdfs_match_jax(k):
    """The GoldenPredictor's (64, 64) next-token table: every row."""
    tab = GoldenPredictor()._table
    if k:
        ids_j, cdf_j = (np.asarray(a) for a in jcdf.topk_cdf_jit(
            jnp.asarray(tab), k, 16))
        ids, c = (cdf.to_numpy(a) for a in cdf.topk_cdf(tab, k, 16))
        assert np.array_equal(ids, ids_j)
    else:
        cdf_j = np.asarray(jcdf.full_cdf_jit(jnp.asarray(tab), 16))
        c = cdf.to_numpy(cdf.full_cdf(tab, 16))
    assert np.abs(c - cdf_j).max() <= 1
    _invariants(c, 16)


def test_topk_lookup_is_consistent_with_cdf():
    lg = _logits(6, 300, seed=11)
    rng = np.random.default_rng(12)
    slots = rng.integers(0, 1 << 16, 6).astype(np.int32)
    ids, c, syms, starts, freqs = (cdf.to_numpy(a) for a in
                                   cdf.topk_cdf_lookup(lg, slots, 24, 16))
    rows = np.arange(6)
    assert (c[rows, syms] <= slots).all() and (slots < c[rows, syms + 1]).all()
    assert np.array_equal(starts, c[rows, syms])
    assert np.array_equal(freqs, c[rows, syms + 1] - c[rows, syms])
    # the JAX lookup on the same slots picks the same symbols wherever the
    # two CDFs agree around the slot
    j = [np.asarray(a) for a in jcdf.topk_cdf_lookup_jit(
        jnp.asarray(lg), jnp.asarray(slots), 24, 16)]
    same = (j[1] == c).all(axis=-1)
    assert np.array_equal(j[2][same], syms[same])


def test_full_lookup_is_consistent_with_cdf():
    lg = _logits(5, 258, seed=13)
    slots = np.random.default_rng(14).integers(0, 1 << 16, 5).astype(
        np.int32)
    syms, starts, freqs = (cdf.to_numpy(a) for a in
                           cdf.full_cdf_lookup(lg, slots, 16))
    c = cdf.logits_to_cdf(lg, 16)
    rows = np.arange(5)
    assert (c[rows, syms] <= slots).all() and (slots < c[rows, syms + 1]).all()
    assert np.array_equal(starts, c[rows, syms])
    assert np.array_equal(freqs, c[rows, syms + 1] - c[rows, syms])


def test_rows_do_not_depend_on_the_batch():
    """The grouped encoder calls the CDF on (B*C, V) rows and the decoder
    on (B, V): a row's integers must not depend on its neighbours."""
    lg = _logits(6, 500, seed=17).reshape(2, 3, 500)
    ids, c = (cdf.to_numpy(a) for a in cdf.topk_cdf(lg, 32, 16))
    assert ids.shape == (2, 3, 32) and c.shape == (2, 3, 34)
    for i in range(2):
        for j in range(3):
            ids1, c1 = (cdf.to_numpy(a) for a in
                        cdf.topk_cdf(lg[i, j][None], 32, 16))
            assert np.array_equal(ids1[0], ids[i, j])
            assert np.array_equal(c1[0], c[i, j])
    full = cdf.to_numpy(cdf.full_cdf(lg, 16))
    assert np.array_equal(cdf.to_numpy(cdf.full_cdf(lg[1, 2], 16)),
                          full[1, 2])


def test_device_tensors_and_arrays_agree():
    lg = _logits(3, 258, seed=19)
    a = cdf.to_numpy(cdf.topk_cdf(lg, 48, 16)[1])
    b = cdf.to_numpy(cdf.topk_cdf(torch.from_numpy(lg), 48, 16)[1])
    c = cdf.to_numpy(cdf.topk_cdf(torch.from_numpy(lg).to(torch.bfloat16)
                                  .float(), 48, 16)[1])
    assert np.array_equal(a, b) and c.shape == a.shape


def test_precision_too_small_raises():
    with pytest.raises(ValueError):
        cdf.quantize_cdf_points(np.full((1, 300), 1 / 300, np.float32), 8)
    with pytest.raises(ValueError):
        cdf.full_cdf(_logits(1, 300, seed=1), 8)


def test_quantize_pmf_and_pmf_to_cdf_match_jax():
    p = np.random.default_rng(23).random((4, 50)).astype(np.float32)
    p /= p.sum(-1, keepdims=True)
    q = cdf.to_numpy(cdf.quantize_pmf(p, 16))
    qj = np.asarray(jcdf.quantize_pmf(jnp.asarray(p), 16))
    assert (q >= 1).all() and (q.sum(-1) == 1 << 16).all()
    assert np.abs(np.cumsum(q, -1) - np.cumsum(qj, -1)).max() <= 1
    assert np.array_equal(cdf.pmf_to_cdf(qj), jcdf.pmf_to_cdf(qj))


def test_coding_cost_bits_matches_jax():
    lg = _logits(8, 64, seed=29)
    toks = np.random.default_rng(30).integers(0, 64, 8)
    assert cdf.coding_cost_bits(lg, toks) == pytest.approx(
        jcdf.coding_cost_bits(lg, toks), rel=1e-5)
