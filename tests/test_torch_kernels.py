"""The port's kernels (``repro_torch.kernels``) against the JAX package's.

On the CPU each wrapper runs its kernel's plain PyTorch version; these
tests hold that version against the Pallas kernels as ``test_kernels.py``
runs them (``interpret=True``) and against ``repro.kernels.ref``, at that
file's shapes. Tolerances: attention atol 2e-5 in fp32 and 3e-2 in bf16;
integer CDFs within one quantum with the same top-k ids — a float
reduction taken in another order can move cum * budget across a .5
boundary (test_kernels.py:17-20), so exact equality is not promised —
while the coder invariants (cdf[0] == 0, strictly increasing, last ==
2**precision) hold exactly.

The CUDA kernels themselves are held against these plain versions on a
card by ``tests/test_torch_cuda.py``.
"""
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.ac_cdf import cdf_points as j_cdf_points  # noqa: E402
from repro.kernels.ac_cdf import topk_cdf_points as j_topk  # noqa: E402
from repro.kernels.decode_attention import \
    decode_attention as j_decode  # noqa: E402
from repro_torch.kernels import build, ops, ref  # noqa: E402

_topk_ref = jax.jit(jref.topk_cdf_ref, static_argnums=(1, 2))
_DT = {"float32": (jnp.float32, torch.float32),
       "bfloat16": (jnp.bfloat16, torch.bfloat16)}

DECODE_SHAPES = [(2, 4, 2, 64, 16, 16), (3, 4, 4, 128, 32, 32),
                 (2, 2, 1, 96, 16, 32), (1, 8, 8, 512, 64, 128)]


def _decode_inputs(B, H, K, S, hd, seed):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, H, hd)).astype(np.float32)
    kc = rng.normal(size=(B, K, S, hd)).astype(np.float32)
    vc = rng.normal(size=(B, K, S, hd)).astype(np.float32)
    lens = rng.integers(1, S + 1, B).astype(np.int32)
    return q, kc, vc, lens


def _port_attention(q, kc, vc, lens, tdt, device="cpu"):
    """The port takes the model's (B, S, K, hd) cache layout."""
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(  # noqa
        device=device, dtype=tdt)
    return ops.decode_attention(t(q), t(kc.transpose(0, 2, 1, 3)),
                                t(vc.transpose(0, 2, 1, 3)),
                                torch.from_numpy(lens).to(device))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,H,K,S,hd,blk", DECODE_SHAPES)
def test_decode_attention_vs_pallas(B, H, K, S, hd, blk, dtype):
    q, kc, vc, lens = _decode_inputs(B, H, K, S, hd, seed=S + hd)
    jdt, tdt = _DT[dtype]
    args = (jnp.asarray(q, jdt), jnp.asarray(kc, jdt), jnp.asarray(vc, jdt),
            jnp.asarray(lens))
    want = np.asarray(j_decode(*args, block_k=blk, interpret=True),
                      np.float32)
    oracle = np.asarray(jref.decode_attention_ref(*args), np.float32)
    out = _port_attention(q, kc, vc, lens, tdt).float().numpy()
    tol = 2e-5 if dtype == "float32" else 3e-2
    np.testing.assert_allclose(out, want, atol=tol)
    np.testing.assert_allclose(out, oracle, atol=tol)


def _cdf_ok(cdf, precision):
    assert (cdf[:, 0] == 0).all()
    assert (cdf[:, -1] == 1 << precision).all()
    assert (np.diff(cdf, axis=-1) >= 1).all()


@pytest.mark.parametrize("B,V,k,prec", [
    (4, 512, 16, 16), (2, 1024, 48, 16), (1, 256, 8, 14),
])
def test_topk_cdf_single_block_vs_oracle(B, V, k, prec):
    lg = (np.random.default_rng(V + k).normal(size=(B, V)) * 3).astype(
        np.float32)
    ids_r, cdf_r = (np.asarray(a) for a in _topk_ref(jnp.asarray(lg), k,
                                                       prec))
    ids, cdf = (a.numpy() for a in ops.topk_cdf(torch.from_numpy(lg), k,
                                                  prec))
    assert np.array_equal(ids, ids_r)
    assert np.abs(cdf - cdf_r).max() <= 1
    _cdf_ok(cdf, prec)


@pytest.mark.parametrize("B,V,k,bv,prec", [
    (4, 512, 16, 128, 16), (2, 1024, 32, 256, 16), (3, 512, 8, 64, 14),
])
def test_topk_cdf_multi_block_vs_pallas(B, V, k, bv, prec):
    lg = (np.random.default_rng(bv + k).normal(size=(B, V)) * 3).astype(
        np.float32)
    ids_p, cdf_p = (np.asarray(a) for a in j_topk(
        jnp.asarray(lg), k, prec, block_v=bv, interpret=True))
    ids, cdf = (a.numpy() for a in ops.topk_cdf(torch.from_numpy(lg), k,
                                                  prec))
    assert np.array_equal(ids, ids_p)
    assert np.abs(cdf - cdf_p).max() <= 1
    _cdf_ok(cdf, prec)


@pytest.mark.parametrize("V", [258, 1000])
def test_topk_cdf_ragged_vocab_vs_flat_oracle(V):
    """No vocab block divides V here; the port needs none."""
    lg = (np.random.default_rng(V).normal(size=(3, V)) * 3).astype(
        np.float32)
    ids_r, cdf_r = (np.asarray(a) for a in _topk_ref(jnp.asarray(lg), 48,
                                                       16))
    ids, cdf = (a.numpy() for a in ops.topk_cdf(torch.from_numpy(lg), 48,
                                                  16))
    assert np.array_equal(ids, ids_r)
    assert np.abs(cdf - cdf_r).max() <= 1
    _cdf_ok(cdf, 16)


def test_topk_cdf_ties_go_to_smallest_id():
    """bf16 logits tie often; lax.top_k orders ties by ascending id, and
    so must the port (torch.topk promises no order)."""
    rng = np.random.default_rng(3)
    lg = np.round(rng.normal(size=(4, 600)) * 4) / 4     # heavy ties
    lg = lg.astype(np.float32)
    ids_r, cdf_r = (np.asarray(a) for a in _topk_ref(jnp.asarray(lg), 32,
                                                       16))
    ids, cdf = (a.numpy() for a in ops.topk_cdf(torch.from_numpy(lg), 32,
                                                  16))
    assert np.array_equal(ids, ids_r)
    assert np.abs(cdf - cdf_r).max() <= 1


def test_topk_cdf_padded_vocab():
    """Pad logits masked to -1e30 never enter the top-k, and the CDF
    invariants survive an exactly-zero probability tail."""
    lg = (np.random.default_rng(5).normal(size=(2, 512)) * 3).astype(
        np.float32)
    lg[:, 400:] = ref.NEG_INF
    ids, cdf = (a.numpy() for a in ops.topk_cdf(torch.from_numpy(lg), 16,
                                                  16))
    assert (ids < 400).all()
    ids_r, _ = _topk_ref(jnp.asarray(lg), 16, 16)
    assert np.array_equal(ids, np.asarray(ids_r))
    _cdf_ok(cdf, 16)


@pytest.mark.parametrize("B,V,bv,prec", [
    (4, 256, 64, 16), (2, 1024, 256, 16), (1, 512, 512, 14),
    (3, 4096, 1024, 18),
])
def test_cdf_points_vs_pallas(B, V, bv, prec):
    lg = (np.random.default_rng(V + bv).normal(size=(B, V)) * 3).astype(
        np.float32)
    want = np.asarray(j_cdf_points(jnp.asarray(lg), prec, block_v=bv,
                                   interpret=True))
    pts = ops.cdf_points(torch.from_numpy(lg), prec).numpy()
    assert np.abs(pts - want).max() <= 1
    assert (np.diff(pts, axis=-1) >= 1).all()
    assert (pts[:, -1] == 1 << prec).all()
    assert (pts[:, 0] >= 1).all()


@pytest.mark.parametrize("case", ["peaky", "flat", "ramp", "padded"])
def test_cdf_points_drift_prone_vs_pallas(case):
    """test_kernels.py's drift-prone rows (near-delta, near-uniform over
    many blocks, a ramp, a padded zero tail): the tail is exact, the
    points strictly increase, and the Pallas integers are within one
    quantum."""
    B, V, bv, prec = 3, 4096, 128, 16
    rng = np.random.default_rng(7)
    if case == "peaky":
        lg = rng.standard_normal((B, V)).astype(np.float32) * 40.0
    elif case == "flat":
        lg = rng.standard_normal((B, V)).astype(np.float32) * 1e-3
    elif case == "ramp":
        lg = np.tile(np.linspace(-5, 5, V, dtype=np.float32), (B, 1))
    else:
        lg = rng.standard_normal((B, V)).astype(np.float32) * 3.0
        lg[:, V // 2:] = jref.NEG_INF
    want = np.asarray(j_cdf_points(jnp.asarray(lg), prec, block_v=bv,
                                   interpret=True))
    pts = ops.cdf_points(torch.from_numpy(lg), prec).numpy()
    assert (pts[:, -1] == 1 << prec).all()
    assert (np.diff(pts, axis=-1) >= 1).all()
    assert (pts[:, 0] >= 1).all()
    assert np.abs(pts - want).max() <= 1


def test_wrappers_refuse_other_devices():
    """A tensor that is neither on the CPU nor on a card gets an error,
    never the plain version."""
    q = torch.empty((1, 2, 16), device="meta")
    kc = torch.empty((1, 8, 2, 16), device="meta")
    lens = torch.empty((1,), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        ops.decode_attention(q, kc, kc, lens)
    with pytest.raises(ValueError):
        ops.topk_cdf(torch.empty((2, 64), device="meta"), 8, 16)
    with pytest.raises(ValueError):
        ops.cdf_points(torch.empty((2, 64), device="meta"), 16)


def test_cpu_calls_do_not_count_as_launches():
    ops.reset_launches()
    lg = torch.randn(2, 64)
    ops.topk_cdf(lg, 8, 16)
    ops.cdf_points(lg, 16)
    assert all(v == 0 for v in ops.LAUNCHES.values())


def test_library_name_tracks_sources_and_flags():
    """A built library is reused only for the same sources and flags."""
    paths = {n: build.library_path(n) for n in build.KERNELS}
    assert len(set(paths.values())) == len(build.KERNELS)
    for name, p in paths.items():
        assert p.parent == build.BUILD_DIR
        assert p.name.startswith(f"lib{name}-")
        assert (build.CSRC / build.KERNELS[name][0]).exists()
    assert "arch=compute_90a,code=sm_90a" in build.ARCH


def test_build_dir_stays_inside_the_checkout(monkeypatch, tmp_path):
    """Libraries are built into the checkout's build/, or where
    $REPRO_TORCH_BUILD_DIR says; never beside an installed package."""
    root = pathlib.Path(__file__).resolve().parents[1]
    monkeypatch.delenv("REPRO_TORCH_BUILD_DIR", raising=False)
    assert build.build_dir() == root / "build" / "repro_torch"
    monkeypatch.setenv("REPRO_TORCH_BUILD_DIR", str(tmp_path))
    assert build.build_dir() == tmp_path
