"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Every test here is marked ``cuda`` and skips without a CUDA device; on
the machine with the card run

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

This file imports no JAX (that machine has none). Tolerances as in
``test_torch_kernels.py``: attention atol 2e-5 in fp32 and 3e-2 in bf16
(the kernel sums in another order than torch's einsum; the bf16
flash-attention kernel also rounds P to bf16 for its second tensor-core
product, as the bf16 output itself is rounded); CDFs within one
quantum with equal ids (a GPU ``expf`` and a CPU ``exp`` differ in the
last bit), invariants exact. ``ssd_intra`` within 2e-5 (fp32) and 1e-4
(bf16) of the plain version's largest |value| (at least 1): both compute
in fp32 from the same inputs, in another order; the bf16 kernel splits
its fp32 factors into two bf16 parts for the tensor cores, which keeps
~16 of their 24 bits.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ops, ref  # noqa: E402

_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
DECODE_SHAPES = [(2, 4, 2, 64, 16), (3, 4, 4, 128, 32), (2, 2, 1, 96, 16),
                 (1, 8, 8, 512, 64), (16, 16, 8, 128, 128),
                 (16, 8, 4, 128, 32)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernel vs plain version)")
    return torch.device("cuda")


def _cdf_ok(cdf, precision):
    assert (cdf[:, 0] == 0).all()
    assert (cdf[:, -1] == 1 << precision).all()
    assert (np.diff(cdf, axis=-1) >= 1).all()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,H,K,S,hd", DECODE_SHAPES)
def test_decode_attention_kernel_vs_plain(cuda, B, H, K, S, hd, dtype):
    rng = np.random.default_rng(S + hd)
    t = lambda shape: torch.from_numpy(rng.normal(size=shape).astype(  # noqa
        np.float32)).to(device=cuda, dtype=_DT[dtype])
    q, kc, vc = t((B, H, hd)), t((B, S, K, hd)), t((B, S, K, hd))
    lens = torch.from_numpy(rng.integers(1, S + 1, B).astype(
        np.int32)).to(cuda)
    out = ops.decode_attention(q, kc, vc, lens)
    want = ref.decode_attention(q, kc, vc, lens)
    tol = 2e-5 if dtype == "float32" else 3e-2
    np.testing.assert_allclose(out.float().cpu().numpy(),
                               want.float().cpu().numpy(), atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("R,V,k,dtype", [
    (4, 512, 16, "float32"), (3, 1000, 48, "float32"),
    (16, 258, 48, "float32"), (16, 151936, 48, "bfloat16"),
])
def test_topk_cdf_kernel_vs_plain(cuda, R, V, k, dtype):
    lg = torch.from_numpy(np.random.default_rng(V).normal(
        size=(R, V)).astype(np.float32)).to(cuda, _DT[dtype])
    ids, cdf = ops.topk_cdf(lg, k, 16)
    ids_r, cdf_r = ref.topk_cdf(lg, k, 16)
    assert torch.equal(ids, ids_r)
    assert (cdf - cdf_r).abs().max().item() <= 1
    _cdf_ok(cdf.cpu().numpy(), 16)


@pytest.mark.cuda
@pytest.mark.parametrize("R,V,prec,dtype", [
    (4, 256, 16, "float32"), (3, 4096, 18, "float32"),
    (16, 258, 16, "float32"), (16, 151936, 18, "bfloat16"),
])
def test_cdf_points_kernel_vs_plain(cuda, R, V, prec, dtype):
    lg = torch.from_numpy(np.random.default_rng(V).normal(
        size=(R, V)).astype(np.float32) * 3).to(cuda, _DT[dtype])
    pts = ops.cdf_points(lg, prec)
    want = ref.cdf_points(lg, prec)
    assert (pts - want).abs().max().item() <= 1
    p = pts.cpu().numpy()
    assert (np.diff(p, axis=-1) >= 1).all() and (p[:, -1] == 1 << prec).all()


FLASH_CASES = [
    # (B, H, K, Sq, Sk, hd, causal, window)
    (16, 16, 8, 128, 128, 128, True, None),     # qwen3-1.7b score_chunks
    (8, 16, 8, 32, 32, 128, True, None),        # the router probe
    (4, 16, 8, 160, 160, 128, True, None),      # a 32-token prefix
    (2, 4, 2, 100, 100, 64, True, None),        # ragged tiles
    (2, 4, 4, 96, 96, 32, True, 16),            # sliding window
    (2, 4, 1, 130, 130, 64, True, 48),
    (2, 4, 2, 70, 70, 64, False, None),
    (2, 4, 2, 70, 70, 64, False, 16),
    (2, 4, 2, 50, 130, 64, False, None),        # Sq != Sk
    (1, 2, 1, 17, 17, 8, True, None),           # hd 8, 24, 40, 120
    (1, 2, 2, 33, 33, 24, True, None),
    (1, 3, 1, 65, 65, 40, True, None),
    (1, 2, 1, 64, 64, 120, True, None),
    (16, 8, 4, 128, 128, 32, True, None),       # pred-base
]


def _flash_inputs(cuda, B, H, K, Sq, Sk, hd, dtype, layout="bhsd"):
    rng = np.random.default_rng(B * 1000 + Sq + hd)
    t = lambda shape: torch.from_numpy(rng.normal(size=shape).astype(  # noqa
        np.float32)).to(device=cuda, dtype=_DT[dtype])
    if layout == "bshd":              # the model's layout, as views
        return (t((B, Sq, H, hd)).transpose(1, 2),
                t((B, Sk, K, hd)).transpose(1, 2),
                t((B, Sk, K, hd)).transpose(1, 2))
    return t((B, H, Sq, hd)), t((B, K, Sk, hd)), t((B, K, Sk, hd))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,H,K,Sq,Sk,hd,causal,window", FLASH_CASES)
def test_flash_attention_kernel_vs_plain(cuda, B, H, K, Sq, Sk, hd, causal,
                                         window, dtype):
    for layout in ("bhsd", "bshd"):
        q, k, v = _flash_inputs(cuda, B, H, K, Sq, Sk, hd, dtype, layout)
        n0 = ops.LAUNCHES["flash_attention"]
        out = ops.flash_attention(q, k, v, causal, window)
        assert ops.LAUNCHES["flash_attention"] == n0 + 1
        want = ref.flash_attention(q, k, v, causal, window)
        assert out.shape == want.shape and out.dtype == want.dtype
        tol = 2e-5 if dtype == "float32" else 3e-2
        np.testing.assert_allclose(out.float().cpu().numpy(),
                                   want.float().cpu().numpy(), atol=tol)


@pytest.mark.cuda
def test_flash_attention_lanes_are_independent(cuda):
    """A lane's output is bit-identical whatever the other lanes hold."""
    q, k, v = _flash_inputs(cuda, 6, 16, 8, 128, 128, 128, "bfloat16")
    a = ops.flash_attention(q, k, v)
    perm = torch.tensor([3, 0, 5, 1, 4, 2], device=cuda)
    b = ops.flash_attention(q[perm], k[perm], v[perm])
    assert torch.equal(a[perm], b)
    assert torch.equal(ops.flash_attention(q[:2], k[:2], v[:2]), a[:2])


@pytest.mark.cuda
@pytest.mark.parametrize("bad", ["hd12", "hd136", "gqa", "float16",
                                 "stride", "window0"])
def test_flash_attention_wrapper_refuses(cuda, bad):
    hd = {"hd12": 12, "hd136": 136}.get(bad, 64)
    dt = torch.float16 if bad == "float16" else torch.bfloat16
    q = torch.zeros((1, 4, 8, hd), device=cuda, dtype=dt)
    k = torch.zeros((1, 3 if bad == "gqa" else 2, 8, hd), device=cuda,
                    dtype=dt)
    v = k.clone()
    if bad == "stride":
        q = torch.zeros((1, 4, hd, 8), device=cuda, dtype=dt).transpose(2, 3)
    with pytest.raises(ValueError):
        ops.flash_attention(q, k, v, True, 0 if bad == "window0" else None)


SSD_CASES = [
    # (R, Q, H, P, N): the mamba2-130m scoring path (chip_smoke.py phase 2)
    (16, 128, 24, 64, 128),     # score_chunks, 16 chunks x 128
    (23, 32, 24, 64, 128),      # the router probe
    (16, 160, 24, 64, 128),     # under a 32-token prefix
    (32, 256, 24, 64, 128),     # S = 512: two chunks of 256 per lane
    (16, 16, 8, 16, 16),        # the tiny test width
    (3, 23, 2, 8, 4),           # ragged Q, P and N
    (2, 100, 3, 40, 72),
]


def _ssd_inputs(cuda, R, Q, H, P, N, dtype, strided):
    """Inputs drawn as in tests/test_kernels.py. ``strided``: x, B and C
    as views of one (R, Q, H*P + 2N) tensor, as the model passes them."""
    rng = np.random.default_rng(R * Q + P + N)
    dt_ = _DT[dtype]
    if strided:
        conv = torch.from_numpy(rng.normal(size=(R, Q, H * P + 2 * N))
                                .astype(np.float32)).to(cuda, dt_)
        x, Bm, Cm = torch.split(conv, [H * P, N, N], dim=-1)
        x = x.reshape(R, Q, H, P)
    else:
        x, Bm, Cm = (torch.from_numpy(rng.normal(size=s).astype(
            np.float32)).to(cuda, dt_) for s in ((R, Q, H, P), (R, Q, N),
                                                 (R, Q, N)))
    dt = torch.from_numpy(rng.uniform(0.05, 0.8, (R, Q, H)).astype(
        np.float32)).to(cuda, dt_)
    A = torch.from_numpy(-rng.uniform(0.3, 2.0, (H,)).astype(
        np.float32)).to(cuda)
    return x, dt, A, Bm, Cm


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("R,Q,H,P,N", SSD_CASES)
def test_ssd_intra_kernel_vs_plain(cuda, R, Q, H, P, N, dtype):
    for strided in (False, True):
        args = _ssd_inputs(cuda, R, Q, H, P, N, dtype, strided)
        n0 = ops.LAUNCHES["ssd_intra"]
        y, s = ops.ssd_intra(*args)
        assert ops.LAUNCHES["ssd_intra"] == n0 + 1
        yr, sr = ref.ssd_intra(*args)
        tol = 2e-5 if dtype == "float32" else 1e-4
        for got, want in ((y, yr), (s, sr)):
            assert got.shape == want.shape and got.dtype == torch.float32
            scale = max(1.0, want.abs().max().item())
            assert (got - want).abs().max().item() <= tol * scale


@pytest.mark.cuda
def test_ssd_intra_chunks_are_independent(cuda):
    """A chunk's result is bit-identical whatever the other chunks hold."""
    x, dt, A, Bm, Cm = _ssd_inputs(cuda, 6, 160, 24, 64, 128, "bfloat16",
                                   True)
    y, s = ops.ssd_intra(x, dt, A, Bm, Cm)
    perm = torch.tensor([3, 0, 5, 1, 4, 2], device=cuda)
    y2, s2 = ops.ssd_intra(x[perm], dt[perm], A, Bm[perm], Cm[perm])
    assert torch.equal(y[perm], y2) and torch.equal(s[perm], s2)
    y3, s3 = ops.ssd_intra(x[:2], dt[:2], A, Bm[:2], Cm[:2])
    assert torch.equal(y3, y[:2]) and torch.equal(s3, s[:2])


@pytest.mark.cuda
@pytest.mark.parametrize("bad", ["P72", "N136", "float16", "mixed",
                                 "stride", "A_bf16"])
def test_ssd_intra_wrapper_refuses(cuda, bad):
    P = 72 if bad == "P72" else 16
    N = 136 if bad == "N136" else 16
    dt_ = torch.float16 if bad == "float16" else torch.bfloat16
    x = torch.zeros((2, 8, 3, P), device=cuda, dtype=dt_)
    dt = torch.zeros((2, 8, 3), device=cuda,
                     dtype=torch.float32 if bad == "mixed" else dt_)
    A = torch.zeros((3,), device=cuda,
                    dtype=torch.bfloat16 if bad == "A_bf16"
                    else torch.float32)
    Bm = torch.zeros((2, 8, N), device=cuda, dtype=dt_)
    if bad == "stride":
        x = torch.zeros((2, 8, P, 3), device=cuda,
                        dtype=dt_).transpose(2, 3)
    with pytest.raises(ValueError):
        ops.ssd_intra(x, dt, A, Bm, Bm.clone())
