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
last bit), invariants exact.
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
