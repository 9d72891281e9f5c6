"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Every test here is marked ``cuda`` and skips without a CUDA device; on
the machine with the card run

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

This file imports no JAX (that machine has none). Attention is held
against the plain version computed in fp32 on the same inputs
(``_attention_close``): atol 2e-5 in fp32 (the kernel sums in another
order than torch's einsum); in bf16, 2**-7 of each output row's largest
|value| and 3e-2 absolute, as ``chip_smoke.py`` holds it (rounding the
output to bf16 moves a value by up to 2**-8 of itself, and the bf16
flash-attention kernel also rounds P to bf16 for its second tensor-core
product; 3e-2 alone is the size of the output itself over thousands of
positions). CDFs within one quantum with equal ids (a GPU ``expf`` and
a CPU ``exp`` differ in the last bit), invariants exact. ``ssd_intra``
within 2e-5 (fp32) and 1e-4 (bf16) of the plain version's largest
|value| (at least 1): both compute
in fp32 from the same inputs, in another order; the bf16 kernel splits
its fp32 factors into two bf16 parts for the tensor cores, which keeps
~16 of their 24 bits.

The captured decode programs (``serve/graphs.py``) are held against the
eager step bit for bit (logits and every cache leaf), for the four
families (the hybrid with a trailing SSD layer, the moe with G = 16) in
fp32 and bf16, on
fresh lanes, after a lane reset, after ``restore_slot`` and after a
speculative ``rollback``; the launch counters against captured launches
x replays (dense, hybrid and moe); and a cache of another length
against its own capture. A moe lane's logits are bit-identical whatever
the other lanes hold, through the captured step. The decode kernel takes
groups of up to 16 q-heads per kv-head (qwen3-moe-235b-a22b's G = 16). Kernels also run at zamba2-7b's shapes (hd 112 and G = 1,
H = 112 and N = 64, V = 32000).

The int8 decode-attention kernel (``ops.decode_attention_int8``) is held
against its plain version (dequantize, then attend) at the tolerances
above, and bit for bit against the bf16 / fp32 kernel on the dequantized
cache: the two share the geometry and every sum, and the int8 kernel's
dequantized values are the plain version's. The dense family's int8 and
sliding-window ring caches (tiny h2o-danube-3-4b: hd 24, a ring of 8)
join the captured-step checks, and a captured verify round that crosses
the ring's wrap, rolled back to the inputs each lane kept, equals a
captured lock-step cache that took only those inputs, bit for bit; so
does speculative decompression across the wrap.

Training and sampling on the card: a ``pred-tiny`` train step against
the same step on the CPU (loss within 1e-4, every gradient nonzero and
within 1e-3 of the leaf's largest |g|, no kernel launched), and
``generate`` through the captured step against ``generate`` through the
eager step from the same generator seed: the same tokens.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import base as pbase  # noqa: E402
from repro_torch.configs import h2o_danube_3_4b as ph2o  # noqa: E402
from repro_torch.configs import mamba2_130m as pmamba  # noqa: E402
from repro_torch.configs import qwen3_1_7b as pqwen  # noqa: E402
from repro_torch.configs import qwen3_moe_235b_a22b as pqmoe  # noqa: E402
from repro_torch.configs import whisper_large_v3 as pwhisper  # noqa: E402
from repro_torch.configs import zamba2_7b as pzamba  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.models import api as model_api  # noqa: E402
from repro_torch.serve import graphs  # noqa: E402
from repro_torch.serve.engine import ModelPredictor  # noqa: E402

_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
DECODE_SHAPES = [(2, 4, 2, 64, 16), (3, 4, 4, 128, 32), (2, 2, 1, 96, 16),
                 (1, 8, 8, 512, 64), (16, 16, 8, 128, 128),
                 (16, 8, 4, 128, 32),
                 # G 16: qwen3-moe-235b-a22b's 64 q-heads over 4 kv-heads,
                 # and 16 over 1 at hd 64
                 (16, 64, 4, 128, 128), (3, 16, 1, 96, 64),
                 # whisper-large-v3's cross-attention: S 1,500, not a
                 # multiple of the 32-position tile (8 CTAs of 192)
                 (16, 32, 32, 1500, 64)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernel vs plain version)")
    return torch.device("cuda")


def _attention_close(out, want32, dtype):
    """``out`` against the fp32 plain version ``want32``: 2e-5 absolute
    in fp32; in bf16 2**-7 of the largest |value| of each row (the last
    axis), and 3e-2 absolute."""
    err = (out.float() - want32).abs()
    if dtype in ("float32", torch.float32):
        assert err.max().item() <= 2e-5
    else:
        row = want32.abs().amax(-1, keepdim=True).clamp_min(1e-30)
        assert (err / row).max().item() <= 2.0 ** -7
        assert err.max().item() <= 3e-2


def _f32(*ts):
    return [t.float() for t in ts]


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
    _attention_close(out, ref.decode_attention(*_f32(q, kc, vc), lens),
                     dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("R,V,k,dtype", [
    (4, 512, 16, "float32"), (3, 1000, 48, "float32"),
    (16, 258, 48, "float32"), (16, 151936, 48, "bfloat16"),
    (16, 32000, 48, "bfloat16"),                # zamba2-7b
])
def test_topk_cdf_kernel_vs_plain(cuda, R, V, k, dtype):
    lg = torch.from_numpy(np.random.default_rng(V).normal(
        size=(R, V)).astype(np.float32)).to(cuda, _DT[dtype])
    ids, cdf = ops.topk_cdf(lg, k, 16)
    ids_r, cdf_r = ref.topk_cdf(lg, k, 16)
    assert torch.equal(ids, ids_r)
    assert (cdf - cdf_r).abs().max().item() <= 1
    _cdf_ok(cdf.cpu().numpy(), 16)


def _topk_check(lg, k, prec=16):
    ids, cdf = ops.topk_cdf(lg, k, prec)
    ids_r, cdf_r = ref.topk_cdf(lg, k, prec)
    assert torch.equal(ids, ids_r)
    assert (cdf - cdf_r).abs().max().item() <= 1
    _cdf_ok(cdf.cpu().numpy(), prec)
    return ids, cdf


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("V,padded", [
    (258, None), (1000, None), (4097, None), (50280, None),
    (151936, 152064), (258, 258 + 5),
])
def test_topk_cdf_ragged_slices(cuda, V, padded, dtype):
    """V that no slice width divides, rows as views of wider (padded)
    rows, misaligned row starts (a 263-wide stride)."""
    full = torch.from_numpy(np.random.default_rng(V).normal(
        size=(16, padded or V)).astype(np.float32) * 3).to(cuda, _DT[dtype])
    _topk_check(full[:, :V], 48)


@pytest.mark.cuda
def test_topk_cdf_unstaged_slices(cuda):
    """A slice too large for shared memory is read from global memory."""
    V = 500_000
    assert not ops.topk_cdf_geometry(V, torch.float32)[2]
    lg = torch.from_numpy(np.random.default_rng(1).normal(
        size=(3, V)).astype(np.float32)).to(cuda)
    _topk_check(lg, 48)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("V", [4097, 50280, 151936])
def test_topk_cdf_threshold_tied_across_slices(cuda, V, dtype):
    """The k-th value sits in several slices: the smallest ids win."""
    k = 48
    _, width, _ = ops.topk_cdf_geometry(V, _DT[dtype])
    rng = np.random.default_rng(V + 1)
    lg = rng.uniform(-4, 0, size=(4, V)).astype(np.float32)
    top = rng.choice(V, k - 3, replace=False)
    lg[:, top] = 4 + rng.uniform(0, 2, size=(4, k - 3))
    tied = [width - 1, width + 2, width - 5, 2 * width - 1, width + 40,
            V - 1]
    lg[:, [i for i in tied if i < V and i not in top]] = 3.0
    ids, _ = _topk_check(torch.from_numpy(lg).to(cuda, _DT[dtype]), k)
    assert (ids[:, -3:].cpu().numpy() < 2 * width).all()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", ["all_equal", "rounded", "neg_inf_tail",
                                  "neg_inf_past_half_k"])
@pytest.mark.parametrize("V", [258, 50280, 151936])
def test_topk_cdf_degenerate_rows(cuda, V, case, dtype):
    k = 48
    rng = np.random.default_rng(V + 2)
    lg = rng.normal(size=(4, V)).astype(np.float32)
    if case == "all_equal":
        lg[:] = 0.25
    elif case == "rounded":                 # many keys tie at threshold
        lg = np.round(lg * 2) / 2
    elif case == "neg_inf_tail":
        lg[:, V - k:] = -np.inf
    else:                                   # -inf must fill the top k
        lg[:, k // 2:] = -np.inf
    _topk_check(torch.from_numpy(lg).to(cuda, _DT[dtype]), k)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("V", [258, 50280, 151936])
def test_topk_cdf_rows_are_independent(cuda, V, dtype):
    """Permuting the rows permutes ids and CDFs bit for bit, and a row
    alone gives what it gives among others."""
    lg = torch.from_numpy(np.random.default_rng(V + 3).normal(
        size=(7, V)).astype(np.float32) * 3).to(cuda, _DT[dtype])
    ids, cdf = ops.topk_cdf(lg, 48, 16)
    perm = torch.tensor([3, 0, 6, 5, 1, 4, 2], device=cuda)
    ids2, cdf2 = ops.topk_cdf(lg[perm], 48, 16)
    assert torch.equal(ids[perm], ids2) and torch.equal(cdf[perm], cdf2)
    ids3, cdf3 = ops.topk_cdf(lg[5:6].clone(), 48, 16)
    assert torch.equal(ids3, ids[5:6]) and torch.equal(cdf3, cdf[5:6])


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
    (16, 32, 32, 128, 128, 112, True, None),    # zamba2-7b: MHA, hd 112
    (16, 32, 32, 32, 32, 112, True, None),      # its probe
    (16, 32, 32, 160, 160, 112, True, None),    # under a 32-token prefix
    # whisper-large-v3: the encoder (bidirectional over 1,500 frames) and
    # scoring's cross-attention (128 queries over 1,500 keys), G 1, hd 64
    (1, 32, 32, 1500, 1500, 64, False, None),
    (16, 32, 32, 128, 1500, 64, False, None),
    # llava-next-34b with its image: 576 + 128 positions, G 8
    (2, 64, 8, 704, 704, 128, True, None),
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
        _attention_close(out, ref.flash_attention(*_f32(q, k, v), causal,
                                                  window), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("hd", [64, 112, 128])
@pytest.mark.parametrize("S", [32, 128, 160])
@pytest.mark.parametrize("G", [1, 2, 4])
def test_flash_attention_group_shared_tiles(cuda, G, S, hd):
    """One CTA per group of G q-heads: G = 1, 2, 4 at the scoring
    lengths, in the model's layout, causal and under a 64-key window."""
    q, k, v = _flash_inputs(cuda, 3, 2 * G, 2, S, S, hd, "bfloat16",
                            "bshd")
    for window in (None, 64):
        out = ops.flash_attention(q, k, v, True, window)
        _attention_close(out, ref.flash_attention(*_f32(q, k, v), True,
                                                  window), "bfloat16")


@pytest.mark.cuda
@pytest.mark.parametrize("S,G", [(32, 2), (128, 2), (160, 2), (128, 1),
                                 (100, 4)])
def test_flash_attention_bits_do_not_depend_on_the_tiling(cuda, S, G):
    """Every launch geometry the kernel accepts gives the same bits: the
    K/V tiles start at key 0 in steps of 64 whatever the q tile, and a
    tile masked for a whole warp is skipped exactly."""
    from repro_torch.kernels import build
    q, k, v = _flash_inputs(cuda, 2, 2 * G, 2, S, S, 64, "bfloat16",
                            "bshd")
    want = ops.flash_attention(q, k, v, True, 48)
    B, H, Sq, hd = q.shape
    for hg in (d for d in (1, 2, 4) if G % d == 0):
        for bq in (16, 32, 64, 128):
            if hg * bq > ops.FLASH_ROWS:
                continue
            out = torch.empty((B, Sq, H, hd), dtype=q.dtype,
                              device=cuda).transpose(1, 2)
            rc = build.entry("flash_attention")(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                *out.stride()[:3], B, H, 2, Sq, Sq, hd, 1, 48, 1,
                1.0 / hd ** 0.5, 1, hg, bq,
                torch.cuda.current_stream(cuda).cuda_stream)
            assert rc == 0
            assert torch.equal(out, want), (hg, bq)


@pytest.mark.cuda
def test_flash_attention_lanes_are_independent(cuda):
    """A lane's output is bit-identical whatever the other lanes hold."""
    q, k, v = _flash_inputs(cuda, 6, 16, 8, 128, 128, 128, "bfloat16")
    a = ops.flash_attention(q, k, v)
    perm = torch.tensor([3, 0, 5, 1, 4, 2], device=cuda)
    b = ops.flash_attention(q[perm], k[perm], v[perm])
    assert torch.equal(a[perm], b)
    assert torch.equal(ops.flash_attention(q[:2], k[:2], v[:2]), a[:2])
    for S in (32, 160):                 # the probe's and the prefix's
        q, k, v = _flash_inputs(cuda, 6, 16, 8, S, S, 128, "bfloat16",
                                "bshd")
        a = ops.flash_attention(q, k, v)
        b = ops.flash_attention(q[perm], k[perm], v[perm])
        assert torch.equal(a[perm], b)


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
    (1, 1, 24, 64, 128),        # one position, one chunk
    (4, 33, 24, 64, 128),       # odd Q
    (1, 160, 5, 32, 64),        # P < 64, N = 64, a partial head group
    (2, 256, 4, 48, 96),        # Q = 256, P and N ragged in their tiles
    (1, 65, 1, 8, 65),          # rows not on 16 bytes: scalar copies
    (2, 64, 25, 64, 128),       # one head past the last full group
    (16, 128, 112, 64, 64),     # zamba2-7b score_chunks (H=112, N=64)
    (23, 32, 112, 64, 64),      # its router probe
    (16, 160, 112, 64, 64),     # under a 32-token prefix
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
@pytest.mark.parametrize("S", [128, 161])
def test_single_chunk_ssd_chunked_is_the_general_path_bit_for_bit(cuda, S):
    """mamba2-130m's scoring shapes (16 lanes of 128 positions, fresh and
    under a 32-token prefix; chunk 256, so one chunk): the shortcut for a
    fresh single chunk gives the bits the general path gives from an
    explicit zero entering state."""
    from repro_torch.models.mamba2 import ssd_chunked
    x, dt, A, Bm, Cm = _ssd_inputs(cuda, 16, S, 24, 64, 128, "bfloat16",
                                   True)
    y, s = ssd_chunked(x, dt, A, Bm, Cm, chunk=256)
    zero = torch.zeros((16, 24, 64, 128), dtype=torch.bfloat16,
                       device=cuda)
    y0, s0 = ssd_chunked(x, dt, A, Bm, Cm, chunk=256, initial_state=zero)
    assert torch.equal(y, y0) and torch.equal(s, s0)


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


# The cluster kernels of cdf_points and decode_attention (rows split over
# ops.cdf_points_geometry, cache positions over ops.decode_geometry).

def _cdf_points_check(lg, prec):
    pts = ops.cdf_points(lg, prec)
    want = ref.cdf_points(lg, prec)
    assert (pts - want).abs().max().item() <= 1
    p = pts.cpu().numpy()
    assert (np.diff(p, axis=-1) >= 1).all() and (p[:, 0] >= 1).all()
    assert (p[:, -1] == 1 << prec).all()
    return pts


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", ["normal", "misaligned", "neg_inf_tail",
                                  "all_equal"])
@pytest.mark.parametrize("V", [258, 4097, 50280, 151936])
def test_cdf_points_cluster_rows(cuda, V, case, dtype):
    """Slices no 128-row divides, misaligned row starts (a V + 5 stride:
    263 at pred-base's 258), a -inf tail, all-equal logits."""
    prec = 18 if V > 65000 else 16
    rng = np.random.default_rng(V + 11)
    lg = rng.normal(size=(16, V + 5)).astype(np.float32) * 3
    if case == "neg_inf_tail":
        lg[:, V - V // 3:] = -np.inf
    elif case == "all_equal":
        lg[:] = 0.25
    full = torch.from_numpy(lg).to(cuda, _DT[dtype])
    x = full[:, :V] if case == "misaligned" else full[:, :V].contiguous()
    _cdf_points_check(x, prec)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("V", [258, 50280, 151936])
def test_cdf_points_rows_are_independent(cuda, V, dtype):
    """Permuting the rows permutes the points bit for bit, and a row
    alone gives what it gives among others."""
    prec = 18 if V > 65000 else 16
    lg = torch.from_numpy(np.random.default_rng(V + 12).normal(
        size=(7, V)).astype(np.float32) * 3).to(cuda, _DT[dtype])
    pts = ops.cdf_points(lg, prec)
    perm = torch.tensor([3, 0, 6, 5, 1, 4, 2], device=cuda)
    assert torch.equal(ops.cdf_points(lg[perm], prec), pts[perm])
    assert torch.equal(ops.cdf_points(lg[5:6].clone(), prec), pts[5:6])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cdf_points_unstaged_slices(cuda, dtype):
    """A slice too large for shared memory is read from global memory,
    its running sums kept in the output row."""
    V = 500_000
    assert not ops.cdf_points_staged(V, _DT[dtype])
    lg = torch.from_numpy(np.random.default_rng(2).normal(
        size=(3, V)).astype(np.float32) * 3).to(cuda, _DT[dtype])
    _cdf_points_check(lg, 20)


def _decode_inputs(cuda, B, H, K, S, hd, dtype, seed):
    rng = np.random.default_rng(seed)
    t = lambda shape: torch.from_numpy(rng.normal(size=shape).astype(  # noqa
        np.float32)).to(device=cuda, dtype=_DT[dtype])
    lens = torch.from_numpy(rng.integers(1, S + 1, B).astype(
        np.int32)).to(cuda)
    return t((B, H, hd)), t((B, S, K, hd)), t((B, S, K, hd)), lens


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,H,K,S,hd", [(16, 16, 8, 128, 128),
                                         (16, 8, 4, 128, 32),
                                         (4, 8, 8, 512, 112),
                                         (16, 64, 4, 128, 128)])
def test_decode_attention_lanes_are_independent(cuda, B, H, K, S, hd,
                                                dtype):
    """A lane's output is bit-identical whatever the other lanes hold,
    whatever their lengths, and whatever the lane count."""
    q, kc, vc, lens = _decode_inputs(cuda, B, H, K, S, hd, dtype, S + hd)
    a = ops.decode_attention(q, kc, vc, lens)
    perm = torch.roll(torch.arange(B, device=cuda), 3)
    assert torch.equal(ops.decode_attention(q[perm], kc[perm], vc[perm],
                                            lens[perm]), a[perm])
    other = lens.clone()
    other[1:] = torch.flip(lens[1:], (0,)) % S + 1
    assert torch.equal(ops.decode_attention(q, kc, vc, other)[0], a[0])
    assert torch.equal(ops.decode_attention(q[:3], kc[:3], vc[:3],
                                            lens[:3]), a[:3])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S,hd", [(128, 128), (512, 112), (161, 64)])
def test_decode_attention_masked_slices(cuda, S, hd, dtype):
    """Lengths that leave whole slices of the cluster without a live
    position (1, one slice, one slice and one position, ...), and a lane
    of length 0, which gives 0 as before."""
    _, per = ops.decode_geometry(S, 2, hd, _DT[dtype])
    q, kc, vc, _ = _decode_inputs(cuda, 8, 4, 2, S, hd, dtype, S)
    lens = torch.tensor([1, per - 1, per, per + 1, 2 * per, S - 1, S, 0],
                        dtype=torch.int32, device=cuda)
    out = ops.decode_attention(q, kc, vc, lens)
    want = ref.decode_attention(*_f32(q, kc, vc), lens)
    _attention_close(out[:7], want[:7], dtype)
    assert torch.equal(out[7], torch.zeros_like(out[7]))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S", [128, 512])
@pytest.mark.parametrize("hd", [112, 120])
@pytest.mark.parametrize("G", [1, 8, 12, 16])
def test_decode_attention_widths_groups_and_caches(cuda, G, hd, S, dtype):
    """hd 112 and 120 (zamba2's and danube's widths), G = 1, 8, 12 and 16
    (the last two: sixteen head rows computed), a 512-position cache;
    against the plain version."""
    K = 2
    q, kc, vc, lens = _decode_inputs(cuda, 5, G * K, K, S, hd, dtype,
                                     G + hd + S)
    out = ops.decode_attention(q, kc, vc, lens)
    _attention_close(out, ref.decode_attention(*_f32(q, kc, vc), lens),
                     dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("G,hd,S", [(2, 128, 128), (1, 112, 512),
                                     (2, 32, 128), (16, 64, 128)])
def test_decode_attention_misaligned_rows(cuda, G, hd, S, dtype):
    """q and cache rows that do not start on 16 bytes (views of hd + 1
    wide rows) take the kernel's scalar copies."""
    K, B = 2, 5
    rng = np.random.default_rng(G + hd + S + 1)
    t = lambda shape: torch.from_numpy(rng.normal(size=shape).astype(  # noqa
        np.float32)).to(device=cuda, dtype=_DT[dtype])[..., :hd]
    q, kc, vc = t((B, G * K, hd + 1)), t((B, S, K, hd + 1)), \
        t((B, S, K, hd + 1))
    assert not ops._rows_aligned(kc)
    lens = torch.from_numpy(rng.integers(1, S + 1, B).astype(
        np.int32)).to(cuda)
    out = ops.decode_attention(q, kc, vc, lens)
    _attention_close(out, ref.decode_attention(*_f32(q, kc, vc), lens),
                     dtype)


def _int8_inputs(cuda, B, H, K, S, hd, dtype, seed):
    """q in ``dtype``, an int8 cache quantized as the model quantizes it
    (one fp16 scale per row), lengths."""
    from repro_torch.models.transformer import _quant_kv
    q, kc, vc, lens = _decode_inputs(cuda, B, H, K, S, hd, "float32", seed)
    kq, ks = _quant_kv(kc)
    vq, vs = _quant_kv(vc)
    return q.to(_DT[dtype]), kq, vq, ks, vs, lens


INT8_SHAPES = DECODE_SHAPES + [(16, 32, 8, 4096, 120),   # h2o-danube-3-4b
                               (16, 32, 32, 128, 128),   # deepseek-7b
                               (16, 48, 8, 128, 128),    # qwen3-14b, G 6
                               (3, 4, 2, 40, 24)]        # hd % 16 == 8


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,H,K,S,hd", INT8_SHAPES)
def test_decode_attention_int8_kernel_vs_plain(cuda, B, H, K, S, hd, dtype):
    q, kq, vq, ks, vs, lens = _int8_inputs(cuda, B, H, K, S, hd, dtype,
                                           B + H + S + hd)
    ops.reset_launches()
    out = ops.decode_attention_int8(q, kq, vq, ks, vs, lens)
    assert ops.LAUNCHES["decode_attention_int8"] == 1
    k, v = ref.dequant_kv(kq, ks, q.dtype), ref.dequant_kv(vq, vs, q.dtype)
    _attention_close(out, ref.decode_attention(*_f32(q, k, v), lens), dtype)
    assert torch.equal(out, ops.decode_attention(q, k, v, lens))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_attention_int8_strided_layer_views(cuda, dtype):
    """The model hands over one layer of (L, B, S, K, hd) int8 leaves and
    (L, B, S, K) scales, and a q row that does not start on 16 bytes
    takes the scalar q copies."""
    L, B, H, K, S, hd = 3, 4, 8, 2, 96, 64
    q, kq, vq, ks, vs, lens = _int8_inputs(cuda, L * B, H, K, S, hd, dtype,
                                           5)
    kq, vq = kq.reshape(L, B, S, K, hd), vq.reshape(L, B, S, K, hd)
    ks, vs = ks.reshape(L, B, S, K), vs.reshape(L, B, S, K)
    wide = torch.zeros((B, H, hd + 1), dtype=q.dtype, device=cuda)
    wide[..., :hd] = q[:B]
    qm = wide[..., :hd]
    assert not ops._rows_aligned(qm)
    out = ops.decode_attention_int8(qm, kq[1], vq[1], ks[1], vs[1],
                                    lens[:B])
    k = ref.dequant_kv(kq[1], ks[1], q.dtype)
    v = ref.dequant_kv(vq[1], vs[1], q.dtype)
    _attention_close(out, ref.decode_attention(*_f32(qm, k, v), lens[:B]),
                     dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("bad", ["hd18", "bf16_cache", "f32_scales",
                                 "scale_shape", "misaligned"])
def test_decode_attention_int8_wrapper_refuses(cuda, bad):
    q, kq, vq, ks, vs, lens = _int8_inputs(cuda, 2, 4, 2, 32, 16,
                                           "bfloat16", 3)
    if bad == "hd18":
        q, kq, vq, ks, vs, lens = _int8_inputs(cuda, 2, 4, 2, 32, 18,
                                               "bfloat16", 3)
    elif bad == "bf16_cache":
        kq = kq.to(torch.bfloat16)
        vq = vq.to(torch.bfloat16)
    elif bad == "f32_scales":
        ks = ks.float()
    elif bad == "scale_shape":
        ks, vs = ks[:, :16], vs[:, :16]
    else:
        wide = torch.zeros((2, 32, 2, 17), dtype=torch.int8, device=cuda)
        kq = vq = wide[..., 1:]
    with pytest.raises(ValueError):
        ops.decode_attention_int8(q, kq, vq, ks, vs, lens)


# ------------------------------------------------ captured decode programs
_RING = dict(d_head=24, sliding_window=8)   # h2o's trait: hd % 16 == 8
_GRAPH_FAMILIES = (("dense", pqwen.CONFIG, {}), ("ssm", pmamba.CONFIG, {}),
                   # a trailing SSD layer, as zamba2-7b has
                   ("hybrid", pzamba.CONFIG, {"n_layers": 5}),
                   ("dense-int8", pqwen.CONFIG, {"kv_cache_dtype": "int8"}),
                   ("dense-ring", ph2o.CONFIG, _RING),
                   ("dense-ring-int8", ph2o.CONFIG,
                    dict(_RING, kv_cache_dtype="int8")),
                   # qk-norm and G = 16, as qwen3-moe-235b-a22b
                   ("moe", pqmoe.CONFIG, {"n_heads": 16, "n_kv_heads": 1}),
                   # frames (1, 32, d) drawn by random_init: one cross
                   # cache read by every lane with stride 0
                   ("encdec", pwhisper.CONFIG, {}))
GRAPH_CFGS = {f"{fam}-{dt}": pbase.tiny_variant(cfg, **kw).with_(dtype=dt)
              for fam, cfg, kw in _GRAPH_FAMILIES
              for dt in ("float32", "bfloat16")}
#: decode_attention launches per decode step: one per layer (dense, moe),
#: one per application of the shared block (hybrid)
ATTN_PER_STEP = {"dense-bfloat16": GRAPH_CFGS["dense-bfloat16"].n_layers,
                 "dense-int8-bfloat16": GRAPH_CFGS["dense-bfloat16"].n_layers,
                 "hybrid-bfloat16": 2,
                 "moe-bfloat16": GRAPH_CFGS["moe-bfloat16"].n_layers,
                 # self and cross attention in every decoder layer
                 "encdec-bfloat16": 2 * GRAPH_CFGS["encdec-bfloat16"]
                 .n_layers}


def _same_cache(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(GRAPH_CFGS))
def test_captured_step_equals_eager_bit_for_bit(cuda, name):
    """Replays of the captured step against the eager step on a twin
    cache: logits and every leaf bit for bit, on fresh lanes, after a lane
    reset, after restore_slot, and through verify_steps + rollback."""
    cfg = GRAPH_CFGS[name]
    pred = ModelPredictor.random_init(cfg, seed=0, device=cuda)
    B, S, T = 4, 32, 4
    pred.set_decode_len(S)
    rng = np.random.default_rng(7)
    tok = lambda *shape: rng.integers(0, cfg.vocab_size - 1,  # noqa: E731
                                      shape)
    g = pred.begin_decode(B)
    e = pred._init_cache(B, S)

    def steps(n):
        for _ in range(n):
            prev = tok(B)
            lg, _ = pred.decode_step(g, prev)
            le, _ = pred._eager_decode_step(e, prev)
            assert torch.equal(lg, le)
            _same_cache(g, e)

    steps(5)
    mask = np.array([False, True, False, True])
    pred.reset_slots(g, mask)
    pred.reset_slots(e, mask)
    steps(3)
    snap = pred.snapshot_slot(g, 0)
    pred.restore_slot(g, snap, mask)
    pred.restore_slot(e, snap, mask)
    steps(3)
    seq = tok(B, T)
    lg, snaps = pred.verify_steps(g, seq)
    le, esnaps, erows = graphs.verify_body(pred._step_body, e,
                                           pred._tokens(seq.T),
                                           model_api.rollback_leaves(cfg),
                                           model_api.ring_leaves(cfg))
    assert torch.equal(lg, le)
    acc = np.array([0, 1, T, 2])
    pred.rollback(snaps, acc)
    graphs.rollback(graphs.Snapshots(e, esnaps, erows), acc)
    _same_cache(g, e)
    steps(4)
    assert graphs.STATS["captures"] >= 2


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(ATTN_PER_STEP))
def test_launch_counts_are_captured_launches_times_replays(cuda, name):
    cfg = GRAPH_CFGS[name]
    per = ATTN_PER_STEP[name]
    kern = "decode_attention_int8" if cfg.kv_cache_dtype == "int8" \
        else "decode_attention"
    pred = ModelPredictor.random_init(cfg, seed=0, device=cuda)
    pred.set_decode_len(16)
    state = pred.begin_decode(2)
    ops.reset_launches()
    graphs.reset_stats()
    n = 6
    for _ in range(n):
        pred.decode_step(state, np.array([1, 2]))
    prog = state.slot.step
    assert prog.launches == {kern: per}
    assert graphs.STATS["captures"] == 1
    assert graphs.STATS["step_replays"] == n
    # the eager warm-up before capture launches for real, once
    assert ops.LAUNCHES[kern] == per * (n + 1)
    seq = np.ones((2, 3), np.int64)
    ops.reset_launches()
    for _ in range(2):
        _, snaps = pred.verify_steps(state, seq)
        pred.rollback(snaps, np.array([1, 3]))
    prog = state.slot.verify[3][1]
    assert prog.launches == {kern: 3 * per}
    assert ops.LAUNCHES[kern] == 3 * per * (2 + 1)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_lane_is_independent_on_the_card(cuda, dtype):
    """Through the captured step, bit for bit: a lane's logits are the
    same whatever the other lanes' tokens are (permuted or replaced,
    which moves where its tokens land in each expert's buffer), and a
    sequence's logits are the same on whichever lane it runs."""
    cfg = GRAPH_CFGS[f"moe-{dtype}"]
    pred = ModelPredictor.random_init(cfg, seed=0, device=cuda)
    B, n = 16, 8
    pred.set_decode_len(16)
    rng = np.random.default_rng(3)
    toks = rng.integers(0, cfg.vocab_size - 1, (B, n))
    base = _lockstep(pred, pred.begin_decode(B), toks)[0]
    moved = np.roll(np.arange(B), 5)
    assert torch.equal(_lockstep(pred, pred.begin_decode(B),
                                 toks[moved])[0], base[moved])
    for lane in (0, 9):
        other = rng.integers(0, cfg.vocab_size - 1, (B, n))
        other[lane] = toks[lane]
        got = _lockstep(pred, pred.begin_decode(B), other)[0]
        assert torch.equal(got[lane], base[lane])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_attention_over_a_shared_cross_cache(cuda, dtype):
    """The encdec cross-attention's call: one (S, K, hd) source expanded
    over 16 lanes with stride 0, every lane's length S = 1,500: against
    the plain version, and each lane equal to the same query against an
    unexpanded copy, bit for bit."""
    rng = np.random.default_rng(15)
    t = lambda shape: torch.from_numpy(rng.normal(size=shape).astype(  # noqa
        np.float32)).to(device=cuda, dtype=_DT[dtype])
    B, H, S, hd = 16, 32, 1500, 64
    q, kc, vc = t((B, H, hd)), t((1, S, H, hd)), t((1, S, H, hd))
    lens = torch.full((B,), S, dtype=torch.int32, device=cuda)
    ke, ve = kc.expand(B, -1, -1, -1), vc.expand(B, -1, -1, -1)
    out = ops.decode_attention(q, ke, ve, lens)
    _attention_close(out, ref.decode_attention(*_f32(q, ke, ve), lens),
                     dtype)
    own = ops.decode_attention(q, ke.contiguous(), ve.contiguous(), lens)
    assert torch.equal(out, own)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_encdec_lane_is_independent_on_the_card(cuda, dtype):
    """Through the captured encdec step, bit for bit: a sequence's logits
    are the same on whichever lane it runs, and a lane's are the same
    whatever the other lanes' tokens are; a lane reset in mid-job then
    gives a fresh cache's logits (the cross K/V survive the reset)."""
    cfg = GRAPH_CFGS[f"encdec-{dtype}"]
    pred = ModelPredictor.random_init(cfg, seed=0, device=cuda)
    B, n = 16, 8
    pred.set_decode_len(16)
    rng = np.random.default_rng(4)
    toks = rng.integers(0, cfg.vocab_size - 1, (B, n))
    base = _lockstep(pred, pred.begin_decode(B), toks)[0]
    moved = np.roll(np.arange(B), 5)
    assert torch.equal(_lockstep(pred, pred.begin_decode(B),
                                 toks[moved])[0], base[moved])
    other = rng.integers(0, cfg.vocab_size - 1, (B, n))
    other[3] = toks[3]
    assert torch.equal(_lockstep(pred, pred.begin_decode(B), other)[0][3],
                       base[3])
    state = _lockstep(pred, pred.begin_decode(B), other)[1]
    pred.reset_slots(state, np.arange(B) == 3)
    got = _lockstep(pred, state, toks)[0]
    assert torch.equal(got[3], base[3])


def _lockstep(pred, state, toks):
    out = []
    for t in range(toks.shape[1]):
        lg, _ = pred.decode_step(state, toks[:, t])
        out.append(lg.clone())
    return (torch.stack(out, 1) if out else None), state


@pytest.mark.cuda
@pytest.mark.parametrize("warm", [6, 20])
@pytest.mark.parametrize("name", ["dense-ring-bfloat16",
                                  "dense-ring-int8-bfloat16"])
def test_ring_rollback_after_the_wrap_equals_lockstep(cuda, name, warm):
    """A captured verify round of 5 steps on a ring of 8 slots, crossing
    the wrap (warm 6) or wholly past it (warm 20), each lane rolled back
    to 0, 2 or 5 of its inputs, then 6 more captured steps: each lane's
    logits and cache leaves equal those of a captured cache that took
    only the kept inputs, bit for bit."""
    cfg = GRAPH_CFGS[name]
    pred = ModelPredictor.random_init(cfg, seed=0, device=cuda)
    pred.set_decode_len(32)
    rng = np.random.default_rng(warm)
    B, T, acc = 3, 5, [0, 2, 5]
    w, seq, after = (rng.integers(0, cfg.vocab_size - 1, (B, n))
                     for n in (warm, T, 6))
    g = _lockstep(pred, pred.begin_decode(B), w)[1]
    _, snaps = pred.verify_steps(g, seq)
    pred.rollback(snaps, np.array(acc))
    kept = {k: v.clone() for k, v in g.items()}
    got = _lockstep(pred, g, after)[0]
    del g
    for b, a in enumerate(acc):
        r = _lockstep(pred, pred.begin_decode(B), w)[1]
        r = _lockstep(pred, r, seq[:, :a])[1]
        for k, v in r.items():
            lane = (lambda x: x[b]) if k == "pos" else (lambda x: x[:, b])
            assert torch.equal(lane(kept[k]), lane(v)), (b, k)
        assert torch.equal(got[b], _lockstep(pred, r, after)[0][b]), b
        del r


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["dense-ring-bfloat16",
                                  "dense-ring-int8-bfloat16"])
def test_speculative_decompress_across_the_wrap_on_the_card(cuda, name):
    """Chunks of 40 through a ring of 8, decoded by captured verify rounds
    whose always-wrong drafts are all rejected: the same tokens as the
    lock-step decoder's."""
    from repro_torch.core import LLMCompressor
    from repro_torch.core.draft import ConstantDraft
    from repro_torch.data.synthetic import human_like
    from repro_torch.data.tokenizer import encode
    pred = ModelPredictor.random_init(GRAPH_CFGS[name], seed=0, device=cuda)
    toks = encode(human_like("wiki", 160, seed=71))
    kw = dict(chunk_size=40, topk=8, decode_batch=4)
    blob, _ = LLMCompressor(pred, **kw).compress(toks)
    spec = LLMCompressor(pred, draft_k=4, draft=ConstantDraft(pred.bos_id),
                         **kw)
    spec._spec_window = 1 << 30      # no fall-through to lock-step
    graphs.reset_stats()
    assert np.array_equal(spec.decompress(blob), toks)
    assert graphs.STATS["verify_replays"] >= 40


@pytest.mark.cuda
def test_capture_pauses_the_garbage_collector(cuda):
    """The cyclic collector is off while a graph is captured, and on
    again after: a dead predictor's graphs destroyed mid-capture would
    invalidate it."""
    import gc
    seen = []
    x = torch.zeros(4, device=cuda)

    def body():
        seen.append(gc.isenabled())
        return x.add_(1)
    prog = graphs.Program(body, {"x": x}, torch.cuda.Stream(cuda), "step", 1)
    assert seen == [True, False] and gc.isenabled()
    assert torch.equal(prog.replay(), torch.ones(4, device=cuda))


@pytest.mark.cuda
def test_each_cache_length_and_holder_has_its_own_capture(cuda):
    """A cache of another length captures its own graph; a cache that is
    let go is handed out again, zeroed, with its graph; a cache still
    held is not."""
    cfg = GRAPH_CFGS["dense-float32"]
    pred = ModelPredictor.random_init(cfg, seed=0, device=cuda)
    graphs.reset_stats()
    out = {}
    for S in (16, 48):
        pred.set_decode_len(S)
        g, e = pred.begin_decode(2), pred._init_cache(2, S)
        for t in range(3):
            prev = np.array([t, t + 5])
            lg, _ = pred.decode_step(g, prev)
            le, _ = pred._eager_decode_step(e, prev)
            assert torch.equal(lg, le)
        out[S] = g.slot
    assert graphs.STATS["captures"] == 2
    del g
    a = pred.begin_decode(2)                  # S = 48 again: reused
    assert a.slot is out[48] and int(a["pos"].abs().sum()) == 0
    assert float(a["k"].abs().sum()) == 0
    pred.decode_step(a, np.array([1, 1]))
    b = pred.begin_decode(2)                  # a is held: a new cache
    assert b.slot is not a.slot
    pred.decode_step(b, np.array([1, 1]))
    assert graphs.STATS["captures"] == 3


# ------------------------------------------------- training and sampling
@pytest.mark.cuda
def test_train_step_on_the_card_matches_the_cpu(cuda):
    from repro_torch.configs.paper_predictors import PRED_TINY
    from repro_torch.train.optimizer import AdamWConfig, tree_leaves
    from repro_torch.train.train_loop import (init_train_state,
                                              make_train_step,
                                              value_and_grad)
    opt = AdamWConfig(learning_rate=3e-3, warmup_steps=2, total_steps=4)
    params, state = init_train_state(PRED_TINY, 0, "cpu", opt)
    batch = {"tokens": np.random.default_rng(0).integers(0, 256, (4, 33))}
    to = lambda tree: {k: to(v) if isinstance(v, dict)  # noqa: E731
                       else v.to(cuda) for k, v in tree.items()}
    ops.reset_launches()
    lc, gc = value_and_grad(params, PRED_TINY, batch)
    lg, gg = value_and_grad(to(params), PRED_TINY, batch)
    assert abs(float(lc) - float(lg)) < 1e-4
    for a, b in zip(tree_leaves(gc), tree_leaves(gg)):
        assert float(b.abs().max()) > 0 and torch.isfinite(b).all()
        np.testing.assert_allclose(b.cpu().numpy(), a.numpy(), rtol=0,
                                   atol=1e-3 * float(a.abs().max()))
    step = make_train_step(PRED_TINY, opt=opt)
    _, _, mc = step(params, state, batch)
    _, _, mg = step(to(params), to(state), batch)
    assert abs(float(mc["loss"]) - float(mg["loss"])) < 1e-4
    assert all(n == 0 for n in ops.LAUNCHES.values())


@pytest.mark.cuda
def test_captured_generate_equals_eager_generate(cuda):
    from repro_torch.configs.paper_predictors import PRED_TINY
    a = ModelPredictor.random_init(PRED_TINY, seed=0, device=cuda)
    b = ModelPredictor(a.params, PRED_TINY, device=cuda)
    b.decode_step = lambda state, prev: (  # noqa: E731
        b._eager_decode_step(state, prev)[0], state)
    prompt = np.random.default_rng(1).integers(0, 256, (3, 8))
    graphs.reset_stats()
    for kw in (dict(temperature=0.7), dict(temperature=1.0, top_k=5)):
        got = a.generate(40, batch=3, seed=9, prompt=prompt,
                         vocab_limit=256, **kw)
        want = b.generate(40, batch=3, seed=9, prompt=prompt,
                          vocab_limit=256, **kw)
        np.testing.assert_array_equal(got, want)
    # every decode step of both captured runs a replay (8 + 40 each)
    assert graphs.STATS["step_replays"] == 2 * 48
