"""Launch geometry of the port's redesigned kernels, on the CPU.

``ops.topk_cdf_geometry`` and ``ops.flash_geometry`` fix how the top-k
and flash-attention kernels split their work. The kernels' float sums
follow that split, and compress and decompress must build the same
integers whatever else shares a launch. So the split may depend on the
static shapes (V, dtype; Sq, G, dtype) and never on the row or lane
count. These tests hold that, check the split's invariants, and replay
the top-k kernel's slice-and-merge selection in plain PyTorch against
the plain version. The wrappers' CPU dispatch to ``kernels/ref.py`` is
held bit for bit.
"""
import inspect

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import build, ops, ref  # noqa: E402

VOCABS = [1, 48, 257, 258, 1000, 4096, 4097, 8193, 50280, 151936, 152064,
          262144, 500000]


def test_topk_geometry_takes_only_v_and_dtype():
    assert list(inspect.signature(ops.topk_cdf_geometry).parameters) == [
        "V", "dtype"]
    assert list(inspect.signature(ops.flash_geometry).parameters) == [
        "Sq", "G", "dtype"]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("V", VOCABS)
def test_topk_geometry_slices_cover_the_row(V, dtype):
    clusters, width, staged = ops.topk_cdf_geometry(V, dtype)
    assert 1 <= clusters <= ops.TOPK_MAX_CLUSTERS
    assert width % 8 == 0
    assert clusters * width >= V > (clusters - 1) * width   # none empty
    el = torch.empty((), dtype=dtype).element_size()
    assert staged == (width * el <= ops.TOPK_STAGE_BYTES)


def test_topk_geometry_at_the_configs_vocabularies():
    """pred-base's 258 stays in one CTA; qwen3-1.7b's and mamba2-130m's
    vocabularies take a cluster of 8 (16 rows: 128 CTAs)."""
    assert ops.topk_cdf_geometry(258, torch.float32) == (1, 264, True)
    assert ops.topk_cdf_geometry(151936, torch.bfloat16) == (8, 18992,
                                                            True)
    assert ops.topk_cdf_geometry(50280, torch.bfloat16) == (8, 6288, True)
    assert not ops.topk_cdf_geometry(500000, torch.float32)[2]


class _Recorder:
    """Stands in for a kernel's C entry point: keeps the arguments."""

    def __init__(self):
        self.calls = []

    def __call__(self, *args):
        self.calls.append(args)
        return 0


@pytest.fixture
def launches(monkeypatch):
    """The wrappers' CUDA branch on ``meta`` tensors, with the C entry
    points recorded instead of called."""
    rec = _Recorder()
    monkeypatch.setattr(ops, "_check_cuda", lambda name, *t: None)
    monkeypatch.setattr(ops, "_stream", lambda t: 0)
    monkeypatch.setattr(build, "entry", lambda name: rec)
    return rec


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("V", [258, 50280, 151936])
def test_topk_launch_geometry_ignores_the_row_count(launches, V, dtype):
    n0 = ops.LAUNCHES["topk_cdf"]
    for R in (1, 7, 16, 64):
        ops.topk_cdf(torch.empty((R, V), dtype=dtype, device="meta"), 48,
                     16)
    assert ops.LAUNCHES["topk_cdf"] == n0 + 4
    geometry = {c[7:10] for c in launches.calls}          # C, width, staged
    rows = [c[3] for c in launches.calls]
    assert rows == [1, 7, 16, 64]
    clusters, width, staged = ops.topk_cdf_geometry(V, dtype)
    assert geometry == {(clusters, width, int(staged))}


@pytest.mark.parametrize("S,G", [(32, 2), (128, 2), (160, 2), (128, 1),
                                 (100, 4)])
def test_flash_launch_geometry_ignores_the_lanes(launches, S, G):
    for B in (1, 3, 16):
        q = torch.empty((B, 2 * G, S, 64), dtype=torch.bfloat16,
                        device="meta")
        k = torch.empty((B, 2, S, 64), dtype=torch.bfloat16, device="meta")
        ops.flash_attention(q, k, k.clone())
    assert {c[-3:-1] for c in launches.calls} == {
        ops.flash_geometry(S, G, torch.bfloat16)}
    assert [c[16] for c in launches.calls] == [1, 3, 16]


@pytest.mark.parametrize("G", [1, 2, 3, 4, 6, 8, 16])
@pytest.mark.parametrize("Sq", [1, 17, 32, 100, 128, 160, 4096])
def test_flash_geometry_fits_the_kernel(Sq, G):
    hg, bq = ops.flash_geometry(Sq, G, torch.bfloat16)
    assert G % hg == 0 and hg in (1, 2, 4, 8)
    assert bq % ops.FLASH_WARP_ROWS == 0 and hg * bq <= ops.FLASH_ROWS
    # no taller than Sq rounded up to a warp's rows
    assert bq < Sq + ops.FLASH_WARP_ROWS
    assert ops.flash_geometry(Sq, G, torch.float32) == (1, 32)


def test_flash_geometry_at_the_scoring_shapes():
    """qwen3-1.7b (G = 2): both heads of a kv-head share each K/V tile;
    the probe's 32 tokens get 32-position tiles."""
    bf = torch.bfloat16
    assert ops.flash_geometry(128, 2, bf) == (2, 64)
    assert ops.flash_geometry(160, 2, bf) == (2, 64)
    assert ops.flash_geometry(32, 2, bf) == (2, 32)


def _slice_merge_topk(x, k):
    """The top-k kernel's selection in plain PyTorch: each slice of the
    geometry keeps its own top k in (value desc, id asc) order, and the
    union is merged in the same order."""
    R, V = x.shape
    clusters, width, _ = ops.topk_cdf_geometry(V, x.dtype)
    cand_v, cand_i = [], []
    for c in range(clusters):
        part = x[:, c * width:(c + 1) * width].float()
        v, i = torch.sort(part, dim=-1, descending=True, stable=True)
        kk = min(k, part.shape[1])
        cand_v.append(v[:, :kk])
        cand_i.append(i[:, :kk] + c * width)
    v, i = torch.cat(cand_v, 1), torch.cat(cand_i, 1)
    # (value desc, id asc): order by id first, then a stable sort by value
    by_id = torch.argsort(i, dim=-1)
    v, i = torch.gather(v, 1, by_id), torch.gather(i, 1, by_id)
    order = torch.sort(v, dim=-1, descending=True, stable=True).indices
    return torch.gather(i, 1, order)[:, :k].to(torch.int32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ["normal", "rounded", "tied_across",
                                  "all_equal", "neg_inf_tail"])
@pytest.mark.parametrize("V", [258, 4097, 50280])
def test_slice_merge_selects_the_plain_top_k(V, case, dtype):
    """The union of the slices' top k holds the row's top k in lax.top_k
    order, ties across slices going to the smallest ids."""
    k = 48
    rng = np.random.default_rng(V)
    x = rng.normal(size=(3, V)).astype(np.float32)
    if case == "rounded":
        x = np.round(x * 2) / 2
    elif case == "tied_across":
        _, width, _ = ops.topk_cdf_geometry(V, dtype)
        x = rng.uniform(-4, 0, size=(3, V)).astype(np.float32)
        x[:, rng.choice(V, k - 3, replace=False)] = 5.0 + rng.uniform(
            0, 1, (3, k - 3))
        tied = [i for i in (width - 2, width + 1, width - 1, V - 1, 2 * width)
                if i < V]
        x[:, tied] = 4.0
    elif case == "all_equal":
        x[:] = 0.5
    elif case == "neg_inf_tail":
        x[:, k // 2:] = -np.inf
    t = torch.from_numpy(x).to(dtype)
    ids_r, _ = ref.topk_cdf(t, k, 16)
    assert torch.equal(_slice_merge_topk(t, k), ids_r)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wrappers_take_the_plain_version_on_the_cpu(dtype):
    """On a CPU tensor the wrappers return the plain versions' bits and
    launch nothing."""
    rng = np.random.default_rng(0)
    lg = torch.from_numpy(rng.normal(size=(4, 1000)).astype(
        np.float32)).to(dtype)
    q, k, v = (torch.from_numpy(rng.normal(size=s).astype(np.float32))
               .to(dtype) for s in ((2, 4, 40, 64), (2, 2, 40, 64),
                                    (2, 2, 40, 64)))
    ops.reset_launches()
    ids, cdf = ops.topk_cdf(lg, 48, 16)
    ids_r, cdf_r = ref.topk_cdf(lg, 48, 16)
    assert torch.equal(ids, ids_r) and torch.equal(cdf, cdf_r)
    for window in (None, 16):
        assert torch.equal(ops.flash_attention(q, k, v, True, window),
                           ref.flash_attention(q, k, v, True, window))
    assert all(n == 0 for n in ops.LAUNCHES.values())
