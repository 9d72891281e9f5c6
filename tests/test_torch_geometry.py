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
    """pred-base's 258 stays in one CTA; qwen3-1.7b's, mamba2-130m's and
    zamba2-7b's vocabularies take a cluster of 8 (16 rows: 128 CTAs)."""
    assert ops.topk_cdf_geometry(258, torch.float32) == (1, 264, True)
    assert ops.topk_cdf_geometry(32000, torch.bfloat16) == (8, 4000, True)
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
@pytest.mark.parametrize("V", [258, 50280, 151936, 32000])
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
    the probe's 32 tokens get 32-position tiles. zamba2-7b (MHA, G = 1):
    one head a CTA, 128-position tiles."""
    bf = torch.bfloat16
    assert ops.flash_geometry(128, 2, bf) == (2, 64)
    assert ops.flash_geometry(160, 2, bf) == (2, 64)
    assert ops.flash_geometry(32, 2, bf) == (2, 32)
    assert ops.flash_geometry(128, 1, bf) == (1, 128)
    assert ops.flash_geometry(160, 1, bf) == (1, 128)
    assert ops.flash_geometry(32, 1, bf) == (1, 32)


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


# ------------------------------------------------ cdf_points, decode_attention
#
# The full-vocabulary CDF kernel and the decode-attention kernel split
# their work by ``ops.cdf_points_geometry(V, dtype)`` and
# ``ops.decode_geometry(S, G, hd, dtype)``. Below: the same rules as for
# top-k and flash, and plain-PyTorch replays of each kernel's split and
# combine, held against the plain versions.

DECODE_CACHES = [1, 16, 31, 32, 33, 96, 128, 129, 160, 161, 256, 257, 512,
                 513, 1024, 4096]


def test_cdf_and_decode_geometry_take_only_static_shapes():
    assert list(inspect.signature(ops.cdf_points_geometry).parameters) == [
        "V", "dtype"]
    assert list(inspect.signature(ops.decode_geometry).parameters) == [
        "S", "G", "hd", "dtype"]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("V", VOCABS)
def test_cdf_geometry_slices_cover_the_row(V, dtype):
    clusters, width = ops.cdf_points_geometry(V, dtype)
    assert 1 <= clusters <= ops.CDF_MAX_CLUSTERS
    assert width % ops.CDF_ROW == 0
    assert clusters * width >= V > (clusters - 1) * width   # none empty
    el = torch.empty((), dtype=dtype).element_size()
    assert ops.cdf_points_staged(V, dtype) == (
        (el + 4) * width <= ops.CDF_STAGE_BYTES)


def test_cdf_geometry_at_the_configs_vocabularies():
    """pred-base's 258 stays in one CTA; qwen3-1.7b's 151,936 takes a
    cluster of 8 (16 rows: 128 CTAs), staged in shared memory."""
    assert ops.cdf_points_geometry(258, torch.float32) == (1, 384)
    assert ops.cdf_points_geometry(151936, torch.bfloat16) == (8, 19072)
    assert ops.cdf_points_geometry(50280, torch.bfloat16) == (8, 6400)
    assert ops.cdf_points_staged(151936, torch.bfloat16)
    assert not ops.cdf_points_staged(500000, torch.float32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("G,hd", [(1, 112), (2, 32), (2, 128), (8, 256),
                                  (16, 128)])
@pytest.mark.parametrize("S", DECODE_CACHES)
def test_decode_geometry_slices_cover_the_cache(S, G, hd, dtype):
    clusters, per = ops.decode_geometry(S, G, hd, dtype)
    assert 1 <= clusters <= ops.DECODE_MAX_CLUSTERS
    assert per % ops.DECODE_TILE == 0
    assert clusters * per >= S > (clusters - 1) * per        # none empty


def test_decode_geometry_at_the_configs_shapes():
    """qwen3-1.7b's chunk-128 cache: 4 CTAs of 32 positions; the scoring
    comparison's 161; a 512-position cache: 8 of 64."""
    bf = torch.bfloat16
    assert ops.decode_geometry(128, 2, 128, bf) == (4, 32)
    assert ops.decode_geometry(128, 2, 32, torch.float32) == (4, 32)
    assert ops.decode_geometry(161, 2, 128, bf) == (6, 32)
    assert ops.decode_geometry(512, 1, 112, bf) == (8, 64)
    # granite-moe-1b-a400m (G 2, hd 64), qwen3-moe-235b-a22b (G 16)
    assert ops.decode_geometry(128, 2, 64, bf) == (4, 32)
    assert ops.decode_geometry(128, 16, 128, bf) == (4, 32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("V", [258, 4097, 50280, 151936])
def test_cdf_launch_geometry_ignores_the_row_count(launches, V, dtype):
    n0 = ops.LAUNCHES["cdf_points"]
    for R in (1, 7, 16, 64):
        ops.cdf_points(torch.empty((R, V), dtype=dtype, device="meta"), 18)
    assert ops.LAUNCHES["cdf_points"] == n0 + 4
    assert [c[3] for c in launches.calls] == [1, 7, 16, 64]
    assert {c[6:8] for c in launches.calls} == {
        ops.cdf_points_geometry(V, dtype)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S,H,K,hd", [(128, 16, 8, 128), (128, 8, 4, 32),
                                      (161, 16, 8, 128), (512, 8, 8, 112),
                                      (161, 32, 32, 112),    # zamba2-7b
                                      (128, 64, 4, 128),     # qwen3-moe
                                      (128, 16, 8, 64)])     # granite-moe
def test_decode_launch_geometry_ignores_lanes_and_lengths(launches, S, H, K,
                                                          hd, dtype):
    """The wrapper never reads the lengths, and the split it passes on
    is the same for every lane count."""
    for B in (1, 3, 16):
        q = torch.empty((B, H, hd), dtype=dtype, device="meta")
        kc = torch.empty((B, S, K, hd), dtype=dtype, device="meta")
        lens = torch.empty((B,), dtype=torch.int32, device="meta")
        ops.decode_attention(q, kc, kc.clone(), lens)
    assert [c[10] for c in launches.calls] == [1, 3, 16]
    assert {c[17:19] for c in launches.calls} == {
        ops.decode_geometry(S, H // K, hd, dtype)}


def _lane_scan(x):
    """Inclusive sum over the last axis (32 lanes) in the order of the
    kernels' shuffle scan: at step d, lane l adds lane l - d's value."""
    for d in (1, 2, 4, 8, 16):
        y = torch.nn.functional.pad(x[..., :-d], (d, 0))
        lane = torch.arange(x.shape[-1], device=x.device)
        x = torch.where(lane >= d, y + x, x)
    return x


def _shift(x, fill):
    return torch.cat([torch.full_like(x[..., :1], fill), x[..., :-1]], -1)


def _cdf_replay(logits, precision):
    """The full-vocabulary CDF kernel's arithmetic in plain PyTorch:
    float32, every operation rounded on its own, in the kernel's order --
    slices of ``cdf_points_geometry``, 128-element rows of 32 lanes x 4,
    contiguous runs of rows per warp (16 warps), lane and warp offsets
    by the shuffle scan, slice offsets chained by the same scan over
    ranks; each prefix floored by the largest prefix before it and
    normalised by the row's largest. On the card (the same expf) it
    gives the kernel's integers bit for bit."""
    x = logits.float()
    R, V = x.shape
    dev = x.device
    C, width = ops.cdf_points_geometry(V, logits.dtype)
    M = x.max(dim=-1, keepdim=True).values
    e = torch.where(x > -np.inf, torch.exp(x - M), torch.zeros_like(x))
    ninf = torch.tensor(-np.inf, device=dev)
    u_local, tot, best = [], [], []
    for r in range(C):
        n = min(V, r * width + width) - r * width
        nrow = -(-n // 128)
        rpw = -(-nrow // 16)
        es = torch.nn.functional.pad(e[:, r * width:r * width + n],
                                     (0, nrow * 128 - n))
        es = es.reshape(R, nrow, 32, 4)
        a = [es[..., 0]]
        for k in range(1, 4):
            a.append(a[-1] + es[..., k])
        a = torch.stack(a, -1)
        incl = _lane_scan(a[..., 3])
        part = _shift(incl, 0.0)[..., None] + a          # (R, nrow, 32, 4)
        live = (torch.arange(nrow * 128, device=dev) < n).reshape(nrow, 32,
                                                                  4)
        v = torch.empty_like(part)
        wtot = torch.zeros(R, 32, device=dev)
        wmax = torch.full((R, 32), -np.inf, device=dev)
        for w in range(16):
            carry = torch.zeros(R, 1, 1, device=dev)
            for row in range(w * rpw, min(nrow, (w + 1) * rpw)):
                v[:, row] = carry + part[:, row]
                carry = carry + incl[:, row, 31][:, None, None]
                m = torch.where(live[row], v[:, row], ninf).amax((1, 2))
                wmax[:, w] = torch.maximum(wmax[:, w], m)
            wtot[:, w] = carry[:, 0, 0]
        winc = _lane_scan(wtot)
        wofs = _shift(winc, 0.0)
        best.append(torch.where(wmax > -np.inf, wofs + wmax, ninf)
                    .amax(-1))
        tot.append(winc[:, 31])
        rows = torch.arange(nrow, device=dev)
        u = wofs[:, torch.clamp(rows // rpw, max=15)][:, :, None, None] + v
        u_local.append(u.reshape(R, -1)[:, :n])
    tq = torch.nn.functional.pad(torch.stack(tot, -1), (0, 32 - C))
    ofs = _shift(_lane_scan(tq), 0.0)[:, :C]
    big = ofs + torch.stack(best, -1)
    total = big.amax(-1, keepdim=True)
    u = torch.cat([ofs[:, r:r + 1] + u_local[r] for r in range(C)], -1)
    c = torch.cummax(u, dim=-1).values / total
    budget = (1 << precision) - V
    pts = torch.floor(c * float(budget) + 0.5).to(torch.int32) \
        + torch.arange(1, V + 1, dtype=torch.int32, device=dev)
    pts[:, -1] = budget + V
    return pts


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ["normal", "neg_inf_tail", "all_equal"])
@pytest.mark.parametrize("V,prec", [(258, 16), (4097, 16), (50280, 16),
                                    (151936, 18)])
def test_cdf_replay_of_the_cluster_split_matches_the_plain_version(
        V, prec, case, dtype):
    """Segmented sums, slice offsets in rank order, the floor across
    slice edges and the normalisation give the plain version's points
    within one quantum, and every invariant exactly."""
    x = np.random.default_rng(V + 7).normal(size=(3, V)).astype(
        np.float32) * 3
    if case == "neg_inf_tail":
        x[:, V - V // 3:] = -np.inf
    elif case == "all_equal":
        x[:] = 0.25
    t = torch.from_numpy(x).to(dtype)
    pts = _cdf_replay(t, prec)
    want = ref.cdf_points(t, prec)
    assert (pts - want).abs().max().item() <= 1
    assert (pts.diff(dim=-1) >= 1).all()
    assert (pts[:, 0] >= 1).all() and (pts[:, -1] == 1 << prec).all()


def _decode_replay(q, kc, vc, lengths):
    """The decode kernel's split and combine in plain PyTorch: each slice
    of ``decode_geometry`` runs an online softmax over its tiles of 32
    positions that hold a live position, from m = -inf, l = 0, acc = 0;
    the slices' states are merged in rank order with weights
    exp(m_r - M) (0 for a slice with no live position)."""
    B, H, hd = q.shape
    S, K = kc.shape[1], kc.shape[2]
    G = H // K
    C, per = ops.decode_geometry(S, G, hd, q.dtype)
    scale = float(np.float32(1.0 / np.sqrt(hd)))
    qf = q.float().reshape(B, K, G, hd)
    kf, vf = kc.float(), vc.float()
    lens = lengths.long().clamp(max=S)
    states = []
    for r in range(C):
        m = torch.full((B, K, G), -np.inf)
        l = torch.zeros(B, K, G)
        acc = torch.zeros(B, K, G, hd)
        for t0 in range(r * per, min(S, (r + 1) * per), ops.DECODE_TILE):
            pos = torch.arange(t0, min(S, t0 + ops.DECODE_TILE,
                                       (r + 1) * per))
            live = pos[None, :] < lens[:, None]                  # (B, n)
            upd = live.any(-1)[:, None, None]
            s = torch.einsum("bkgd,bnkd->bkgn", qf, kf[:, pos]) * scale
            s = torch.where(live[:, None, None, :], s,
                            torch.tensor(-np.inf))
            m_new = torch.maximum(m, s.amax(-1))
            m_new = torch.where(upd, m_new, m)
            alpha = torch.where(upd, torch.exp(m - m_new), torch.ones(()))
            p = torch.where(live[:, None, None, :],
                            torch.exp(s - m_new[..., None]),
                            torch.zeros(()))
            l = l * alpha + p.sum(-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bkgn,bnkd->bkgd", p, vf[:, pos])
            m = m_new
        states.append((m, l, acc))
    M = torch.stack([s[0] for s in states]).amax(0)
    L = torch.zeros(B, K, G)
    O = torch.zeros(B, K, G, hd)
    for m, l, acc in states:
        a = torch.where(m == -np.inf, torch.zeros(()), torch.exp(m - M))
        L = L + l * a
        O = O + acc * a[..., None]
    return (O / L.clamp(min=1e-30)[..., None]).reshape(B, H, hd)


@pytest.mark.parametrize("B,H,K,S,hd", [(16, 16, 8, 128, 128),
                                         (16, 8, 4, 128, 32),
                                         (4, 8, 8, 512, 112),
                                         (3, 16, 2, 161, 64),
                                         (4, 64, 4, 128, 128)])   # G 16
def test_decode_replay_of_the_cluster_split_matches_the_plain_version(
        B, H, K, S, hd):
    """Per-slice softmax states merged in rank order give the plain
    version's output (fp32, atol 2e-5), lanes whose length leaves whole
    slices empty included; a lane of length 0 gives 0."""
    rng = np.random.default_rng(S + hd)
    t = lambda shape: torch.from_numpy(  # noqa: E731
        rng.normal(size=shape).astype(np.float32))
    q, kc, vc = t((B, H, hd)), t((B, S, K, hd)), t((B, S, K, hd))
    _, per = ops.decode_geometry(S, H // K, hd, torch.float32)
    lens = rng.integers(1, S + 1, B)
    lens[:4] = [1, per, per + 1, S][:B]       # slices left empty
    lens = torch.from_numpy(lens.astype(np.int32))
    got = _decode_replay(q, kc, vc, lens)
    want = ref.decode_attention(q, kc, vc, lens)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=2e-5)
    zero = _decode_replay(q[:1], kc[:1], vc[:1],
                          torch.zeros(1, dtype=torch.int32))
    assert torch.equal(zero, torch.zeros_like(zero))


@pytest.mark.parametrize("H,K,hd,dtype,ok", [
    (64, 4, 128, torch.bfloat16, True),     # qwen3-moe-235b-a22b: G 16
    (16, 1, 256, torch.bfloat16, True),     # G 16 at rows of 512 bytes
    (16, 1, 128, torch.float32, True),
    (16, 1, 256, torch.float32, False),     # G 16 at rows of 1 KB
    (8, 1, 256, torch.float32, True),       # G 8 takes any hd to 256
    (12, 1, 64, torch.bfloat16, True),      # G 12: 16 rows computed
    (32, 1, 64, torch.bfloat16, False),     # G 32
    (17, 1, 64, torch.bfloat16, False)])
def test_decode_wrappers_take_groups_of_up_to_16(launches, H, K, hd, dtype,
                                                 ok):
    """Both decode wrappers take G = H / K up to DECODE_MAX_G; above 8
    heads, q rows of at most DECODE_WIDE_ROW bytes (the sixteen heads'
    partial outputs of eight CTAs must fit a CTA's shared memory)."""
    q = torch.empty((2, H, hd), dtype=dtype, device="meta")
    kc = torch.empty((2, 128, K, hd), dtype=dtype, device="meta")
    k8 = torch.empty((2, 128, K, hd), dtype=torch.int8, device="meta")
    sc = torch.empty((2, 128, K), dtype=torch.float16, device="meta")
    lens = torch.empty((2,), dtype=torch.int32, device="meta")
    for run in (lambda: ops.decode_attention(q, kc, kc.clone(), lens),
                lambda: ops.decode_attention_int8(q, k8, k8.clone(), sc,
                                                  sc.clone(), lens)):
        if ok:
            run()
        else:
            with pytest.raises(ValueError, match="G="):
                run()
    assert len(launches.calls) == (2 if ok else 0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cdf_and_decode_wrappers_take_the_plain_version_on_the_cpu(dtype):
    rng = np.random.default_rng(1)
    lg = torch.from_numpy(rng.normal(size=(4, 1000)).astype(
        np.float32)).to(dtype)
    q, kc, vc = (torch.from_numpy(rng.normal(size=s).astype(np.float32))
                 .to(dtype) for s in ((3, 4, 64), (3, 40, 2, 64),
                                      (3, 40, 2, 64)))
    lens = torch.tensor([1, 17, 40], dtype=torch.int32)
    ops.reset_launches()
    assert torch.equal(ops.cdf_points(lg, 16), ref.cdf_points(lg, 16))
    assert torch.equal(ops.decode_attention(q, kc, vc, lens),
                       ref.decode_attention(q, kc, vc, lens))
    assert all(n == 0 for n in ops.LAUNCHES.values())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("V,prec,padded", [(258, 16, 263), (4097, 16, None),
                                           (50280, 16, None),
                                           (151936, 18, 152064)])
def test_cdf_kernel_is_its_replay_bit_for_bit(V, prec, padded, dtype):
    """On the card the replay above, run by PyTorch's own kernels, gives
    the cluster kernel's integers exactly: it describes the kernel's
    order of operations, not only its tolerance."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernel vs its replay)")
    x = np.random.default_rng(V).normal(size=(5, padded or V)).astype(
        np.float32) * 3
    t = torch.from_numpy(x).to("cuda").to(dtype)[:, :V]
    assert torch.equal(ops.cdf_points(t, prec), _cdf_replay(t, prec))


# ---------------------------------------------------------------- ssd_intra
# The bf16 SSD kernel splits a chunk over CTAs by ops.ssd_geometry: a
# group of heads and a 64-row tile of y, or the chunk-end state of two of
# the group's heads. The split follows the static shapes only, and the
# plain replay below holds its order (G once per (row tile, column tile)
# for the group, y over j tiles in order, the state over j tiles in
# order) to the plain version.

def test_ssd_geometry_takes_only_static_shapes():
    assert list(inspect.signature(ops.ssd_geometry).parameters) == [
        "Q", "H", "P", "N", "dtype"]
    assert ops.ssd_geometry(128, 24, 64, 128, torch.bfloat16) == (64, 4, 2, 2)
    assert ops.ssd_geometry(32, 24, 64, 128, torch.bfloat16) == (64, 4, 1, 2)
    assert ops.ssd_geometry(160, 24, 64, 128, torch.bfloat16) == (64, 4, 3,
                                                                    2)
    assert ops.ssd_geometry(4096, 24, 64, 128, torch.bfloat16) == (64, 2, 64,
                                                                     1)
    assert ops.ssd_geometry(128, 3, 64, 128, torch.bfloat16) == (64, 2, 2, 1)
    assert ops.ssd_geometry(16, 8, 16, 16, torch.float32) == (32, 1, 1, 1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Q", [1, 23, 32, 64, 65, 128, 160, 256, 4096])
@pytest.mark.parametrize("H,P,N", [(1, 8, 4), (2, 16, 16), (3, 40, 72),
                                   (24, 64, 128), (25, 64, 65)])
def test_ssd_geometry_covers_the_chunk(Q, H, P, N, dtype):
    rows, heads, ytiles, parts = ops.ssd_geometry(Q, H, P, N, dtype)
    assert (ytiles - 1) * rows < Q <= ytiles * rows
    groups = -(-H // heads)
    assert (groups - 1) * heads < H <= groups * heads
    if dtype == torch.bfloat16:
        assert rows == ops.SSD_ROWS and heads in (2, 4)
        assert parts * 2 == heads           # two heads per state CTA
    else:
        assert (rows, heads, parts) == (32, 1, 1)


def test_ssd_grid_fills_the_card_at_the_scoring_shapes():
    """mamba2-130m (H = 24, P = 64, N = 128) on 132 SMs, two CTAs of 256
    threads resident on each: 16 chunks of 128 launch 384 CTAs, the
    probe's 23 x 32 launch 414, the prefix's 16 x 160 launch 480.
    zamba2-7b (H = 112, N = 64): (y tiles + 2) x 28 CTAs a chunk, 1,792,
    1,932 and 2,240."""
    for H, N, R, Q, want in ((24, 128, 16, 128, 384), (24, 128, 23, 32, 414),
                             (24, 128, 16, 160, 480),
                             (112, 64, 16, 128, 1792),
                             (112, 64, 23, 32, 1932),
                             (112, 64, 16, 160, 2240)):
        rows, heads, ytiles, parts = ops.ssd_geometry(Q, H, 64, N,
                                                      torch.bfloat16)
        ctas = (ytiles + parts) * (-(-H // heads)) * R
        assert ctas == want and ctas >= 2 * 132


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Q,H,P,N", [(128, 24, 64, 128), (32, 24, 64, 128),
                                     (23, 3, 40, 72), (16, 8, 16, 16),
                                     (128, 112, 64, 64)])     # zamba2-7b
def test_ssd_launch_geometry_ignores_the_chunk_count(launches, Q, H, P, N,
                                                     dtype):
    n0 = ops.LAUNCHES["ssd_intra"]
    for R in (1, 5, 16):
        conv = torch.empty((R, Q, H * P + 2 * N), dtype=dtype,
                           device="meta")
        x, Bm, Cm = torch.split(conv, [H * P, N, N], dim=-1)
        ops.ssd_intra(x.reshape(R, Q, H, P),
                      torch.empty((R, Q, H), dtype=dtype, device="meta"),
                      torch.empty((H,), device="meta"), Bm, Cm)
    assert ops.LAUNCHES["ssd_intra"] == n0 + 3
    assert [c[17] for c in launches.calls] == [1, 5, 16]
    assert {c[24:28] for c in launches.calls} == {
        ops.ssd_geometry(Q, H, P, N, dtype)}


def _ssd_inputs(seed, R, Q, H, P, N):
    rng = np.random.default_rng(seed)
    f = lambda *s: torch.from_numpy(  # noqa: E731
        rng.normal(size=s).astype(np.float32))
    return (f(R, Q, H, P), torch.from_numpy(rng.uniform(
        0.05, 0.8, (R, Q, H)).astype(np.float32)), torch.from_numpy(
        -rng.uniform(0.3, 2.0, (H,)).astype(np.float32)), f(R, Q, N),
        f(R, Q, N))


def _split(v, on):
    """The kernel's bf16 (hi, lo) parts of an fp32 factor, as floats."""
    if not on:
        return [v]
    hi = v.bfloat16().float()
    return [hi, (v - hi).bfloat16().float()]


def ssd_replay(x, dt, A, Bm, Cm, split=False):
    """The bf16 kernel's split of the work, in plain fp32 PyTorch: for
    each head group and 64-row tile of y, G = C_i B_j^T once per j tile,
    then per head W = G exp(cum_i - cum_j) dt_j and y_i += W x_j, j tiles
    in order; the exp taken per entry in 16 x 16 blocks on the diagonal
    (exponent -inf where j > i), and below them as exp(cum_i - cum_r) b_j
    with r the j block's last position and b_j = exp(cum_r - cum_j) dt_j.
    For each head, the state S += (x_j e_j)^T B_j, j tiles in order.
    ``split``: the fp32 factors W and x e as the kernel feeds them to the
    tensor cores, a bf16 high part and a bf16 remainder."""
    R, Q, H, P = x.shape
    N = Bm.shape[2]
    rows, heads, ytiles, _ = ops.ssd_geometry(Q, H, P, N, torch.bfloat16)
    x, dt, Bm, Cm = (t.float() for t in (x, dt, Bm, Cm))
    cum = torch.cumsum(dt * A, dim=1)                         # (R, Q, H)
    y = torch.zeros((R, Q, H, P))
    state = torch.zeros((R, H, P, N))
    tiles = [slice(k * rows, min(Q, (k + 1) * rows)) for k in range(ytiles)]
    pos = torch.arange(Q)
    ref_pos = torch.clamp(pos // 16 * 16 + 15, max=Q - 1)    # r of each j
    fb = torch.exp(cum[:, ref_pos] - cum) * dt                # b_j
    for g0 in range(0, H, heads):
        hs = slice(g0, min(H, g0 + heads))
        for it, i in enumerate(tiles):
            for j in tiles[:it + 1]:
                G = torch.einsum("rin,rjn->rij", Cm[:, i], Bm[:, j])
                seg = cum[:, i, None, hs] - cum[:, None, j, hs]
                seg = torch.where((pos[j][None, :] <= pos[i][:, None])
                                  [None, :, :, None], seg,
                                  torch.tensor(float("-inf")))
                direct = torch.exp(seg) * dt[:, None, j, hs]
                fa = torch.exp(cum[:, i, None, hs]
                               - cum[:, None, ref_pos[j], hs])
                below = (pos[j][None, :] // 16 < pos[i][:, None] // 16)
                L = torch.where(below[None, :, :, None],
                                fa * fb[:, None, j, hs], direct)
                W = G[..., None] * L
                for part in _split(W, split):
                    y[:, i, hs] += torch.einsum("rijh,rjhp->rihp", part,
                                                x[:, j, hs])
        for j in tiles:
            e = torch.exp(cum[:, Q - 1:Q, hs] - cum[:, j, hs]) * dt[:, j, hs]
            for part in _split(x[:, j, hs] * e[..., None], split):
                state[:, hs] += torch.einsum("rjhp,rjn->rhpn", part,
                                             Bm[:, j])
    return y, state


@pytest.mark.parametrize("R,Q,H,P,N", [(2, 128, 8, 64, 128), (3, 23, 3, 8, 4),
                                       (2, 160, 5, 40, 72),
                                       (1, 256, 4, 64, 128),
                                       (2, 1, 2, 16, 16), (1, 65, 1, 8, 65)])
def test_ssd_replay_of_the_split_matches_the_plain_version(R, Q, H, P, N):
    """fp32 factors: within 2e-5 of the plain version's scale (the order
    of sums differs). bf16 inputs with the kernel's hi/lo split of W and
    x e: within 1e-4, the card's tolerance for the bf16 kernel."""
    args = _ssd_inputs(R * Q + N, R, Q, H, P, N)
    for split, tol in ((False, 2e-5), (True, 1e-4)):
        if split:
            args = tuple(a if k == 2 else a.bfloat16().float()
                         for k, a in enumerate(args))
        y, s = ssd_replay(*args, split=split)
        yr, sr = ref.ssd_intra(*args)
        scale = max(1.0, yr.abs().max().item(), sr.abs().max().item())
        assert (y - yr).abs().max().item() <= tol * scale
        assert (s - sr).abs().max().item() <= tol * scale
