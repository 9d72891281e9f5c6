"""The port's serve steps on a mesh against the JAX package's sharded
steps, on the CPU (gloo).

The JAX reference runs in a subprocess that sets ``XLA_FLAGS`` for 4
host devices before importing ``jax`` and lays its meshes out with
Auto axes (``jax.sharding.Mesh``); it writes its weights, tokens and
outputs to an npz file. The port runs the same weights (``from_jax``,
cut by ``shard_params``) in one world of 4 ranks (meshes (1, 4) and
(2, 2), ranks of one thread each) and one of 2 ((1, 2)), each started
once per module (``launch.mesh.run_ranks``, a ``FileStore`` under the
module's temporary directory). Configs: ``tiny(vocab_pad_multiple=4)``
(vocabulary 260, which 2 and 4 divide: the sharded top-K) with 2 KV
heads, and ``tiny("moe", vocab_pad_multiple=4)``.

  * dense on (1, 2): heads, KV heads and vocabulary cut over 'model';
  * dense on (1, 4): 2 KV heads do not divide 4, so decode takes the
    sequence-sharded attention (the partial kernel's plain twin and the
    LSE combine), with the model dtype's cache and with an int8 cache;
  * dense on (2, 2): the batch over 'data';
  * moe on (1, 4) (4 experts, one a rank) and (2, 2) (the serve layout:
    each rank holds its D-block of two experts);
  * ``topk_quantized_sharded`` alone on (1, 4), on logits full of ties.

Each through ``make_serve_step`` (8 steps), ``make_prefill_step`` (a
4-token prefix, then 4 serve steps) and ``make_score_step``; on the
meshes with one rank over 'data', also through the engine
(``ModelPredictor(mesh=...)``'s decode and scoring, read by the coder's
``topk_cdf``). In fp32:
the decode logits within 1e-4 of JAX's (atol and rtol), the same top-K
ids, qpmf within one quantum, every qpmf row summing to 2**16 with every
entry >= 1, and every rank's outputs equal to rank 0's. Beside them, the
partial decode attention's plain twin: four slices of a cache combined
by their LSE equal ``ref.decode_attention`` on the whole cache, and a
lane of length 0 gives o = 0 and lse = -inf.
"""
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs.base import ModelConfig  # noqa: E402
from repro_torch.core.cdf import (LogitShards, as_tensor,  # noqa: E402
                                  full_logits, to_numpy, topk_cdf,
                                  topk_quantized_sharded)
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.launch.mesh import Mesh, run_ranks  # noqa: E402
from repro_torch.models import api, schema  # noqa: E402
from repro_torch.serve import steps  # noqa: E402
from repro_torch.serve.engine import ModelPredictor  # noqa: E402
from repro_torch.sharding import specs  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
B, S, PREFIX, K = 4, 8, 4, 8
#: case -> (config, cache dtype, mesh shape)
CASES = {
    "dense_1x2": ("dense", None, (1, 2)),
    "dense_1x4": ("dense", None, (1, 4)),
    "dense_int8_1x4": ("dense", "int8", (1, 4)),
    "dense_2x2": ("dense", None, (2, 2)),
    "moe_1x4": ("moe", None, (1, 4)),
    "moe_2x2": ("moe", None, (2, 2)),
}
LOGIT_TOL = 1e-4

JAX_SCRIPT = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
sys.path.insert(0, sys.argv[2])
from helpers import tiny
from repro.core.cdf import topk_quantized, topk_quantized_sharded
from repro.models import api as mapi
from repro.models.layers import mesh_context
from repro.serve.steps import (_fam_kw, make_prefill_step, make_score_step,
                               make_serve_step)
from repro.sharding.specs import cache_pspecs, param_pspecs

B, S, PREFIX, K = %(B)d, %(S)d, %(PREFIX)d, %(K)d
CASES = %(CASES)r
out = {}
rng = np.random.default_rng(0)
tokens = rng.integers(0, 256, (B, S)).astype(np.int32)
out["tokens"] = tokens
bos = np.full((B, 1), 256, np.int32)
inputs = np.concatenate([bos, tokens[:, :-1]], axis=1)

def cfg_of(family, kv):
    kw = dict(vocab_pad_multiple=4)
    if kv:
        kw["kv_cache_dtype"] = kv
    return tiny(family, **kw)

def flat(tree, prefix=""):
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from flat(v, prefix + k + "/")
        else:
            yield prefix + k, np.asarray(v, np.float32)

params = {}
for family in ("dense", "moe"):
    params[family] = mapi.init_params(cfg_of(family, None),
                                      jax.random.PRNGKey(0))
    for k, v in flat(params[family]):
        out[f"params/{family}/{k}"] = v

for case, (family, kv, shape) in CASES.items():
    cfg = cfg_of(family, kv)
    n = int(np.prod(shape))
    mesh = Mesh(np.array(jax.devices()[:n]).reshape(shape), ("data", "model"))
    sh = lambda s: NamedSharding(mesh, s)
    pspec = jax.tree_util.tree_map(sh, param_pspecs(cfg, mesh, "serve"))
    ps = jax.device_put(params[family], pspec)
    cspec = jax.tree_util.tree_map(sh, cache_pspecs(cfg, mesh, batch=B))

    def fresh():
        return jax.device_put(mapi.init_cache(cfg, B, S), cspec)

    serve = make_serve_step(cfg, mesh, batch=B, topk=K)
    cache, ids, qs = fresh(), [], []
    for t in range(S):
        i, q, cache = serve(ps, cache, jnp.asarray(inputs[:, t]))
        ids.append(np.asarray(i)); qs.append(np.asarray(q))
    out[f"{case}/serve_ids"] = np.stack(ids)
    out[f"{case}/serve_q"] = np.stack(qs)

    fam = _fam_kw(cfg, mesh)

    @jax.jit
    def logits_step(p, c, x):
        with mesh_context(mesh, layout="serve"):
            return mapi.decode_step(p, cfg, c, x, **fam)
    cache, lgs = fresh(), []
    for t in range(S):
        lg, cache = logits_step(ps, cache, jnp.asarray(inputs[:, t]))
        lgs.append(np.asarray(lg, np.float32))
    out[f"{case}/logits"] = np.stack(lgs)

    prefill = make_prefill_step(cfg, mesh, batch=B)
    cache = prefill(ps, fresh(), jnp.asarray(tokens[:, :PREFIX]))
    ids, qs = [], []
    for t in range(PREFIX - 1, S - 1):
        i, q, cache = serve(ps, cache, jnp.asarray(tokens[:, t]))
        ids.append(np.asarray(i)); qs.append(np.asarray(q))
    out[f"{case}/prefill_ids"] = np.stack(ids)
    out[f"{case}/prefill_q"] = np.stack(qs)

    score = make_score_step(cfg, mesh, topk=K, global_batch=B)
    i, q = score(jax.device_put(params[family], jax.tree_util.tree_map(
        sh, param_pspecs(cfg, mesh, "serve" if family != "moe" else "train"))),
        {"tokens": jnp.asarray(inputs)})
    out[f"{case}/score_ids"] = np.asarray(i)
    out[f"{case}/score_q"] = np.asarray(q)

# the sharded top-K alone, on logits full of ties
mesh = Mesh(np.array(jax.devices()[:4]).reshape(1, 4), ("data", "model"))
lg = (np.round(rng.normal(size=(6, 260)) * 4) / 4).astype(np.float32)
out["topk/logits"] = lg
x = jax.device_put(jnp.asarray(lg), NamedSharding(mesh, P(None, "model")))
i, q = topk_quantized_sharded(x, K, 16, mesh, batch_axes=())
out["topk/ids"], out["topk/q"] = np.asarray(i), np.asarray(q)
i, q = topk_quantized(jnp.asarray(lg), K, 16)
out["topk/ids_whole"], out["topk/q_whole"] = np.asarray(i), np.asarray(q)
np.savez(sys.argv[1], **out)
print("JAX_REF_OK")
"""


def jax_reference(path: pathlib.Path, cases: dict) -> dict:
    """Run the JAX steps for ``cases`` in a subprocess (4 host devices)
    and load what it wrote."""
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env["PYTHONPATH"] = f"{ROOT / 'src'}"
    env["JAX_PLATFORMS"] = "cpu"
    code = JAX_SCRIPT % dict(B=B, S=S, PREFIX=PREFIX, K=K, CASES=cases)
    r = subprocess.run([sys.executable, "-c", code, str(path),
                        str(ROOT / "tests")], capture_output=True, text=True,
                       env=env, timeout=600)
    assert r.returncode == 0 and "JAX_REF_OK" in r.stdout, \
        r.stdout[-3000:] + r.stderr[-3000:]
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def _cfg(family: str, kv) -> ModelConfig:
    base = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
                vocab_size=257, head_pad_multiple=1, vocab_pad_multiple=4,
                dtype="float32", remat=False)
    if family == "moe":
        base.update(n_experts=4, top_k=2)
    if kv:
        base["kv_cache_dtype"] = kv
    return ModelConfig(name=f"tiny-{family}", family=family, **base)


def _params(ref_: dict, family: str) -> dict:
    tree: dict = {}
    pre = f"params/{family}/"
    for k, v in ref_.items():
        if k.startswith(pre):
            node = tree
            parts = k[len(pre):].split("/")
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = v
    return schema.from_jax(tree)


def _digest(mesh, *tensors) -> bool:
    return mesh.agree(b"".join(t.contiguous().numpy().tobytes()
                               for t in tensors))


def run_case(mesh, ref_: dict, family: str, kv) -> dict:
    """The port's steps on this rank (one case's mesh); rank 0's
    outputs, and whether every rank's equal them."""
    cfg = _cfg(family, kv)
    p = specs.shard_params(_params(ref_, family), cfg, mesh)
    tokens = torch.as_tensor(ref_["tokens"]).long()
    inputs = torch.cat([torch.full((B, 1), 256), tokens[:, :-1]], dim=1)
    out = {}

    def fresh():
        return api.init_cache(cfg, B, S, mesh=mesh)

    serve = steps.make_serve_step(cfg, mesh, batch=B, topk=K)
    cache, ids, qs = fresh(), [], []
    for t in range(S):
        i, q, cache = serve(p, cache, inputs[:, t])
        ids.append(i)
        qs.append(q)
    out["serve_ids"], out["serve_q"] = torch.stack(ids), torch.stack(qs)

    rows = steps._Rows(mesh, B)
    cache, lgs = fresh(), []
    with torch.no_grad():
        for t in range(S):
            lg, cache = api.decode_step(p, cfg, cache, rows.mine(
                inputs[:, t]), mesh=mesh, batch_sharded=rows.sharded)
            if steps.vocab_sharded(cfg, mesh):
                lg = mesh.all_gather(lg, "model", dim=-1)
            lgs.append(rows.whole(lg))
    out["logits"] = torch.stack(lgs)

    prefill = steps.make_prefill_step(cfg, mesh, batch=B)
    cache = prefill(p, fresh(), tokens[:, :PREFIX])
    ids, qs = [], []
    for t in range(PREFIX - 1, S - 1):
        i, q, cache = serve(p, cache, tokens[:, t])
        ids.append(i)
        qs.append(q)
    out["prefill_ids"], out["prefill_q"] = torch.stack(ids), torch.stack(qs)

    # the score step takes its layout's blocks (moe: the train layout)
    score = steps.make_score_step(cfg, mesh, topk=K, global_batch=B)
    out["score_ids"], out["score_q"] = score(specs.shard_params(
        _params(ref_, family), cfg, mesh,
        layout=steps.score_layout(cfg, mesh)), {"tokens": inputs})
    if mesh.shape["data"] == 1:
        out.update(run_engine(mesh, cfg, p, tokens))
    out["agree"] = _digest(mesh, *out.values())
    return out


def run_engine(mesh, cfg, p, tokens) -> dict:
    """The engine on this rank, as the coder drives it: decode steps
    (a cache of S positions, so that each rank of a sequence-sharded
    decode holds live ones) and scoring, each read through ``topk_cdf``
    with K, as the coder reads a predictor's logits."""
    pred = ModelPredictor(p, cfg, mesh=mesh, device="cpu")
    pred.set_decode_len(S)
    state = pred.begin_decode(B)
    prev = np.full(B, pred.bos_id)
    ids, qs = [], []
    for t in range(S):
        lg, state = pred.decode_step(state, prev)
        i, cdf = topk_cdf(lg, K, 16)
        ids.append(i)
        qs.append(torch.diff(cdf, dim=-1))
        prev = tokens[:, t].numpy()
    i, cdf = topk_cdf(pred.score_chunks(tokens.numpy()), K, 16)
    return dict(engine_ids=torch.stack(ids), engine_q=torch.stack(qs),
                engine_score_ids=i, engine_score_q=torch.diff(cdf, dim=-1))


def world(mesh4_or_2, npz: str, cases: list) -> dict:
    """One world's cases: every mesh of this world's size built on it."""
    torch.set_num_threads(1)
    with np.load(npz) as z:
        ref_ = {k: z[k] for k in z.files}
    got = {}
    for case in cases:
        family, kv, shape = CASES[case]
        mesh = mesh4_or_2 if shape == mesh4_or_2.devices_shape else \
            Mesh(shape, ("data", "model"))
        got[case] = run_case(mesh, ref_, family, kv)
    if mesh4_or_2.size == 4:
        mesh = mesh4_or_2
        lg = torch.as_tensor(ref_["topk/logits"])
        n = lg.shape[1] // 4
        local = lg[:, mesh.axis_index("model") * n:][:, :n]
        i, q = topk_quantized_sharded(local, K, 16, mesh)
        got["topk"] = dict(ids=i, q=q, agree=_digest(mesh, i, q))
    return got


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    d = tmp_path_factory.mktemp("tp")
    ref_ = jax_reference(d / "jax.npz", CASES)
    npz = str(d / "jax.npz")
    got = run_ranks(world, (1, 4), backend="gloo", device="cpu",
                    args=(npz, [c for c in CASES if CASES[c][2] != (1, 2)]),
                    store_dir=d, timeout=900)
    got.update(run_ranks(world, (1, 2), backend="gloo", device="cpu",
                         args=(npz, ["dense_1x2"]), store_dir=d,
                         timeout=900))
    return ref_, got


def _same_topk(ids_p, q_p, ids_j, q_j, precision=16):
    ids_p, q_p = np.asarray(ids_p), np.asarray(q_p)
    np.testing.assert_array_equal(ids_p, ids_j)
    assert np.abs(q_p.astype(np.int64) - q_j).max() <= 1
    assert (q_p.sum(-1) == 1 << precision).all() and (q_p >= 1).all()


@pytest.mark.parametrize("case", list(CASES))
def test_serve_step_matches_jax(results, case):
    ref_, got = results
    g = got[case]
    assert g["agree"], "a rank's outputs differ from rank 0's"
    np.testing.assert_allclose(g["logits"].numpy(), ref_[f"{case}/logits"],
                               atol=LOGIT_TOL, rtol=LOGIT_TOL)
    _same_topk(g["serve_ids"], g["serve_q"], ref_[f"{case}/serve_ids"],
               ref_[f"{case}/serve_q"])


@pytest.mark.parametrize("case", list(CASES))
def test_prefill_step_matches_jax(results, case):
    ref_, got = results
    _same_topk(got[case]["prefill_ids"], got[case]["prefill_q"],
               ref_[f"{case}/prefill_ids"], ref_[f"{case}/prefill_q"])
    # the prefilled cache serves what the serve steps' own cache does
    _same_topk(got[case]["prefill_ids"], got[case]["prefill_q"],
               got[case]["serve_ids"][PREFIX:].numpy(),
               got[case]["serve_q"][PREFIX:].numpy())


@pytest.mark.parametrize("case", list(CASES))
def test_score_step_matches_jax(results, case):
    ref_, got = results
    _same_topk(got[case]["score_ids"], got[case]["score_q"],
               ref_[f"{case}/score_ids"], ref_[f"{case}/score_q"])


@pytest.mark.parametrize("case", [c for c in CASES if CASES[c][2][0] == 1])
def test_engine_matches_jax(results, case):
    """The engine's decode and scoring on a mesh, read by the coder's
    ``topk_cdf``, give JAX's sharded serve and score steps' top-K."""
    ref_, got = results
    g = got[case]
    _same_topk(g["engine_ids"], g["engine_q"], ref_[f"{case}/serve_ids"],
               ref_[f"{case}/serve_q"])
    _same_topk(g["engine_score_ids"], g["engine_score_q"],
               ref_[f"{case}/score_ids"], ref_[f"{case}/score_q"])


def test_logit_shards_are_read_explicitly():
    """A mesh step's logits convert to nothing implicitly: the reader
    asks for the top-K CDF or for the whole vocabulary, and an index that
    may reach the vocabulary axis raises."""
    x = torch.randn(2, 3, 10, generator=torch.Generator().manual_seed(0))
    lg = LogitShards(x, Mesh((1, 1), ("data", "model"), rank=0),
                     sharded=False, vocab=9)
    for convert in (as_tensor, to_numpy, lambda a: a[..., 0],
                    lambda a: a[0, 1, 2], lambda a: a[:, None]):
        with pytest.raises(TypeError, match="LogitShards"):
            convert(lg)
    assert torch.equal(full_logits(lg), x[..., :9])
    row = lg[1]
    assert isinstance(row, LogitShards) and torch.equal(row.local, x[1])
    for a, b in zip(topk_cdf(lg, 4), topk_cdf(x[..., :9], 4)):
        assert torch.equal(a, b)


def test_sharded_topk_matches_jax_and_the_whole(results):
    ref_, got = results
    t = got["topk"]
    assert t["agree"]
    _same_topk(t["ids"], t["q"], ref_["topk/ids"], ref_["topk/q"])
    # ties to the lower global id: the unsharded top-K's ids
    _same_topk(t["ids"], t["q"], ref_["topk/ids_whole"], ref_["topk/q_whole"])


def test_partial_twin_combines_to_the_whole_cache():
    """Four slices' (o, lse), combined by the LSE as the sequence-sharded
    decode combines them, give ``ref.decode_attention`` on the whole
    cache; a slice where a lane has no live position gives o = 0 and
    lse = -inf for it (weight 0)."""
    g = torch.Generator().manual_seed(0)
    Bq, H, Kh, hd, Sq = 3, 8, 2, 16, 32
    q = torch.randn(Bq, H, hd, generator=g)
    kc = torch.randn(Bq, Sq, Kh, hd, generator=g)
    vc = torch.randn(Bq, Sq, Kh, hd, generator=g)
    lengths = torch.tensor([32, 9, 1], dtype=torch.int32)
    want = ref.decode_attention(q, kc, vc, lengths)
    n = Sq // 4
    parts = [ops.decode_attention_partial(
        q, kc[:, r * n:(r + 1) * n], vc[:, r * n:(r + 1) * n],
        (lengths - r * n).clamp(0, n).to(torch.int32)) for r in range(4)]
    lse = torch.stack([p[1] for p in parts])                 # (4, B, H)
    m = lse.amax(0)
    w = torch.exp(lse - m)
    o = sum(p[0] * w[r][..., None] for r, p in enumerate(parts)) \
        / w.sum(0)[..., None]
    torch.testing.assert_close(o, want, atol=1e-5, rtol=1e-5)
    # lane 2 has one live position: slices 1..3 hold none of it
    for r in (1, 2, 3):
        assert torch.equal(parts[r][0][2], torch.zeros(H, hd))
        assert torch.isneginf(parts[r][1][2]).all()
    # the int8 twin dequantizes first, then attends the same way
    from repro_torch.models.transformer import _quant_kv
    kq, ks = _quant_kv(kc)
    vq, vs = _quant_kv(vc)
    o8, l8 = ops.decode_attention_partial_int8(q, kq, vq, ks, vs, lengths)
    o_, l_ = ref.decode_attention_partial(q, ref.dequant_kv(kq, ks, q.dtype),
                                          ref.dequant_kv(vq, vs, q.dtype),
                                          lengths)
    assert torch.equal(o8, o_) and torch.equal(l8, l_)
    # an all-empty cache: every lane weighs 0
    o0, l0 = ops.decode_attention_partial(
        q, kc[:, :0], vc[:, :0], torch.zeros(Bq, dtype=torch.int32))
    assert torch.equal(o0, torch.zeros_like(o0)) and torch.isneginf(l0).all()


def test_backends_are_refused_not_switched():
    """nccl on the CPU, or with more ranks than cards, is refused before
    any process starts; an unknown backend too."""
    with pytest.raises(ValueError, match="nccl"):
        run_ranks(world, (1, 2), backend="nccl", device="cpu")
    with pytest.raises(ValueError, match="backend"):
        run_ranks(world, (1, 2), backend="mpi", device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            run_ranks(world, (1, 2), backend="gloo", device="cuda")


def test_a_failing_rank_ends_the_run(tmp_path):
    with pytest.raises(RuntimeError, match="rank 1"):
        run_ranks(_fail_on_rank_1, (1, 2), backend="gloo", device="cpu",
                  store_dir=tmp_path, timeout=120)


def _fail_on_rank_1(mesh):
    if mesh.rank == 1:
        raise ValueError("rank 1 fails")
    mesh.psum(torch.ones(2), "model")       # rank 0 waits here: killed
    return True

