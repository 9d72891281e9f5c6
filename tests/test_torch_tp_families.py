"""The port's serve steps on a mesh for the ssm, hybrid, encdec and vlm
families against the JAX package's sharded steps, on the CPU (gloo).

The JAX reference runs in a subprocess on 4 host devices (Auto axes, as
``tests/test_torch_tp.py``'s): it writes each config (its fields), its
weights, the tokens, the conditioning (encdec ``frames`` (B, 8, D), vlm
``img_embeds`` (B, 4, D)) and its outputs to an npz file. The port runs
the same config and weights (``from_jax``, cut by ``shard_params``) in
one world of 4 ranks (meshes (1, 4) and (2, 2)) and one of 2 ((1, 2)).
Configs: ``tiny(family, vocab_pad_multiple=4)`` for the four families,
and ``tiny("ssm", ssm_headdim=64)`` at (1, 4), whose 2 SSD heads do not
divide 4: the mixer whole on every rank.

  * ssm: the SSD heads (``ssd_intra``'s H / tp), ``in_z``/``in_x``/
    ``in_dt`` columns and ``conv_w`` in the port's [xc block | B | C]
    layout cut over 'model'; ``out_proj`` summed over 'model';
  * hybrid: the same, and the shared attention block's heads; at (1, 4)
    its 2 KV heads do not divide 4: each application's cache is cut
    along the sequence (lock-step, the partial kernel's plain twin);
  * encdec: the encoder's non-causal attention on the rank's heads, the
    cross K/V of the frames a rank's KV heads or, at (1, 4), its slice
    of the source (the partial twin and the LSE combine);
  * vlm: scored under its image prefix, the image rows cut with the
    tokens over 'data' at (2, 2).

Each through ``make_serve_step`` (8 steps), ``make_prefill_step`` (a
4-token prefix, then 4 serve steps) and ``make_score_step``; on the
meshes with one rank over 'data', also through ``ModelPredictor``'s
decode and scoring with the frames or the image. In fp32: the decode
logits within 1e-4 of JAX's (atol and rtol), the same top-K ids, qpmf
within one quantum, and every rank's outputs equal to rank 0's.
"""
import dataclasses
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401  (caps torch's threads)

from repro_torch.configs.base import ModelConfig  # noqa: E402
from repro_torch.core.cdf import topk_cdf  # noqa: E402
from repro_torch.launch.mesh import Mesh, run_ranks  # noqa: E402
from repro_torch.models import api, schema  # noqa: E402
from repro_torch.serve import steps  # noqa: E402
from repro_torch.serve.engine import ModelPredictor  # noqa: E402
from repro_torch.service import CompressionService  # noqa: E402
from repro_torch.sharding import specs  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
B, S, PREFIX, K = 4, 8, 4, 8
#: config name -> (family, tiny's overrides)
CONFIGS = {
    "ssm": ("ssm", {}),
    "ssm64": ("ssm", {"ssm_headdim": 64}),
    "hybrid": ("hybrid", {}),
    "encdec": ("encdec", {}),
    "vlm": ("vlm", {}),
}
#: case -> (config name, mesh shape)
CASES = {f"{c}_{a}x{b}": (c, (a, b))
         for c in ("ssm", "hybrid", "encdec", "vlm")
         for a, b in ((1, 2), (1, 4), (2, 2))}
CASES["ssm64_1x4"] = ("ssm64", (1, 4))
LOGIT_TOL = 1e-4

JAX_SCRIPT = r"""
import dataclasses, json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding
sys.path.insert(0, sys.argv[2])
from helpers import tiny
from repro.models import api as mapi
from repro.models.encdec import precompute_cross_kv
from repro.models.layers import mesh_context
from repro.serve.steps import (_fam_kw, make_prefill_step, make_score_step,
                               make_serve_step)
from repro.sharding.specs import cache_pspecs, param_pspecs

B, S, PREFIX, K = %(B)d, %(S)d, %(PREFIX)d, %(K)d
CONFIGS = %(CONFIGS)r
CASES = %(CASES)r
out = {}
rng = np.random.default_rng(0)
tokens = rng.integers(0, 256, (B, S)).astype(np.int32)
out["tokens"] = tokens
inputs = np.concatenate([np.full((B, 1), 256, np.int32), tokens[:, :-1]],
                        axis=1)

def flat(tree, prefix=""):
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from flat(v, prefix + k + "/")
        else:
            yield prefix + k, np.asarray(v, np.float32)

cfgs, params, extra = {}, {}, {}
for name, (family, kw) in CONFIGS.items():
    cfg = tiny(family, vocab_pad_multiple=4, **kw)
    cfgs[name] = cfg
    out[f"cfg/{name}"] = np.frombuffer(
        json.dumps(dataclasses.asdict(cfg)).encode(), np.uint8)
    params[name] = mapi.init_params(cfg, jax.random.PRNGKey(0))
    for k, v in flat(params[name]):
        out[f"params/{name}/{k}"] = v
    extra[name] = {}
    if family == "encdec":
        extra[name]["frames"] = rng.normal(
            size=(B, cfg.max_source_len, cfg.d_model)).astype(np.float32)
    if family == "vlm":
        extra[name]["img_embeds"] = rng.normal(
            size=(B, cfg.n_img_tokens, cfg.d_model)).astype(np.float32)
    for k, v in extra[name].items():
        out[f"extra/{name}/{k}"] = v

for case, (name, shape) in CASES.items():
    cfg = cfgs[name]
    n = int(np.prod(shape))
    mesh = Mesh(np.array(jax.devices()[:n]).reshape(shape), ("data", "model"))
    sh = lambda s: NamedSharding(mesh, s)
    ps = jax.device_put(params[name], jax.tree_util.tree_map(
        sh, param_pspecs(cfg, mesh, "serve")))
    cspec = jax.tree_util.tree_map(sh, cache_pspecs(cfg, mesh, batch=B))

    def fresh():
        c = mapi.init_cache(cfg, B, S)
        if cfg.family == "encdec":
            xk, xv = precompute_cross_kv(params[name], cfg,
                                         jnp.asarray(extra[name]["frames"]))
            c = {**c, "xk": xk, "xv": xv}
        return jax.device_put(c, cspec)

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
    i, q = score(ps, {"tokens": jnp.asarray(inputs),
                      **{k: jnp.asarray(v) for k, v in extra[name].items()}})
    out[f"{case}/score_ids"] = np.asarray(i)
    out[f"{case}/score_q"] = np.asarray(q)
np.savez(sys.argv[1], **out)
print("JAX_REF_OK")
"""


def jax_reference(path: pathlib.Path) -> dict:
    """Run the JAX steps of every case in a subprocess (4 host devices)
    and load what it wrote."""
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env["PYTHONPATH"] = f"{ROOT / 'src'}"
    env["JAX_PLATFORMS"] = "cpu"
    code = JAX_SCRIPT % dict(B=B, S=S, PREFIX=PREFIX, K=K, CONFIGS=CONFIGS,
                             CASES=CASES)
    r = subprocess.run([sys.executable, "-c", code, str(path),
                        str(ROOT / "tests")], capture_output=True, text=True,
                       env=env, timeout=600)
    assert r.returncode == 0 and "JAX_REF_OK" in r.stdout, \
        r.stdout[-3000:] + r.stderr[-3000:]
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def _cfg(ref_: dict, name: str) -> ModelConfig:
    """The JAX config's fields, as the port's config."""
    return ModelConfig(**json.loads(ref_[f"cfg/{name}"].tobytes()))


def _tree(ref_: dict, pre: str) -> dict:
    tree: dict = {}
    for k, v in ref_.items():
        if k.startswith(pre):
            node = tree
            parts = k[len(pre):].split("/")
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = v
    return tree


def _digest(mesh, *tensors) -> bool:
    return mesh.agree(b"".join(t.contiguous().numpy().tobytes()
                               for t in tensors))


def run_case(mesh, ref_: dict, name: str) -> dict:
    """The port's steps on this rank (one case's mesh); rank 0's
    outputs, and whether every rank's equal them."""
    cfg = _cfg(ref_, name)
    whole = schema.from_jax(_tree(ref_, f"params/{name}/"))
    p = specs.shard_params(whole, cfg, mesh)
    extra = {k: torch.as_tensor(v)
             for k, v in _tree(ref_, f"extra/{name}/").items()}
    tokens = torch.as_tensor(ref_["tokens"]).long()
    inputs = torch.cat([torch.full((B, 1), 256), tokens[:, :-1]], dim=1)
    out = {}
    if cfg.family in ("ssm", "hybrid"):
        # the port's conv layout, gathered back over 'model'
        entry = specs.param_pspecs(cfg, mesh, "serve")["layers"]["conv_w"]
        out["conv_gathered"] = torch.tensor(torch.equal(specs.gather_conv(
            p["layers"]["conv_w"], cfg, mesh, entry[-1]),
            whole["layers"]["conv_w"]))

    def fresh():
        cache = api.init_cache(cfg, B, S, mesh=mesh)
        steps.write_conditioning(p, cfg, cache, extra, mesh, batch=B)
        return cache

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

    # the prefill step conditions the cache itself, given the frames
    prefill = steps.make_prefill_step(cfg, mesh, batch=B)
    cache = prefill(p, api.init_cache(cfg, B, S, mesh=mesh),
                    tokens[:, :PREFIX], extra)
    ids, qs = [], []
    for t in range(PREFIX - 1, S - 1):
        i, q, cache = serve(p, cache, tokens[:, t])
        ids.append(i)
        qs.append(q)
    out["prefill_ids"], out["prefill_q"] = torch.stack(ids), torch.stack(qs)

    score = steps.make_score_step(cfg, mesh, topk=K, global_batch=B)
    out["score_ids"], out["score_q"] = score(p, {"tokens": inputs, **extra})
    if mesh.shape["data"] == 1:
        out.update(run_engine(mesh, cfg, p, tokens, extra))
    out["agree"] = _digest(mesh, *out.values())
    return out


def run_engine(mesh, cfg, p, tokens, extra) -> dict:
    """The engine on this rank, as the coder drives it (decode steps and
    scoring, each read through ``topk_cdf`` with K), under the config's
    conditioning: the frames' cross K/V written by ``begin_decode``, the
    image in scoring."""
    pred = ModelPredictor(p, cfg, mesh=mesh, device="cpu",
                          extra_batch=extra)
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
    try:
        CompressionService(pred, slots=B, chunk_size=S, topk=K,
                           device="cpu")
        refused = False
    except ValueError as e:
        refused = "lock-step" in str(e)
    return dict(engine_ids=torch.stack(ids), engine_q=torch.stack(qs),
                engine_score_ids=i, engine_score_q=torch.diff(cdf, dim=-1),
                lockstep=torch.tensor(pred.lockstep),
                refused=torch.tensor(refused))


def world(mesh4_or_2, npz: str, cases: list) -> dict:
    """One world's cases: every mesh of this world's size built on it."""
    torch.set_num_threads(1)
    with np.load(npz) as z:
        ref_ = {k: z[k] for k in z.files}
    got = {}
    for case in cases:
        name, shape = CASES[case]
        mesh = mesh4_or_2 if shape == mesh4_or_2.devices_shape else \
            Mesh(shape, ("data", "model"))
        got[case] = run_case(mesh, ref_, name)
    return got


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    d = tmp_path_factory.mktemp("tp_families")
    ref_ = jax_reference(d / "jax.npz")
    npz = str(d / "jax.npz")
    got = run_ranks(world, (1, 4), backend="gloo", device="cpu",
                    args=(npz, [c for c in CASES if CASES[c][1] != (1, 2)]),
                    store_dir=d, timeout=900)
    got.update(run_ranks(world, (1, 2), backend="gloo", device="cpu",
                         args=(npz, [c for c in CASES
                                     if CASES[c][1] == (1, 2)]),
                         store_dir=d, timeout=900))
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
    _same_topk(got[case]["prefill_ids"], got[case]["prefill_q"],
               got[case]["serve_ids"][PREFIX:].numpy(),
               got[case]["serve_q"][PREFIX:].numpy())


@pytest.mark.parametrize("case", list(CASES))
def test_score_step_matches_jax(results, case):
    ref_, got = results
    _same_topk(got[case]["score_ids"], got[case]["score_q"],
               ref_[f"{case}/score_ids"], ref_[f"{case}/score_q"])


@pytest.mark.parametrize("case", [c for c in CASES if CASES[c][1][0] == 1])
def test_engine_matches_jax(results, case):
    """``ModelPredictor(mesh=...)``'s decode and scoring, under the
    frames or the image, read by the coder's ``topk_cdf``, give JAX's
    sharded serve and score steps' top-K. Decode is lock-step exactly
    where a self-attention cache is cut along the sequence (hybrid's
    shared block, encdec's and vlm's decoder at (1, 4); never ssm), and
    the continuous-batching service refuses exactly those predictors."""
    ref_, got = results
    g = got[case]
    name, (_, tp) = CASES[case]
    _same_topk(g["engine_ids"], g["engine_q"], ref_[f"{case}/serve_ids"],
               ref_[f"{case}/serve_q"])
    _same_topk(g["engine_score_ids"], g["engine_score_q"],
               ref_[f"{case}/score_ids"], ref_[f"{case}/score_q"])
    lockstep = not name.startswith("ssm") and tp == 4
    assert bool(g["lockstep"]) == lockstep == bool(g["refused"])


def test_the_replicated_mixer_and_the_cut_source(results):
    """The cases the (1, 4) mesh forces: ssm64's 2 SSD heads do not
    divide 4 (every rank holds the mixer whole: no ``ssm_inner`` cut),
    and encdec's 2 KV heads do not either (its cross K/V cut along the
    source positions, JAX's spec)."""
    ref_, _ = results
    mesh = Mesh((1, 4), ("data", "model"), rank=1)
    c64, ced = _cfg(ref_, "ssm64"), _cfg(ref_, "encdec")
    assert specs.rules(c64, mesh, "serve")["ssm_inner"] is None
    assert specs.rules(_cfg(ref_, "ssm"), mesh, "serve")["ssm_inner"] \
        == "model"
    assert specs.cache_pspecs(ced, mesh, batch=B)["xk"][2:4] == \
        ("model", None)
    local = api.init_cache(ced, B, S, device="meta", mesh=mesh)
    assert tuple(local["xk"].shape) == (ced.n_layers, B,
                                        ced.max_source_len // 4,
                                        ced.padded_kv_heads, ced.head_dim)
    p64 = api.init_cache(c64, B, S, device="meta", mesh=mesh)
    assert tuple(p64["conv"].shape[2:]) == (
        c64.ssm_conv - 1, c64.ssm_d_inner + 2 * c64.ssm_state)
    assert dataclasses.asdict(c64)["ssm_headdim"] == 64


@pytest.mark.parametrize("case", [c for c in CASES
                                  if CASES[c][0] in ("ssm", "hybrid")])
def test_gathered_conv_is_the_global_leaf(results, case):
    """Every rank's ``conv_w`` block ([its xc block | B | C]), gathered
    over 'model' (``specs.gather_conv``), is JAX's global leaf."""
    assert bool(results[1][case]["conv_gathered"])
