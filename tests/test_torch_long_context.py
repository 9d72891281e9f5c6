"""Long-context decode on a mesh against the JAX package, on the CPU
(gloo): caches cut along the sequence over the batch axes, a
sliding-window ring cut along its slots, and JAX's train-layout moe
scoring.

The JAX reference runs in a subprocess on 4 host devices (as
``tests/test_torch_tp.py``'s) with its meshes' Auto axes, and writes its
weights, tokens and outputs to an npz file. The port runs the same
weights (``from_jax``, cut by ``shard_params``) in one world of 4 ranks,
started once for the module, which builds the (1, 4), (2, 2) and (4, 1)
meshes. Configs are ``tiny``'s (fp32, vocabulary padded to 260):

  * ``swa``: a window of 8 slots over 2 KV heads, at (1, 4): the ring
    cut over 'model' (2 slots a rank), per-lane positions (the lanes
    start at 0, 3, 5 and 6), with the model dtype's cache and with an
    int8 cache; and at batch 1 on (2, 2): the ring over 'data';
  * ``dense`` (no window) at batch 1 on (2, 2) and on (4, 1): the
    sequence over 'data';
  * ``kv1`` (one KV head) at batch 1 on (2, 2): the sequence over
    ('data', 'model'), lock-step (JAX's predicate);
  * ``hybrid`` and ``encdec`` at batch 1 on (2, 2): the shared block's
    cache over 'data' (the SSM state whole on every rank), and the
    decoder's self cache and the cross K/V of the one source over
    'data'.

Each through ``make_serve_step`` (12 steps from the lanes' starting
positions, past the ring's wrap), the decode logits of the same steps
and ``make_prefill_step`` (a 4-token prefix, then the serve steps to the
16th token): the logits within 1e-4 of JAX's, the same top-K ids, qpmf
within one quantum, and every rank's outputs equal to rank 0's. Where
JAX's sharded step raises for a case (R1), the port is held against
JAX's unsharded step on the same weights, and the test says so.

``moe`` scoring at (2, 2), at batch 4 (the rows over 'data') and at
batch 1 (the tokens cut over 'data' inside the dispatch): the port's
``make_score_step`` in JAX's train layout (dropless, groups of 2,048),
given that layout's blocks, against JAX's ``make_score_step``.

``ModelPredictor`` with the ``swa`` config at (1, 4): a service round
trip (chunks of 24 tokens, three times the window; more chunks than
lanes, so lanes are reset after the wrap; a shared prefix whose lane
snapshot is restored) and a speculative decompression (drafts rejected
after the wrap, so the ring's rollback runs) are byte-identical, and
every rank's archives are rank 0's.

Last, training with microbatches that do not divide the batch axes:
one row over 'data' 2, whole on every rank (as JAX's ``batch_pspecs``
keeps it), and two rows over (pod 2, data 2), cut over 'data' and
whole over 'pod' (``train_loop.row_axes``), each with the loss, the
gradient norm and every updated block equal to the unsharded step's;
and moe with capacity drops on (pod, data, model) meshes, in this world
and in one of 8 ranks, against JAX's train step and gradients under the
same mesh (``TRAIN_CASES``). Two cases run again with the partials
merged as JAX merges them over many ranks (``PSUM_CASES``).
"""
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401  (caps torch's threads)

from repro_torch import obs  # noqa: E402
from repro_torch.configs.base import ModelConfig  # noqa: E402
from repro_torch.core import LLMCompressor  # noqa: E402
from repro_torch.data import synthetic  # noqa: E402
from repro_torch.data.tokenizer import encode  # noqa: E402
from repro_torch.launch.mesh import Mesh, run_ranks  # noqa: E402
from repro_torch.models import api, schema, transformer  # noqa: E402
from repro_torch.serve import steps  # noqa: E402
from repro_torch.serve.engine import ModelPredictor  # noqa: E402
from repro_torch.service import CompressionService  # noqa: E402
from repro_torch.sharding import specs  # noqa: E402
from repro_torch.train import optimizer as popt  # noqa: E402
from repro_torch.train import train_loop as ploop  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
T, MAXLEN, PREFIX, K = 16, 24, 4, 8
STEPS = 12
#: config name -> (family, tiny's overrides)
CONFIGS = {
    "swa": ("dense", {"sliding_window": 8}),
    "swa_int8": ("dense", {"sliding_window": 8, "kv_cache_dtype": "int8"}),
    "dense": ("dense", {}),
    "kv1": ("dense", {"n_kv_heads": 1}),
    "hybrid": ("hybrid", {}),
    "encdec": ("encdec", {}),
    "moe": ("moe", {}),
    "moe_drop": ("moe", {"capacity_factor": 0.5}),
}
#: case -> (config name, batch, mesh shape, the lanes' first positions)
CASES = {
    "swa_1x4": ("swa", 4, (1, 4), (0, 3, 5, 6)),
    "swa_int8_1x4": ("swa_int8", 4, (1, 4), (0, 3, 5, 6)),
    "swa_b1_2x2": ("swa", 1, (2, 2), (3,)),
    "dense_b1_2x2": ("dense", 1, (2, 2), (2,)),
    "dense_b1_4x1": ("dense", 1, (4, 1), (2,)),
    "kv1_b1_2x2": ("kv1", 1, (2, 2), (1,)),
    "hybrid_b1_2x2": ("hybrid", 1, (2, 2), (0,)),
    "encdec_b1_2x2": ("encdec", 1, (2, 2), (0,)),
}
#: moe scoring case -> batch at (2, 2)
SCORE_CASES = {"moe_2x2": 4, "moe_b1_2x2": 1}
#: a case run again with the partials merged by JAX's pmax and psum
#: (``transformer.COMBINE_GATHER_RANKS`` 1) -> the JAX case it is held to
PSUM_CASES = {"kv1_b1_2x2+psum": "kv1_b1_2x2", "swa_1x4+psum": "swa_1x4"}
#: moe training with capacity drops on a (pod, data, model) mesh, the
#: ``moe_drop`` config: case -> (mesh shape, global batch, kind, the
#: batch axes a microbatch's rows are cut over). "step": JAX's train
#: step, 2 microbatches; "vg": JAX's value_and_grad under the mesh
TRAIN_CASES = {"moe_pod_part": ((2, 2, 1), 4, "step", ("data",)),
               "moe_pod_cut": ((2, 2, 1), 8, "step", ("pod", "data")),
               "moe_ep_whole": ((2, 1, 2), 1, "vg", ()),
               "moe_ep_part": ((2, 2, 2), 2, "vg", ("data",))}
TRAIN_OPT = dict(learning_rate=3e-3, warmup_steps=2, total_steps=6, eps=1e-5)
LOGIT_TOL = 1e-4

JAX_SCRIPT = r"""
import dataclasses, json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
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

T, MAXLEN, PREFIX, K, STEPS = %(T)d, %(MAXLEN)d, %(PREFIX)d, %(K)d, %(STEPS)d
CONFIGS = %(CONFIGS)r
CASES = %(CASES)r
SCORE_CASES = %(SCORE_CASES)r
TRAIN_CASES = %(TRAIN_CASES)r
TRAIN_OPT = %(TRAIN_OPT)r
out = {}
rng = np.random.default_rng(0)
tokens = rng.integers(0, 256, (4, T)).astype(np.int32)
out["tokens"] = tokens

def flat(tree, prefix=""):
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from flat(v, prefix + k + "/")
        else:
            yield prefix + k, np.asarray(v, np.float32)

cfgs, params = {}, {}
for name, (family, kw) in CONFIGS.items():
    cfg = tiny(family, vocab_pad_multiple=4, **kw)
    cfgs[name] = cfg
    out[f"cfg/{name}"] = np.frombuffer(
        json.dumps(dataclasses.asdict(cfg)).encode(), np.uint8)
    params[name] = mapi.init_params(cfg, jax.random.PRNGKey(0))
    for k, v in flat(params[name]):
        out[f"params/{name}/{k}"] = v
frames = rng.normal(size=(1, cfgs["encdec"].max_source_len,
                          cfgs["encdec"].d_model)).astype(np.float32)
out["frames"] = frames

def run(cfg, p0, B, mesh, pos0):
    toks = tokens[:B]
    inputs = np.concatenate([np.full((B, 1), 256, np.int32),
                             toks[:, :-1]], axis=1)
    if mesh is None:
        ps, put = p0, (lambda c: c)
    else:
        sh = lambda s: NamedSharding(mesh, s)
        ps = jax.device_put(p0, jax.tree_util.tree_map(
            sh, param_pspecs(cfg, mesh, "serve")))
        cspec = jax.tree_util.tree_map(sh, cache_pspecs(cfg, mesh, batch=B))
        put = lambda c: jax.device_put(c, cspec)

    def fresh(pos):
        c = mapi.init_cache(cfg, B, MAXLEN)
        if cfg.family == "encdec":
            xk, xv = precompute_cross_kv(p0, cfg, jnp.asarray(frames))
            c = {**c, "xk": xk, "xv": xv}
        c = {**c, "pos": jnp.asarray(np.asarray(pos, np.int32))}
        return put(c)

    res = {}
    serve = make_serve_step(cfg, mesh, batch=B, topk=K)
    cache, ids, qs = fresh(pos0), [], []
    for t in range(STEPS):
        i, q, cache = serve(ps, cache, jnp.asarray(inputs[:, t]))
        ids.append(np.asarray(i)); qs.append(np.asarray(q))
    res["serve_ids"], res["serve_q"] = np.stack(ids), np.stack(qs)
    fam = _fam_kw(cfg, mesh)

    @jax.jit
    def logits_step(p, c, x):
        with mesh_context(mesh, layout="serve"):
            return mapi.decode_step(p, cfg, c, x, **fam)
    cache, lgs = fresh(pos0), []
    for t in range(STEPS):
        lg, cache = logits_step(ps, cache, jnp.asarray(inputs[:, t]))
        lgs.append(np.asarray(lg, np.float32))
    res["logits"] = np.stack(lgs)
    prefill = make_prefill_step(cfg, mesh, batch=B)
    cache = prefill(ps, fresh([0] * B), jnp.asarray(toks[:, :PREFIX]))
    ids, qs = [], []
    for t in range(PREFIX - 1, T - 1):
        i, q, cache = serve(ps, cache, jnp.asarray(toks[:, t]))
        ids.append(np.asarray(i)); qs.append(np.asarray(q))
    res["prefill_ids"], res["prefill_q"] = np.stack(ids), np.stack(qs)
    return res

for case, (name, B, shape, pos0) in CASES.items():
    cfg = cfgs[name]
    n = int(np.prod(shape))
    mesh = Mesh(np.array(jax.devices()[:n]).reshape(shape), ("data", "model"))
    try:
        res = run(cfg, params[name], B, mesh, pos0)
        out[f"{case}/mode"] = np.frombuffer(b"sharded", np.uint8)
    except Exception as e:
        res = run(cfg, params[name], B, None, pos0)
        out[f"{case}/mode"] = np.frombuffer(
            ("unsharded: " + type(e).__name__).encode(), np.uint8)
    for k, v in res.items():
        out[f"{case}/{k}"] = v

cfg = cfgs["moe"]
mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("data", "model"))
sh = lambda s: NamedSharding(mesh, s)
for case, B in SCORE_CASES.items():
    inputs = np.concatenate([np.full((B, 1), 256, np.int32),
                             tokens[:B, :-1]], axis=1)
    score = make_score_step(cfg, mesh, topk=K, global_batch=B)
    ps = jax.device_put(params["moe"], jax.tree_util.tree_map(
        sh, param_pspecs(cfg, mesh, "train")))
    i, q = score(ps, {"tokens": jnp.asarray(inputs)})
    out[f"{case}/score_ids"] = np.asarray(i)
    out[f"{case}/score_q"] = np.asarray(q)

from repro.train import optimizer as jopt
from repro.train.train_loop import make_train_step
cfg, oc = cfgs["moe_drop"], jopt.AdamWConfig(**TRAIN_OPT)
ttoks = rng.integers(0, 256, (8, 12)).astype(np.int32)
out["train_tokens"] = ttoks
for case, (shape, G, kind, _) in TRAIN_CASES.items():
    mesh = Mesh(np.array(jax.devices()[:int(np.prod(shape))]).reshape(shape),
                ("pod", "data", "model"))
    ps = jax.device_put(params["moe_drop"], jax.tree_util.tree_map(
        lambda s: NamedSharding(mesh, s), param_pspecs(cfg, mesh)))
    batch = {"tokens": jnp.asarray(ttoks[:G])}
    if kind == "step":
        step = make_train_step(cfg, mesh, opt=oc, num_microbatches=2,
                               global_batch=G, donate=False)
        new, _, m = step(ps, jopt.init_opt_state(ps, oc), batch)
        out[f"{case}/loss"] = np.asarray(m["loss"])
        out[f"{case}/grad_norm"] = np.asarray(m["grad_norm"])
        tree = new
    else:
        @jax.jit
        def vg(p, b):
            with mesh_context(mesh):
                return jax.value_and_grad(mapi.loss_fn)(
                    p, cfg, b, attn_impl="masked", mesh=mesh)
        loss, tree = vg(ps, batch)
        out[f"{case}/loss"] = np.asarray(loss)
    for k, v in flat(tree):
        out[f"{case}/tree/{k}"] = v
np.savez(sys.argv[1], **out)
print("JAX_REF_OK")
"""


def jax_reference(path: pathlib.Path) -> dict:
    """Run the JAX steps of every case in a subprocess (4 host devices)
    and load what it wrote."""
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env["PYTHONPATH"] = f"{ROOT / 'src'}"
    env["JAX_PLATFORMS"] = "cpu"
    code = JAX_SCRIPT % dict(T=T, MAXLEN=MAXLEN, PREFIX=PREFIX, K=K,
                             STEPS=STEPS, CONFIGS=CONFIGS, CASES=CASES,
                             SCORE_CASES=SCORE_CASES,
                             TRAIN_CASES=TRAIN_CASES, TRAIN_OPT=TRAIN_OPT)
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


def run_case(mesh, ref_: dict, name: str, B: int, pos0) -> dict:
    """The port's steps on this rank (one case's mesh); rank 0's
    outputs, and whether every rank's equal them."""
    cfg = _cfg(ref_, name)
    p = specs.shard_params(schema.from_jax(_tree(ref_, f"params/{name}/")),
                           cfg, mesh)
    extra = {"frames": torch.as_tensor(ref_["frames"])} \
        if cfg.family == "encdec" else {}
    toks = torch.as_tensor(ref_["tokens"][:B]).long()
    inputs = torch.cat([torch.full((B, 1), 256), toks[:, :-1]], dim=1)
    rows = steps._Rows(mesh, B)
    out = {}

    def fresh(pos):
        cache = api.init_cache(cfg, B, MAXLEN, mesh=mesh)
        steps.write_conditioning(p, cfg, cache, extra, mesh, batch=B)
        cache["pos"].copy_(rows.mine(torch.tensor(pos, dtype=torch.int32)))
        return cache

    serve = steps.make_serve_step(cfg, mesh, batch=B, topk=K)
    cache, ids, qs = fresh(pos0), [], []
    for t in range(STEPS):
        i, q, cache = serve(p, cache, inputs[:, t])
        ids.append(i)
        qs.append(q)
    out["serve_ids"], out["serve_q"] = torch.stack(ids), torch.stack(qs)
    out["seq_axes"] = torch.tensor(len(specs.seq_axes(
        cfg, mesh, lanes_cut=rows.sharded)))

    cache, lgs = fresh(pos0), []
    with torch.no_grad():
        for t in range(STEPS):
            lg, cache = api.decode_step(p, cfg, cache, rows.mine(
                inputs[:, t]), mesh=mesh, batch_sharded=rows.sharded)
            if steps.vocab_sharded(cfg, mesh):
                lg = mesh.all_gather(lg, "model", dim=-1)
            lgs.append(rows.whole(lg))
    out["logits"] = torch.stack(lgs)

    prefill = steps.make_prefill_step(cfg, mesh, batch=B)
    cache = prefill(p, fresh([0] * B), toks[:, :PREFIX])
    ids, qs = [], []
    for t in range(PREFIX - 1, T - 1):
        i, q, cache = serve(p, cache, toks[:, t])
        ids.append(i)
        qs.append(q)
    out["prefill_ids"], out["prefill_q"] = torch.stack(ids), torch.stack(qs)
    out["agree"] = torch.tensor(_digest(mesh, *out.values()))
    return out


def run_scores(mesh, ref_: dict) -> dict:
    """moe scoring at (2, 2) in JAX's train layout, given the blocks of
    that layout (``steps.score_layout``)."""
    cfg = _cfg(ref_, "moe")
    whole = schema.from_jax(_tree(ref_, "params/moe/"))
    p = specs.shard_params(whole, cfg, mesh,
                           layout=steps.score_layout(cfg, mesh))
    got = {}
    for case, B in SCORE_CASES.items():
        inputs = torch.cat([torch.full((B, 1), 256), torch.as_tensor(
            ref_["tokens"][:B, :-1]).long()], dim=1)
        score = steps.make_score_step(cfg, mesh, topk=K, global_batch=B)
        out = dict(zip(("ids", "q"), score(p, {"tokens": inputs})))
        out["agree"] = torch.tensor(_digest(mesh, *out.values()))
        got[case] = out
    return got


def _texts():
    """Texts the same in every process (``human_like`` seeds with
    ``hash(domain)``, pinned here)."""
    synthetic.hash = lambda s: 5
    try:
        return [encode(synthetic.human_like("wiki", 150, seed=3)),
                encode(synthetic.human_like("code", 90, seed=4)),
                encode(synthetic.human_like("math", 60, seed=5))]
    finally:
        del synthetic.hash


def run_engine(mesh, ref_: dict) -> dict:
    """The windowed predictor at (1, 4): the service (lane resets, a
    shared prefix's snapshot restored) and speculative decompression
    (the ring's rollback), every archive byte-identical."""
    cfg = _cfg(ref_, "swa")
    pred = ModelPredictor.random_init(cfg, seed=3, device="cpu", mesh=mesh)
    texts = _texts()
    svc = CompressionService(pred, slots=4, chunk_size=24, topk=K,
                             device="cpu")
    blobs = [h.result()[0] for h in [svc.submit_compress(t) for t in texts]]
    back = {i: svc.submit_decompress(blobs[i]) for i in (2, 0, 1)}
    out = dict(service=all(np.array_equal(back[i].result(), t)
                           for i, t in enumerate(texts)))
    prefix = texts[2][:10]
    shared = [svc.submit_compress(t, shared_prefix=prefix).result()[0]
              for t in texts[:2]]
    out["shared"] = all(np.array_equal(svc.submit_decompress(b).result(), t)
                        for b, t in zip(shared, texts))
    out["prefix_hits"] = svc.snapshot()["prefix_cache"]["hits"]
    reg = obs.MetricsRegistry()
    spec = LLMCompressor(pred, chunk_size=24, topk=K, decode_batch=4,
                         draft_k=3, registry=reg)
    out["speculative"] = all(np.array_equal(spec.decompress(b), t)
                             for b, t in zip(blobs, texts))
    out["rollbacks"] = reg.value("spec.rollbacks")
    out["ring_split"] = pred._ring_slice(pred.begin_decode(4)) is not None
    out["agree"] = mesh.agree(b"".join(blobs + shared))
    return out


def run_train(mesh, rows: int) -> dict:
    """A train step whose microbatches of ``rows`` rows do not divide
    the mesh's batch axes, against the unsharded step on the same
    weights."""
    cfg = ModelConfig(name="tiny-dense", family="dense", n_layers=2,
                      d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
                      vocab_size=257, head_pad_multiple=1,
                      vocab_pad_multiple=1, dtype="float32", remat=False)
    opt = popt.AdamWConfig(**TRAIN_OPT)
    whole = api.init_params(cfg, 0, "cpu")
    toks = torch.as_tensor(np.random.default_rng(1).integers(
        0, 256, (2 * rows, 12))).long()
    p = specs.shard_params(whole, cfg, mesh, layout="train")
    step = ploop.make_train_step(cfg, mesh, opt=opt, num_microbatches=2,
                                 global_batch=2 * rows)
    new, _, m = step(p, popt.init_opt_state(p, opt), {"tokens": toks})
    one = ploop.make_train_step(cfg, None, opt=opt, num_microbatches=2)
    want, _, m1 = one(whole, popt.init_opt_state(whole, opt),
                      {"tokens": toks})
    want = specs.shard_params(want, cfg, mesh, layout="train")
    return dict(loss=(float(m["loss"]), float(m1["loss"])),
                norm=(float(m["grad_norm"]), float(m1["grad_norm"])),
                new=popt.tree_leaves(new), want=popt.tree_leaves(want),
                axes=ploop.row_axes(cfg, mesh, rows))


def _off_blocks(mesh, cfg, got: dict, want_np: dict, close) -> int:
    """The leaves of this rank's blocks ``got`` that are not ``close``
    to their blocks of the whole numpy tree ``want_np``, counted over
    every rank of ``mesh``."""
    want = specs.shard_params(schema.from_jax(want_np), cfg, mesh,
                              layout="train")
    off = torch.tensor([float(sum(
        not close(g, w) for g, w in zip(popt.tree_leaves(got),
                                        popt.tree_leaves(want))))])
    return int(mesh.psum(off, mesh.axis_names).item())


def run_train_moe(ref_: dict, world: int) -> dict:
    """The moe training cases of a world of ``world`` ranks: with one
    rank on 'model' (JAX's one-device dispatch of the whole microbatch)
    a microbatch cut over 'data' and whole over 'pod', and one cut over
    both, against JAX's train step; with 'model' cutting the experts
    (JAX's ``mapped``), one row whole on every rank and two rows cut
    over 'data' and whole over 'pod' (the tokens cut further over the
    axes the rows are whole on), against JAX's gradients under the same
    mesh."""
    cfg = _cfg(ref_, "moe_drop")
    whole = schema.from_jax(_tree(ref_, "params/moe_drop/"))
    toks = torch.as_tensor(ref_["train_tokens"]).long()
    opt = popt.AdamWConfig(**TRAIN_OPT)
    out = {}
    for case, (shape, G, kind, _) in TRAIN_CASES.items():
        if int(np.prod(shape)) != world:
            continue
        mesh = Mesh(shape, ("pod", "data", "model"))
        p = specs.shard_params(whole, cfg, mesh, layout="train")
        want = _tree(ref_, f"{case}/tree/")
        r = dict(axes=ploop.row_axes(cfg, mesh, G // 2 if kind == "step"
                                     else G))
        if kind == "step":
            step = ploop.make_train_step(cfg, mesh, opt=opt,
                                         num_microbatches=2, global_batch=G)
            new, _, m = step(p, popt.init_opt_state(p, opt),
                             {"tokens": toks[:G]})
            r.update(loss=float(m["loss"]), norm=float(m["grad_norm"]),
                     off=_off_blocks(mesh, cfg, new, want, lambda a, b:
                                     torch.allclose(a, b, rtol=1e-5,
                                                    atol=1e-6)))
        else:
            rows = ploop.rank_rows({"tokens": toks[:G]}, cfg, mesh, G)
            loss, g = ploop.value_and_grad(p, cfg, rows, mesh=mesh,
                                           batch_sharded=r["axes"])
            near = lambda a, b: torch.allclose(  # noqa: E731
                a, b, rtol=0, atol=1e-4 * float(b.abs().max()))
            # JAX's embedding gradient is not held: under ``mapped`` with
            # the rows whole over a batch axis it comes out non-finite
            # (one row) or ~1e8 (two), a reference-side fault, where every
            # other leaf agrees. The port's is held against its own with
            # the rows whole on every rank: the same blocks of tokens are
            # dispatched together, so the same function
            _, gw = ploop.value_and_grad(p, cfg, {"tokens": toks[:G]},
                                         mesh=mesh, batch_sharded=())
            r["embed_off"] = int(mesh.psum(torch.tensor(
                [float(not near(g["embed"], gw["embed"]))]),
                mesh.axis_names).item())
            g.pop("embed")
            want.pop("embed")
            r.update(loss=float(loss), off=_off_blocks(mesh, cfg, g, want,
                                                       near),
                     unsharded=float(api.loss_fn(whole, cfg,
                                                 {"tokens": toks[:G]})))
        out[case] = r
    return out


def world(mesh22, npz: str) -> dict:
    """Every case of the module on this world of 4 ranks: the (2, 2)
    mesh it was started with, and (1, 4) and (4, 1) built on it."""
    torch.set_num_threads(1)
    with np.load(npz) as z:
        ref_ = {k: z[k] for k in z.files}
    meshes = {(2, 2): mesh22}
    for shape in ((1, 4), (4, 1)):
        meshes[shape] = Mesh(shape, ("data", "model"))
    got = {case: run_case(meshes[shape], ref_, name, B, pos0)
           for case, (name, B, shape, pos0) in CASES.items()}
    gather_ranks = transformer.COMBINE_GATHER_RANKS
    transformer.COMBINE_GATHER_RANKS = 1
    try:
        for case, of in PSUM_CASES.items():
            name, B, shape, pos0 = CASES[of]
            got[case] = run_case(meshes[shape], ref_, name, B, pos0)
    finally:
        transformer.COMBINE_GATHER_RANKS = gather_ranks
    got.update(run_scores(mesh22, ref_))
    got["engine"] = run_engine(meshes[(1, 4)], ref_)
    got["train"] = run_train(mesh22, 1)
    got["train_pod"] = run_train(Mesh((2, 2), ("pod", "data")), 2)
    got.update(run_train_moe(ref_, 4))
    return got


def world8(mesh, npz: str) -> dict:
    """The cases of a world of 8 ranks: (pod 2, data 2, model 2)."""
    torch.set_num_threads(1)
    with np.load(npz) as z:
        ref_ = {k: z[k] for k in z.files}
    return run_train_moe(ref_, 8)


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    d = tmp_path_factory.mktemp("long_context")
    ref_ = jax_reference(d / "jax.npz")
    got = run_ranks(world, (2, 2), backend="gloo", device="cpu",
                    args=(str(d / "jax.npz"),), store_dir=d, timeout=900)
    got.update(run_ranks(world8, (2, 2, 2), ("pod", "data", "model"),
                         backend="gloo", device="cpu",
                         args=(str(d / "jax.npz"),), store_dir=d,
                         timeout=600))
    return ref_, got


def _same_topk(ids_p, q_p, ids_j, q_j, precision=16):
    ids_p, q_p = np.asarray(ids_p), np.asarray(q_p)
    np.testing.assert_array_equal(ids_p, ids_j)
    assert np.abs(q_p.astype(np.int64) - q_j).max() <= 1
    assert (q_p.sum(-1) == 1 << precision).all() and (q_p >= 1).all()


def test_the_cases_cut_the_sequence(results):
    """Every case runs a cache cut along the sequence (a ring, or the
    batch axes), and JAX's sharded step ran each one: no case fell back
    to JAX's unsharded step."""
    ref_, got = results
    for case in CASES:
        assert int(got[case]["seq_axes"]) >= 1, case
        assert ref_[f"{case}/mode"].tobytes() == b"sharded", \
            (case, ref_[f"{case}/mode"].tobytes())


@pytest.mark.parametrize("case", list(CASES) + list(PSUM_CASES))
def test_serve_step_matches_jax(results, case):
    ref_, got = results
    g, of = got[case], PSUM_CASES.get(case, case)
    assert bool(g["agree"]), "a rank's outputs differ from rank 0's"
    np.testing.assert_allclose(g["logits"].numpy(), ref_[f"{of}/logits"],
                               atol=LOGIT_TOL, rtol=LOGIT_TOL)
    _same_topk(g["serve_ids"], g["serve_q"], ref_[f"{of}/serve_ids"],
               ref_[f"{of}/serve_q"])


@pytest.mark.parametrize("case", list(CASES) + list(PSUM_CASES))
def test_prefill_step_matches_jax(results, case):
    ref_, got = results
    of = PSUM_CASES.get(case, case)
    _same_topk(got[case]["prefill_ids"], got[case]["prefill_q"],
               ref_[f"{of}/prefill_ids"], ref_[f"{of}/prefill_q"])


@pytest.mark.parametrize("case", list(SCORE_CASES))
def test_moe_scores_in_the_train_layout_as_jax(results, case):
    ref_, got = results
    g = got[case]
    assert bool(g["agree"])
    _same_topk(g["ids"], g["q"], ref_[f"{case}/score_ids"],
               ref_[f"{case}/score_q"])


def test_windowed_engine_round_trips_on_a_ring_cut_over_model(results):
    e = results[1]["engine"]
    assert e["ring_split"], "the ring is not cut over 'model'"
    assert e["service"] and e["shared"] and e["speculative"], e
    assert e["prefix_hits"] >= 1 and e["rollbacks"] >= 1, e
    assert e["agree"], "a rank's archive differs from rank 0's"


@pytest.mark.parametrize("case,axes", [("train", ()),
                                       ("train_pod", ("data",))])
def test_a_microbatch_whole_on_every_rank_trains_as_unsharded(results, case,
                                                              axes):
    """One row over (data 2, model 2): whole on every rank; two rows
    over (pod 2, data 2): cut over 'data', whole over 'pod'."""
    t = results[1][case]
    assert tuple(t["axes"]) == axes
    np.testing.assert_allclose(*t["loss"], rtol=1e-6)
    np.testing.assert_allclose(*t["norm"], rtol=1e-5)
    for got, want in zip(t["new"], t["want"]):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                                   atol=1e-6)


@pytest.mark.parametrize("case", list(TRAIN_CASES))
def test_moe_training_matches_jax_where_a_microbatch_is_whole(results,
                                                              case):
    """moe with capacity drops on (pod, data, model) meshes, every rank's
    blocks held. On (pod 2, data 2, model 1), microbatches of two rows
    (cut over 'data', whole over 'pod') and of four (cut over both),
    each dispatched as JAX's one-device dispatch of the whole
    microbatch: the train step's loss, grad norm and every updated
    block. With 'model' cutting the experts, JAX's ``mapped``: one row
    on (pod 2, data 1, model 2), whole, and two on (pod 2, data 2, model
    2), cut over 'data' and whole over 'pod', the tokens cut over what
    the rows are whole on: the loss and every gradient block but the
    embedding's, which JAX gets wrong there and which is held against
    the port's own with the rows whole on every rank (the control:
    those losses are not the unsharded ones, so the capacity is per
    block of tokens)."""
    ref_, got = results
    t = got[case]
    shape, G, kind, axes = TRAIN_CASES[case]
    assert tuple(t["axes"]) == axes
    np.testing.assert_allclose(t["loss"], ref_[f"{case}/loss"], rtol=1e-5)
    assert t["off"] == 0, f"{t['off']} blocks differ from JAX's"
    if kind == "step":
        np.testing.assert_allclose(t["norm"], ref_[f"{case}/grad_norm"],
                                   rtol=1e-5)
    else:
        assert t["embed_off"] == 0, "the embedding's gradient moved with " \
            "the rows' cut"
        assert abs(t["loss"] - t["unsharded"]) > 1e-3, t
