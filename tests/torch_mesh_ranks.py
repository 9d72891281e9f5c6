"""The rank side of the port's training-on-a-mesh tests.

``launch.mesh.run_ranks`` imports a rank's function by module; these
live apart from the test modules so that a rank imports torch and the
port only (no JAX). Each function runs on every rank and returns, on
rank 0, every rank's outputs (``dist.all_gather_object``): blocks as
numpy arrays, keyed by rank, beside the rank's coordinates.
"""
import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs.base import ModelConfig
from repro_torch.launch.mesh import Mesh
from repro_torch.models import schema
from repro_torch.sharding import specs
from repro_torch.train import optimizer as popt
from repro_torch.train import train_loop as ploop


def _np(tree):
    return popt.tree_map(lambda t: t.detach().cpu().numpy(), tree)


def _all_ranks(mesh, out: dict) -> list:
    """Every rank's ``out`` (rank order) on every rank."""
    got = [None] * mesh.size
    dist.all_gather_object(got, out)
    return got


def _blocks(cfg, mesh, tree_np):
    return specs.shard_params(schema.from_jax(tree_np), cfg, mesh,
                              layout="train")


def _case(mesh, cfg: ModelConfig, jp, batch: dict, kind: str, kw: dict):
    """One case on ``mesh``: "vg" (loss and this rank's gradient blocks),
    "step" (``steps`` train steps, each on ``batch``'s tokens rolled by
    the step index, its conditioning as it is: the losses, grad norms and final parameter blocks, and the
    same again from the start: whether the two runs agree bit for bit)
    or "adamw" (the sharded update on given gradients: ``kw["grads"]``,
    two updates)."""
    p = _blocks(cfg, mesh, jp)
    toks = torch.as_tensor(batch["tokens"]).long()
    # the conditioning (encdec frames, vlm img_embeds) rides beside them
    extra = {k: torch.as_tensor(v) for k, v in batch.items()
             if k != "tokens"}
    if kind == "vg":
        rows = ploop.rank_rows({"tokens": toks, **extra}, cfg, mesh,
                               len(toks))
        loss, g = ploop.value_and_grad(p, cfg, rows, mesh=mesh,
                                       loss_block=kw.get("loss_block", 0))
        return {"loss": float(loss), "grads": _np(g)}
    if kind == "step":
        opt = popt.AdamWConfig(**kw["opt"])

        def run():
            params, state = p, popt.init_opt_state(p, opt)
            step = ploop.make_train_step(
                cfg, mesh, opt=opt, global_batch=len(toks),
                num_microbatches=kw.get("microbatches", 1),
                loss_block=kw.get("loss_block", 0))
            losses, norms = [], []
            for s in range(kw["steps"]):
                params, state, m = step(params, state, {
                    "tokens": torch.roll(toks, s, dims=1), **extra})
                losses.append(float(m["loss"]))
                norms.append(float(m["grad_norm"]))
            return params, losses, norms
        params, losses, norms = run()
        again, l2, n2 = run()
        same = losses == l2 and norms == n2 and all(
            torch.equal(a, b) for a, b in zip(popt.tree_leaves(params),
                                              popt.tree_leaves(again)))
        return {"losses": losses, "norms": norms, "params": _np(params),
                "bitwise_repeat": same}
    if kind == "adamw":
        opt = popt.AdamWConfig(**kw["opt"])
        pspecs = specs.param_pspecs(cfg, mesh, "train")
        g = _blocks(cfg, mesh, kw["grads"])
        params, state = p, popt.init_opt_state(p, opt)
        norms = []
        for _ in range(2):
            params, state, n = popt.adamw_update(params, g, state, opt,
                                                 mesh=mesh, pspecs=pspecs)
            norms.append(float(n))
        out = {"params": _np(params), "norms": norms,
               "m": _np(state["m"]), "v": _np(state["v"])}
        if opt.grad_compress:
            out["err"] = _np(state["err"])
        return out
    raise ValueError(kind)


def train_world(mesh, cases: dict) -> dict:
    """Every case of ``cases`` (name -> (mesh shape, mesh axes, config
    fields, JAX parameters, batch, kind, options)) on this world; a case
    whose mesh is not the world's own builds it here (its groups made
    collectively, every rank at the same point). Returns {name: [each
    rank's {"rank", "coords", "out"}]}."""
    torch.set_num_threads(1)
    meshes = {(mesh.devices_shape, mesh.axis_names): mesh}
    got = {}
    for name, (shape, axes, fields, jp, batch, kind, kw) in cases.items():
        key = (tuple(shape), tuple(axes))
        if key not in meshes:
            meshes[key] = Mesh(shape, axes)
        m = meshes[key]
        cfg = ModelConfig(**fields)
        out = _case(m, cfg, jp, batch, kind, kw)
        got[name] = _all_ranks(m, {"rank": m.rank, "out": out})
    return got


def rank_block(tree_np: dict, fields: dict, shape, axes, rank: int):
    """Rank ``rank``'s train-layout blocks of a whole numpy tree (the
    test side's cut of a JAX reference), as numpy."""
    cfg = ModelConfig(**fields)
    m = Mesh(shape, axes, rank=rank)
    return _np(_blocks(cfg, m, tree_np))


def flat(tree, prefix=""):
    """{path: leaf} of a nested dict."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


# ------------------------------------------------ resume and elastic restore
def _pipeline_steps(cfg, mesh, params, state, step_fn, pipe, steps):
    for s in steps:
        params, state, _ = step_fn(params, state,
                                   {"tokens": pipe.global_batch_array(s)})
        pipe.advance()
    return params, state


def resume_world(mesh, fields: dict, ckpt_dir: str) -> list:
    """Bitwise resume on this world: 6 steps straight against 3 steps, a
    checkpoint (with the pipeline's cursor), a restore into a fresh
    state and 3 more. Returns every rank's (rank, whether its blocks are
    equal bit for bit)."""
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.train.checkpoint import restore_latest, save_checkpoint
    torch.set_num_threads(1)
    m = None if mesh.size == 1 else mesh
    cfg = ModelConfig(**fields)
    toks = (np.arange(20000) * 7919) % 250
    opt = popt.AdamWConfig(learning_rate=1e-3)
    sspecs = None if m is None else ploop.state_specs(cfg, m, opt)

    def fresh():
        params, state = ploop.init_train_state(cfg, 0, "cpu", opt, mesh=m)
        return params, state, TokenPipeline(toks, global_batch=4,
                                            seq_len=32, seed=5)
    step_fn = ploop.make_train_step(cfg, m, opt=opt, global_batch=4)
    params, state, pipe = fresh()
    straight, _ = _pipeline_steps(cfg, m, params, state, step_fn, pipe,
                                  range(6))
    params, state, pipe = fresh()
    params, state = _pipeline_steps(cfg, m, params, state, step_fn, pipe,
                                    range(3))
    save_checkpoint(ckpt_dir, 3, {
        "params": params, "opt": state,
        "pipe": {"step": np.asarray(pipe.state.step, np.int64)}},
        mesh=m, specs=sspecs)
    params, state, pipe = fresh()
    like = {"params": params, "opt": state,
            "pipe": {"step": np.zeros((), np.int64)}}
    restored, step = restore_latest(ckpt_dir, like, mesh=m, specs=sspecs)
    assert step == 3
    pipe.state.step = int(restored["pipe"]["step"])
    params, _ = _pipeline_steps(cfg, m, restored["params"],
                                restored["opt"], step_fn, pipe,
                                range(pipe.state.step, 6))
    same = all(torch.equal(a, b) for a, b in zip(
        popt.tree_leaves(straight), popt.tree_leaves(params)))
    return _all_ranks(mesh, (mesh.rank, same)) if mesh.size > 1 \
        else [(0, same)]


def elastic_world(mesh, fields: dict, ckpt_dir: str) -> dict:
    """Save a training state on this world's mesh (2, 2), then restore
    its parameters onto meshes (1, 4) and (4, 1) in the train layout and
    (1, 4) in the serve layout, and the whole state into one with
    ``grad_compress``'s error leaves. Returns {(shape, layout): every
    rank's (rank, parameter blocks as numpy), "refused": every rank's
    (rank, the KeyError's message or None)}."""
    from repro_torch.train.checkpoint import restore_latest, save_checkpoint
    torch.set_num_threads(1)
    cfg = ModelConfig(**fields)
    opt = popt.AdamWConfig()
    params, state = ploop.init_train_state(cfg, 0, "cpu", opt, mesh=mesh)
    save_checkpoint(ckpt_dir, 1, {
        "params": params, "opt": state,
        "pipe": {"step": np.asarray(1, np.int64)}},
        mesh=mesh, specs=ploop.state_specs(cfg, mesh, opt))
    out = {}
    for shape, layout in (((1, 4), "train"), ((4, 1), "train"),
                          ((1, 4), "serve")):
        m = Mesh(shape, ("data", "model"))
        like = {"params": specs.init_params_sharded(cfg, m, 1, "cpu",
                                                    layout=layout)}
        got, step = restore_latest(
            ckpt_dir, like, mesh=m,
            specs={"params": specs.param_pspecs(cfg, m, layout)})
        assert step == 1
        out[(shape, layout)] = _all_ranks(m, (m.rank,
                                              _np(got["params"])))
    # a state of another structure (grad_compress adds opt.err) is not a
    # corrupt checkpoint: every rank raises, none resumes from nothing
    compress = popt.AdamWConfig(grad_compress=True)
    params, state = ploop.init_train_state(cfg, 0, "cpu", compress,
                                           mesh=mesh)
    try:
        restore_latest(ckpt_dir, {
            "params": params, "opt": state,
            "pipe": {"step": np.asarray(0, np.int64)}},
            mesh=mesh, specs=ploop.state_specs(cfg, mesh, compress))
        refused = None
    except KeyError as e:
        refused = str(e)
    out["refused"] = _all_ranks(mesh, (mesh.rank, refused))
    return out


def elastic_ssd_world(mesh, cases: dict) -> dict:
    """``_elastic_ssd`` for each case (name -> (config fields, checkpoint
    directory)) on this world."""
    torch.set_num_threads(1)
    return {name: _elastic_ssd(mesh, fields, ckpt_dir)
            for name, (fields, ckpt_dir) in cases.items()}


def _elastic_ssd(mesh, fields: dict, ckpt_dir: str) -> dict:
    """An ssm or hybrid training state on this world's mesh (2, 2) after
    one step (so that m and v are not zero), saved; then restored onto
    (1, 4) and (4, 1) in the train layout and (1, 4) in the serve
    layout (parameters, m and v). Returns {"saved": every rank's (rank,
    its state's blocks as numpy), (shape, layout): every rank's (rank,
    restored blocks)}."""
    from repro_torch.train.checkpoint import restore_latest, save_checkpoint
    cfg = ModelConfig(**fields)
    opt = popt.AdamWConfig(learning_rate=1e-3, warmup_steps=1)
    params, state = ploop.init_train_state(cfg, 0, "cpu", opt, mesh=mesh)
    toks = np.random.default_rng(7).integers(0, cfg.vocab_size, (4, 16))
    params, state, _ = ploop.make_train_step(cfg, mesh, opt=opt,
                                             global_batch=4)(
        params, state, {"tokens": toks})
    sspecs = ploop.state_specs(cfg, mesh, opt)
    save_checkpoint(ckpt_dir, 1, {
        "params": params, "opt": state,
        "pipe": {"step": np.asarray(1, np.int64)}}, mesh=mesh, specs=sspecs)
    mine = {"params": params, "m": state["m"], "v": state["v"]}
    out = {"saved": _all_ranks(mesh, (mesh.rank, _np(mine)))}
    for shape, layout in (((1, 4), "train"), ((4, 1), "train"),
                          ((1, 4), "serve")):
        m = Mesh(shape, ("data", "model"))
        p = specs.init_params_sharded(cfg, m, 1, "cpu", layout=layout)
        sp = specs.param_pspecs(cfg, m, layout)
        like = {"params": p, "opt": {"m": p, "v": p}}
        got, step = restore_latest(ckpt_dir, like, mesh=m, specs={
            "params": sp, "opt": {"m": sp, "v": sp}})
        assert step == 1
        blocks = {"params": got["params"], "m": got["opt"]["m"],
                  "v": got["opt"]["v"]}
        out[(shape, layout)] = _all_ranks(m, (m.rank, _np(blocks)))
    return out
