"""The train step (the JAX package's ``train/train_loop.py``).

``make_train_step(cfg, mesh, ...)`` returns ``(params, opt_state, batch)
-> (params, opt_state, metrics)``: the loss and every parameter's
gradient by autograd through ``models.api.loss_fn``, gradients averaged
over ``num_microbatches`` slices of the batch's rows, then
``adamw_update``. Every family trains on one device, each through its
differentiable forward and never a kernel (the kernels have no backward
and refuse a gradient-carrying input; ``models.api.TRAIN_FORWARD``):
dense and vlm through ``attention_masked``, ssm through the chunked SSD
with its intra-chunk part in plain PyTorch
(``mamba2.ssd_chunked(impl="plain")``), hybrid through both, moe through
the plain attention and the capacity-dropped dispatch JAX trains with
(a microbatch's own token count sets its capacity, as in JAX), encdec
through the plain attention with ``frames`` (B, S_enc, D) in the batch
beside the tokens, sliced with them. Per-layer remat follows
``cfg.remat``. The metrics stay on the device: reading one waits for the
step.

On a mesh (``launch/mesh.py``; every family) the step is one rank's
program in JAX's train layout
(``specs.param_pspecs(cfg, mesh, "train")``): FSDP over 'data' (a
weight's D rows; each layer gathers its weights at use), TP and EP over
'model', data parallelism over 'pod' and 'data'. Every tree holds this
rank's blocks (``init_train_state(..., mesh=...)``,
``specs.shard_params(..., layout="train")``); the step takes the global
batch, slices it into microbatches and keeps this rank's rows of each
(``specs.batch_pspecs``; a microbatch that does not divide the batch
axes is cut over the inner ones that divide it, or whole on every
rank: ``row_axes``), as JAX does (with moe's capacity drops, the
tokens that compete for capacity are those of one microbatch on one
rank), and sums each leaf's gradient over the batch
axes it is whole on (a gathered leaf's came summed over 'data' from the
gather's backward) and over 'model' where each rank holds a partial one
(``model_partial``); then the sharded ``adamw_update``. The families'
conditioning (encdec ``frames``, vlm ``img_embeds``) is cut over the
batch axes with the tokens; mamba2's ``conv_w`` is a leaf of the port's
conv layout (``specs.ConvSpec``: its xc channels cut over 'model', B and
C whole, their gradient summed over 'model' in the backward). The
metrics are the same on every rank. The step is eager: capture of a sharded step is
ROADMAP Queue 1 item 3.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.launch.mesh import batch_axes
from repro_torch.models import api as model_api
from repro_torch.sharding import specs
from .optimizer import (AdamWConfig, adamw_update, cut_axes, init_opt_state,
                        tree_leaves, tree_unflatten)


def _on(batch: dict, device) -> dict:
    """The batch's arrays (numpy or tensors) as tensors on ``device``,
    the tokens as int64 (frames and image embeddings keep their float
    dtype)."""
    out = {k: torch.as_tensor(v, device=device) for k, v in batch.items()}
    out["tokens"] = out["tokens"].long()
    return out


def _local_value_and_grad(params, cfg: ModelConfig, batch: dict, *,
                          mesh=None, **loss_kw):
    """(loss, this rank's gradient contributions), leaves in sorted-key
    order: whole gradients on one device."""
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    ps = tree_unflatten(params, leaves)
    dev = leaves[0].device
    with torch.enable_grad():
        loss = model_api.loss_fn(ps, cfg, _on(batch, dev), mesh=mesh,
                                 **loss_kw)
        grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), list(grads)


def value_and_grad(params, cfg: ModelConfig, batch: dict, *, mesh=None,
                   **loss_kw):
    """(loss, gradients): the loss as a 0-d device tensor, the gradients
    a tree like ``params`` in each parameter's dtype. ``params`` is not
    modified; its leaves need not require a gradient. On a ``mesh``:
    ``params`` are this rank's blocks in the train layout, ``batch`` this
    rank's rows, and the gradients this rank's blocks of the whole
    gradient (reduced over the ranks, ``reduce_grads``)."""
    loss, grads = _local_value_and_grad(params, cfg, batch, mesh=mesh,
                                        **loss_kw)
    if mesh is not None:
        grads = reduce_grads(grads, cfg, mesh)
    return loss, tree_unflatten(params, grads)


def model_partial(cfg: ModelConfig, mesh) -> set:
    """The leaves (paths) whole on every rank of 'model' whose gradient
    each rank holds a part of: they act on what differs along 'model'
    (this rank's heads, experts). Their gradients are summed over
    'model'; every other leaf whole over 'model' acts on what is the same
    on every rank of it, and its gradient is too. Every attention group
    counts (``layers``, encdec's ``enc_layers`` and ``dec_layers`` with
    the cross-attention's ``wxk``/``wxv``, hybrid's unstacked
    ``shared_attn``). mamba2's B and C, whole on every rank and read by
    this rank's heads, are not among them: their cotangent is summed
    over 'model' in the backward (``mamba2.ssm_block``), so ``in_B``,
    ``in_C`` and conv_w's B and C channels come out whole."""
    r = specs.rules(cfg, mesh, "train")
    if mesh.axis_size("model") == 1:
        return set()
    out = set()
    for group, leaves in specs.param_pspecs(cfg, mesh, "train").items():
        if not isinstance(leaves, dict) or "wq" not in leaves \
                or r["heads"] != "model":
            continue
        names = {"q_norm", "k_norm"}
        if r["kv_heads"] != "model":    # q gathered, K/V whole
            names |= {"wk", "wv", "wxk", "wxv"}
        out |= {(group, k) for k in names if k in leaves}
    if cfg.family == "moe" and r["expert"] == "model":
        out.add(("layers", "router"))
    return out


def _paths(tree, prefix=()) -> list:
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in _paths(tree[k],
                                                         prefix + (k,))]
    return [prefix]


def grad_axes(cfg: ModelConfig, mesh) -> list:
    """For each leaf (sorted-key order), the axes its gradient is summed
    over after the backward: the batch axes it is whole on, and 'model'
    for ``model_partial`` leaves."""
    pspecs = specs.param_pspecs(cfg, mesh, "train")
    partial = model_partial(cfg, mesh)
    out = []
    for path, spec in zip(_paths(pspecs), tree_leaves(pspecs)):
        cut = cut_axes(mesh, spec)
        axes = [a for a in batch_axes(mesh)
                if a not in cut and mesh.axis_size(a) > 1]
        if path in partial:
            axes.append("model")
        out.append(tuple(axes))
    return out


def reduce_grads(grads: list, cfg: ModelConfig, mesh) -> list:
    """Every leaf's gradient (sorted-key order) summed over its
    ``grad_axes``: the leaves of one axis set and dtype flattened into
    one buffer, one ``psum`` per axis."""
    axes = grad_axes(cfg, mesh)
    grads = list(grads)
    groups: dict = {}
    for i, (g, ax) in enumerate(zip(grads, axes)):
        if ax:
            groups.setdefault((ax, g.dtype), []).append(i)
    for (ax, _), idx in groups.items():
        flat = mesh.psum(torch.cat([grads[i].reshape(-1) for i in idx]), ax)
        for i, part in zip(idx, flat.split([grads[i].numel()
                                            for i in idx])):
            grads[i] = part.view(grads[i].shape)
    return grads


def check_train_mesh(cfg: ModelConfig, mesh) -> None:
    """Refuse what the port does not train on a mesh yet: experts that
    do not divide 'model' (ROADMAP Queue 1 item 3); every family of
    ``models.api.TRAIN_MESH_FAMILIES`` trains there."""
    model_api.module_for(cfg)
    tp = mesh.axis_size("model")
    if cfg.family == "moe" and tp > 1 and cfg.n_experts % tp:
        raise NotImplementedError(
            f"{cfg.n_experts} experts do not divide the model axis ({tp}): "
            f"experts whole on every rank of a mesh are not ported "
            f"(ROADMAP Queue 1 item 3)")


def row_axes(cfg: ModelConfig, mesh, global_batch: int) -> tuple:
    """The batch axes a batch of ``global_batch`` rows is cut over: all
    of them (with more than one rank) where the rows divide them
    (``specs.batch_pspecs``), else the innermost ones whose ranks divide
    the rows, the outer ones ('pod' first) keeping the rows whole, ()
    where none does. JAX's spec keeps such a batch whole and leaves its
    placement to XLA's partitioner; the function is the same: the loss
    counts a row once on every rank that holds it, numerator and
    denominator alike, and a moe layer cuts its tokens further over the
    axes the rows are whole on, so that it dispatches JAX's blocks of
    tokens (``models.moe._moe_block_train``)."""
    spec = specs.batch_pspecs(cfg, mesh, global_batch=global_batch)
    ba = tuple(a for a in batch_axes(mesh) if mesh.axis_size(a) > 1)
    if spec["tokens"][0] is not None:
        return ba
    for i in range(1, len(ba)):
        if global_batch % mesh.degree(ba[i:]) == 0:
            return ba[i:]
    return ()


def rank_rows(batch: dict, cfg: ModelConfig, mesh, global_batch: int):
    """This rank's rows of the global ``batch``: cut over ``row_axes``
    (all the batch axes, 'pod' and 'data', where they divide it, as
    ``specs.batch_pspecs``), whole over the others."""
    ax = row_axes(cfg, mesh, global_batch)
    rows = None if not ax else (ax[0] if len(ax) == 1 else ax)
    out = {}
    for k, v in batch.items():
        v = torch.as_tensor(v)
        if v.shape[0] != global_batch:
            raise ValueError(f"batch[{k!r}] has {v.shape[0]} rows, the "
                             f"global batch {global_batch}")
        out[k] = specs.cut(v, mesh, (rows,))
    return out


def make_train_step(cfg: ModelConfig, mesh=None, *,
                    opt: Optional[AdamWConfig] = None,
                    num_microbatches: int = 1,
                    global_batch: Optional[int] = None,
                    loss_block: int = 0):
    """The train step of ``cfg`` on ``mesh`` (None, or a mesh of one
    rank: one device). ``global_batch``: the rows of the batch the step
    is given (by default, its first dimension)."""
    if mesh is not None and mesh.size == 1:
        mesh = None
    if mesh is not None:
        check_train_mesh(cfg, mesh)
        pspecs = specs.param_pspecs(cfg, mesh, "train")
    else:
        pspecs = None
    opt = opt or AdamWConfig()
    kw = dict(loss_block=loss_block, mesh=mesh)

    def microbatches(batch):
        """The microbatches of this rank: the batch's rows sliced, and
        on a mesh each slice's rows of this rank (JAX slices the global
        batch, then cuts each microbatch over the batch axes)."""
        rows = len(batch["tokens"])
        if mesh is not None and global_batch and rows != global_batch:
            raise ValueError(f"the batch has {rows} rows, the global "
                             f"batch {global_batch}")
        if rows % num_microbatches:
            raise ValueError(f"{rows} rows do not split into "
                             f"{num_microbatches} microbatches")
        mb = rows // num_microbatches
        for i in range(num_microbatches):
            part = batch if num_microbatches == 1 else \
                {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
            if mesh is None:
                yield part, {}
            else:
                yield rank_rows(part, cfg, mesh, mb), dict(
                    batch_sharded=row_axes(cfg, mesh, mb))

    def train_step(params, opt_state, batch):
        grads, loss = None, 0.0
        for part, rows in microbatches(batch):
            l_i, g_i = _local_value_and_grad(params, cfg, part, **kw,
                                             **rows)
            if num_microbatches == 1:
                grads, loss = g_i, l_i
                break
            g_i = [g.float() for g in g_i]
            grads = g_i if grads is None else [
                a + b for a, b in zip(grads, g_i)]
            loss = loss + l_i
        if num_microbatches > 1:
            grads = [g / num_microbatches for g in grads]
            loss = loss / num_microbatches
        if mesh is not None:
            grads = reduce_grads(grads, cfg, mesh)
        new_params, new_opt, gnorm = adamw_update(
            params, tree_unflatten(params, grads), opt_state, opt,
            mesh=mesh, pspecs=pspecs)
        return new_params, new_opt, {"loss": loss, "grad_norm": gnorm,
                                     "step": new_opt["step"]}

    return train_step


def init_train_state(cfg: ModelConfig, seed: int = 0, device=None,
                     opt: Optional[AdamWConfig] = None, mesh=None):
    """Random parameters from ``seed`` on ``device`` and a fresh
    optimizer state; on a ``mesh``, this rank's blocks of both in the
    train layout (each leaf drawn whole from the seed in turn and cut:
    ``specs.init_params_sharded``)."""
    if mesh is None:
        params = model_api.init_params(cfg, seed, device)
    else:
        params = specs.init_params_sharded(cfg, mesh, seed, device,
                                           layout="train")
    return params, init_opt_state(params, opt or AdamWConfig())


def state_specs(cfg: ModelConfig, mesh, opt: AdamWConfig) -> dict:
    """The spec of every leaf of the trainer's checkpointed state
    ``{"params", "opt": {"m", "v", "step"[, "err"]}, "pipe": {"step"}}``
    in the train layout (``train/checkpoint.py`` gathers and cuts by
    it)."""
    p = specs.param_pspecs(cfg, mesh, "train")
    o = {"m": p, "v": p, "step": ()}
    if opt.grad_compress:
        o["err"] = p
    return {"params": p, "opt": o, "pipe": {"step": ()}}
