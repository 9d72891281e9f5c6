"""AdamW with global-norm clipping and a warmup-then-cosine learning rate,
as the JAX package's ``train/optimizer.py`` has it, plus optional int8
gradient compression with error feedback (``train/grad_compress.py``).

Trees are nested dicts of tensors (the port's parameter layout). The
update is functional, as in JAX: ``adamw_update`` returns new parameters
and a new state and leaves its inputs as they were. The moments ``m`` and
``v`` are fp32 whatever the parameter's dtype; the update is made in fp32
and cast back to the parameter's dtype.

On a mesh (``mesh`` and ``pspecs``, the train layout's spec of every
leaf) each leaf is this rank's block and ``m``, ``v`` and ``err`` are
cut like it (ZeRO: FSDP parameters, FSDP optimizer states); the update
of a block is the update of its elements. Two quantities span blocks:
``global_norm`` sums each leaf's squares once (a ``psum`` over the axes
the leaf is cut on, never over one it is whole on; mamba2's ``conv_w``
block holds B and C whole beside its cut channels, and they are counted
once), and ``grad_compress`` quantizes with the leaf's global amax (a
``pmax`` over its cut axes, which the whole B and C channels do not
disturb), so each element rounds as the unsharded update rounds it.
Every rank ends with the same norm.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import torch


@dataclass(frozen=True)
class AdamWConfig:
    learning_rate: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.01
    clip_norm: Optional[float] = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1
    grad_compress: bool = False  # int8 + error feedback on the gradients


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of nested dicts of one structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """The leaves in sorted-key order (the JAX tree order); anything but
    a dict is a leaf (a spec tree's are tuples)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    return [tree]


def tree_unflatten(like, leaves: list):
    """Nested dicts of ``like``'s structure over ``leaves`` (sorted-key
    order)."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        return next(it)
    return build(like)


def lr_at(cfg: AdamWConfig, step) -> torch.Tensor:
    """Linear warmup, then cosine decay to ``min_lr_ratio``; fp32, on the
    device of ``step`` when it is a tensor."""
    step = torch.as_tensor(step).float()
    warm = step / max(1.0, cfg.warmup_steps)
    prog = (step - cfg.warmup_steps) / max(
        1.0, cfg.total_steps - cfg.warmup_steps)
    prog = prog.clamp(0.0, 1.0)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * \
        (1 + torch.cos(math.pi * prog))
    return cfg.learning_rate * torch.minimum(warm, cos)


def init_opt_state(params, cfg: AdamWConfig) -> dict:
    zeros32 = lambda p: torch.zeros(p.shape, dtype=torch.float32,  # noqa
                                    device=p.device)
    leaf = tree_leaves(params)[0]
    state = {"m": tree_map(zeros32, params), "v": tree_map(zeros32, params),
             "step": torch.zeros((), dtype=torch.int32, device=leaf.device)}
    if cfg.grad_compress:
        state["err"] = tree_map(zeros32, params)
    return state


def cut_axes(mesh, spec) -> tuple:
    """The axes of ``mesh`` (more than one rank each) that ``spec`` cuts
    a leaf over, in the mesh's order; () on one device."""
    if mesh is None or spec is None:
        return ()
    named = set()
    for entry in spec:
        named.update(entry if isinstance(entry, (tuple, list)) else
                     (entry,))
    return tuple(a for a in mesh.axis_names
                 if a in named and mesh.axis_size(a) > 1)


def reduce_by_axes(values: list, axes: list, mesh, op: str):
    """Each ``values[i]`` (a 0-d fp32 tensor) reduced by ``op`` ("psum"
    or "pmax") over the axes ``axes[i]``: one collective per mesh axis
    for all the values that axis reduces. Returns the list."""
    values = list(values)
    for a in ([] if mesh is None else mesh.axis_names):
        sel = [i for i, ax in enumerate(axes) if a in ax]
        if not sel:
            continue
        red = getattr(mesh, op)(torch.stack([values[i] for i in sel]), a)
        for j, i in enumerate(sel):
            values[i] = red[j]
    return values


def global_norm(tree, mesh=None, pspecs=None) -> torch.Tensor:
    """The L2 norm of every leaf's elements; on a mesh, of the whole
    leaves, each block's squares summed over the axes its leaf is cut
    on. A leaf in mamba2's conv layout (``sharding.specs.ConvSpec``)
    counts its cut channels so, and its trailing B and C channels,
    whole on every rank of the last dim's axes, once."""
    if mesh is None:
        return torch.sqrt(sum(torch.sum(x.float() ** 2)
                              for x in tree_leaves(tree)))
    from repro_torch.sharding.specs import whole_tail
    sq, axes = [], []
    for x, s in zip(tree_leaves(tree), tree_leaves(pspecs)):
        tail = whole_tail(mesh, s)
        parts = [(x, s)] if not tail else [
            (x[..., :-tail], s), (x[..., -tail:], tuple(s[:-1]) + (None,))]
        for part, spec in parts:
            sq.append(torch.sum(part.float() ** 2))
            axes.append(cut_axes(mesh, spec))
    return torch.sqrt(sum(reduce_by_axes(sq, axes, mesh, "psum")))


@torch.no_grad()
def adamw_update(params, grads, state: dict, cfg: AdamWConfig, *,
                 mesh=None, pspecs=None):
    """Returns (new_params, new_state, grad_norm); the norm is taken
    before clipping. On a ``mesh``, every tree holds this rank's blocks
    under ``pspecs`` (a tree like ``params``)."""
    step = state["step"] + 1
    gnorm = global_norm(grads, mesh, pspecs)
    scale = torch.clamp(cfg.clip_norm / (gnorm + 1e-9), max=1.0) \
        if cfg.clip_norm else None

    def clipped(g):
        # fp32 and clipped one leaf at a time, inside ``upd``: a whole
        # fp32 copy of the gradients would add 4 B a parameter to the
        # update's peak memory
        return g.float() if scale is None else g.float() * scale
    new_err = None
    if cfg.grad_compress:
        from .grad_compress import compress_decompress
        grads, new_err = compress_decompress(tree_map(clipped, grads),
                                             state["err"], mesh, pspecs)
        scale = None

    lr = lr_at(cfg, step)
    b1, b2 = cfg.beta1, cfg.beta2
    stepf = step.float()
    bc1 = 1 - b1 ** stepf
    bc2 = 1 - b2 ** stepf

    def upd(p, g, m, v):
        g = clipped(g)
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * g * g
        delta = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps) + \
            cfg.weight_decay * p.float()
        return (p.float() - lr * delta).to(p.dtype), m, v

    out = tree_map(upd, params, grads, state["m"], state["v"])
    new_state = {"m": _pick(out, 1), "v": _pick(out, 2), "step": step}
    if new_err is not None:
        new_state["err"] = new_err
    return _pick(out, 0), new_state, gnorm


def _pick(tree, i: int):
    """Element ``i`` of every tuple leaf of ``tree``."""
    if isinstance(tree, dict):
        return {k: _pick(v, i) for k, v in tree.items()}
    return tree[i]
