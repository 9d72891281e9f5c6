"""AdamW with global-norm clipping and a warmup-then-cosine learning rate,
as the JAX package's ``train/optimizer.py`` has it, plus optional int8
gradient compression with error feedback (``train/grad_compress.py``).

Trees are nested dicts of tensors (the port's parameter layout). The
update is functional, as in JAX: ``adamw_update`` returns new parameters
and a new state and leaves its inputs as they were. The moments ``m`` and
``v`` are fp32 whatever the parameter's dtype; the update is made in fp32
and cast back to the parameter's dtype.
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
    """The leaves in sorted-key order (the JAX tree order)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    return [tree]


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


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(x.float() ** 2)
                          for x in tree_leaves(tree)))


@torch.no_grad()
def adamw_update(params, grads, state: dict, cfg: AdamWConfig):
    """Returns (new_params, new_state, grad_norm); the norm is taken
    before clipping."""
    step = state["step"] + 1
    gnorm = global_norm(grads)
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
                                             state["err"])
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
