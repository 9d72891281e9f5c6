"""The train step (the JAX package's ``train/train_loop.py``, one device).

``make_train_step(cfg, ...)`` returns ``(params, opt_state, batch) ->
(params, opt_state, metrics)``: the loss and every parameter's gradient
by autograd through ``models.api.loss_fn``, gradients averaged over
``num_microbatches`` slices of the batch's rows, then ``adamw_update``.
Every family trains, each through its differentiable forward and never
a kernel (the kernels have no backward and refuse a gradient-carrying
input; ``models.api.TRAIN_FORWARD``): dense and vlm through
``attention_masked``, ssm through the chunked SSD with its intra-chunk
part in plain PyTorch (``mamba2.ssd_chunked(impl="plain")``), hybrid through both, moe through the plain
attention and the capacity-dropped dispatch JAX trains with (a
microbatch's own token count sets its capacity, as in JAX), encdec
through the plain attention with ``frames`` (B, S_enc, D) in the batch
beside the tokens, sliced with them. Per-layer remat follows
``cfg.remat``. The metrics stay on the device: reading one waits for the
step.

No mesh: multi-GPU training is a later slice, and a mesh is refused.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import api as model_api
from .optimizer import (AdamWConfig, adamw_update, init_opt_state,
                        tree_leaves, tree_map)


def _unflatten(like, leaves: list):
    """Nested dicts of ``like``'s structure over ``leaves`` (sorted-key
    order)."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        return next(it)
    return build(like)


def _on(batch: dict, device) -> dict:
    """The batch's arrays (numpy or tensors) as tensors on ``device``,
    the tokens as int64 (frames and image embeddings keep their float
    dtype)."""
    out = {k: torch.as_tensor(v, device=device) for k, v in batch.items()}
    out["tokens"] = out["tokens"].long()
    return out


def value_and_grad(params, cfg: ModelConfig, batch: dict, **loss_kw):
    """(loss, gradients): the loss as a 0-d device tensor, the gradients
    a tree like ``params`` in each parameter's dtype. ``params`` is not
    modified; its leaves need not require a gradient."""
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    ps = _unflatten(params, leaves)
    dev = leaves[0].device
    with torch.enable_grad():
        loss = model_api.loss_fn(ps, cfg, _on(batch, dev), **loss_kw)
        grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), _unflatten(params, list(grads))


def make_train_step(cfg: ModelConfig, mesh=None, *,
                    opt: Optional[AdamWConfig] = None,
                    num_microbatches: int = 1, loss_block: int = 0):
    if mesh is not None:
        raise NotImplementedError(
            "the port trains on one device: training on a mesh (FSDP and "
            "TP, the JAX train layout) is ROADMAP Queue 1 item 3; the "
            "port serves the dense and moe families on a mesh")
    opt = opt or AdamWConfig()
    kw = dict(loss_block=loss_block)

    def train_step(params, opt_state, batch):
        if num_microbatches == 1:
            loss, grads = value_and_grad(params, cfg, batch, **kw)
        else:
            rows = batch["tokens"].shape[0]
            if rows % num_microbatches:
                raise ValueError(f"{rows} rows do not split into "
                                 f"{num_microbatches} microbatches")
            mb = rows // num_microbatches
            grads, loss = None, 0.0
            for i in range(num_microbatches):
                part = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
                l_i, g_i = value_and_grad(params, cfg, part, **kw)
                g_i = tree_map(lambda g: g.float(), g_i)
                grads = g_i if grads is None else tree_map(
                    torch.add, grads, g_i)
                loss = loss + l_i
            grads = tree_map(lambda g: g / num_microbatches, grads)
            loss = loss / num_microbatches
        new_params, new_opt, gnorm = adamw_update(params, grads, opt_state,
                                                  opt)
        return new_params, new_opt, {"loss": loss, "grad_norm": gnorm,
                                     "step": new_opt["step"]}

    return train_step


def init_train_state(cfg: ModelConfig, seed: int = 0, device=None,
                     opt: Optional[AdamWConfig] = None):
    """Random parameters from ``seed`` on ``device`` and a fresh
    optimizer state."""
    params = model_api.init_params(cfg, seed, device)
    return params, init_opt_state(params, opt or AdamWConfig())
