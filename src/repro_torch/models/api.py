"""Family dispatch: one forward/init_cache/decode_step API over the model
families the port has (dense, moe, ssm and hybrid; the JAX package's
``models/api.py`` also covers encdec and the vlm image prefix), and the
training loss ``loss_fn`` (the dense family so far)."""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from . import hybrid, mamba2, moe, transformer
from .schema import count_params, from_jax, init_params, schema

_FAMS = {
    "dense": transformer,
    "vlm": transformer,
    "moe": moe,
    "ssm": mamba2,
    "hybrid": hybrid,
}


def module_for(cfg: ModelConfig):
    if cfg.family not in _FAMS:
        raise NotImplementedError(
            f"model family {cfg.family!r} is not ported yet (the port has "
            f"{', '.join(sorted(_FAMS))})")
    return _FAMS[cfg.family]


def forward(params, cfg: ModelConfig, batch: dict, **kw):
    """Teacher-forced logits (B, S, padded_vocab) for batch["tokens"]."""
    return module_for(cfg).forward(params, cfg, batch, **kw)


def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=None,
               device=None):
    return module_for(cfg).init_cache(cfg, batch, max_len, dtype, device)


def decode_step(params, cfg: ModelConfig, cache, prev_tokens):
    """(logits (B, padded_vocab), cache) — the cache is updated in place."""
    return module_for(cfg).decode_step(params, cfg, cache, prev_tokens)


def rollback_leaves(cfg: ModelConfig) -> tuple[str, ...]:
    """The cache leaves that a speculative rollback restores per lane,
    whole (the rest need no copy: see each family's ``ROLLBACK_LEAVES``)."""
    return module_for(cfg).ROLLBACK_LEAVES


def ring_leaves(cfg: ModelConfig) -> tuple[str, ...]:
    """The ring-cache leaves (a sliding window) whose slots a verify round
    overwrites: a rollback writes back the rows of the rejected steps
    (see ``transformer.ring_leaves``, which the moe family's cache
    shares); none without a window, and none in a family without a ring
    (ssm, hybrid)."""
    ring = getattr(module_for(cfg), "ring_leaves", None)
    return ring(cfg) if ring else ()


def _ce_from_logits(logits, targets):
    """Per-position cross entropy (B, S) in fp32: logsumexp minus the
    target's logit (padded-vocabulary ids carry -1e30 and add nothing)."""
    lg = logits.float()
    return torch.logsumexp(lg, dim=-1) - lg.gather(
        -1, targets[..., None])[..., 0]


def loss_fn(params, cfg: ModelConfig, batch: dict, *, loss_block: int = 0):
    """Next-token cross entropy (paper Eq. 16), as the JAX package's
    ``loss_fn``: batch["tokens"] (B, S) is the whole input, the target of
    position t is token t + 1, and the last position (no target) is
    masked, as is any position where batch["mask"] is 0. Attention is the
    differentiable ``attention_masked``, never a kernel.

    ``loss_block > 0`` evaluates the LM head and the cross entropy per
    block of ``loss_block`` positions, each block under
    ``torch.utils.checkpoint``, so the fp32 logits exist one block at a
    time."""
    if cfg.family not in ("dense", "vlm"):
        raise NotImplementedError(
            f"training runs the dense family so far (got {cfg.family!r}: "
            f"the other families' training is not ported yet; the moe "
            f"family's trains with capacity-dropped dispatch, which the "
            f"port's dropless moe.py does not have)")
    tokens = batch["tokens"]
    targets = F.pad(tokens[:, 1:], (0, 1))
    mask = torch.ones(targets.shape, dtype=torch.float32,
                      device=tokens.device) if "mask" not in batch \
        else batch["mask"].float().clone()
    mask[:, -1] = 0.0
    if loss_block:
        hidden = forward(params, cfg, batch, attn_impl="masked",
                         return_hidden=True)
        S, sb = hidden.shape[1], loss_block

        def blk(h, t):
            return _ce_from_logits(transformer.lm_logits(cfg, params, h), t)
        nll = torch.cat([
            checkpoint(blk, hidden[:, s0:s0 + sb], targets[:, s0:s0 + sb],
                       use_reentrant=False)
            for s0 in range(0, S, sb)], dim=1)
    else:
        logits = forward(params, cfg, batch, attn_impl="masked")
        nll = _ce_from_logits(logits, targets)
    return (nll * mask).sum() / mask.sum().clamp(min=1.0)


__all__ = ["forward", "loss_fn", "init_cache", "decode_step",
           "rollback_leaves", "ring_leaves", "module_for", "init_params",
           "from_jax", "count_params", "schema"]
