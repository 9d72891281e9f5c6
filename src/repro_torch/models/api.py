"""Family dispatch: one init_cache/decode_step API over the model
families the port has (the dense family so far; the JAX package's
``models/api.py`` covers six)."""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig
from . import transformer
from .schema import count_params, from_jax, init_params, schema

_FAMS = {
    "dense": transformer,
    "vlm": transformer,
}


def module_for(cfg: ModelConfig):
    if cfg.family not in _FAMS:
        raise NotImplementedError(
            f"model family {cfg.family!r} is not ported yet (dense only)")
    return _FAMS[cfg.family]


def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=None,
               device=None):
    return module_for(cfg).init_cache(cfg, batch, max_len, dtype, device)


def decode_step(params, cfg: ModelConfig, cache, prev_tokens):
    """(logits (B, padded_vocab), cache) — the cache is updated in place."""
    return module_for(cfg).decode_step(params, cfg, cache, prev_tokens)


__all__ = ["init_cache", "decode_step", "module_for", "init_params",
           "from_jax", "count_params", "schema"]
