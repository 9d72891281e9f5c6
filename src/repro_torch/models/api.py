"""Family dispatch: one forward/init_cache/decode_step API over the model
families the port has (dense and ssm so far; the JAX package's
``models/api.py`` covers six)."""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig
from . import mamba2, transformer
from .schema import count_params, from_jax, init_params, schema

_FAMS = {
    "dense": transformer,
    "vlm": transformer,
    "ssm": mamba2,
}


def module_for(cfg: ModelConfig):
    if cfg.family not in _FAMS:
        raise NotImplementedError(
            f"model family {cfg.family!r} is not ported yet (the port has "
            f"{', '.join(sorted(_FAMS))})")
    return _FAMS[cfg.family]


def forward(params, cfg: ModelConfig, batch: dict):
    """Teacher-forced logits (B, S, padded_vocab) for batch["tokens"]."""
    return module_for(cfg).forward(params, cfg, batch)


def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=None,
               device=None):
    return module_for(cfg).init_cache(cfg, batch, max_len, dtype, device)


def decode_step(params, cfg: ModelConfig, cache, prev_tokens):
    """(logits (B, padded_vocab), cache) — the cache is updated in place."""
    return module_for(cfg).decode_step(params, cfg, cache, prev_tokens)


def rollback_leaves(cfg: ModelConfig) -> tuple[str, ...]:
    """The cache leaves that a speculative rollback restores per lane
    (the rest need no copy: see each family's ``ROLLBACK_LEAVES``)."""
    return module_for(cfg).ROLLBACK_LEAVES


__all__ = ["forward", "init_cache", "decode_step", "rollback_leaves",
           "module_for", "init_params", "from_jax", "count_params",
           "schema"]
