"""Zamba2-style hybrid: Mamba2 (SSD) layers with ONE shared attention +
MLP block applied after every ``hybrid_ssm_per_block`` of them
(arXiv:2411.15242) -- the PyTorch counterpart of the JAX package's
``models/hybrid.py``.

The shared block reuses the same weights (``params["shared_attn"]``,
unstacked) at every application; each application keeps its own K/V
cache. With L SSD layers and ``per`` layers to a group there are L //
per applications, and the L % per trailing SSD layers run after the
last one (zamba2-7b: 81 = 6 x 13 + 3).

JAX nests two scans (groups, then the group's layers); here the blocks
are a plain loop in model order (``block_order``). Teacher-forced
scoring launches one ``ssd_intra`` per SSD layer and one
``flash_attention`` per application; the decode step runs the O(1) SSD
recurrence per layer and one ``decode_attention`` per application.
Training runs ``forward(attn_impl="masked", ssd_impl="plain")``, no
kernel, with each SSD layer and each application of the shared block
under ``torch.utils.checkpoint`` when ``cfg.remat`` is set (per block,
not per group, as the JAX package remats); the shared block's gradient
sums over its applications.

On a mesh the SSD layers run as ``mamba2.py``'s do (a rank's heads, one
psum over 'model' a layer) and each application of the shared block as
the dense family's (``transformer.dense_block`` / ``decode_block``: a
rank's heads over its KV heads, or, where the KV heads do not divide
'model', every head over a rank's slice of the sequence, lock-step). In
the train layout each application gathers the shared block's weights
over 'data' by their own, unstacked specs (``gather_layer(...,
"shared_attn")``); each gather's backward reduce-scatters that
application's gradient, and autograd sums the applications' into the
one leaf, as ``jax.grad`` does.

As in ``mamba2.py`` and ``transformer.py``, ``decode_step`` writes every
cache leaf in place (the conv and SSM states, the new K/V at each lane's
``pos``, and ``pos`` itself), so a captured CUDA graph of the step reads
and writes fixed addresses.
"""
from __future__ import annotations

from functools import partial

import torch

from repro_torch.configs.base import ModelConfig
from .layers import rms_norm
from . import mamba2
from .mamba2 import SSD_IMPLS, ssm_block, ssm_decode_step
from .transformer import (ATTN_IMPLS, check_impl, decode_block, dense_block,
                          embed_tokens, layer_weights, lm_logits, remat,
                          torch_dtype)


def n_applications(cfg: ModelConfig) -> int:
    """Applications of the shared block: one per full group of SSD
    layers."""
    return cfg.n_layers // cfg.hybrid_ssm_per_block


def block_order(cfg: ModelConfig) -> list[tuple[str, int]]:
    """The blocks in model order: ("ssm", layer) for SSD layer ``layer``
    and ("attn", i) for the i-th application of the shared block, which
    follows each group of ``hybrid_ssm_per_block`` SSD layers; the
    trailing SSD layers come last (JAX ``_split_layers``)."""
    per, n_apply = cfg.hybrid_ssm_per_block, n_applications(cfg)
    order = []
    for i in range(n_apply):
        order += [("ssm", i * per + j) for j in range(per)]
        order.append(("attn", i))
    order += [("ssm", layer) for layer in range(n_apply * per, cfg.n_layers)]
    return order


def forward(params, cfg: ModelConfig, batch: dict, *,
            attn_impl: str = "flash", ssd_impl: str = "kernel",
            return_hidden: bool = False):
    """Teacher-forced scoring: batch["tokens"] (B, S) -> logits (B, S, Vp)
    (or, with ``return_hidden``, the final-normed (B, S, D)). By default
    each application of the shared block runs the prefill-attention
    kernel and each SSD layer ``ssd_intra``; ``attn_impl="masked"`` and
    ``ssd_impl="plain"`` run their differentiable plain versions."""
    check_impl("attn_impl", attn_impl, ATTN_IMPLS)
    check_impl("ssd_impl", ssd_impl, SSD_IMPLS)
    tokens = batch["tokens"]
    x = embed_tokens(cfg, params, tokens)
    positions = torch.arange(tokens.shape[1], device=x.device)
    attend = partial(dense_block, cfg, params["shared_attn"],
                     positions=positions, attn_impl=attn_impl,
                     group="shared_attn")
    for kind, i in block_order(cfg):
        block = partial(ssm_block, cfg, layer_weights(params, i),
                        ssd_impl=ssd_impl) if kind == "ssm" else attend
        x = remat(cfg, block, x)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return x if return_hidden else lm_logits(cfg, params, x)


#: the cache leaves a speculative rollback restores per lane: the SSD
#: recurrence carries its context in conv and state; K/V rows past a
#: lane's ``pos`` are hidden by ``lengths = pos + 1`` and overwritten by
#: the next step, as in the dense family
ROLLBACK_LEAVES = ("conv", "state", "pos")


def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=None,
               device=None):
    """mamba2's recurrent cache over the L SSD layers ("conv", "state",
    "pos") and "k"/"v": (n_apply, B, S, K, hd) in the model dtype. The
    lane is on axis 1 of every leaf but ``pos``, as the engine's slot
    programs assume."""
    dtype = dtype or torch_dtype(cfg.dtype)
    cache = mamba2.init_cache(cfg, batch, max_len, dtype, device)
    kv = (n_applications(cfg), batch, max_len, cfg.padded_kv_heads,
          cfg.head_dim)
    cache["k"] = torch.zeros(kv, dtype=dtype, device=device)
    cache["v"] = torch.zeros(kv, dtype=dtype, device=device)
    return cache


def decode_step(params, cfg: ModelConfig, cache, prev_tokens):
    """One autoregressive step: (cache, prev (B,)) -> (logits (B, Vp),
    cache). Application i of the shared block writes ``k[i]``/``v[i]``;
    the cache is updated in place and ``pos`` advances by one."""
    pos = cache["pos"]
    x = embed_tokens(cfg, params, prev_tokens[:, None])
    shared = params["shared_attn"]
    for kind, i in block_order(cfg):
        if kind == "ssm":
            x = ssm_decode_step(cfg, layer_weights(params, i), x,
                                cache["conv"][i], cache["state"][i])
        else:
            x = decode_block(cfg, shared, x, cache["k"][i], cache["v"][i],
                             pos)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = lm_logits(cfg, params, x)[:, 0]
    pos.add_(1)             # in place: every cache leaf keeps its storage
    return logits, cache
