"""Dense decoder-only transformer (llama/qwen family): the teacher-forced
``forward`` and the decode path of the JAX package's
``models/transformer.py`` in PyTorch.

Layouts are the JAX ones, so tests compare like with like: stacked layer
weights (L, D, out) used as ``x @ W``; caches (L, B, S, K, hd); per-lane
positions ``pos`` (B,). ``forward`` and ``decode_step`` cover GQA, RoPE,
qk-norm and the padded-vocab mask; ``forward`` also takes a sliding
window. ``forward(attn_impl="flash")`` (the default: scoring, under
``no_grad``) runs the prefill-attention kernel; ``attn_impl="masked"``
runs the differentiable ``attention_masked`` for training, with each
layer under ``torch.utils.checkpoint`` when ``cfg.remat`` is set (the
JAX package's per-layer ``jax.checkpoint``, applied in grad mode). Not
ported yet (they raise ``NotImplementedError``): the int8 KV cache
(``kv_cache_dtype="int8"``), the sliding-window ring cache of the decode
path, and the ``vlm`` image-embedding prefix of ``forward``; neither
``pred-*`` nor ``qwen3-1.7b`` uses them.

One deliberate difference: JAX is functional and returns a new cache;
here ``decode_step`` writes the new K/V into the cache tensors in place
(a full-width cache is hundreds of MB, and a copy per step would double
the step's memory traffic) and advances ``pos`` in place, so every cache
leaf keeps its storage: a captured CUDA graph of the step
(``serve/graphs.py``) reads and writes fixed addresses.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from .layers import (NEG_INF, attention_masked, decode_attention,
                     prefill_attention, rms_norm, rope, swiglu)

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def torch_dtype(name: str) -> torch.dtype:
    return _DTYPES[name]


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family not in ("dense", "vlm"):
        raise NotImplementedError(
            f"models/transformer.py runs the dense family (got "
            f"{cfg.family!r}; the port's ssm family is models/mamba2.py, "
            f"its hybrid family models/hybrid.py)")


def _check_cache(cfg: ModelConfig) -> None:
    """The decode path's cache variants the port has not ported."""
    _check_family(cfg)
    if cfg.kv_cache_dtype == "int8":
        raise NotImplementedError(
            "int8 KV cache is not ported yet (models/transformer.py "
            "_quant_kv/_dequant_kv in the JAX package)")
    if cfg.sliding_window:
        raise NotImplementedError(
            "sliding-window (ring buffer) KV cache is not ported yet")


def embed_tokens(cfg: ModelConfig, params, tokens):
    return params["embed"][tokens]


def lm_logits(cfg: ModelConfig, params, x):
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    logits = x @ head
    if cfg.padded_vocab != cfg.vocab_size:  # mask padding ids
        pad = torch.arange(cfg.padded_vocab, device=x.device) \
            >= cfg.vocab_size
        # a Python scalar, not a tensor made on the host: the decode step
        # runs under CUDA-graph capture, where a host copy is refused
        logits = logits.float().masked_fill(pad, NEG_INF).to(logits.dtype)
    return logits


ATTN_IMPLS = ("flash", "masked")


def attn_block(cfg: ModelConfig, lp: dict, x, *, positions,
               attn_impl: str = "flash"):
    """Pre-norm attention of one layer over the whole sequence (residual
    applied by the caller): x (B, S, D) -> (B, S, D). ``attn_impl``
    "flash" is the kernel, "masked" the differentiable plain version."""
    B, S, _ = x.shape
    hd, Hp, Kp = cfg.head_dim, cfg.padded_heads, cfg.padded_kv_heads
    q = (x @ lp["wq"]).reshape(B, S, Hp, hd)
    k = (x @ lp["wk"]).reshape(B, S, Kp, hd)
    v = (x @ lp["wv"]).reshape(B, S, Kp, hd)
    if cfg.qk_norm:
        q = rms_norm(q, lp["q_norm"], cfg.norm_eps)
        k = rms_norm(k, lp["k_norm"], cfg.norm_eps)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    if attn_impl == "masked":
        o = attention_masked(q, k, v, causal=True,
                             window=cfg.sliding_window)
    else:
        o = prefill_attention(q, k, v, causal=True,
                              window=cfg.sliding_window)
    return o.reshape(B, S, Hp * hd) @ lp["wo"]


def dense_block(cfg: ModelConfig, lp: dict, x, *, positions,
                attn_impl: str = "flash"):
    x = x + attn_block(cfg, lp, rms_norm(x, lp["ln1"], cfg.norm_eps),
                       positions=positions, attn_impl=attn_impl)
    return x + swiglu(rms_norm(x, lp["ln2"], cfg.norm_eps), lp["wi_gate"],
                      lp["wi_up"], lp["wo_mlp"])


def forward(params, cfg: ModelConfig, batch: dict, *,
            attn_impl: str = "flash", return_hidden: bool = False):
    """Teacher-forced scoring: batch["tokens"] (B, S) -> logits (B, S, Vp);
    logits[:, t] predicts tokens[:, t + 1] (the predictor handles the BOS
    shift). "flash": one prefill-attention launch per layer; "masked":
    the plain attention autograd can differentiate. ``return_hidden``
    stops before the LM head: the final-normed (B, S, D)."""
    _check_family(cfg)
    if attn_impl not in ATTN_IMPLS:
        raise ValueError(f"attn_impl {attn_impl!r} (one of {ATTN_IMPLS})")
    if "img_embeds" in batch:
        raise NotImplementedError(
            "the vlm image-embedding prefix of forward is not ported yet")
    tokens = batch["tokens"]
    S = tokens.shape[1]
    x = embed_tokens(cfg, params, tokens)
    positions = torch.arange(S, device=x.device)
    lp = params["layers"]
    remat = cfg.remat and torch.is_grad_enabled()

    def block(x, *weights):
        return dense_block(cfg, dict(zip(lp, weights)), x,
                           positions=positions, attn_impl=attn_impl)
    for layer in range(cfg.n_layers):
        weights = [w[layer] for w in lp.values()]
        x = checkpoint(block, x, *weights, use_reentrant=False) if remat \
            else block(x, *weights)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return x if return_hidden else lm_logits(cfg, params, x)


#: the cache leaves a speculative rollback restores per lane: only
#: ``pos``. K/V rows past a lane's ``pos`` are hidden from attention by
#: ``lengths = pos + 1`` (the kernel and its plain version skip them
#: exactly) and the next step's write overwrites them.
ROLLBACK_LEAVES = ("pos",)


def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=None,
               device=None):
    """KV cache {"k", "v": (L, B, S, K, hd), "pos": (B,) int32}. ``pos``
    is PER-LANE: every lane carries its own decode position, so the
    continuous-batching scheduler can reset one slot to a fresh context
    while the rest keep stepping."""
    _check_cache(cfg)
    dtype = dtype or torch_dtype(cfg.dtype)
    L, Kp, hd = cfg.n_layers, cfg.padded_kv_heads, cfg.head_dim
    return {
        "k": torch.zeros((L, batch, max_len, Kp, hd), dtype=dtype,
                         device=device),
        "v": torch.zeros((L, batch, max_len, Kp, hd), dtype=dtype,
                         device=device),
        "pos": torch.zeros((batch,), dtype=torch.int32, device=device),
    }


def layer_weights(params, layer: int) -> dict:
    """Layer ``layer``'s slices (views) of the stacked weights."""
    return {name: w[layer] for name, w in params["layers"].items()}


def _decode_attn_one(cfg, lp: dict, x, kc, vc, pos):
    """One-token attention of one block, whose weights ``lp`` (a layer's
    slices, or the hybrid's shared block) are given, vs. its (B, S, K,
    hd) cache slices ``kc``/``vc``, which receive the new K/V in place
    at each lane's ``pos``."""
    B, _, D = x.shape
    hd, Hp, Kp = cfg.head_dim, cfg.padded_heads, cfg.padded_kv_heads
    q = (x @ lp["wq"]).reshape(B, 1, Hp, hd)
    k = (x @ lp["wk"]).reshape(B, 1, Kp, hd)
    v = (x @ lp["wv"]).reshape(B, 1, Kp, hd)
    if cfg.qk_norm:
        q = rms_norm(q, lp["q_norm"], cfg.norm_eps)
        k = rms_norm(k, lp["k_norm"], cfg.norm_eps)
    q = rope(q, pos[:, None], cfg.rope_theta)
    k = rope(k, pos[:, None], cfg.rope_theta)
    S = kc.shape[1]
    # A lane past the cache end (an idle scheduler slot keeps stepping)
    # writes its last slot instead of being dropped as in JAX; its output
    # is never read, and live lanes always satisfy pos < S.
    slot = pos.clamp(max=S - 1).long()
    lanes = torch.arange(B, device=x.device)
    kc[lanes, slot] = k[:, 0].to(kc.dtype)
    vc[lanes, slot] = v[:, 0].to(vc.dtype)
    o = decode_attention(q, kc, vc, pos)
    return o.reshape(B, 1, Hp * hd) @ lp["wo"]


def decode_block(cfg: ModelConfig, lp: dict, x, kc, vc, pos):
    """One decoder block's step (attention, then the MLP, each pre-norm
    with its residual): x (B, 1, D) -> (B, 1, D); the new K/V land in
    ``kc``/``vc`` in place."""
    x = x + _decode_attn_one(cfg, lp, rms_norm(x, lp["ln1"], cfg.norm_eps),
                             kc, vc, pos)
    return x + swiglu(rms_norm(x, lp["ln2"], cfg.norm_eps), lp["wi_gate"],
                      lp["wi_up"], lp["wo_mlp"])


def decode_step(params, cfg: ModelConfig, cache, prev_tokens):
    """One autoregressive step: (cache, prev (B,)) -> (logits (B, Vp),
    cache). The cache is updated in place; ``pos`` advances by one."""
    _check_cache(cfg)
    pos = cache["pos"]
    x = embed_tokens(cfg, params, prev_tokens[:, None])
    for layer in range(cfg.n_layers):
        x = decode_block(cfg, layer_weights(params, layer), x,
                         cache["k"][layer], cache["v"][layer], pos)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = lm_logits(cfg, params, x)[:, 0]
    pos.add_(1)             # in place: every cache leaf keeps its storage
    return logits, cache
