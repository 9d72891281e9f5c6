"""Dense decoder-only transformer (llama/qwen family): the decode path of
the JAX package's ``models/transformer.py`` in PyTorch.

Layouts are the JAX ones, so tests compare like with like: stacked layer
weights (L, D, out) used as ``x @ W``; caches (L, B, S, K, hd); per-lane
positions ``pos`` (B,). ``decode_step`` covers GQA, RoPE, qk-norm and the
padded-vocab mask. Not ported yet (they raise ``NotImplementedError``):
the int8 KV cache (``kv_cache_dtype="int8"``) and the sliding-window
ring cache; neither ``pred-*`` nor ``qwen3-1.7b`` uses them.

One deliberate difference: JAX is functional and returns a new cache;
here ``decode_step`` writes the new K/V into the cache tensors in place
(a full-width cache is hundreds of MB, and a copy per step would double
the step's memory traffic) and returns the same dict with ``pos``
advanced.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from .layers import NEG_INF, decode_attention, rms_norm, rope, swiglu

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def torch_dtype(name: str) -> torch.dtype:
    return _DTYPES[name]


def _check_supported(cfg: ModelConfig) -> None:
    if cfg.family not in ("dense", "vlm"):
        raise NotImplementedError(
            f"the port runs the dense family only so far (got "
            f"{cfg.family!r})")
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
        logits = torch.where(pad, torch.tensor(NEG_INF, device=x.device),
                             logits.float()).to(logits.dtype)
    return logits


def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=None,
               device=None):
    """KV cache {"k", "v": (L, B, S, K, hd), "pos": (B,) int32}. ``pos``
    is PER-LANE: every lane carries its own decode position, so the
    continuous-batching scheduler can reset one slot to a fresh context
    while the rest keep stepping."""
    _check_supported(cfg)
    dtype = dtype or torch_dtype(cfg.dtype)
    L, Kp, hd = cfg.n_layers, cfg.padded_kv_heads, cfg.head_dim
    return {
        "k": torch.zeros((L, batch, max_len, Kp, hd), dtype=dtype,
                         device=device),
        "v": torch.zeros((L, batch, max_len, Kp, hd), dtype=dtype,
                         device=device),
        "pos": torch.zeros((batch,), dtype=torch.int32, device=device),
    }


def _decode_attn_one(cfg, params, layer: int, x, kc, vc, pos):
    """One-token attention of layer ``layer`` vs. its (B, S, K, hd) cache
    slices ``kc``/``vc``, which receive the new K/V in place at each
    lane's ``pos``."""
    lp = params["layers"]
    B, _, D = x.shape
    hd, Hp, Kp = cfg.head_dim, cfg.padded_heads, cfg.padded_kv_heads
    q = (x @ lp["wq"][layer]).reshape(B, 1, Hp, hd)
    k = (x @ lp["wk"][layer]).reshape(B, 1, Kp, hd)
    v = (x @ lp["wv"][layer]).reshape(B, 1, Kp, hd)
    if cfg.qk_norm:
        q = rms_norm(q, lp["q_norm"][layer], cfg.norm_eps)
        k = rms_norm(k, lp["k_norm"][layer], cfg.norm_eps)
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
    return o.reshape(B, 1, Hp * hd) @ lp["wo"][layer]


def decode_step(params, cfg: ModelConfig, cache, prev_tokens):
    """One autoregressive step: (cache, prev (B,)) -> (logits (B, Vp),
    cache). The cache is updated in place; ``pos`` advances by one."""
    _check_supported(cfg)
    pos = cache["pos"]
    lp = params["layers"]
    x = embed_tokens(cfg, params, prev_tokens[:, None])
    for layer in range(cfg.n_layers):
        a = _decode_attn_one(cfg, params, layer,
                             rms_norm(x, lp["ln1"][layer], cfg.norm_eps),
                             cache["k"][layer], cache["v"][layer], pos)
        x = x + a
        x = x + swiglu(rms_norm(x, lp["ln2"][layer], cfg.norm_eps),
                       lp["wi_gate"][layer], lp["wi_up"][layer],
                       lp["wo_mlp"][layer])
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = lm_logits(cfg, params, x)[:, 0]
    cache["pos"] = pos + 1
    return logits, cache
