"""Dense decoder-only transformer (llama/qwen family): the teacher-forced
``forward`` and the decode path of the JAX package's
``models/transformer.py`` in PyTorch.

Layouts are the JAX ones, so tests compare like with like: stacked layer
weights (L, D, out) used as ``x @ W``; caches (L, B, S, K, hd); per-lane
positions ``pos`` (B,). ``forward`` and ``decode_step`` cover GQA, RoPE,
qk-norm, the padded-vocab mask and a sliding window.
``forward(attn_impl="flash")`` (the default: scoring, under
``no_grad``) runs the prefill-attention kernel; ``attn_impl="masked"``
runs the differentiable ``attention_masked`` for training, with each
layer under ``torch.utils.checkpoint`` when ``cfg.remat`` is set (the
JAX package's per-layer ``jax.checkpoint``, applied in grad mode).

The decode cache has the JAX package's two variants:
  * ``kv_cache_dtype="int8"``: K/V rows quantized on write (``_quant_kv``:
    one fp16 scale per lane, position and kv-head) into int8 leaves beside
    ``k_scale``/``v_scale``; the int8 decode-attention kernel dequantizes
    them as it reads (``kernels/ref.py dequant_kv``: to fp32, then the
    model dtype);
  * a sliding window W: the cache is a ring of S = min(max_len, W) slots,
    position p written at slot p % S (``_cache_slot``), and the decode
    kernel attends min(pos + 1, S) slots -- the last S positions once the
    ring has wrapped. A speculative rollback must then put back the slots
    that rejected drafts overwrote (``ring_leaves``, ``serve/graphs.py``).
Not ported yet (it raises ``NotImplementedError``): the ``vlm``
image-embedding prefix of ``forward``.

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


def _check_family(cfg: ModelConfig, *also: str) -> None:
    """Refuse a config outside the dense family (and the families
    ``also``, which share the function called)."""
    if cfg.family not in ("dense", "vlm") + also:
        raise NotImplementedError(
            f"models/transformer.py runs the dense family (got "
            f"{cfg.family!r}; the port's moe family is models/moe.py, its "
            f"ssm family models/mamba2.py, its hybrid family "
            f"models/hybrid.py)")


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


#: the cache leaves a speculative rollback restores per lane, whole: only
#: ``pos``. In a linear cache, K/V rows past a lane's ``pos`` are hidden
#: from attention by ``lengths = pos + 1`` (the kernel and its plain
#: version skip them exactly) and the next step's write overwrites them.
#: A ring that has wrapped hides nothing: see ``ring_leaves``.
ROLLBACK_LEAVES = ("pos",)


def int8_cache(cfg: ModelConfig) -> bool:
    return cfg.kv_cache_dtype == "int8"


def ring_leaves(cfg: ModelConfig) -> tuple[str, ...]:
    """The leaves of a ring cache (sliding window): (L, B, S, ...) with the
    position's slot on axis 2. A verify round of T steps overwrites slots
    (pos + t) % S, which after the wrap hold positions still inside the
    window, so it copies those rows first and a rollback writes back the
    ones of the rejected steps (``serve/graphs.py``). No window: none."""
    if not cfg.sliding_window:
        return ()
    return ("k", "v", "k_scale", "v_scale") if int8_cache(cfg) \
        else ("k", "v")


def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=None,
               device=None):
    """KV cache {"k", "v": (L, B, S, K, hd), "pos": (B,) int32}: S =
    max_len slots per lane, or a ring of min(max_len, W) under a sliding
    window W. With ``kv_cache_dtype="int8"`` k/v are int8 and
    "k_scale"/"v_scale" (L, B, S, K) fp16 hold each row's scale (half the
    decode step's cache bytes of bf16, as in the JAX package). ``pos`` is
    PER-LANE: every lane carries its own decode position, so the
    continuous-batching scheduler can reset one slot to a fresh context
    while the rest keep stepping. The moe family's cache is this one
    (``models/moe.py``: its attention is the dense block's)."""
    _check_family(cfg, "moe")
    dtype = dtype or torch_dtype(cfg.dtype)
    L, Kp, hd = cfg.n_layers, cfg.padded_kv_heads, cfg.head_dim
    S = min(max_len, cfg.sliding_window) if cfg.sliding_window \
        else max_len
    kv = torch.int8 if int8_cache(cfg) else dtype
    cache = {
        "k": torch.zeros((L, batch, S, Kp, hd), dtype=kv, device=device),
        "v": torch.zeros((L, batch, S, Kp, hd), dtype=kv, device=device),
    }
    if int8_cache(cfg):
        cache["k_scale"] = torch.zeros((L, batch, S, Kp),
                                       dtype=torch.float16, device=device)
        cache["v_scale"] = torch.zeros((L, batch, S, Kp),
                                       dtype=torch.float16, device=device)
    cache["pos"] = torch.zeros((batch,), dtype=torch.int32, device=device)
    return cache


def _quant_kv(x):
    """x (..., hd) -> (int8 (..., hd), fp16 scale (...)), as the JAX
    package's ``_quant_kv``: scale = (max |x| + 1e-8) / 127 in fp32,
    round(x / scale) half to even, clipped to +-127; the scale is stored
    in fp16 (and the dequantization reads that fp16 value)."""
    xf = x.float()
    scale = (xf.abs().amax(dim=-1) + 1e-8) / 127.0
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale.to(torch.float16)


def _cache_slot(cfg: ModelConfig, pos, cache_len: int):
    """Slot of each lane's position ``pos`` (B,): pos % S in a ring (a
    sliding window), else pos. A lane past the end of a linear cache (an
    idle scheduler slot keeps stepping) writes its last slot instead of
    being dropped as in JAX; its output is never read, and live lanes
    always satisfy pos < S."""
    if cfg.sliding_window:
        return (pos % cache_len).long()
    return pos.clamp(max=cache_len - 1).long()


def layer_weights(params, layer: int) -> dict:
    """Layer ``layer``'s slices (views) of the stacked weights."""
    return {name: w[layer] for name, w in params["layers"].items()}


def _decode_attn_one(cfg, lp: dict, x, kc, vc, pos, scales=None):
    """One-token attention of one block, whose weights ``lp`` (a layer's
    slices, or the hybrid's shared block) are given, vs. its (B, S, K,
    hd) cache slices ``kc``/``vc``, which receive the new K/V in place at
    each lane's slot (``_cache_slot``). ``scales`` (k_scale, v_scale),
    each (B, S, K): an int8 cache, written quantized, with the row's
    scale, in place."""
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
    slot = _cache_slot(cfg, pos, kc.shape[1])
    lanes = torch.arange(B, device=x.device)
    if scales is None:
        kc[lanes, slot] = k[:, 0].to(kc.dtype)
        vc[lanes, slot] = v[:, 0].to(vc.dtype)
    else:
        ks, vs = scales
        kq, k_sc = _quant_kv(k[:, 0])
        vq, v_sc = _quant_kv(v[:, 0])
        kc[lanes, slot] = kq
        vc[lanes, slot] = vq
        ks[lanes, slot] = k_sc
        vs[lanes, slot] = v_sc
    o = decode_attention(q, kc, vc, pos, scales)
    return o.reshape(B, 1, Hp * hd) @ lp["wo"]


def decode_block(cfg: ModelConfig, lp: dict, x, kc, vc, pos, scales=None):
    """One decoder block's step (attention, then the MLP, each pre-norm
    with its residual): x (B, 1, D) -> (B, 1, D); the new K/V (and, in
    an int8 cache, their ``scales``) land in ``kc``/``vc`` in place."""
    x = x + _decode_attn_one(cfg, lp, rms_norm(x, lp["ln1"], cfg.norm_eps),
                             kc, vc, pos, scales)
    return x + swiglu(rms_norm(x, lp["ln2"], cfg.norm_eps), lp["wi_gate"],
                      lp["wi_up"], lp["wo_mlp"])


def decode_step(params, cfg: ModelConfig, cache, prev_tokens):
    """One autoregressive step: (cache, prev (B,)) -> (logits (B, Vp),
    cache). The cache is updated in place; ``pos`` advances by one."""
    _check_family(cfg)
    pos = cache["pos"]
    int8 = int8_cache(cfg)
    x = embed_tokens(cfg, params, prev_tokens[:, None])
    for layer in range(cfg.n_layers):
        scales = (cache["k_scale"][layer], cache["v_scale"][layer]) \
            if int8 else None
        x = decode_block(cfg, layer_weights(params, layer), x,
                         cache["k"][layer], cache["v"][layer], pos, scales)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = lm_logits(cfg, params, x)[:, 0]
    pos.add_(1)             # in place: every cache leaf keeps its storage
    return logits, cache
