"""Top-k token-choice Mixture-of-Experts (granite-moe, qwen3-moe) on one
device: the PyTorch counterpart of the JAX package's ``models/moe.py``
single-shard path, dropless.

A moe layer is the dense layer's attention (``transformer.attn_block``
for scoring, ``_decode_attn_one`` for a decode step: qk-norm, RoPE, the
prefill and decode kernels) followed by E SwiGLU experts, of which each
token takes its top k. Dispatch is JAX's ``moe_ffn_local`` with one shard
and capacity C = T, the call's token count (dropless):

  1. ``route``: the router's logits (a matmul in the model dtype, then
     fp32), each token's k largest in descending order -- equal logits
     to the lower expert id first, as ``jax.lax.top_k`` orders them (a
     stable descending sort; ``torch.topk`` promises no order for ties,
     and a tie is not rare among 32-128 experts with bf16 logits) -- and
     the softmax over those k;
  2. ``rank_within_expert``: each (token, slot)'s place in its expert's
     arrival order, sort-based as in JAX (no (T k, E) one-hot);
  3. the tokens copied into an (E * C, D) buffer at row expert * C +
     rank, every expert's SwiGLU as one batched product over the (E, C,
     D) buffer, each (token, slot)'s row gathered back
     and weighted, and a token's k slots summed in fp32, rounded once.

What the coder needs of it, and how it holds:

  * No slot is dropped: a token's k experts are distinct and C = T, so
    ``dest`` is injective into the E * C rows. JAX's overflow row (for
    capacity drops) is gone.
  * The combine gathers; nothing scatters with accumulation
    (``index_add_``, ``scatter_add_`` and ``index_put_(accumulate=True)``
    add in an order that changes from run to run on the card, and the
    coder needs the same CDF on both sides). The copies into the buffer
    and the rank's scatter write each row once.
  * Nothing reads the routing on the host: no ``.item()``, ``nonzero``,
    boolean mask or data-dependent shape. The buffer is (E, T, D)
    whatever the routing and the live lengths, so the decode step is
    captured as one CUDA graph unchanged (``serve/graphs.py``), and a
    verify round's steps (B tokens each) have lock-step's shapes.
  * A token's output depends on its own input: each expert's product
    computes each buffer row from that row alone, and the lane's row of
    every later matmul likewise, as in the dense family (a GEMM's row
    does not depend on which row it is: held on the card by
    ``chip_smoke.py``'s lane permutation). Where a token lands in its
    expert's buffer depends on the other tokens of the step; what it
    computes there does not.

Teacher-forced scoring splits its B * S tokens into dispatch groups
(``group_size``: as many tokens as keep the (E, C, D) buffer within
``DISPATCH_BYTES``, a function of the config alone) so that the buffer
and the experts' hiddens stay bounded: qwen3-moe's 16 x 160 scored
tokens would make a 2.7 GB buffer in bf16 (5.4 in fp32) at once, and
take groups of 1,024 (512) tokens instead; granite-moe's fit in one.
Any grouping is exact when dropless (the last group may be shorter,
which JAX's ``lax.map`` does not allow). The expert products cost E * C
* D * F * 6 flops per group whatever the routing.

Not ported: the capacity-dropped dispatch that training uses (the port's
``loss_fn`` refuses the moe family), expert parallelism over several
cards (JAX's ``shard_map`` paths), and an int8 KV cache: the JAX
package's moe decode step writes no scales (``moe.py decode_step``
unpacks three values from ``_decode_attn_one``), so there is no
reference to hold one against and ``init_cache`` refuses it.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from . import transformer
from .layers import rms_norm, swiglu
from .transformer import (_decode_attn_one, attn_block, embed_tokens,
                          layer_weights, lm_logits)

#: bytes of a teacher-forced forward's (E, C, D) dispatch buffer at most
DISPATCH_BYTES = 1 << 30


def group_size(cfg: ModelConfig) -> int:
    """Tokens per dispatch group of a teacher-forced forward: the most
    whose (E, C, D) buffer in the model dtype fits DISPATCH_BYTES (the
    experts' (E, C, F) hiddens are smaller where F < D), at least one. A
    function of the config alone."""
    per_token = cfg.n_experts * cfg.d_model * \
        transformer.torch_dtype(cfg.dtype).itemsize
    return max(1, DISPATCH_BYTES // per_token)


def _check(cfg: ModelConfig) -> None:
    if cfg.family != "moe":
        raise NotImplementedError(
            f"models/moe.py runs the moe family (got {cfg.family!r})")


def route(x_flat, router_w, top_k: int):
    """x (T, D) -> (weights (T, k) fp32, experts (T, k) int64): the k
    largest router logits of each token in descending order, equal ones
    to the lower expert id first (as ``jax.lax.top_k``), and the softmax
    over them (the qwen3 / mixtral convention)."""
    logits = (x_flat @ router_w).float()
    vals, experts = torch.sort(logits, dim=-1, descending=True, stable=True)
    vals, experts = vals[:, :top_k], experts[:, :top_k]
    return torch.softmax(vals, dim=-1), experts


def rank_within_expert(flat_experts, n_experts: int):
    """Position of each (token, slot) in its expert's arrival order
    (token-major): (T k,) expert ids -> (T k,) ranks. Sort-based, as in
    JAX: a stable sort by expert, each run's start found by
    ``searchsorted``, and the sorted ranks written back through the
    sort's permutation (each position once)."""
    Tk = flat_experts.shape[0]
    dev = flat_experts.device
    order = torch.argsort(flat_experts, stable=True)
    se = flat_experts[order]
    first = torch.searchsorted(se, torch.arange(n_experts, device=dev))
    rank_sorted = torch.arange(Tk, device=dev) - first[se]
    return torch.empty_like(flat_experts).scatter_(0, order, rank_sorted)


def moe_ffn(x_flat, lp: dict, cfg: ModelConfig):
    """Dropless dispatch and expert compute of T tokens on one device:
    x (T, D) -> (T, D), JAX's ``moe_ffn_local`` with one shard and C =
    T."""
    T, D = x_flat.shape
    E, k = cfg.n_experts, cfg.top_k
    C = T
    weights, experts = route(x_flat, lp["router"], k)
    fe = experts.reshape(-1)                                  # (T k,)
    dest = fe * C + rank_within_expert(fe, E)
    tok = torch.arange(T * k, device=x_flat.device) // k
    buf = x_flat.new_zeros((E * C, D)).index_copy_(0, dest, x_flat[tok])
    # each expert's SwiGLU (JAX ``_expert_ffn``): one batched product per
    # weight, (E, C, D) @ (E, D, F)
    out = swiglu(buf.view(E, C, D), lp["we_gate"], lp["we_up"],
                 lp["we_down"]).reshape(E * C, D)
    y = out.index_select(0, dest) * weights.reshape(-1, 1).to(out.dtype)
    return y.view(T, k, D).float().sum(dim=1).to(x_flat.dtype)


def moe_block(cfg: ModelConfig, lp: dict, x, dispatch_group: int = 0):
    """The moe FFN sub-block (residual applied by the caller): x (B, S, D)
    -> (B, S, D). ``dispatch_group`` > 0 dispatches the B * S tokens in
    groups of at most that many (exact: dropless)."""
    B, S, D = x.shape
    x_flat = x.reshape(B * S, D)
    if dispatch_group and x_flat.shape[0] > dispatch_group:
        y = torch.cat([moe_ffn(g, lp, cfg)
                       for g in x_flat.split(dispatch_group)])
    else:
        y = moe_ffn(x_flat, lp, cfg)
    return y.reshape(B, S, D)


def moe_dense_block(cfg: ModelConfig, lp: dict, x, *, positions,
                    attn_impl: str = "flash", dispatch_group: int = 0):
    """Attention + moe FFN transformer block, each pre-norm with its
    residual."""
    x = x + attn_block(cfg, lp, rms_norm(x, lp["ln1"], cfg.norm_eps),
                       positions=positions, attn_impl=attn_impl)
    return x + moe_block(cfg, lp, rms_norm(x, lp["ln2"], cfg.norm_eps),
                         dispatch_group)


def forward(params, cfg: ModelConfig, batch: dict, *,
            attn_impl: str = "flash", dispatch_group: int | None = None,
            return_hidden: bool = False):
    """Teacher-forced scoring: batch["tokens"] (B, S) -> logits (B, S, Vp)
    (or, with ``return_hidden``, the final-normed (B, S, D)); one
    prefill-attention launch per layer, the experts dispatched in groups
    of at most ``dispatch_group`` tokens (None: the config's
    ``group_size``; 0: all at once)."""
    _check(cfg)
    if dispatch_group is None:
        dispatch_group = group_size(cfg)
    if attn_impl not in transformer.ATTN_IMPLS:
        raise ValueError(f"attn_impl {attn_impl!r} (one of "
                         f"{transformer.ATTN_IMPLS})")
    tokens = batch["tokens"]
    x = embed_tokens(cfg, params, tokens)
    positions = torch.arange(tokens.shape[1], device=x.device)
    for layer in range(cfg.n_layers):
        x = moe_dense_block(cfg, layer_weights(params, layer), x,
                            positions=positions, attn_impl=attn_impl,
                            dispatch_group=dispatch_group)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return x if return_hidden else lm_logits(cfg, params, x)


#: a rollback restores ``pos`` only, as in the dense family
ROLLBACK_LEAVES = transformer.ROLLBACK_LEAVES
ring_leaves = transformer.ring_leaves


def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=None,
               device=None):
    """The dense family's KV cache (``transformer.init_cache``), in the
    model dtype. An int8 cache is refused: the JAX package's moe decode
    step keeps no scales, so the port has no reference for one."""
    _check(cfg)
    if transformer.int8_cache(cfg):
        raise NotImplementedError(
            "an int8 KV cache for the moe family: the JAX package's "
            "moe.decode_step unpacks no scales from _decode_attn_one "
            "(moe.py:267, :279), so there is no reference to hold it "
            "against; use the model dtype's cache")
    return transformer.init_cache(cfg, batch, max_len, dtype, device)


def decode_step(params, cfg: ModelConfig, cache, prev_tokens):
    """One autoregressive step: (cache, prev (B,)) -> (logits (B, Vp),
    cache). Each layer's new K/V land in the cache in place and ``pos``
    advances by one; the B tokens of the step are dispatched together."""
    _check(cfg)
    pos = cache["pos"]
    x = embed_tokens(cfg, params, prev_tokens[:, None])
    for layer in range(cfg.n_layers):
        lp = layer_weights(params, layer)
        x = x + _decode_attn_one(cfg, lp,
                                 rms_norm(x, lp["ln1"], cfg.norm_eps),
                                 cache["k"][layer], cache["v"][layer], pos)
        x = x + moe_block(cfg, lp, rms_norm(x, lp["ln2"], cfg.norm_eps))
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = lm_logits(cfg, params, x)[:, 0]
    pos.add_(1)             # in place: every cache leaf keeps its storage
    return logits, cache
