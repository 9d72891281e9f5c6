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
The ``vlm`` family is this model with an image prefix in ``forward``:
``batch["img_embeds"]`` (B, n_img, D), the stub frontend's patch
embeddings, go before the token embeddings, positions run over the whole
sequence, and the image positions are dropped after the final norm (the
JAX package's ``transformer.py`` forward). Its decode step is the dense
one and reads no image, as the JAX package's does. ``attn_block`` also
serves the encdec family (``models/encdec.py``): bidirectional, without
rotary positions, and as cross-attention over given K/V.

On a mesh (``models/layers.py mesh_context``, the serve layout) each
call runs this rank's blocks: its q and KV heads (both cut over 'model'
where the KV heads divide tp), its hidden columns of the MLP and, where
'model' cuts the vocabulary, its block of the logits' columns
(``lm_logits``); ``tp_down_proj`` sums the row-parallel products over
'model'. KV heads that do not divide tp leave the K/V projections whole
on every rank: q is gathered over 'model', scoring attends all heads,
and decode runs the sequence-cut attention (``_seq_sharded_decode_attn``),
as it does wherever JAX's ``cache_pspecs`` cuts the cache along the
sequence (``seq_cut``: also over the batch axes, for a batch that does
not divide them, and a ring along its slots); lock-step only where
JAX's predicate says so (``decode_requires_lockstep``). In the
train layout (``models.api.loss_fn(mesh=...)``) each block first
gathers its weights' D rows over 'data' (``layers.gather_layer``), the
normed activations ``enter`` the column-parallel products, and the
batch is this rank's rows (vlm: with their rows of ``img_embeds``): the
gradients come out as this rank's blocks (``train/train_loop.py``).

One deliberate difference: JAX is functional and returns a new cache;
here ``decode_step`` writes the new K/V into the cache tensors in place
(a full-width cache is hundreds of MB, and a copy per step would double
the step's memory traffic) and advances ``pos`` in place, so every cache
leaf keeps its storage: a captured CUDA graph of the step
(``serve/graphs.py``) reads and writes fixed addresses.
"""
from __future__ import annotations

from functools import partial

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.launch import collectives
from repro_torch.sharding import specs
from .layers import (NEG_INF, attention_masked, column_input,
                     decode_attention, gather_layer, in_mesh_ctx,
                     mesh_ctx,
                     prefill_attention, rms_norm, rope, swiglu,
                     tp_down_proj)

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
    """Logits (..., Vp) of the final-normed ``x``; on a mesh whose 'model'
    axis cuts the vocabulary, this rank's block of Vp / tp columns (ids
    from rank * Vp / tp on: ``lm_head`` is that block, a tied ``embed``
    gives its rows), the padding ids among them masked. In the train
    layout ``x`` enters the product (its backward sums over 'model') and
    a tied ``embed``, whole on every rank of 'model', gives its rows
    through ``collectives.split`` (whose backward gathers the blocks'
    gradients)."""
    ctx = mesh_ctx()
    lo = 0
    if ctx is not None and ctx.cut("vocab"):
        n = cfg.padded_vocab // ctx.tp
        lo = ctx.mesh.axis_index("model") * n
        x = ctx.enter(x)
        if not cfg.tie_embeddings:
            head = params["lm_head"]
        elif ctx.train:
            head = collectives.split(params["embed"], ctx.mesh, "model").T
        else:
            head = params["embed"][lo:lo + n].T
    else:
        head = params["embed"].T if cfg.tie_embeddings \
            else params["lm_head"]
    logits = x @ head
    if cfg.padded_vocab != cfg.vocab_size:  # mask padding ids
        pad = torch.arange(lo, lo + logits.shape[-1], device=x.device) \
            >= cfg.vocab_size
        # a Python scalar, not a tensor made on the host: the decode step
        # runs under CUDA-graph capture, where a host copy is refused
        logits = logits.float().masked_fill(pad, NEG_INF).to(logits.dtype)
    return logits


ATTN_IMPLS = ("flash", "masked")


def check_impl(what: str, impl: str, allowed: tuple) -> None:
    """Refuse an implementation name outside ``allowed``."""
    if impl not in allowed:
        raise ValueError(f"{what} {impl!r} (one of {allowed})")


def remat(cfg: ModelConfig, block, x, *args):
    """``block(x, *args)``, under ``torch.utils.checkpoint`` when
    ``cfg.remat`` is set and autograd records (the JAX package's
    per-layer ``jax.checkpoint``): the backward recomputes the block's
    activations instead of keeping them. Tensors the block closes over
    get their gradients too (non-reentrant checkpoint). The recompute
    runs on the mesh the forward ran on (``layers.in_mesh_ctx``): in the
    train layout it gathers the layer's weights again, in the same order
    on every rank."""
    if cfg.remat and torch.is_grad_enabled():
        return checkpoint(in_mesh_ctx(block), x, *args,
                          use_reentrant=False)
    return block(x, *args)


def attn_block(cfg: ModelConfig, lp: dict, x, *, positions,
               attn_impl: str = "flash", prefix: str = "", kv=None,
               causal: bool = True):
    """Pre-norm attention of one layer over the whole sequence (residual
    applied by the caller): x (B, S, D) -> (B, S, D). ``attn_impl``
    "flash" is the kernel, "masked" the differentiable plain version.
    As the JAX package's ``attn_block``: ``positions`` None applies no
    rotary embedding; ``kv`` (k, v), each (B, Sk, K, hd), replaces the
    block's own K/V (cross-attention); ``prefix`` picks the weights
    ``w{prefix}q`` ...; qk-norm applies to the unprefixed block only."""
    B, S, _ = x.shape
    hd = cfg.head_dim
    ctx = mesh_ctx()
    gather = _gathers_q(cfg, ctx)
    x = column_input(x, "heads")
    q = x @ lp[f"w{prefix}q"]
    if gather:
        q = ctx.all_gather(q, "model", dim=-1)
    q = q.reshape(B, S, -1, hd)
    if kv is None:
        k = (x @ lp[f"w{prefix}k"]).reshape(B, S, -1, hd)
        v = (x @ lp[f"w{prefix}v"]).reshape(B, S, -1, hd)
    else:
        k, v = kv
    if cfg.qk_norm and not prefix:
        q = rms_norm(q, lp["q_norm"], cfg.norm_eps)
        k = rms_norm(k, lp["k_norm"], cfg.norm_eps)
    if positions is not None:
        q = rope(q, positions, cfg.rope_theta)
        if kv is None:
            k = rope(k, positions, cfg.rope_theta)
    attend = attention_masked if attn_impl == "masked" else \
        prefill_attention
    o = attend(q, k, v, causal=causal, window=cfg.sliding_window)
    o = o.reshape(B, S, -1)
    if gather:
        o = _own_columns(o, ctx)
    return tp_down_proj(o, lp[f"w{prefix}o"], "heads")


def _gathers_q(cfg: ModelConfig, ctx) -> bool:
    """Whether attention on the mesh ``ctx`` gathers q over 'model': the
    q heads are cut but the KV heads are whole (they do not divide tp).
    Then every rank attends all heads and keeps its own block of the
    output's columns for its rows of ``wo``. Otherwise a rank attends
    its own heads over its own KV heads (both cut: H / tp over K / tp,
    whole GQA groups) or, with neither cut, all of them."""
    return ctx is not None and ctx.cut("heads") and not ctx.cut("kv_heads")


def _own_columns(o, ctx):
    """This rank's block of the last dim of ``o`` (its rows of ``wo``)."""
    n = o.shape[-1] // ctx.tp
    return o.narrow(-1, ctx.mesh.axis_index("model") * n, n)


def dense_block(cfg: ModelConfig, lp: dict, x, *, positions,
                attn_impl: str = "flash", group: str = "layers"):
    """One decoder block (attention, then the MLP, each pre-norm with its
    residual) over the whole sequence; ``lp`` are the block's weights
    from the leaf group ``group`` (hybrid's shared block: "shared_attn"),
    gathered by its specs in the train layout."""
    lp = gather_layer(lp, group)    # FSDP: whole over 'data' (train layout)
    x = x + attn_block(cfg, lp, rms_norm(x, lp["ln1"], cfg.norm_eps),
                       positions=positions, attn_impl=attn_impl)
    return x + swiglu(rms_norm(x, lp["ln2"], cfg.norm_eps), lp["wi_gate"],
                      lp["wi_up"], lp["wo_mlp"], reduce="mlp")


def forward(params, cfg: ModelConfig, batch: dict, *,
            attn_impl: str = "flash", return_hidden: bool = False):
    """Teacher-forced scoring: batch["tokens"] (B, S) -> logits (B, S, Vp);
    logits[:, t] predicts tokens[:, t + 1] (the predictor handles the BOS
    shift). "flash": one prefill-attention launch per layer; "masked":
    the plain attention autograd can differentiate. ``return_hidden``
    stops before the LM head: the final-normed (B, S, D).

    vlm: ``batch["img_embeds"]`` (B, n_img, D), cast to the model dtype,
    is put before the token embeddings and dropped after the final norm,
    so the logits are the text positions' (B, S, Vp). Its batch must be
    the tokens' (``ValueError``, where the JAX package's concatenate
    raises). Other families ignore it, as the JAX package does."""
    _check_family(cfg)
    check_impl("attn_impl", attn_impl, ATTN_IMPLS)
    tokens = batch["tokens"]
    x = embed_tokens(cfg, params, tokens)
    n_img = 0
    if cfg.family == "vlm" and "img_embeds" in batch:
        img = batch["img_embeds"]
        if img.dim() != 3 or img.shape[0] != x.shape[0] \
                or img.shape[2] != x.shape[2]:
            raise ValueError(
                f"img_embeds {tuple(img.shape)} must be (B, n_img, "
                f"{x.shape[2]}) with the tokens' batch B = {x.shape[0]}")
        n_img = img.shape[1]
        x = torch.cat([img.to(device=x.device, dtype=x.dtype), x], dim=1)
    positions = torch.arange(x.shape[1], device=x.device)
    for layer in range(cfg.n_layers):
        x = remat(cfg, partial(dense_block, cfg, layer_weights(params, layer),
                               positions=positions, attn_impl=attn_impl), x)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)[:, n_img:]
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


def decode_requires_lockstep(cfg: ModelConfig, mesh=None) -> bool:
    """True when the decode step of ``cfg`` on ``mesh`` (None: the active
    mesh context's) takes the sequence-sharded attention: the 'model'
    axis has more than one rank, the padded KV heads do not divide it,
    and there is no sliding window. That path collapses the lanes'
    positions to their max (``_seq_sharded_decode_attn``), so it is
    lock-step only: no per-slot refill. One predicate for the refusal
    (the service scheduler's) and the dispatch, so they cannot drift.
    It covers every family with a self-attention cache: hybrid's shared
    block, encdec's decoder, vlm's (the dense step). The ssm family has
    no attention and never takes it (the JAX predicate reads only the
    KV heads, so it refuses a mamba2 predictor where they do not
    divide). The JAX predicate also asks for its explicit-TP switch or
    the serve layout; the port's collectives are always explicit and
    its serving runs the serve layout, so it has no such term."""
    if mesh is None:
        ctx = mesh_ctx()
        mesh = None if ctx is None else ctx.mesh
    if mesh is None or "model" not in mesh.axis_names \
            or cfg.family == "ssm":
        return False
    tp = mesh.shape["model"]
    return tp > 1 and cfg.padded_kv_heads % tp != 0 \
        and not cfg.sliding_window


def seq_cut(cfg: ModelConfig, ctx) -> tuple:
    """The mesh axes this rank's self-attention cache is cut over along
    the sequence on the mesh ``ctx`` (``specs.seq_axes``: the batch axes
    where the lanes are not cut over them, 'model' where the KV heads do
    not divide it); () on one device or where the sequence is whole."""
    if ctx is None or cfg.family == "ssm":
        return ()
    return specs.seq_axes(cfg, ctx.mesh, lanes_cut=ctx.batch_sharded)


def _write_rows(c, lanes, slot, new, mine):
    """c[lane, slot[lane]] = new[lane] for the lanes where ``mine`` (B,)
    holds, the others' rows rewritten with what they hold: in place and
    without a host sync."""
    old = c[lanes, slot]
    keep = mine.view((-1,) + (1,) * (new.dim() - 1))
    c[lanes, slot] = torch.where(keep, new.to(c.dtype), old)


def _seq_sharded_decode_attn(cfg: ModelConfig, mesh, axes: tuple, q, k_new,
                             v_new, kc, vc, pos, scales=None,
                             lockstep: bool = False):
    """Decode attention over a cache cut along the SEQUENCE over the mesh
    ``axes`` (``seq_cut``): this rank's ``kc``/``vc`` (B, S_loc, K, hd)
    hold slots [lo, lo + S_loc) of the S = S_loc x degree(axes) slots,
    its block in the row-major order of ``axes`` (``specs.block``), as
    JAX's ``cache_pspecs`` lays them out. Each lane writes its new K/V
    (int8: quantized, with their scales) at its slot (``_cache_slot``:
    pos % S in a ring) on the rank whose slice holds it, and every rank
    attends q (B, 1, H, hd) over its live slots with the partial
    decode-attention kernel at per-lane lengths clamp(min(p + 1, S) -
    lo, 0, S_loc) (the ring's live slots after the wrap are all of
    them), which returns the normalized output and its log-sum-exp (a
    lane with no live slot here: 0 and -inf). ``combine_partials``
    merges the ranks' partials over ``axes``.

    ``lockstep`` (JAX's ``decode_requires_lockstep``: KV heads that do
    not divide 'model', no window): as JAX's ``_seq_sharded_decode_attn``,
    the lanes' positions collapse to their max. Elsewhere (a ring, a
    cache cut over the batch axes), each lane keeps its own position, as
    JAX's unsharded arithmetic that XLA's partitioner runs there.
    Returns (B, 1, H, hd) in q's dtype."""
    B, _, H, hd = q.shape
    S_loc = kc.shape[1]
    S = S_loc * mesh.degree(axes)
    lo = mesh.axis_index(axes) * S_loc
    p = pos.max().expand(B) if lockstep else pos
    glob = _cache_slot(cfg, p, S)
    mine = (glob >= lo) & (glob < lo + S_loc)
    slot = (glob - lo).clamp(0, S_loc - 1)
    lanes = torch.arange(B, device=q.device)
    if scales is None:
        _write_rows(kc, lanes, slot, k_new[:, 0], mine)
        _write_rows(vc, lanes, slot, v_new[:, 0], mine)
    else:
        ks, vs = scales
        kq, k_sc = _quant_kv(k_new[:, 0])
        vq, v_sc = _quant_kv(v_new[:, 0])
        _write_rows(kc, lanes, slot, kq, mine)
        _write_rows(vc, lanes, slot, vq, mine)
        _write_rows(ks, lanes, slot, k_sc, mine)
        _write_rows(vs, lanes, slot, v_sc, mine)
    lengths = ((p + 1).clamp(max=S) - lo).clamp(0, S_loc) \
        .to(torch.int32).contiguous()
    if scales is None:
        o, lse = ops.decode_attention_partial(q[:, 0], kc, vc, lengths)
    else:
        o, lse = ops.decode_attention_partial_int8(q[:, 0], kc, vc,
                                                   *scales, lengths)
    return combine_partials(mesh, o, lse, axes).to(q.dtype) \
        .reshape(B, 1, H, hd)


#: the most ranks whose partials ``combine_partials`` all-gathers: one
#: collective a layer, of n x (B, H, hd + 1) fp32, where over gloo a
#: collective's round trip costs more than its bytes; above it JAX's
#: pmax and psum, two collectives whose payload does not grow with n
COMBINE_GATHER_RANKS = 8


def combine_partials(mesh, o, lse, axes=("model",)):
    """The attention over a sequence cut over the mesh ``axes`` from every
    rank's partial (``ops.decode_attention_partial``: o (B, H, hd)
    normalized over its slice, lse (B, H); a rank with no live position
    0 and -inf): o = sum_r o_r exp(lse_r - M) / sum_r exp(lse_r - M), M
    the max of the lse, the same bits on every rank. Over at most
    ``COMBINE_GATHER_RANKS`` ranks, one ``all_gather`` of every rank's
    (o, lse) (the blocks in the row-major order of the tuple, the order
    their slices take along the sequence), merged in that order on every
    rank; over more, as JAX: M by a ``pmax``, then the numerator and
    the denominator by one ``psum`` (an all-reduce gives every rank of
    its group the same bits). fp32 (B, H, hd)."""
    hd = o.shape[-1]
    if mesh.degree(axes) <= COMBINE_GATHER_RANKS:
        parts = mesh.all_gather(torch.cat([o, lse[..., None]], dim=-1)[None],
                                axes, dim=0)            # (n, B, H, hd + 1)
        o_r, lse_r = parts[..., :hd], parts[..., hd]
        w = torch.exp(lse_r - lse_r.amax(dim=0))        # (n, B, H)
        num = (o_r * w[..., None]).sum(dim=0)
        return num / w.sum(dim=0)[..., None]
    w = torch.exp(lse - mesh.pmax(lse.clone(), axes))   # (B, H)
    sums = mesh.psum(torch.cat([o * w[..., None], w[..., None]], dim=-1),
                     axes)                              # (B, H, hd + 1)
    return sums[..., :hd] / sums[..., hd:]


def _decode_attn_one(cfg, lp: dict, x, kc, vc, pos, scales=None):
    """One-token attention of one block, whose weights ``lp`` (a layer's
    slices, or the hybrid's shared block) are given, vs. its (B, S, K,
    hd) cache slices ``kc``/``vc``, which receive the new K/V in place at
    each lane's slot (``_cache_slot``). ``scales`` (k_scale, v_scale),
    each (B, S, K): an int8 cache, written quantized, with the row's
    scale, in place. On a mesh: this rank's heads over its KV heads
    (both cut over 'model'), or, where the cache is cut along the
    sequence (``seq_cut``), its slice through the partial kernel
    (``_seq_sharded_decode_attn``), which gathers q's heads over 'model'
    first where they are cut and the KV heads are not."""
    B, _, D = x.shape
    hd = cfg.head_dim
    ctx = mesh_ctx()
    axes = seq_cut(cfg, ctx)
    gather = bool(axes) and _gathers_q(cfg, ctx)
    q = x @ lp["wq"]
    if gather:
        q = ctx.mesh.all_gather(q, "model", dim=-1)
    q = q.reshape(B, 1, -1, hd)
    k = (x @ lp["wk"]).reshape(B, 1, -1, hd)
    v = (x @ lp["wv"]).reshape(B, 1, -1, hd)
    if cfg.qk_norm:
        q = rms_norm(q, lp["q_norm"], cfg.norm_eps)
        k = rms_norm(k, lp["k_norm"], cfg.norm_eps)
    q = rope(q, pos[:, None], cfg.rope_theta)
    k = rope(k, pos[:, None], cfg.rope_theta)
    if axes:
        o = _seq_sharded_decode_attn(
            cfg, ctx.mesh, axes, q, k, v, kc, vc, pos, scales,
            lockstep=decode_requires_lockstep(cfg, ctx.mesh))
    else:
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
    o = o.reshape(B, 1, -1)
    if gather:
        o = _own_columns(o, ctx)
    return tp_down_proj(o, lp["wo"], "heads")


def decode_block(cfg: ModelConfig, lp: dict, x, kc, vc, pos, scales=None):
    """One decoder block's step (attention, then the MLP, each pre-norm
    with its residual): x (B, 1, D) -> (B, 1, D); the new K/V (and, in
    an int8 cache, their ``scales``) land in ``kc``/``vc`` in place."""
    x = x + _decode_attn_one(cfg, lp, rms_norm(x, lp["ln1"], cfg.norm_eps),
                             kc, vc, pos, scales)
    return x + swiglu(rms_norm(x, lp["ln2"], cfg.norm_eps), lp["wi_gate"],
                      lp["wi_up"], lp["wo_mlp"], reduce="mlp")


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
