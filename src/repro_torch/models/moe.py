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
  3. the (E, C, D) buffer gathered row by row: row (e, c) reads the
     token of expert e's arrival of rank c, if there is one, else zeros
     (``capacity_rows``, which the capacity dispatch shares), every
     expert's SwiGLU as one batched product over it, each (token,
     slot)'s row gathered back at expert * C + rank and weighted, and a
     token's k slots summed in fp32, rounded once.

What the coder needs of it, and how it holds:

  * No slot is dropped: a token's k experts are distinct and C = T, so
    ``dest`` is injective into the E * C rows. JAX's overflow row (for
    capacity drops) is gone.
  * The combine gathers; nothing scatters with accumulation
    (``index_add_``, ``scatter_add_`` and ``index_put_(accumulate=True)``
    add in an order that changes from run to run on the card, and the
    coder needs the same CDF on both sides). The buffer is gathered, and
    the rank's scatter writes each position once.
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

Training dispatches as JAX trains (``forward(dropless=False)``, which
``models.api.loss_fn`` passes; JAX ``moe_ffn_local(dropless=False)``):
capacity C = max(1, ceil(T k / E x ``capacity_factor``)) for the call's
T = B * S tokens, in one group. A (token, slot) is kept iff its
``rank_within_expert`` is below C; a dropped one adds nothing. Where
JAX writes every dropped slot to one overflow row, the port builds the
(E, C, D) buffer by gathering: row (e, c) reads expert e's arrival of
rank c, if there is one (``capacity_rows``), so no two writes meet and
nothing scatters. A microbatch is its own call: its T sets its C, as in
JAX, where the train step slices the batch before the loss. With a
capacity factor of E / k (C = T) nothing is dropped and the capacity
dispatch equals the dropless one bit for bit.

Expert parallelism (JAX's ``moe_block(mesh=...)``): on a mesh whose
'model' axis cuts the experts, a rank holds E / tp of them (``lo`` ..
``lo + E_loc``) and ``moe_ffn`` dispatches, dropless, every one of its
tokens' (token, slot)s that one of them takes; the ranks' partial
outputs, kept in fp32, are summed over 'model' and rounded once. Its
(E_loc, C, D) buffer holds experts lo .. lo + E_loc - 1's rows, so a
token's output still depends on its own input
alone (the one-device dispatch is the same function with lo = 0 and
E_loc = E). Two layouts, as in JAX:

  * the serve layout with a 'data' axis that cuts D (``mapped_serve``):
    the expert weights are this rank's D-block of its experts, the
    tokens are gathered whole over the batch axes, the gate and up
    D-partials are summed over 'data', the down product gives this
    rank's D-block of the output, which is gathered over 'data'; the
    rank keeps its own tokens' rows;
  * otherwise (``mapped``): the tokens are this rank's, the expert
    weights whole;
  * the train layout (``_moe_block_train``, JAX's ``mapped`` under
    ``make_train_step`` and ``make_score_step``): the expert weights
    gathered over 'data' with the rest of the layer, the tokens this
    rank's rows, and the capacity-dropped dispatch with C from this
    rank's own T, as JAX's ``shard_map`` body computes it; scoring
    dispatches dropless there, in groups of 2,048 tokens. The drops
    then depend on the batch shard: the sharded loss equals the mean
    of the shards' unsharded losses, not the loss over the whole batch
    (each shard has the same number of positions). The tokens
    ``enter`` the dispatch and the router's gradient, a partial one on
    each rank, is summed over 'model' by the train step
    (``train_loop.model_partial``). A microbatch whose rows are whole
    over some batch axes has its tokens cut further over them, so that
    the blocks of tokens dispatched together are JAX's. On a mesh whose
    'model' axis has one rank JAX dispatches each microbatch on one
    device, with C from all its tokens, and so does the port (the
    tokens gathered over the batch axes).

Not ported: an int8 KV cache: the JAX package's moe decode step writes
no scales (``moe.py decode_step`` unpacks three values from
``_decode_attn_one``), so there is no reference to hold one against and
``init_cache`` refuses it.
"""
from __future__ import annotations

import math
from functools import partial

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.launch.mesh import batch_axes
from . import transformer
from .layers import gather_layer, mesh_ctx, rms_norm, swiglu
from .transformer import (_decode_attn_one, attn_block, check_impl,
                          embed_tokens, layer_weights, lm_logits, remat)

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


def _arrivals(flat_experts, n_experts: int):
    """(order, sorted expert ids, first): the stable sort of the (T k,)
    expert ids (token-major arrival order within each expert) and where
    each expert's run starts in it."""
    order = torch.argsort(flat_experts, stable=True)
    se = flat_experts[order]
    first = torch.searchsorted(
        se, torch.arange(n_experts, device=flat_experts.device))
    return order, se, first


def _ranks(order, se, first):
    """Each (token, slot)'s rank from its ``_arrivals``: the sorted ranks
    written back through the sort's permutation (each position once)."""
    rank_sorted = torch.arange(order.shape[0], device=order.device) \
        - first[se]
    return torch.empty_like(se).scatter_(0, order, rank_sorted)


def rank_within_expert(flat_experts, n_experts: int):
    """Position of each (token, slot) in its expert's arrival order
    (token-major): (T k,) expert ids -> (T k,) ranks. Sort-based, as in
    JAX: a stable sort by expert, each expert's first position by
    ``searchsorted``, and the sorted ranks written back through the
    sort's permutation (each position once)."""
    return _ranks(*_arrivals(flat_experts, n_experts))


def capacity(cfg: ModelConfig, T: int) -> int:
    """The capacity-dropped dispatch's rows per expert for T tokens, as
    JAX computes it: max(1, ceil(T k / E x capacity_factor))."""
    return max(1, int(math.ceil(T * cfg.top_k / cfg.n_experts
                                * cfg.capacity_factor)))


def capacity_rows(order, first, C: int):
    """The (E, C) rows of a capacity buffer from the dispatch's
    ``_arrivals`` (order, first): (slot, held), where row (e, c) holds
    flat (token, slot) ``slot[e, c]`` -- expert e's arrival of rank c --
    iff ``held[e, c]`` (expert e has more than c arrivals). These are
    exactly the kept slots (rank < C), each in one row."""
    Tk = order.shape[0]
    count = torch.diff(first, append=first.new_full((1,), Tk))
    c = torch.arange(C, device=order.device)
    held = c < count[:, None]
    return order[(first[:, None] + c).clamp(max=Tk - 1)], held


def _keep(rank, C: int):
    """The kept (token, slot)s of a capacity dispatch: rank < C. (Tests
    and ``chip_smoke.py`` wrap it to observe the drops.)"""
    return rank < C


def _combine(out, dest, weights, T: int, k: int, dtype):
    """Each (token, slot)'s expert output row ``dest`` of ``out`` (E C,
    D), weighted, and a token's k slots summed in fp32, rounded once."""
    y = out.index_select(0, dest) * weights.reshape(-1, 1).to(out.dtype)
    return y.view(T, k, -1).float().sum(dim=1).to(dtype)


def _partial(out, dest, weights, T: int, k: int):
    """This rank's fp32 partial output: each (token, slot)'s row ``dest``
    of ``out`` weighted (0 where another rank's expert or a drop takes
    it) and a token's k slots summed in fp32."""
    y = out.index_select(0, dest) * weights.reshape(-1, 1).to(out.dtype)
    return y.view(T, k, -1).float().sum(dim=1)


def moe_ffn_capacity(x_flat, lp: dict, cfg: ModelConfig, *, lo: int = 0,
                     E_loc: int | None = None):
    """Capacity-dropped dispatch and expert compute of T tokens (the
    training path): x (T, D) -> (T, D), JAX's ``moe_ffn_local`` with
    ``dropless=False``. Differentiable. On a mesh (JAX's ``mapped``), the experts lo .. lo +
    E_loc - 1 are this rank's (``lp``'s expert weights are theirs, whole
    over 'data'): the routing and each slot's rank are the global ones
    over these T tokens, and the result is their fp32 partial output."""
    T, D = x_flat.shape
    E, k = cfg.n_experts, cfg.top_k
    whole = E_loc is None
    E_loc = E if whole else E_loc
    C = capacity(cfg, T)
    weights, experts = route(x_flat, lp["router"], k)
    fe = experts.reshape(-1)                                  # (T k,)
    order, se, first = _arrivals(fe, E)
    rank = _ranks(order, se, first)
    keep = _keep(rank, C)
    slot, held = capacity_rows(order, first, C)
    slot, held = slot[lo:lo + E_loc], held[lo:lo + E_loc]
    buf = x_flat[slot // k].masked_fill(~held[..., None], 0)  # (E_loc, C, D)
    out = swiglu(buf, lp["we_gate"], lp["we_up"],
                 lp["we_down"]).reshape(E_loc * C, D)
    if not whole:
        keep = keep & (fe >= lo) & (fe < lo + E_loc)
    # a dropped slot (or another rank's) reads row 0 at weight 0
    dest = torch.where(keep, (fe - lo) * C + rank, 0)
    w = weights * keep.view(T, k)
    if whole:
        return _combine(out, dest, w, T, k, x_flat.dtype)
    return _partial(out, dest, w, T, k)


def moe_ffn(x_flat, lp: dict, cfg: ModelConfig, *, lo: int = 0,
            E_loc: int | None = None, d_block=None, mesh=None):
    """Dropless dispatch and expert compute of T tokens, JAX's
    ``moe_ffn_local`` with C = T: x (T, D) -> (T, D) in x's dtype on one
    device. On a mesh, the experts lo .. lo + E_loc - 1 are this rank's
    (``lp``'s expert weights are theirs) and the result is their fp32
    partial output (T, D_loc); ``d_block`` (start, length): the expert
    weights hold that block of D (the serve layout over 'data'): the
    tokens' block enters the gate and up products, whose partials are
    summed over 'data' on ``mesh``, and the down product gives the
    output's block."""
    T, D = x_flat.shape
    E, k = cfg.n_experts, cfg.top_k
    whole = E_loc is None
    E_loc = E if whole else E_loc
    C = T
    weights, experts = route(x_flat, lp["router"], k)
    fe = experts.reshape(-1)                                  # (T k,)
    order, se, first = _arrivals(fe, E)
    rank = _ranks(order, se, first)
    # expert lo + e's arrival of rank c, if any: row (e, c) of the buffer
    slot, held = capacity_rows(order, first, C)
    slot, held = slot[lo:lo + E_loc], held[lo:lo + E_loc]
    xs = x_flat if d_block is None else x_flat.narrow(1, *d_block)
    buf = xs[slot // k].masked_fill(~held[..., None], 0)     # (E_loc, C, Dl)
    hg = buf @ lp["we_gate"]
    hu = buf @ lp["we_up"]
    if d_block is not None:
        hg = mesh.psum(hg, "data")
        hu = mesh.psum(hu, "data")
    # each expert's SwiGLU (JAX ``_expert_ffn``): one batched product per
    # weight, (E, C, D) @ (E, D, F)
    out = (torch.nn.functional.silu(hg) * hu) @ lp["we_down"]
    out = out.reshape(E_loc * C, -1)
    if whole:
        return _combine(out, fe * C + rank, weights, T, k, x_flat.dtype)
    local = (fe >= lo) & (fe < lo + E_loc)
    # a slot another rank's expert takes reads row 0 at weight 0
    dest = torch.where(local, (fe - lo) * C + rank, 0)
    return _partial(out, dest, weights * local.view(T, k), T, k)


def _moe_block_mesh(cfg: ModelConfig, lp: dict, x_flat, ctx,
                    dispatch_group: int):
    """The moe FFN of this rank's tokens x (T, D) on the mesh ``ctx``
    (expert parallelism; see the module's docstring) -> (T, D)."""
    mesh = ctx.mesh
    tp = _expert_tp(cfg, ctx)
    E_loc = cfg.n_experts // tp
    lo = mesh.axis_index("model") * E_loc if tp > 1 else 0
    d_block = None
    T = x_flat.shape[0]
    if ctx.rules["expert_embed"] == "data":
        dp = mesh.axis_size("data")
        n = cfg.d_model // dp
        d_block = (mesh.axis_index("data") * n, n)
        if ctx.batch_sharded:           # the tokens, whole over the batch
            x_flat = mesh.all_gather(x_flat, batch_axes(mesh), dim=0)
    groups = x_flat.split(dispatch_group) if dispatch_group else (x_flat,)
    y = torch.cat([moe_ffn(g, lp, cfg, lo=lo, E_loc=E_loc,
                           d_block=d_block, mesh=mesh) for g in groups])
    if d_block is not None:
        y = mesh.all_gather(y, "data", dim=1)
        if ctx.batch_sharded:           # this rank's tokens' rows
            y = y.narrow(0, mesh.axis_index(batch_axes(mesh)) * T, T)
    if tp > 1:
        y = mesh.psum(y, "model")
    return y.to(x_flat.dtype)


def _moe_block_train(cfg: ModelConfig, lp: dict, x_flat, ctx, *,
                     dropless: bool = False, dispatch_group: int = 0):
    """The moe FFN of the tokens x (T, D) in the train layout, the expert
    weights whole over 'data' (the layer's gather), as JAX's
    ``moe_block`` computes it on a mesh. The rows are cut over
    ``ctx.row_axes`` and whole over the other batch axes. Where 'model'
    has more than one rank, JAX's ``mapped``: this rank's experts over
    'model', the T tokens cut further over the batch axes the rows are
    whole on (the outputs gathered back), so that each rank dispatches
    one of the blocks of T x (ranks over 'pod' and 'data') consecutive
    tokens that JAX's ``shard_map`` ``in_specs`` give the ranks; the
    partial outputs summed over 'model' in fp32 and rounded once. Where
    it has one, JAX's one-device dispatch of the whole microbatch: the
    tokens gathered over the axes the rows are cut over, this rank's
    rows of the output kept. Training dispatches with capacity drops, C
    from the tokens dispatched together, as JAX computes it; scoring
    (``dropless``: JAX's ``make_score_step``) dispatches dropless in
    groups of ``dispatch_group`` tokens (0: all at once), exact whatever
    the grouping (so this rank's tokens alone)."""
    mesh = ctx.mesh
    rows = ctx.row_axes
    T = x_flat.shape[0]
    if not dropless and ctx.tp == 1:
        if mesh.degree(rows) == 1:
            return moe_ffn_capacity(x_flat, lp, cfg)
        y = moe_ffn_capacity(ctx.all_gather(x_flat, rows, dim=0), lp, cfg)
        return y.narrow(0, mesh.axis_index(rows) * T, T)
    whole = tuple(a for a in batch_axes(mesh) if a not in rows)
    cut = ctx.tp > 1 and mesh.degree(whole) > 1
    x_in = x_flat
    if cut:
        n = T // mesh.degree(whole)
        if n * mesh.degree(whole) != T:
            raise ValueError(f"{T} tokens do not divide the batch axes "
                             f"{whole} of {mesh.shape}")
        x_in = x_flat.narrow(0, mesh.axis_index(whole) * n, n)
    tp = _expert_tp(cfg, ctx)
    E_loc = cfg.n_experts // tp
    kw = {} if tp == 1 else dict(lo=mesh.axis_index("model") * E_loc,
                                 E_loc=E_loc)
    xe = x_in if tp == 1 else ctx.enter(x_in)
    if not dropless:
        y = moe_ffn_capacity(xe, lp, cfg, **kw)
    else:
        groups = xe.split(dispatch_group) if dispatch_group else (xe,)
        y = torch.cat([moe_ffn(g, lp, cfg, **kw) for g in groups])
    if tp > 1:
        y = ctx.psum(y, "model").to(x_flat.dtype)
    return ctx.all_gather(y, whole, dim=0) if cut else y


def _expert_tp(cfg: ModelConfig, ctx) -> int:
    """The ranks the experts are cut over ('model'); experts that do not
    divide a 'model' axis of more than one rank are refused."""
    if ctx.rules["expert"] == "model":
        return ctx.tp
    if ctx.tp > 1:
        raise NotImplementedError(
            f"{cfg.n_experts} experts do not divide the model axis "
            f"({ctx.tp}): experts whole on every rank of a mesh are not "
            f"ported (ROADMAP Queue 1 item 3)")
    return 1


def moe_block(cfg: ModelConfig, lp: dict, x, dispatch_group: int = 0, *,
              dropless: bool = True):
    """The moe FFN sub-block (residual applied by the caller): x (B, S, D)
    -> (B, S, D). Dropless, ``dispatch_group`` > 0 dispatches the B * S
    tokens in groups of at most that many (exact); ``dropless=False``
    dispatches them all at once with capacity drops
    (``moe_ffn_capacity``). On a mesh, expert parallelism: the serve
    layout dispatches dropless (``_moe_block_mesh``), the train layout
    with capacity drops (``_moe_block_train``), as JAX trains, or, for
    scoring (JAX's ``make_score_step``), dropless."""
    B, S, D = x.shape
    x_flat = x.reshape(B * S, D)
    ctx = mesh_ctx()
    if ctx is not None and ctx.train:
        return _moe_block_train(cfg, lp, x_flat, ctx, dropless=dropless,
                                dispatch_group=dispatch_group
                                ).reshape(B, S, D)
    if ctx is not None:
        if not dropless:
            raise NotImplementedError(
                "the capacity-dropped dispatch runs in the train layout "
                "(models.api.loss_fn(mesh=...)); the serve layout "
                "dispatches dropless")
        return _moe_block_mesh(cfg, lp, x_flat, ctx,
                               dispatch_group).reshape(B, S, D)
    if not dropless:
        y = moe_ffn_capacity(x_flat, lp, cfg)
    elif dispatch_group and x_flat.shape[0] > dispatch_group:
        y = torch.cat([moe_ffn(g, lp, cfg)
                       for g in x_flat.split(dispatch_group)])
    else:
        y = moe_ffn(x_flat, lp, cfg)
    return y.reshape(B, S, D)


def moe_dense_block(cfg: ModelConfig, lp: dict, x, *, positions,
                    attn_impl: str = "flash", dispatch_group: int = 0,
                    dropless: bool = True):
    """Attention + moe FFN transformer block, each pre-norm with its
    residual."""
    lp = gather_layer(lp)           # FSDP: whole over 'data' (train layout)
    x = x + attn_block(cfg, lp, rms_norm(x, lp["ln1"], cfg.norm_eps),
                       positions=positions, attn_impl=attn_impl)
    return x + moe_block(cfg, lp, rms_norm(x, lp["ln2"], cfg.norm_eps),
                         dispatch_group, dropless=dropless)


def forward(params, cfg: ModelConfig, batch: dict, *,
            attn_impl: str = "flash", dispatch_group: int | None = None,
            dropless: bool = True, return_hidden: bool = False):
    """Teacher-forced scoring: batch["tokens"] (B, S) -> logits (B, S, Vp)
    (or, with ``return_hidden``, the final-normed (B, S, D)); one
    prefill-attention launch per layer, the experts dispatched in groups
    of at most ``dispatch_group`` tokens (None: the config's
    ``group_size``; 0: all at once). Training passes
    ``attn_impl="masked"`` and ``dropless=False``: the capacity-dropped
    dispatch over all B * S tokens (``dispatch_group`` unused), each
    layer under ``torch.utils.checkpoint`` when ``cfg.remat`` is set."""
    _check(cfg)
    if dispatch_group is None:
        dispatch_group = group_size(cfg)
    check_impl("attn_impl", attn_impl, transformer.ATTN_IMPLS)
    tokens = batch["tokens"]
    x = embed_tokens(cfg, params, tokens)
    positions = torch.arange(tokens.shape[1], device=x.device)
    for layer in range(cfg.n_layers):
        x = remat(cfg, partial(moe_dense_block, cfg,
                               layer_weights(params, layer),
                               positions=positions, attn_impl=attn_impl,
                               dispatch_group=dispatch_group,
                               dropless=dropless), x)
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
