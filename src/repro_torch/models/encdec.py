"""Whisper-style encoder-decoder (the JAX package's ``models/encdec.py``)
in PyTorch.

The audio frontend is a stub, as in the JAX package: the caller hands
precomputed frame embeddings (B, S_enc, D) over as ``frames``.

* ``encode``: the encoder, bidirectional attention over the frames plus a
  sinusoidal table, then ``enc_final_norm``. Its attention is the prefill
  kernel, non-causal (``attn_impl="flash"``: the kernel on the card, its
  plain version on the CPU).
* ``forward``: teacher-forced decoding. Each decoder layer runs causal
  self-attention with RoPE, then cross-attention over the encoder states
  projected by the layer's ``wxk``/``wxv`` (non-causal, no rotary), then
  the MLP, each pre-norm (``ln1``, ``ln_x``, ``ln2``). Training runs it
  with ``attn_impl="masked"`` (the plain attention, in the encoder too),
  each encoder and decoder layer under ``torch.utils.checkpoint`` when
  ``cfg.remat`` is set, and the frames in the batch beside the tokens.
* ``init_cache`` / ``precompute_cross_kv`` / ``decode_step``: the decode
  program. The cache holds the self-attention K/V per lane, written in
  place at each lane's position as the dense family's are, and the
  cross-attention K/V ``xk``/``xv`` (L, lanes, S_enc, K, hd): the
  encoder's output projected once per source (``write_cross_kv``), which
  every step attends whole (every lane's length is S_enc, as the JAX
  step's ``pos = S_enc - 1``).

In the train layout (``models.api.loss_fn(mesh=...)``) the encoder runs
on this rank's rows of the frames, each encoder and decoder layer
gathers its weights over 'data' by its own group's specs
(``enc_layers``, ``dec_layers``), and the encoder states enter every
layer's cross K/V projection over 'model' (the K/V this rank's KV heads,
or whole and read by its q heads only: either way each rank holds a part
of their cotangent).

On a mesh (``layers.mesh_context``, the serve layout) each block runs as
the dense family's does on its heads (``transformer.attn_block``; the
encoder's non-causal flash over the rank's heads), its MLP columns and
``tp_down_proj``'s sums over 'model'. The cross K/V of a rank are its
KV heads' block of the one shared source (``cross_kv``: its columns of
``wxk``/``wxv``), which a decode step attends with its q heads, summed
over 'model' after ``wxo``. Where JAX's ``cache_pspecs`` cuts
``xk``/``xv`` along the source (over 'model' where the KV heads do not
divide it, every KV head on every rank; over 'data' where the lanes are
not cut over it, a batch that does not divide the batch axes), a rank
holds its slice of the source positions (``source_cut``): the step
runs the partial decode kernel over it and combines the ranks' partials
by their LSE over those axes (``transformer.combine_partials``), as the
sequence-cut self cache does. Every source position is written
before the first step, so the cross cache needs no lock-step of its
own.

The cross K/V are per-job conditioning, not per-lane context: a lane
reset, a prefix-cache snapshot or restore and a speculative rollback
leave them as they are (``CONDITIONING_LEAVES``), as the JAX engine's
``_reset``/``_snapshot``/``_restore``/``_rollback`` do. Frames of batch 1
serve every lane: the cache then holds ONE copy (``lanes`` = 1) that the
step expands over the lanes with stride 0, where the JAX engine
broadcasts the frames and keeps a copy per lane; the kernel reads the
same bytes either way. Frames whose batch equals the cache's serve one
lane each. The cross cache is as long as the frames, not
``max_source_len``: the JAX ``begin_decode`` replaces its leaves with
whatever ``precompute_cross_kv`` returns, and a captured step cannot have
a leaf replaced.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from .layers import (column_input, gather_layer, mesh_ctx, rms_norm, swiglu,
                     tp_down_proj)
from .transformer import (ATTN_IMPLS, _decode_attn_one, _gathers_q,
                          _own_columns, attn_block, check_impl,
                          combine_partials, embed_tokens, lm_logits, remat,
                          seq_cut, torch_dtype)

#: the cache leaves a speculative rollback restores per lane, whole: only
#: ``pos`` (the self-attention K/V past it are hidden and overwritten;
#: the cross K/V never change while a job runs)
ROLLBACK_LEAVES = ("pos",)
#: the per-job conditioning leaves: written once per cache from the
#: frames, never reset, snapshotted, restored or rolled back
CONDITIONING_LEAVES = ("xk", "xv")


def sinusoidal(S: int, D: int, dtype=torch.float32, device=None):
    """The encoder's (S, D) position table: sin and cos of pos / 10000 **
    (2 i / D), computed in float64 by numpy as the JAX package does, then
    cast once to ``dtype``."""
    pos = np.arange(S)[:, None]
    dim = np.arange(D // 2)[None, :]
    ang = pos / np.power(10000.0, 2 * dim / D)
    emb = np.concatenate([np.sin(ang), np.cos(ang)], axis=-1)
    return torch.from_numpy(emb).to(device=device, dtype=dtype)


def _layer(stacked: dict, layer: int) -> dict:
    return {name: w[layer] for name, w in stacked.items()}


def source_lanes(frames_batch: int, batch: int) -> int:
    """The lanes of cross K/V that frames of batch ``frames_batch`` give
    ``batch`` decoder lanes: 1 (one source serves every lane, as the JAX
    package broadcasts it) or ``batch`` (one each). Any other batch
    raises, as ``jnp.broadcast_to`` does."""
    if frames_batch in (1, batch):
        return frames_batch
    raise ValueError(f"frames of batch {frames_batch} cannot serve {batch} "
                     f"lanes (batch 1 serves every lane, batch {batch} one "
                     f"each)")


def encode(params, cfg: ModelConfig, frames, attn_impl: str = "flash"):
    """frames (B, S_enc, D) -> encoder states (B, S_enc, D) in the model
    dtype."""
    eps = cfg.norm_eps
    x = frames.to(dtype=torch_dtype(cfg.dtype))
    x = x + sinusoidal(x.shape[1], x.shape[2], x.dtype, x.device)

    def block(x, lp):
        lp = gather_layer(lp, "enc_layers")     # FSDP (train layout)
        x = x + attn_block(cfg, lp, rms_norm(x, lp["ln1"], eps),
                           positions=None, attn_impl=attn_impl,
                           causal=False)
        return x + swiglu(rms_norm(x, lp["ln2"], eps), lp["wi_gate"],
                          lp["wi_up"], lp["wo_mlp"], reduce="mlp")
    for layer in range(cfg.n_enc_layers):
        x = remat(cfg, block, x, _layer(params["enc_layers"], layer))
    return rms_norm(x, params["enc_final_norm"], eps)


def cross_kv(cfg: ModelConfig, lp: dict, enc):
    """One decoder layer's cross-attention K and V of encoder states enc
    (B, S_enc, D): each (B, S_enc, K, hd) (on a mesh that cuts the KV
    heads, this rank's K / tp)."""
    B, Se, _ = enc.shape
    hd = cfg.head_dim
    # the K/V are this rank's KV heads, or (KV heads that do not divide
    # 'model') whole but read by this rank's q heads only: either way
    # the encoder states' cotangent is summed over 'model' in the train
    # layout (KV heads cut imply q heads cut)
    enc = column_input(enc, "heads")
    return ((enc @ lp["wxk"]).reshape(B, Se, -1, hd),
            (enc @ lp["wxv"]).reshape(B, Se, -1, hd))


def source_cut(cfg: ModelConfig, ctx=None) -> tuple:
    """The mesh axes the cross K/V on the mesh ``ctx`` (default: the
    active one) are cut over along the source positions, as JAX's
    ``cache_pspecs`` cuts them with the self-attention cache's sequence
    (``transformer.seq_cut``): 'data' (and 'pod') where the lanes are
    not cut over the batch axes, 'model' where it does not divide the KV
    heads; () where the source is whole."""
    return seq_cut(cfg, mesh_ctx() if ctx is None else ctx)


def _own_source(cfg: ModelConfig, k, n: int):
    """This rank's ``n`` source positions of ``k`` (B, S_enc, K, hd)
    where the cross K/V are cut along the source (its block in the
    row-major order of ``source_cut``'s axes), else ``k``."""
    axes = source_cut(cfg)
    if not axes:
        return k
    return k.narrow(1, mesh_ctx().mesh.axis_index(axes) * n, n)


def forward(params, cfg: ModelConfig, batch: dict, *,
            attn_impl: str = "flash", return_hidden: bool = False):
    """batch["frames"] (1 or B, S_enc, D) and batch["tokens"] (B, S) ->
    logits (B, S, Vp) (``return_hidden``: the final-normed (B, S, D)).
    The frames are encoded at their own batch; frames of batch 1 serve
    every row of tokens. "flash" runs the prefill kernel in every
    attention; "masked" the differentiable plain attention."""
    check_impl("attn_impl", attn_impl, ATTN_IMPLS)
    tokens = batch["tokens"]
    B, S = tokens.shape
    frames = batch["frames"]
    source_lanes(frames.shape[0], B)
    enc = encode(params, cfg, frames, attn_impl)
    x = embed_tokens(cfg, params, tokens)
    positions = torch.arange(S, device=x.device)
    eps = cfg.norm_eps

    def block(x, lp):
        lp = gather_layer(lp, "dec_layers")     # FSDP (train layout)
        k, v = cross_kv(cfg, lp, enc)
        kv = (k.expand(B, -1, -1, -1), v.expand(B, -1, -1, -1))
        x = x + attn_block(cfg, lp, rms_norm(x, lp["ln1"], eps),
                           positions=positions, attn_impl=attn_impl)
        x = x + attn_block(cfg, lp, rms_norm(x, lp["ln_x"], eps),
                           positions=None, attn_impl=attn_impl, prefix="x",
                           kv=kv, causal=False)
        return x + swiglu(rms_norm(x, lp["ln2"], eps), lp["wi_gate"],
                          lp["wi_up"], lp["wo_mlp"], reduce="mlp")
    for layer in range(cfg.n_layers):
        x = remat(cfg, block, x, _layer(params["dec_layers"], layer))
    x = rms_norm(x, params["final_norm"], eps)
    return x if return_hidden else lm_logits(cfg, params, x)


def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=None,
               device=None, source_len: int | None = None,
               lanes: int | None = None):
    """{"k", "v": (L, batch, max_len, K, hd); "xk", "xv": (L, lanes,
    source_len, K, hd); "pos": (batch,) int32}, zeros, in the model dtype
    (the JAX package plumbs no int8 cache for this family). ``source_len``
    defaults to ``max_source_len``, ``lanes`` to ``batch`` (the JAX
    layout); the engine sizes both from its frames."""
    dtype = dtype or torch_dtype(cfg.dtype)
    L, Kp, hd = cfg.n_layers, cfg.padded_kv_heads, cfg.head_dim
    Se = source_len or cfg.max_source_len
    lanes = batch if lanes is None else lanes
    kv = (L, batch, max_len, Kp, hd)
    xkv = (L, lanes, Se, Kp, hd)
    return {
        "k": torch.zeros(kv, dtype=dtype, device=device),
        "v": torch.zeros(kv, dtype=dtype, device=device),
        "xk": torch.zeros(xkv, dtype=dtype, device=device),
        "xv": torch.zeros(xkv, dtype=dtype, device=device),
        "pos": torch.zeros((batch,), dtype=torch.int32, device=device),
    }


def write_cross_kv(params, cfg: ModelConfig, xk, xv, frames) -> None:
    """Encode ``frames`` (lanes, S_enc, D) once and write every decoder
    layer's cross K/V into ``xk``/``xv`` (L, lanes, S_enc, K, hd) in
    place (on a mesh, this rank's block: its KV heads, or its slice of
    the source positions)."""
    enc = encode(params, cfg, frames)
    for layer in range(cfg.n_layers):
        k, v = cross_kv(cfg, _layer(params["dec_layers"], layer), enc)
        xk[layer].copy_(_own_source(cfg, k, xk.shape[2]))
        xv[layer].copy_(_own_source(cfg, v, xv.shape[2]))


def precompute_cross_kv(params, cfg: ModelConfig, frames):
    """Run the encoder once and return every decoder layer's cross K/V,
    each (L, B, S_enc, K, hd), as the JAX package's function does."""
    shape = (cfg.n_layers,) + tuple(frames.shape[:2]) \
        + (cfg.padded_kv_heads, cfg.head_dim)
    xk = torch.empty(shape, dtype=torch_dtype(cfg.dtype),
                     device=frames.device)
    xv = torch.empty_like(xk)
    write_cross_kv(params, cfg, xk, xv, frames)
    return xk, xv


def _cross_attend(cfg: ModelConfig, lp: dict, x, xk, xv, src_len):
    """One decode step's cross-attention of the normed x (B, 1, D) over
    one layer's cross K/V ``xk``/``xv`` (lanes, S_enc, K, hd), every
    position live (``src_len`` (B,) int32): (B, 1, D). On a mesh, this
    rank's heads over its KV heads, or, where the source is cut along
    its positions (``source_cut``), every q head over this rank's slice
    through the partial kernel, the ranks' partials combined by their
    LSE; the output's rows of ``wxo`` summed over 'model'."""
    B, hd = x.shape[0], cfg.head_dim
    ctx = mesh_ctx()
    split = source_cut(cfg, ctx)
    gather = bool(split) and _gathers_q(cfg, ctx)
    q = column_input(x, "heads") @ lp["wxq"]
    if gather:
        q = ctx.all_gather(q, "model", dim=-1)
    q = q.reshape(B, -1, hd)
    k, v = xk.expand(B, -1, -1, -1), xv.expand(B, -1, -1, -1)
    if split:
        o, lse = ops.decode_attention_partial(q, k, v, src_len)
        o = combine_partials(ctx.mesh, o, lse, split).to(q.dtype)
    else:
        o = ops.decode_attention(q, k, v, src_len)
    o = o.reshape(B, 1, -1)
    if gather:
        o = _own_columns(o, ctx)
    return tp_down_proj(o, lp["wxo"], "heads")


def decode_step(params, cfg: ModelConfig, cache, prev_tokens):
    """One autoregressive step: (logits (B, Vp), cache). Per layer: self-
    attention through the decode-attention kernel over the lane's own
    K/V (written in place at its position), then cross-attention through
    the same kernel over ``xk``/``xv`` whole, then the MLP. ``pos``
    advances by one; the cross K/V are only read."""
    pos = cache["pos"]
    B = prev_tokens.shape[0]
    eps = cfg.norm_eps
    x = embed_tokens(cfg, params, prev_tokens[:, None])
    Se = cache["xk"].shape[2]
    src_len = torch.full((B,), Se, dtype=torch.int32, device=x.device)
    for layer in range(cfg.n_layers):
        lp = _layer(params["dec_layers"], layer)
        x = x + _decode_attn_one(cfg, lp, rms_norm(x, lp["ln1"], eps),
                                 cache["k"][layer], cache["v"][layer], pos)
        x = x + _cross_attend(cfg, lp, rms_norm(x, lp["ln_x"], eps),
                              cache["xk"][layer], cache["xv"][layer],
                              src_len)
        x = x + swiglu(rms_norm(x, lp["ln2"], eps), lp["wi_gate"],
                       lp["wi_up"], lp["wo_mlp"], reduce="mlp")
    x = rms_norm(x, params["final_norm"], eps)
    logits = lm_logits(cfg, params, x)[:, 0]
    pos.add_(1)             # in place: every cache leaf keeps its storage
    return logits, cache
