"""Family dispatch: one forward/init_cache/decode_step API over the six
model families of the JAX package's ``models/api.py`` (dense, vlm: the
dense model with an image prefix in ``forward``, moe, ssm, hybrid and
encdec), and the training loss ``loss_fn`` of every family."""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.launch.mesh import batch_axes
from repro_torch.sharding import specs
from . import encdec, hybrid, mamba2, moe, transformer
from .layers import in_mesh_ctx, mesh_context, mesh_ctx
from .schema import count_params, from_jax, init_params, schema

_FAMS = {
    "dense": transformer,
    "vlm": transformer,
    "moe": moe,
    "ssm": mamba2,
    "hybrid": hybrid,
    "encdec": encdec,
}


#: the arguments that choose each family's differentiable forward, which
#: training runs (no kernel has a backward): the plain attention, the
#: plain chunked SSD, and the capacity-dropped moe dispatch JAX trains
#: with. The defaults of ``forward`` are the kernels (scoring).
TRAIN_FORWARD = {
    "dense": dict(attn_impl="masked"),
    "vlm": dict(attn_impl="masked"),
    "moe": dict(attn_impl="masked", dropless=False),
    "ssm": dict(ssd_impl="plain"),
    "hybrid": dict(attn_impl="masked", ssd_impl="plain"),
    "encdec": dict(attn_impl="masked"),
}


def module_for(cfg: ModelConfig):
    if cfg.family not in _FAMS:
        raise ValueError(f"unknown model family {cfg.family!r} (one of "
                         f"{', '.join(sorted(_FAMS))})")
    return _FAMS[cfg.family]


def stub_inputs(cfg: ModelConfig, batch: int = 1, *, seed: int = 0,
                device=None) -> dict:
    """What a family's stub frontend would hand the model, drawn from
    ``seed`` (standard normal, in the model dtype, on ``device``), at the
    shapes of the JAX package's ``launch/input_specs.py``: encdec
    ``frames`` (batch, max_source_len, D), vlm ``img_embeds`` (batch,
    n_img_tokens, D); ``{}`` for the other families. The same seed and
    device give the same tensors, so a fresh process can rebuild a
    predictor's conditioning as it rebuilds its weights."""
    rows = {"encdec": ("frames", cfg.max_source_len),
            "vlm": ("img_embeds", cfg.n_img_tokens)}.get(cfg.family)
    if rows is None:
        return {}
    device = torch.device("cpu" if device is None else device)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    x = torch.randn((batch, rows[1], cfg.d_model), generator=gen,
                    device=device, dtype=torch.float32)
    return {rows[0]: x.to(transformer.torch_dtype(cfg.dtype))}


#: the families the port trains on a mesh (the train layout), as it
#: serves every family there: all six (``train_loop.check_train_mesh``
#: refuses what stays open, experts that do not divide 'model')
TRAIN_MESH_FAMILIES = tuple(_FAMS)


def _gather_top(params: dict, ctx) -> dict:
    """The top-level leaves (``embed``, ``lm_head``, ``final_norm``)
    gathered over 'data' in the train layout on ``ctx`` (the layers
    gather their own, one layer at a time); ``params`` itself on one
    device."""
    if ctx is None:
        return params
    return {k: v if isinstance(v, dict) else ctx.gather(v, ctx.pspecs[k])
            for k, v in params.items()}


def gather_top(params: dict, cfg: ModelConfig, mesh) -> dict:
    """``params`` (this rank's blocks in the train layout) with the
    top-level leaves gathered over 'data' (``_gather_top``): what the LM
    head of a train-layout forward reads, in the serve layout's
    blocks."""
    with mesh_context(mesh, cfg, "train") as ctx:
        return _gather_top(params, ctx)


def forward(params, cfg: ModelConfig, batch: dict, *, mesh=None,
            batch_sharded: bool = False, layout: str = "serve", **kw):
    """Teacher-forced logits (B, S, padded_vocab) for batch["tokens"]. On
    a ``mesh``: ``params`` are this rank's blocks in ``layout``
    (``sharding.specs.shard_params``; "train": FSDP over 'data', each
    layer gathering its weights at use, as JAX scores the moe family),
    the tokens this rank's lanes (``batch_sharded``: the batch is cut
    over the batch axes) and the logits this rank's block of the
    vocabulary where 'model' cuts it. Training runs ``loss_fn``."""
    with mesh_context(mesh, cfg, layout, batch_sharded=batch_sharded) as ctx:
        if layout == "train":
            params = _gather_top(params, ctx)
        return module_for(cfg).forward(params, cfg, batch, **kw)


def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=None,
               device=None, mesh=None, **kw):
    """A zeroed decode cache; ``kw`` is the family's own (encdec:
    ``source_len`` and ``lanes`` of its cross-attention K/V). On a
    ``mesh``: this rank's block of the cache of ``batch`` lanes
    (``sharding.specs.cache_pspecs``), allocated at its own shapes
    (``sharding.specs.cache_local_shapes``: mamba2's ``conv`` in the
    port's layout, the encdec cross K/V of one source whole along the
    lanes; the sequence cut over the batch axes where the batch does not
    divide them, and over 'model' where the KV heads do not divide it: a
    ring's min(max_len, W) slots too, which must divide those axes)."""
    mod = module_for(cfg)
    if mesh is None:
        return mod.init_cache(cfg, batch, max_len, dtype, device, **kw)
    whole = mod.init_cache(cfg, batch, max_len, dtype, "meta", **kw)
    shapes = specs.cache_local_shapes(
        cfg, mesh, {k: tuple(v.shape) for k, v in whole.items()},
        batch=batch)
    return {k: torch.zeros(shapes[k], dtype=v.dtype, device=device)
            for k, v in whole.items()}


def decode_step(params, cfg: ModelConfig, cache, prev_tokens, *, mesh=None,
                batch_sharded: bool = False):
    """(logits (B, padded_vocab), cache) — the cache is updated in place.
    On a ``mesh``, as ``forward``: this rank's lanes and cache, and its
    block of the vocabulary."""
    with mesh_context(mesh, cfg, batch_sharded=batch_sharded):
        return module_for(cfg).decode_step(params, cfg, cache, prev_tokens)


@torch.no_grad()
def write_conditioning(params, cfg: ModelConfig, cache, extra: dict, *,
                       mesh=None, batch_sharded: bool = False) -> None:
    """Write the per-job conditioning of ``extra`` into ``cache`` in
    place: the encdec cross K/V of ``extra["frames"]`` (``lanes``,
    S_enc, D), encoded at their own batch (``encdec.write_cross_kv``);
    nothing for the other families (the vlm image reaches scoring only).
    On a ``mesh``, this rank's block of the cache and its rows of the
    frames (``batch_sharded``), or the one source all lanes read."""
    if cfg.family != "encdec":
        return
    with mesh_context(mesh, cfg, batch_sharded=batch_sharded):
        encdec.write_cross_kv(params, cfg, cache["xk"], cache["xv"],
                              extra["frames"])


def rollback_leaves(cfg: ModelConfig) -> tuple[str, ...]:
    """The cache leaves that a speculative rollback restores per lane,
    whole (the rest need no copy: see each family's ``ROLLBACK_LEAVES``)."""
    return module_for(cfg).ROLLBACK_LEAVES


def conditioning_leaves(cfg: ModelConfig) -> tuple[str, ...]:
    """The cache leaves that hold per-job conditioning, written once per
    cache and left alone by lane resets, snapshots, restores and
    rollbacks (encdec: the cross-attention K/V ``xk``/``xv``); none in
    the other families."""
    return getattr(module_for(cfg), "CONDITIONING_LEAVES", ())


def ring_leaves(cfg: ModelConfig) -> tuple[str, ...]:
    """The ring-cache leaves (a sliding window) whose slots a verify round
    overwrites: a rollback writes back the rows of the rejected steps
    (see ``transformer.ring_leaves``, which the moe family's cache
    shares); none without a window, and none in a family without a ring
    (ssm, hybrid)."""
    ring = getattr(module_for(cfg), "ring_leaves", None)
    return ring(cfg) if ring else ()


def _ce_from_logits(logits, targets):
    """Per-position cross entropy (B, S) in fp32: logsumexp minus the
    target's logit (padded-vocabulary ids carry -1e30 and add nothing).
    In the train layout on a mesh whose 'model' axis cuts the
    vocabulary, ``logits`` are this rank's block of columns: the max is
    a ``pmax`` over 'model' (no gradient: the result does not depend on
    it), the exp-sum a ``psum``, and the target's logit comes from the
    rank that owns its column (a ``psum`` of each rank's owned ones);
    the result is the same on every rank of 'model'."""
    lg = logits.float()
    ctx = mesh_ctx()
    if ctx is None or not ctx.cut("vocab"):
        return torch.logsumexp(lg, dim=-1) - lg.gather(
            -1, targets[..., None])[..., 0]
    n = lg.shape[-1]
    lo = ctx.mesh.axis_index("model") * n
    m = ctx.mesh.pmax(lg.detach().amax(dim=-1), "model")
    lse = m + ctx.psum((lg - m[..., None]).exp().sum(dim=-1),
                       "model").log()
    local = targets - lo
    own = (local >= 0) & (local < n)
    t = lg.gather(-1, local.clamp(0, n - 1)[..., None])[..., 0]
    return lse - ctx.psum(t * own, "model")


def loss_fn(params, cfg: ModelConfig, batch: dict, *, loss_block: int = 0,
            mesh=None, batch_sharded: bool | tuple = True):
    """Next-token cross entropy (paper Eq. 16), as the JAX package's
    ``loss_fn``: batch["tokens"] (B, S) is the whole input, the target of
    position t is token t + 1, and the last position (no target) is
    masked, as is any position where batch["mask"] is 0. The forward is
    the family's differentiable one (``TRAIN_FORWARD``), never a kernel;
    the batch's other entries (encdec ``frames``, vlm ``img_embeds``)
    reach it.

    ``loss_block > 0`` evaluates the LM head and the cross entropy per
    block of ``loss_block`` positions, each block under
    ``torch.utils.checkpoint``, so the fp32 logits exist one block at a
    time.

    On a ``mesh`` (the train layout): ``params`` are this rank's blocks
    (``specs.param_pspecs(cfg, mesh, "train")``) and ``batch`` this
    rank's rows of the global batch (cut over 'pod' and 'data'), or,
    ``batch_sharded`` False, the whole batch on every rank (one that
    does not divide the batch axes, as JAX's ``batch_pspecs`` keeps it),
    or, a tuple, its rows cut over those batch axes and whole over the
    others (``train_loop.row_axes``);
    the cross entropy is taken over the vocabulary-sharded logits, and
    the loss is the mean over the global batch's masked positions (sums
    ``psum``med over the batch axes: a whole batch counts once on every
    rank, numerator and denominator alike, so the mean and each rank's
    share of the gradient are the same), the same on every rank. The
    gradients autograd then gives are this rank's contributions: the
    train step sums them over the axes a leaf is whole on
    (``train/train_loop.py``)."""
    module_for(cfg)                     # an unknown family raises here
    train_kw = TRAIN_FORWARD[cfg.family]
    tokens = batch["tokens"]
    targets = F.pad(tokens[:, 1:], (0, 1))
    mask = torch.ones(targets.shape, dtype=torch.float32,
                      device=tokens.device) if "mask" not in batch \
        else batch["mask"].float().clone()
    mask[:, -1] = 0.0
    fwd = module_for(cfg).forward
    with mesh_context(mesh, cfg, "train",
                      batch_sharded=batch_sharded) as ctx:
        params = _gather_top(params, ctx)
        if loss_block:
            hidden = fwd(params, cfg, batch, return_hidden=True, **train_kw)
            S, sb = hidden.shape[1], loss_block

            @in_mesh_ctx        # the recompute runs in the backward
            def blk(h, t):
                return _ce_from_logits(
                    transformer.lm_logits(cfg, params, h), t)
            nll = torch.cat([
                checkpoint(blk, hidden[:, s0:s0 + sb],
                           targets[:, s0:s0 + sb], use_reentrant=False)
                for s0 in range(0, S, sb)], dim=1)
        else:
            nll = _ce_from_logits(fwd(params, cfg, batch, **train_kw),
                                  targets)
        tot = torch.stack([(nll * mask).sum(), mask.sum()])
        if ctx is not None:
            tot = ctx.psum(tot, batch_axes(mesh))
    return tot[0] / tot[1].clamp(min=1.0)


__all__ = ["forward", "gather_top", "loss_fn", "TRAIN_MESH_FAMILIES",
           "TRAIN_FORWARD", "init_cache", "decode_step",
           "rollback_leaves", "ring_leaves", "conditioning_leaves",
           "write_conditioning",
           "module_for", "stub_inputs", "init_params", "from_jax",
           "count_params", "schema"]
