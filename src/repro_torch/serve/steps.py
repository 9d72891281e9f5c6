"""Serve steps for the compression system, on one device or on a mesh:
the counterparts of the JAX package's ``serve/steps.py``.

score_step   -- prefill-shaped: tokens (B, S) -> (top-K ids (B, S, K),
                quantized pmf (B, S, K+1)). The LM head, softmax, top-K
                and quantization run per block of ``s_block`` positions,
                so at most B x s_block x V logits exist at once.
prefill_step -- (params, cache, prefix (B, P)) -> the cache after
                [BOS, prefix[:, :-1]], through the decode step itself.
serve_step   -- (params, cache, prev (B,)) -> (ids (B, K), qpmf (B, K+1),
                cache): one new token of every lane, the decompression
                inner loop.

Arguments and outputs are JAX's. On a mesh (``launch/mesh.py``), each
rank calls the step with its own blocks of the weights
(``sharding.specs.shard_params``, the serve layout for both families)
and of the cache (``models.api.init_cache(mesh=...)``), and with the
whole tokens (B, ...): a rank takes its lanes where the batch divides
the batch axes; elsewhere (a batch of 1 on a (data, model) mesh: the
long-context cells) every rank runs every lane, and the cache is cut
along the sequence over the batch axes (``specs.cache_pspecs``: each
rank attends its slice, ``transformer.combine_partials``). The ids and
qpmf come back whole on every rank (gathered over the batch axes), the
same integers on each. The top-K is
the sharded one (``core.cdf.topk_quantized_sharded``) exactly when the
'model' axis cuts the padded vocabulary (``padded_vocab % tp == 0``),
else the top-K kernel on the whole logits. The model calls are split
from the top-K (``decode_logits``, ``score_hidden`` and ``head_logits``
give a step's logits as ``core.cdf.LogitShards``), so that the engine's
decode and scoring on a mesh (``serve/engine.py``), which learn K only
from the coder, run these same functions. The moe family dispatches
dropless, as JAX's ``_fam_kw`` asks (the port's moe model always does
where it serves; scoring in groups of 2,048 tokens). The score step
runs the moe family in JAX's train layout (``score_layout``: FSDP over
'data', the expert weights gathered, the tokens a rank's rows), the
same function with other weight placement and collectives; it takes
that layout's blocks.

Every family serves on a mesh. The per-job conditioning comes with the
tokens, cut over the batch axes as JAX's ``batch_pspecs`` cuts it where
its batch is the tokens': the vlm's ``img_embeds`` in the score step's
batch (scoring only, as on one device) and the encdec ``frames``, which
the score step encodes and ``write_conditioning`` (or the prefill step,
given ``extra``) encodes into the cache's cross K/V, this rank's block
of them; frames of batch 1 are one source that every lane reads, whole
on every rank. The ssm and hybrid caches' ``conv`` and ``state`` are
this rank's channels and heads (``sharding.specs``).

The steps run eagerly: a gloo collective cannot be captured in a CUDA
graph (on one device, ``serve/graphs.py`` captures the engine's decode
step instead). Each call is an ``obs.span`` (model.*).
"""
from __future__ import annotations

import torch

from repro_torch import obs
from repro_torch.configs.base import ModelConfig
from repro_torch.core.cdf import LogitShards
from repro_torch.launch.mesh import batch_axes
from repro_torch.models import api as model_api
from repro_torch.sharding import specs


def tokens_batch_sharded(mesh, batch: int) -> bool:
    """Whether a batch of ``batch`` lanes is cut over the mesh's batch
    axes (JAX's ``batch_pspecs``: only when it divides them)."""
    if mesh is None:
        return False
    ba = batch_axes(mesh)
    n = mesh.degree(ba) if ba else 1
    return n > 1 and batch % n == 0


def vocab_sharded(cfg: ModelConfig, mesh) -> bool:
    """Whether a step's logits are this rank's block of the vocabulary
    (``transformer.lm_logits``), and its top-K then the sharded one
    (JAX's ``use_sharded``)."""
    return (mesh is not None and "model" in mesh.axis_names
            and mesh.shape["model"] > 1
            and cfg.padded_vocab % mesh.shape["model"] == 0)


def step_logits(local: torch.Tensor, cfg: ModelConfig, mesh) -> LogitShards:
    """A step's logits as this rank holds them, for the coder: its top-K
    is the sharded one exactly when ``vocab_sharded``; the unsharded
    top-K and the gathered logits read the real ids (``vocab_size``),
    as on one device (the padding columns carry -1e30, no mass)."""
    return LogitShards(local, mesh, sharded=vocab_sharded(cfg, mesh),
                       vocab=cfg.vocab_size)


def decode_logits(params, cfg: ModelConfig, cache, prev: torch.Tensor,
                  mesh=None, *, batch_sharded: bool = False) -> LogitShards:
    """The serve step's model call: the cache advanced in place, this
    rank's logits (B, V_loc) of its lanes ``prev``."""
    logits, _ = model_api.decode_step(params, cfg, cache, prev, mesh=mesh,
                                      batch_sharded=batch_sharded)
    return step_logits(logits, cfg, mesh)


def score_hidden(params, cfg: ModelConfig, tokens: torch.Tensor, mesh=None,
                 *, batch_sharded: bool = False,
                 extra: dict | None = None) -> torch.Tensor:
    """The score step's teacher-forced forward (the prefill-attention
    kernel, and ``ssd_intra``): the final hidden states (B, S, D) of its
    lanes ``tokens``, under their conditioning ``extra`` (vlm
    ``img_embeds``, encdec ``frames``: this rank's rows, or one source).
    The moe family dispatches in groups of 2,048 tokens."""
    kw = {"dispatch_group": 2048} if cfg.family == "moe" else {}
    return model_api.forward(params, cfg, {"tokens": tokens,
                                           **(extra or {})},
                             mesh=mesh, batch_sharded=batch_sharded,
                             return_hidden=True, **kw)


def head_logits(params, cfg: ModelConfig, hidden: torch.Tensor,
                mesh=None) -> LogitShards:
    """The LM head of ``hidden`` (..., D): this rank's logits."""
    with model_api.mesh_context(mesh, cfg):
        local = model_api.transformer.lm_logits(cfg, params, hidden)
    return step_logits(local, cfg, mesh)


class _Rows:
    """This rank's lanes of a batch and the gather of per-lane results."""

    def __init__(self, mesh, batch: int):
        self.mesh = mesh
        self.sharded = tokens_batch_sharded(mesh, batch)
        self.axes = batch_axes(mesh) if mesh is not None else ()
        self.n = batch // mesh.degree(self.axes) if self.sharded else batch

    def mine(self, x: torch.Tensor) -> torch.Tensor:
        if not self.sharded:
            return x
        return x.narrow(0, self.mesh.axis_index(self.axes) * self.n, self.n)

    def whole(self, x: torch.Tensor) -> torch.Tensor:
        if not self.sharded:
            return x
        return self.mesh.all_gather(x, self.axes, dim=0)

    def conditioning(self, extra: dict, batch: int, device) -> dict:
        """This rank's rows of each conditioning entry whose batch is the
        tokens' ``batch``; an entry of batch 1 (one source for every
        lane) whole."""
        out = {}
        for k, v in extra.items():
            v = torch.as_tensor(v, device=device)
            out[k] = self.mine(v) if v.shape[0] == batch else v
        return out


def _first(tree):
    for v in tree.values():
        return _first(v) if isinstance(v, dict) else v


def make_serve_step(cfg: ModelConfig, mesh=None, *, batch: int,
                    topk: int = 64, precision: int = 16):
    """serve_step(params, cache, prev (B,)) -> (ids (B, K) int32, qpmf
    (B, K+1) int32, cache), the cache advanced in place."""
    rows = _Rows(mesh, batch)

    @torch.no_grad()
    def serve_step(params, cache, prev):
        with obs.span("model.serve_step"):
            prev = rows.mine(torch.as_tensor(prev, device=_first(
                params).device).long())
            ids, qpmf = decode_logits(
                params, cfg, cache, prev, mesh,
                batch_sharded=rows.sharded).topk_quantized(topk, precision)
            return rows.whole(ids), rows.whole(qpmf), cache
    return serve_step


def write_conditioning(params, cfg: ModelConfig, cache, extra: dict,
                       mesh=None, *, batch: int) -> None:
    """The encdec cross K/V of ``extra["frames"]`` (B or 1, S_enc, D)
    written into this rank's ``cache`` of ``batch`` lanes, in place
    (``models.api.write_conditioning``): JAX's ``precompute_cross_kv``
    put into its cache. Nothing for the other families."""
    rows = _Rows(mesh, batch)
    model_api.write_conditioning(
        params, cfg, cache,
        rows.conditioning(extra, batch, _first(params).device),
        mesh=mesh, batch_sharded=rows.sharded)


def make_prefill_step(cfg: ModelConfig, mesh=None, *, batch: int):
    """prefill_step(params, cache, prefix (B, P), extra=None) -> the cache
    after [BOS, prefix[:, :-1]] (BOS = vocab_size - 1), one decode step
    per position: bit-identical to P serve steps' caches. The caller
    feeds prefix[:, -1] as the first serve_step input. ``extra`` (encdec
    ``frames``) is written into the cache first (``write_conditioning``)."""
    rows = _Rows(mesh, batch)

    @torch.no_grad()
    def prefill_step(params, cache, prefix, extra=None):
        with obs.span("model.prefill_step"):
            if extra:
                write_conditioning(params, cfg, cache, extra, mesh,
                                   batch=batch)
            prefix = rows.mine(torch.as_tensor(prefix, device=_first(
                params).device).long())
            inp = torch.cat([torch.full_like(prefix[:, :1],
                                             cfg.vocab_size - 1),
                             prefix[:, :-1]], dim=1)
            for t in range(inp.shape[1]):
                model_api.decode_step(params, cfg, cache, inp[:, t],
                                      mesh=mesh, batch_sharded=rows.sharded)
            return cache
    return prefill_step


def score_layout(cfg: ModelConfig, mesh) -> str:
    """The layout the score step runs in on ``mesh``: JAX's
    ``make_score_step`` scores the moe family in the train layout (FSDP
    over 'data', the dropless dispatch of ``models.moe``'s ``mapped``),
    every other family in the serve layout."""
    return "train" if cfg.family == "moe" and mesh is not None \
        else "serve"


def make_score_step(cfg: ModelConfig, mesh=None, *, topk: int = 64,
                    precision: int = 16, s_block: int = 2048,
                    global_batch: int = 1):
    """score_step(params, batch {"tokens": (B, S)} and the conditioning:
    vlm "img_embeds" (B, n_img, D), encdec "frames" (B or 1, S_enc, D))
    -> (ids (B, S, K), qpmf (B, S, K+1)) of the text positions: the
    teacher-forced forward (the prefill-attention kernel), then the LM
    head and the top-K per block of ``s_block`` positions.

    On a mesh the moe family scores in JAX's train layout
    (``score_layout``): each layer gathers its weights over 'data', the
    tokens are this rank's rows and the experts dispatch dropless in
    groups of 2,048 (``models.moe._moe_block_train``). ``params`` are
    this rank's blocks in that layout (``specs.shard_params(...,
    layout=score_layout(cfg, mesh))``), as JAX's ``in_shardings`` give
    them; with one rank on 'data' the two layouts' blocks are the
    same."""
    rows = _Rows(mesh, global_batch)
    layout = score_layout(cfg, mesh)

    @torch.no_grad()
    def score_step(params, batch):
        with obs.span("model.score_step"):
            dev = _first(params).device
            tokens = rows.mine(torch.as_tensor(
                batch["tokens"], device=dev).long())
            extra = rows.conditioning(
                {k: v for k, v in batch.items() if k != "tokens"},
                global_batch, dev)
            if layout == "train":
                hidden = model_api.forward(
                    params, cfg, {"tokens": tokens, **extra}, mesh=mesh,
                    batch_sharded=rows.sharded, layout="train",
                    return_hidden=True, dispatch_group=2048)
                params = model_api.gather_top(params, cfg, mesh)
            else:
                hidden = score_hidden(params, cfg, tokens, mesh,
                                      batch_sharded=rows.sharded,
                                      extra=extra)
            ids, qpmf = [], []
            for s0 in range(0, hidden.shape[1], s_block):
                i, q = head_logits(params, cfg, hidden[:, s0:s0 + s_block],
                                   mesh).topk_quantized(topk, precision)
                ids.append(rows.whole(i))
                qpmf.append(rows.whole(q))
            return torch.cat(ids, dim=1), torch.cat(qpmf, dim=1)
    return score_step
