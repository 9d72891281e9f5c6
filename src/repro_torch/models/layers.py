"""Core neural layers of the dense decoder (PyTorch port of the JAX
package's ``models/layers.py``).

Float32 inside normalisation, rotary embedding and attention, activations
in the config dtype — cast where the JAX layers cast, so a bf16 config
computes as the reference does. Decode attention and prefill attention
run in the port's CUDA kernels (``kernels/ops.py``) on the card and in
their plain versions on the CPU; the kernels have no backward, so the
training forward takes ``attention_masked``, plain PyTorch on either
device, as the JAX training path takes its XLA ``attention_masked``.

On a mesh (``launch/mesh.py``) a model runs as one rank's program, as a
JAX ``shard_map`` body does: ``mesh_context`` names the mesh and the
layout for the calls inside it, each weight is this rank's block
(``sharding/specs.py``), and the row-parallel products end in an
explicit ``all_reduce`` over 'model' (``tp_down_proj``). The port has no
switch for implicit collectives (the JAX module's ``REPRO_EXPLICIT_TP``
and ``REPRO_BF16_WIRE``, and its residual barrier): its collectives are
always explicit, their payload in the model dtype. Two layouts, as in
the JAX package:

  * "serve": the weights resident (1D TP), the plain ``Mesh``
    collectives, no backward;
  * "train": FSDP and TP (``specs.param_pspecs(cfg, mesh, "train")``):
    the D rows of a weight lie over 'data' where its ``embed`` axis
    says so, and a layer gathers its weights over 'data' before use
    (``MeshContext.gather``; under ``torch.utils.checkpoint`` the
    backward gathers again, in the same order on every rank). Its
    collectives are ``launch/collectives.py``'s, which autograd
    differentiates: a replicated activation ``enter``s a
    column-parallel product, whose backward sums its cotangent over
    'model'; a row-parallel ``psum``'s backward is the identity.
"""
from __future__ import annotations

import contextlib
import contextvars
import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops, ref
from repro_torch.launch import collectives
from repro_torch.launch.mesh import batch_axes
from repro_torch.sharding import specs

NEG_INF = -1e30


@dataclass(frozen=True)
class MeshContext:
    """The mesh a model call runs on: ``mesh`` (a ``launch.mesh.Mesh``),
    ``layout`` ("serve" or "train"), the sharding ``rules`` of the call's
    config on it (``sharding.specs.rules``: logical axis -> mesh axis or
    None), whether the call's batch is cut over the batch axes
    (``batch_sharded``: each rank holds its block of the lanes or rows)
    and over which of them (``row_axes``: all that have more than one
    rank, or, for a train microbatch that does not divide them all, the
    inner ones, its rows whole over the rest), and, in the train layout,
    the spec of every parameter leaf (``pspecs``)."""
    mesh: object
    layout: str
    rules: dict
    batch_sharded: bool = False
    pspecs: dict | None = None
    row_axes: tuple = ()

    @property
    def tp(self) -> int:
        return self.mesh.axis_size("model")

    @property
    def train(self) -> bool:
        return self.layout == "train"

    def cut(self, logical: str) -> bool:
        """Whether ``logical`` is cut over 'model' into more than one
        block."""
        return self.rules[logical] == "model" and self.tp > 1

    # the collectives of a model call: differentiable in the train
    # layout, the plain ``Mesh`` ones in the serve layout
    def psum(self, x, axis):
        return collectives.psum(x, self.mesh, axis) if self.train \
            else self.mesh.psum(x, axis)

    def all_gather(self, x, axis, dim: int = 0):
        return collectives.all_gather(x, self.mesh, axis, dim) \
            if self.train else self.mesh.all_gather(x, axis, dim)

    def enter(self, x, axis="model"):
        """``x``, the same on every rank of ``axis``, entering a product
        that differs along it (identity; its backward sums over
        ``axis`` in the train layout)."""
        return collectives.enter(x, self.mesh, axis) if self.train else x

    def gather(self, w, spec: tuple):
        """The train layout's FSDP gather: ``w`` (this rank's block under
        ``spec``) whole along every dim that ``spec`` cuts over 'data'.
        Other layouts, and dims cut over 'model', are left as they
        are."""
        if not self.train:
            return w
        for dim, entry in enumerate(spec):
            if entry == "data":
                w = collectives.all_gather(w, self.mesh, "data", dim)
        return w

    def gather_layer(self, lp: dict, group: str = "layers") -> dict:
        """A block's weights gathered over 'data' (``gather``): its slices
        of the stacked leaves of ``group`` ("layers", "enc_layers",
        "dec_layers"), or the leaves of an unstacked group (hybrid's
        "shared_attn"), each by its own spec (a slice's spec drops the
        stacked dim)."""
        if not self.train:
            return lp
        sp = self.pspecs[group]
        return {k: self.gather(w, tuple(sp[k])[len(sp[k]) - w.dim():])
                for k, w in lp.items()}


_MESH = contextvars.ContextVar("repro_torch_mesh", default=None)


@contextlib.contextmanager
def mesh_context(mesh, cfg=None, layout: str = "serve", *,
                 batch_sharded: bool | tuple = False):
    """Run the model calls inside on ``mesh`` (None: one device) with
    ``cfg``'s sharding rules in ``layout`` ("serve" or "train", as
    ``sharding.specs.LAYOUTS``). ``batch_sharded``: whether the batch is
    cut over the batch axes, or the tuple of those it is cut over
    (``MeshContext.row_axes``)."""
    ctx = None
    if mesh is not None:
        if layout not in specs.LAYOUTS:
            raise ValueError(f"layout {layout!r} (one of {specs.LAYOUTS})")
        rows = tuple(batch_sharded) if isinstance(batch_sharded, tuple) \
            else tuple(a for a in batch_axes(mesh)
                       if mesh.axis_size(a) > 1) if batch_sharded else ()
        ctx = MeshContext(
            mesh, layout, specs.rules(cfg, mesh, layout),
            bool(batch_sharded),
            specs.param_pspecs(cfg, mesh, layout) if layout == "train"
            else None, rows)
    tok = _MESH.set(ctx)
    try:
        yield ctx
    finally:
        _MESH.reset(tok)


def mesh_ctx():
    """The active ``MeshContext``, or None on one device."""
    return _MESH.get()


def in_mesh_ctx(fn):
    """``fn`` bound to the active ``MeshContext``: run later (the
    recompute of a ``torch.utils.checkpoint`` in the backward, outside
    the ``mesh_context`` block and, on the card, on autograd's own
    thread), it runs on the same mesh and layout."""
    ctx = _MESH.get()

    def bound(*args, **kw):
        tok = _MESH.set(ctx)
        try:
            return fn(*args, **kw)
        finally:
            _MESH.reset(tok)
    return bound


def gather_layer(lp: dict, group: str = "layers") -> dict:
    """``lp`` (a block's weights from the leaf group ``group``) gathered
    over 'data' in the train layout (each leaf whole along its FSDP
    dim), else ``lp`` itself."""
    ctx = mesh_ctx()
    return lp if ctx is None else ctx.gather_layer(lp, group)


def tp_down_proj(h, w, logical: str):
    """A product whose contracted dim is cut over 'model' when the rows
    of ``w`` are (``logical``: "heads" or "mlp"): this rank's partial
    product, summed over 'model' with an ``all_reduce`` whose payload is
    in the model dtype (the JAX package's explicit path:
    ``psum(out.astype(h.dtype))``). On one device, or when the rows are
    whole, a plain product."""
    out = h @ w
    ctx = mesh_ctx()
    if ctx is not None and ctx.cut(logical):
        out = ctx.psum(out.to(h.dtype), "model")
    return out


def column_input(x, logical: str):
    """``x`` entering a column-parallel product whose columns are cut by
    ``logical`` ("heads", "mlp", "vocab"): ``MeshContext.enter`` over
    'model' when they are cut, else ``x``."""
    ctx = mesh_ctx()
    return ctx.enter(x) if ctx is not None and ctx.cut(logical) else x


def rms_norm(x, weight, eps: float = 1e-6):
    dt = x.dtype
    x = x.float()
    var = torch.mean(x * x, dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + eps) * weight.float()).to(dt)


def rope(x, positions, theta: float = 1e6):
    """Rotary embedding. x (..., S, H, hd), positions (..., S)."""
    hd = x.shape[-1]
    half = hd // 2
    freqs = torch.exp(-math.log(theta) * torch.arange(
        half, dtype=torch.float32, device=x.device) / half)
    ang = positions[..., None].float() * freqs                  # (..., S, half)
    cos = torch.cos(ang)[..., None, :]                          # (..., S, 1, half)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def swiglu(x, w_gate, w_up, w_down, reduce: str | None = None):
    """SwiGLU. On a mesh, gate and up are column-parallel (this rank's
    columns of the hidden: ``x`` enters them, ``column_input``) and
    ``reduce`` ("mlp") names the rows of ``w_down`` that
    ``tp_down_proj`` sums over 'model'; None: a plain product (the moe
    experts, each whole on its rank)."""
    if reduce is not None:
        x = column_input(x, reduce)
    h = F.silu(x @ w_gate) * (x @ w_up)
    return h @ w_down if reduce is None else tp_down_proj(h, w_down, reduce)


def decode_attention(q, k_cache, v_cache, pos, scales=None):
    """Single-step attention over a preallocated KV cache.

    q (B, 1, H, hd); caches (B, S, K, hd) (read in place by the kernel);
    pos (B,) int32 = index of the new token per lane, whose K/V the cache
    already holds. Each lane attends its first min(pos_b + 1, S) slots:
    the kernel skips the rest, which is exact (the reference's masked
    terms are exp(-1e30 - m) == 0), so a refilled lane computes exactly
    what a fresh cache would. The same rule serves the sliding-window
    ring (slot = pos % S): before it wraps, slots 0..pos hold the lane's
    positions; after, every slot holds one of the last S, which is the
    JAX ring's mask ``abs_pos >= 0``. The order of the slots does not
    matter to the softmax, and RoPE was applied at each key's absolute
    position when it was written. ``scales`` (k_scale, v_scale), each
    (B, S, K) fp16, marks an int8 cache: the int8 kernel dequantizes its
    rows as it reads them."""
    B, _, H, hd = q.shape
    S = k_cache.shape[1]
    lengths = (pos + 1).clamp(max=S).to(torch.int32)
    if scales is None:
        o = ops.decode_attention(q[:, 0], k_cache, v_cache, lengths)
    else:
        o = ops.decode_attention_int8(q[:, 0], k_cache, v_cache, *scales,
                                      lengths)
    return o.reshape(B, 1, H, hd)


def attention_masked(q, k, v, *, causal: bool = True, window=None):
    """Attention in plain, differentiable PyTorch, for training (the role
    of the JAX package's ``attention_masked``): the prefill kernel's plain
    version (``kernels/ref.py flash_attention``: fp32 scores, GQA by head
    grouping, the causal / window mask) on the model's layout, q
    (B, S, H, hd), k/v (B, S, K, hd) -> (B, S, H, hd), on either
    device."""
    o = ref.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                            v.transpose(1, 2), causal, window or None)
    return o.transpose(1, 2)


def prefill_attention(q, k, v, *, causal: bool = True, window=None):
    """Teacher-forced attention over a whole sequence, in the role the JAX
    model gives ``attention_masked``: q (B, S, H, hd), k/v (B, S, K, hd)
    -> (B, S, H, hd), GQA by head grouping, fp32 softmax. The kernel
    reads the projections through transposed views (no copy) and writes
    the model's layout, so the transposes here move no data on the
    card."""
    o = ops.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                            v.transpose(1, 2), causal, window or None)
    return o.transpose(1, 2)
