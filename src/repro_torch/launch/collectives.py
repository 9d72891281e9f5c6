"""The collectives of one rank's training program, under autograd.

``launch/mesh.py``'s ``Mesh`` collectives are plain functions: the serve
paths run them under ``no_grad`` and need no backward. A training step
differentiates through its collectives, and each one's backward is the
transpose JAX gives it inside ``shard_map``:

  * ``all_gather(x, mesh, axis, dim)``: the blocks of every rank along
    ``axis`` concatenated on ``dim`` (FSDP's gather of a weight whose D
    rows lie over 'data'). Backward: the cotangent summed over ``axis``,
    of which this rank keeps its own block (a reduce-scatter). For a
    weight gathered over the batch axis that sum is also the
    data-parallel sum of its gradient.
  * ``psum(x, mesh, axis)``: the sum over ``axis`` of an output that
    every rank then uses alike (a row-parallel product's partials, the
    moe experts' partial outputs, the loss's partial sums). Backward:
    the identity, since every rank holds the whole cotangent.
  * ``enter(x, mesh, axis)``: the identity on a tensor that is the same
    on every rank of ``axis`` and enters a computation that differs
    along it (a column-parallel product: Megatron's *f*). Backward: the
    cotangents' sum over ``axis``, each rank having contributed its
    part.
  * ``split(x, mesh, axis, dim)``: this rank's block along ``dim`` of a
    tensor that is the same on every rank of ``axis`` (the tied
    embedding's rows of this rank's vocabulary block). Backward: the
    blocks' cotangents gathered over ``axis``.

A missing or doubled reduction shows only as a gradient off by the
axis's size, so every one of these is held leaf by leaf against an
unsharded gradient in ``tests/test_torch_train_mesh.py``. Over an axis
of one rank each is the identity. ``Mesh.calls`` and ``Mesh.bytes``
count the collectives these run, forward and backward alike.
"""
from __future__ import annotations

import torch


def _own(x, mesh, axis, dim: int):
    """This rank's block along ``dim`` of ``x``, cut evenly over
    ``axis``."""
    n = x.shape[dim] // mesh.degree(axis)
    return x.narrow(dim, mesh.axis_index(axis) * n, n)


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        return mesh.all_gather(x, axis, dim)

    @staticmethod
    def backward(ctx, g):
        g = ctx.mesh.psum(g.contiguous().clone(), ctx.axis)
        return _own(g, ctx.mesh, ctx.axis, ctx.dim).contiguous(), None, \
            None, None


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        return mesh.psum(x.contiguous().clone(), axis)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _Enter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.psum(g.contiguous().clone(), ctx.axis), None, None


class _Split(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        return _own(x, mesh, axis, dim).contiguous()

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.all_gather(g, ctx.axis, ctx.dim), None, None, None


def _one(mesh, axis) -> bool:
    return mesh is None or mesh.degree(axis) == 1


def all_gather(x, mesh, axis, dim: int = 0):
    return x if _one(mesh, axis) else _AllGather.apply(x, mesh, axis, dim)


def psum(x, mesh, axis):
    return x if _one(mesh, axis) else _Psum.apply(x, mesh, axis)


def enter(x, mesh, axis):
    return x if _one(mesh, axis) else _Enter.apply(x, mesh, axis)


def split(x, mesh, axis, dim: int = 0):
    return x if _one(mesh, axis) else _Split.apply(x, mesh, axis, dim)
