"""Int8 gradient compression with error feedback (the JAX package's
``train/grad_compress.py``).

Each leaf is quantized to symmetric per-tensor int8 and back; what the
quantization lost is carried into the next step's gradient, which keeps
the accumulated error bounded. The transform is applied to the reduced
gradient, where the JAX package applies it, so convergence under it is
what can be measured. ``torch.round`` rounds half to even, as
``jnp.round`` does. On a mesh each leaf is this rank's block and its
scale comes from the whole leaf's amax (a ``pmax`` over the axes it is
cut on): every element gets the int8 code the unsharded transform gives
it, and the error state is cut like the leaf.
"""
from __future__ import annotations

import torch

from .optimizer import cut_axes, reduce_by_axes, tree_leaves, tree_unflatten


def quantize_int8(x: torch.Tensor, amax=None):
    """Symmetric per-tensor int8: (q, scale); ``amax`` (default: x's own
    max |x|) sets the scale."""
    amax = x.abs().max() if amax is None else amax
    scale = (amax + 1e-12) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def compress_decompress(grads: dict, err_state: dict, mesh=None,
                        pspecs=None):
    """The int8 round trip with error feedback, per leaf: (effective
    gradients, new error state), both fp32. On a ``mesh``, blocks under
    ``pspecs``, each quantized with its leaf's global amax."""
    g32 = [g.float() + e for g, e in zip(tree_leaves(grads),
                                         tree_leaves(err_state))]
    amax = [g.abs().max() for g in g32]
    if mesh is not None:
        axes = [cut_axes(mesh, s) for s in tree_leaves(pspecs)]
        amax = reduce_by_axes(amax, axes, mesh, "pmax")
    deq = [dequantize_int8(*quantize_int8(g, a)) for g, a in zip(g32, amax)]
    return (tree_unflatten(grads, deq),
            tree_unflatten(grads, [g - d for g, d in zip(g32, deq)]))
