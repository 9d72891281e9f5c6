"""Int8 gradient compression with error feedback (the JAX package's
``train/grad_compress.py``).

Each leaf is quantized to symmetric per-tensor int8 and back; what the
quantization lost is carried into the next step's gradient, which keeps
the accumulated error bounded. On one card there is no reduce for it to
shrink: the transform is applied where the gradient reduce would sit, so
convergence under it is what can be measured. ``torch.round`` rounds half
to even, as ``jnp.round`` does.
"""
from __future__ import annotations

import torch


def quantize_int8(x: torch.Tensor):
    """Symmetric per-tensor int8: (q, scale)."""
    scale = (x.abs().max() + 1e-12) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def compress_decompress(grads: dict, err_state: dict):
    """The int8 round trip with error feedback, per leaf: (effective
    gradients, new error state), both fp32."""
    if isinstance(grads, dict):
        pairs = {k: compress_decompress(g, err_state[k])
                 for k, g in grads.items()}
        return ({k: p[0] for k, p in pairs.items()},
                {k: p[1] for k, p in pairs.items()})
    g32 = grads.float() + err_state
    deq = dequantize_int8(*quantize_int8(g32))
    return deq, g32 - deq
