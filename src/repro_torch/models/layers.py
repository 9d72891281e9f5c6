"""Core neural layers of the dense decoder (PyTorch port of the JAX
package's ``models/layers.py``).

Float32 inside normalisation, rotary embedding and attention, activations
in the config dtype — cast where the JAX layers cast, so a bf16 config
computes as the reference does. Decode attention runs in the port's
CUDA kernel (``kernels/ops.py``) on the card and in its plain version on
the CPU. The JAX module's sharding hints, explicit-TP down projection,
residual barrier and environment switches belong to the multi-GPU slice
and are not ported yet.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops

NEG_INF = -1e30


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


def swiglu(x, w_gate, w_up, w_down):
    h = F.silu(x @ w_gate) * (x @ w_up)
    return h @ w_down


def decode_attention(q, k_cache, v_cache, pos):
    """Single-step attention over a preallocated KV cache.

    q (B, 1, H, hd); caches (B, S, K, hd) (read in place by the kernel);
    pos (B,) int32 = index of the new token per lane, whose K/V the cache
    already holds. Each lane attends its own positions [0, pos_b]: the
    kernel skips the rest, which is exact (the reference's masked terms
    are exp(-1e30 - m) == 0), so a refilled lane computes exactly what a
    fresh cache would."""
    B, _, H, hd = q.shape
    S = k_cache.shape[1]
    lengths = (pos + 1).clamp(max=S).to(torch.int32)
    o = ops.decode_attention(q[:, 0], k_cache, v_cache, lengths)
    return o.reshape(B, 1, H, hd)
