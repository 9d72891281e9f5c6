"""Core neural layers of the dense decoder (PyTorch port of the JAX
package's ``models/layers.py``).

Float32 inside normalisation, rotary embedding and attention, activations
in the config dtype — cast where the JAX layers cast, so a bf16 config
computes as the reference does. Decode attention and prefill attention
run in the port's CUDA kernels (``kernels/ops.py``) on the card and in
their plain versions on the CPU; the kernels have no backward, so the
training forward takes ``attention_masked``, plain PyTorch on either
device, as the JAX training path takes its XLA ``attention_masked``.
The JAX module's sharding hints, explicit-TP down projection, residual
barrier and environment switches belong to the multi-GPU slice and are
not ported yet.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops, ref

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
