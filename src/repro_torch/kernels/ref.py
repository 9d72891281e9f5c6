"""Plain PyTorch versions of the port's CUDA kernels.

Each function computes what its kernel computes, written as ordinary
tensor code. The wrappers in ``kernels/ops.py`` call these for tensors on
the CPU (the CPU tests), and ``chip_smoke.py`` holds each kernel against
its plain version on the card. They are deliberately straightforward:
the float order differs from the kernels' (and from XLA's), which is why
kernel and plain version agree to within one quantum with the same ids,
not bit for bit.
"""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def decode_attention(q, k_cache, v_cache, lengths):
    """q (B, H, hd); caches (B, S, K, hd) (the model's layout); lengths
    (B,) valid prefix lengths -> (B, H, hd) in q's dtype. fp32 softmax and
    accumulation, GQA by head grouping (head h reads kv-head h // G)."""
    B, H, hd = q.shape
    S, K = k_cache.shape[1], k_cache.shape[2]
    G = H // K
    qg = q.reshape(B, K, G, hd).float()
    s = torch.einsum("bkgh,bskh->bkgs", qg, k_cache.float()) \
        * (1.0 / math.sqrt(hd))
    valid = torch.arange(S, device=q.device)[None, :] \
        < lengths.to(q.device).long()[:, None]
    s = torch.where(valid[:, None, None, :], s,
                    torch.tensor(NEG_INF, device=q.device))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgs,bskh->bkgh", p, v_cache.float())
    return o.reshape(B, H, hd).to(q.dtype)


def cumulative_round(pmf, precision: int):
    """pmf (..., A) -> int32 CDF interior points (..., A) by cumulative
    rounding: floor(cum / cum[-1] * (2**precision - A) + 0.5) + i + 1.
    Strictly increasing, and the last point is exactly 2**precision."""
    A = pmf.shape[-1]
    budget = float((1 << precision) - A)
    cum = torch.cumsum(pmf.float(), dim=-1)
    cum = cum / cum[..., -1:]
    pts = torch.floor(cum * budget + 0.5).to(torch.int32)
    return pts + torch.arange(1, A + 1, dtype=torch.int32, device=pmf.device)


def topk_cdf(logits, k: int, precision: int):
    """logits (R, V) -> (ids (R, k) int32, cdf (R, k+2) int32): the k
    largest logits in lax.top_k's order (value descending, smallest id
    first among ties -- a stable sort gives exactly that), their softmax
    mass over the full vocabulary plus one ESCAPE slot for the rest, and
    the cumulative-rounding CDF of that (k+1)-symbol pmf with a leading
    0."""
    x = logits.float()
    vals, ids = torch.sort(x, dim=-1, descending=True, stable=True)
    vals, ids = vals[:, :k], ids[:, :k]
    m = x.max(dim=-1, keepdim=True).values
    denom = torch.exp(x - m).sum(dim=-1, keepdim=True)
    top_p = torch.exp(vals - m) / denom
    esc = (1.0 - top_p.sum(dim=-1, keepdim=True)).clamp(0.0, 1.0)
    pmf = torch.cat([top_p, esc], dim=-1)
    pmf = pmf / pmf.sum(dim=-1, keepdim=True)
    pts = cumulative_round(pmf, precision)
    zero = torch.zeros_like(pts[:, :1])
    return ids.to(torch.int32), torch.cat([zero, pts], dim=-1)


def cdf_points(logits, precision: int):
    """logits (R, V) -> int32 full-vocabulary CDF interior points (R, V)
    (cdf[1:]; the coder prepends 0): softmax, then cumulative rounding."""
    x = logits.float()
    e = torch.exp(x - x.max(dim=-1, keepdim=True).values)
    return cumulative_round(e / e.sum(dim=-1, keepdim=True), precision)
