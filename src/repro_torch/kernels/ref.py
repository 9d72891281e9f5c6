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


def decode_attention_partial(q, k_cache, v_cache, lengths):
    """``decode_attention``'s partial form, for a combine across slices
    of the cache: (o (B, H, hd) float32, normalized over the lane's
    first ``lengths[b]`` positions, lse (B, H) float32, the log of the
    scores' sum of exp: max + log(sum exp(s - max))). A lane of length 0
    gives o = 0 and lse = -inf, which weighs it 0 in the combine (where
    ``decode_attention`` would softmax its all-masked row to a uniform
    one)."""
    B, H, hd = q.shape
    S, K = k_cache.shape[1], k_cache.shape[2]
    G = H // K
    qg = q.reshape(B, K, G, hd).float()
    s = torch.einsum("bkgh,bskh->bkgs", qg, k_cache.float()) \
        * (1.0 / math.sqrt(hd))
    valid = torch.arange(S, device=q.device)[None, :] \
        < lengths.to(q.device).long()[:, None]
    s = s.masked_fill(~valid[:, None, None, :], float("-inf"))
    m = s.amax(dim=-1, keepdim=True) if S else torch.full(
        s.shape[:-1] + (1,), float("-inf"), device=q.device)
    m = torch.where(torch.isinf(m), torch.zeros_like(m), m)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bkgs,bskh->bkgh", p, v_cache.float()) \
        / torch.clamp(l, min=1e-30)
    lse = (m + torch.log(l))[..., 0]
    return o.reshape(B, H, hd), lse.reshape(B, H)


def dequant_kv(q, scale, dtype):
    """An int8 cache row back in the model dtype, as the JAX package's
    ``_dequant_kv(q, scale).astype(dtype)``: q (..., hd) int8 and scale
    (...) fp16 -> float32(q) * float32(scale), rounded once to
    ``dtype``."""
    return (q.float() * scale.float()[..., None]).to(dtype)


def decode_attention_int8(q, k_cache, v_cache, k_scale, v_scale, lengths):
    """``decode_attention`` over an int8 cache: k/v (B, S, K, hd) int8 with
    their (B, S, K) fp16 scales, dequantized to q's dtype (``dequant_kv``),
    then attended exactly as a cache of that dtype."""
    return decode_attention(q, dequant_kv(k_cache, k_scale, q.dtype),
                            dequant_kv(v_cache, v_scale, q.dtype), lengths)


def decode_attention_partial_int8(q, k_cache, v_cache, k_scale, v_scale,
                                  lengths):
    """``decode_attention_partial`` over an int8 cache, dequantized to q's
    dtype as ``decode_attention_int8`` does."""
    return decode_attention_partial(
        q, dequant_kv(k_cache, k_scale, q.dtype),
        dequant_kv(v_cache, v_scale, q.dtype), lengths)


def attention_mask(Sq: int, Sk: int, causal: bool, window, device):
    """(Sq, Sk) bool: key k is visible to query q. Positions count from 0
    on both sides, as the Pallas kernel counts them: ``k <= q`` when
    causal, ``k > q - window`` under a sliding window."""
    q_pos = torch.arange(Sq, device=device)[:, None]
    k_pos = torch.arange(Sk, device=device)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=device)
    if causal:
        mask &= k_pos <= q_pos
    if window:
        mask &= k_pos > q_pos - window
    return mask


def flash_attention(q, k, v, causal: bool = True, window=None):
    """q (B, H, Sq, hd), k/v (B, K, Sk, hd) -> (B, H, Sq, hd) in q's
    dtype: softmax(q k^T / sqrt(hd)) v per head, head h reading kv-head
    h // (H / K), fp32 scores and accumulation. Masked scores take the
    reference's value NEG_INF (-1e30, not -inf), and the sum is divided
    by max(l, 1e-30). Masked terms weigh exactly 0, so a query row with
    no visible key gives 0 (such rows never arise in the model, which
    scores Sq == Sk with key q always visible). Any Sq, Sk."""
    B, H, Sq, hd = q.shape
    K, Sk = k.shape[1], k.shape[2]
    G = H // K
    qg = q.reshape(B, K, G, Sq, hd).float()
    s = torch.einsum("bkgqd,bksd->bkgqs", qg, k.float()) \
        * (1.0 / math.sqrt(hd))
    mask = attention_mask(Sq, Sk, causal, window, q.device)
    # a scalar fill: a tensor made from a host value would be a copy to
    # the card that waits for its stream, in every layer of a train step
    s = s.masked_fill(~mask, NEG_INF)
    m = s.max(dim=-1, keepdim=True).values
    p = torch.exp(s - m) * mask
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bkgqs,bksd->bkgqd", p, v.float())
    o = o / torch.clamp(l, min=1e-30)
    return o.reshape(B, H, Sq, hd).to(q.dtype)


SCAN_BLOCK = 16


def blocked_cumsum(x):
    """Inclusive float32 prefix sum over the last axis in the order XLA's
    CPU backend takes for ``jnp.cumsum``: the axis cut into blocks of 16,
    a sequential float32 sum inside each block, the block totals scanned
    the same way (recursively), and each block's exclusive prefix added
    to its elements. ``torch.cumsum`` on the CPU accumulates in float64
    instead, which moves a few rounded CDF points by one quantum."""
    x = x.float()
    n = x.shape[-1]
    if n <= SCAN_BLOCK:
        cols, acc = [], None
        for j in range(n):
            acc = x[..., j] if acc is None else acc + x[..., j]
            cols.append(acc)
        return torch.stack(cols, dim=-1)
    m = -(-n // SCAN_BLOCK)
    xp = torch.nn.functional.pad(x, (0, m * SCAN_BLOCK - n))
    local = blocked_cumsum(xp.reshape(*x.shape[:-1], m, SCAN_BLOCK)
                           .reshape(-1, SCAN_BLOCK))
    local = local.reshape(*x.shape[:-1], m, SCAN_BLOCK)
    tot = blocked_cumsum(local[..., -1])
    excl = torch.nn.functional.pad(tot[..., :-1], (1, 0))
    return (local + excl[..., None]).reshape(*x.shape[:-1], -1)[..., :n]


def cumulative_round(pmf, precision: int):
    """pmf (..., A) -> int32 CDF interior points (..., A) by cumulative
    rounding: floor(cum / cum[-1] * (2**precision - A) + 0.5) + i + 1.
    Strictly increasing, and the last point is exactly 2**precision. The
    prefix sum runs in XLA's CPU order (``blocked_cumsum``), whose block
    offsets can round a prefix below the one before it on a peaky row;
    so each prefix is floored by the largest before it (a running max,
    as ``csrc/cdf_points.cu`` floors its pieces) before it is normalised
    by the last, which keeps every symbol at one quantum or more. Where
    the prefix is already monotone the max changes nothing; where it is
    not, these integers differ from JAX's, whose points there repeat."""
    A = pmf.shape[-1]
    budget = float((1 << precision) - A)
    cum = torch.cummax(blocked_cumsum(pmf), dim=-1).values
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


def ssd_intra(x, dt, A, Bm, Cm):
    """Mamba2 SSD, one chunk with a zero entering state, in fp32: x (R, Q,
    H, P), dt (R, Q, H), A (H,), Bm/Cm (R, Q, N) -> (y (R, Q, H, P),
    chunk-end state (R, H, P, N)), both float32.

    cum = inclusive cumsum over Q of dt * A; y_i = sum_{j <= i} (C_i .
    B_j) exp(cum_i - cum_j) dt_j x_j; state = sum_j exp(cum_{Q-1} -
    cum_j) dt_j x_j (x) B_j. Acausal entries of cum_i - cum_j are set to
    -inf before ``exp`` (they are large and positive), so they weigh
    exactly 0."""
    x, dt, Bm, Cm = x.float(), dt.float(), Bm.float(), Cm.float()
    Q = x.shape[1]
    cum = torch.cumsum(dt * A.float(), dim=1)                 # (R, Q, H)
    seg = cum[:, :, None, :] - cum[:, None, :, :]             # (R, Qi, Qj, H)
    causal = torch.ones((Q, Q), dtype=torch.bool,
                        device=x.device).tril()[None, :, :, None]
    L = torch.exp(torch.where(causal, seg, torch.tensor(
        float("-inf"), device=x.device)))
    G = torch.einsum("rin,rjn->rij", Cm, Bm)
    W = G[..., None] * L * dt[:, None, :, :]                  # (R, Qi, Qj, H)
    y = torch.einsum("rijh,rjhp->rihp", W, x)
    end = torch.exp(cum[:, -1:, :] - cum) * dt                # (R, Q, H)
    state = torch.einsum("rjhp,rjn->rhpn", x * end[..., None], Bm)
    return y, state
