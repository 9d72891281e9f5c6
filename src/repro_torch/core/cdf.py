"""Model distribution -> quantized integer CDFs (PyTorch port).

The bridge between the LLM (which emits logits) and the entropy coder
(which consumes integer CDFs), as in the JAX package's ``core/cdf.py``:

* ``full_cdf`` / ``logits_to_cdf`` — full-vocabulary CDF by cumulative
  rounding: every symbol keeps >= 1 quantum and the last point is
  exactly 2**precision;
* ``topk_cdf`` — top-K + ESCAPE: only the K most likely tokens get
  individual slots, the rest of the mass goes to one ESCAPE symbol
  (an escaped token is then coded uniformly over the vocabulary).

Logits may be a torch tensor on any device or a numpy array (host
predictors such as table models); leading axes are flattened into rows,
and every row is computed independently of the others, so a row's
integers do not depend on how many rows one call holds (the grouped
encoder passes (B*C, V) rows, the decoder (B, V)). On a CUDA tensor the
work runs in the port's kernels (``kernels/ops.py``: ``topk_cdf`` and
``cdf_points``); on the CPU in their plain versions. Results stay on the
logits' device; only the small (ids, cdf) tables need cross to the host.

Ties in the top-K go to the smallest vocabulary id, in ``lax.top_k``'s
order (value descending), which ``torch.topk`` does not promise.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import ops, ref

DEFAULT_PRECISION = 16


def as_tensor(x) -> torch.Tensor:
    """A torch view of ``x`` (numpy arrays become CPU tensors)."""
    if isinstance(x, torch.Tensor):
        return x
    return torch.from_numpy(np.ascontiguousarray(x))


def to_numpy(x) -> np.ndarray:
    """Host numpy copy of a tensor (any device) or array; bfloat16, which
    numpy has no type for, comes back as float32 (exactly)."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            x = x.float()
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _rows(logits) -> tuple[torch.Tensor, tuple]:
    x = as_tensor(logits)
    lead = tuple(x.shape[:-1])
    return x.reshape(-1, x.shape[-1]), lead


def quantize_cdf_points(probs, precision: int = DEFAULT_PRECISION):
    """Quantize a pmf (last axis, size V) into int32 CDF interior points
    by **cumulative rounding**:

        cdf_i = round(P(x <= i) * (T - V)) + (i + 1),   i = 0..V-1

    Strictly increasing, cdf_{V-1} == T exactly. Returns (..., V) =
    cdf[1:] (prepend 0 for the coder)."""
    p = as_tensor(probs)
    V = p.shape[-1]
    if (1 << precision) <= V:
        raise ValueError(f"precision {precision} too small for vocab {V}")
    return ref.cumulative_round(p, precision)


def quantize_pmf(probs, precision: int = DEFAULT_PRECISION):
    """Integer pmf (sums to 2**precision, every entry >= 1) via
    cumulative rounding — see quantize_cdf_points."""
    pts = quantize_cdf_points(probs, precision)
    return torch.diff(pts, dim=-1, prepend=torch.zeros_like(pts[..., :1]))


def pmf_to_cdf(q: np.ndarray) -> np.ndarray:
    """Integer pmf -> CDF array (numpy, host side)."""
    q = np.asarray(q, dtype=np.int64)
    cdf = np.zeros(q.shape[:-1] + (q.shape[-1] + 1,), dtype=np.int64)
    np.cumsum(q, axis=-1, out=cdf[..., 1:])
    return cdf


def full_cdf(logits, precision: int = DEFAULT_PRECISION) -> torch.Tensor:
    """Full-vocabulary quantized CDF rows (..., V+1) int32, leading 0
    included, on the logits' device."""
    x, lead = _rows(logits)
    if (1 << precision) <= x.shape[-1]:
        raise ValueError(f"precision {precision} too small for vocab "
                         f"{x.shape[-1]}")
    pts = ops.cdf_points(x, precision)
    zero = torch.zeros_like(pts[:, :1])
    return torch.cat([zero, pts], dim=-1).reshape(*lead, -1)


def logits_to_cdf(logits, precision: int = DEFAULT_PRECISION) -> np.ndarray:
    """Full-vocab quantized CDF(s) from logits. Returns numpy int64
    (..., V+1)."""
    return to_numpy(full_cdf(logits, precision)).astype(np.int64)


def full_cdf_lookup(logits, slots, precision: int = DEFAULT_PRECISION):
    """Full-vocabulary CDF build + symbol-interval lookup on the logits'
    device: for the rANS decoder's peeked slot bits ``slots`` (...,),
    returns (syms, starts, freqs) with pts[sym-1] <= slot < pts[sym] —
    the decoded symbols ARE the token ids here."""
    x, lead = _rows(logits)
    pts = ops.cdf_points(x, precision)                      # (R, V)
    s = as_tensor(slots).to(device=pts.device, dtype=torch.int32)
    s = s.reshape(-1, 1).contiguous()
    # as in topk_cdf_lookup: a slot >= 2**precision would index pts[V]
    syms = torch.searchsorted(pts, s, right=True)[:, 0].clamp_(
        max=pts.shape[1] - 1)
    ends = torch.gather(pts, 1, syms[:, None])[:, 0]
    starts = torch.gather(pts, 1, (syms - 1).clamp(min=0)[:, None])[:, 0]
    starts = torch.where(syms > 0, starts, torch.zeros_like(starts))
    return (syms.reshape(lead), starts.reshape(lead),
            (ends - starts).reshape(lead))


def topk_cdf(logits, k: int, precision: int = DEFAULT_PRECISION):
    """Fused top-K selection + escape + quantization + integer CDF build:
    returns (ids (..., k) int32, cdf (..., k+2) int32) on the logits'
    device, with cdf[..., 0] == 0 and cdf[..., -1] == 2**precision."""
    x, lead = _rows(logits)
    ids, cdf = ops.topk_cdf(x, k, precision)
    return ids.reshape(*lead, k), cdf.reshape(*lead, k + 2)


def topk_quantized(logits, k: int, precision: int = DEFAULT_PRECISION,
                   temperature: float = 1.0):
    """Top-K + escape quantization: (ids (..., k) int32, qpmf (..., k+1)
    int32 integer pmf over [k slots, ESCAPE] summing to 2**precision).
    The escape slot always has >= 1 quantum."""
    x = as_tensor(logits)
    if temperature != 1.0:
        x = x.float() / temperature
    ids, cdf = topk_cdf(x, k, precision)
    return ids, torch.diff(cdf, dim=-1)


def topk_cdf_lookup(logits, slots, k: int,
                    precision: int = DEFAULT_PRECISION):
    """Fused decode step: top-K + CDF build + **symbol-interval lookup**
    for the rANS decoder's peeked slot bits ``slots`` (...,). Returns
    (ids, cdf, syms, starts, freqs): syms[i] is the unique s with
    cdf[s] <= slot < cdf[s+1] (s == k means ESCAPE), and (starts, freqs)
    are that symbol's interval."""
    ids, cdf = topk_cdf(logits, k, precision)
    s = as_tensor(slots).to(device=cdf.device, dtype=torch.int32)
    # a slot at or above cdf[-1] == 2**precision would count k + 1 and
    # gather cdf[k + 2], past the row (a device-side assert on the card);
    # the decoder's peeked slots are below 2**precision, so the clamp
    # never binds for them, and it costs no host sync
    syms = (cdf[..., 1:] <= s[..., None]).sum(dim=-1).clamp_(max=k)
    starts = torch.gather(cdf, -1, syms[..., None])[..., 0]
    ends = torch.gather(cdf, -1, syms[..., None] + 1)[..., 0]
    return ids, cdf, syms, starts, ends - starts


def build_topk_cdfs(ids, qpmf):
    """Host-side: (ids, qpmf) -> per-position (ids, cdf) numpy pairs."""
    return to_numpy(ids), pmf_to_cdf(to_numpy(qpmf))


def coding_cost_bits(logits, tokens) -> float:
    """Ideal (un-quantized) coding cost of ``tokens`` under ``logits`` in
    bits (the paper's Eq. (4) summed over the sequence)."""
    lg = as_tensor(logits).float()
    logp = torch.log_softmax(lg, dim=-1)
    tok = as_tensor(tokens).to(device=lg.device, dtype=torch.long)
    nll = -torch.gather(logp, -1, tok[..., None])[..., 0]
    return float(nll.sum() / np.log(2.0))
