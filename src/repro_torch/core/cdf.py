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

On a mesh (``launch/mesh.py``) a rank holds its block of the vocabulary's
logits where the 'model' axis cuts it: ``topk_quantized_sharded`` takes
the top-K across the ranks without gathering the logits (JAX's
``topk_quantized_sharded``, in one collective), and ``LogitShards``
carries a step's logits to the coder. The coder names what it reads:
the top-K CDF (``topk_cdf`` and the functions built on it: the serve
step's top-K), or the whole vocabulary (``full_logits``, and the
full-vocabulary CDF, which gathers it). Nothing converts them
implicitly: ``as_tensor`` and ``to_numpy`` refuse them.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import ops, ref

DEFAULT_PRECISION = 16


_NAME_IT = ("a mesh step's LogitShards: ask for the top-K CDF (topk_cdf) "
            "or for the whole vocabulary (full_logits)")


def as_tensor(x) -> torch.Tensor:
    """A torch view of ``x`` (numpy arrays become CPU tensors). A mesh
    step's ``LogitShards`` are refused (``full_logits`` gathers them)."""
    if isinstance(x, torch.Tensor):
        return x
    if isinstance(x, LogitShards):
        raise TypeError(_NAME_IT)
    return torch.from_numpy(np.ascontiguousarray(x))


def full_logits(x) -> torch.Tensor:
    """The whole (..., V) logits: a mesh step's ``LogitShards`` gathered
    over 'model' (a collective: every rank asks), anything else as
    ``as_tensor`` gives it. What the full-vocabulary CDF and the model's
    cross-entropy read."""
    return x.whole() if isinstance(x, LogitShards) else as_tensor(x)


def to_numpy(x) -> np.ndarray:
    """Host numpy copy of a tensor (any device) or array; bfloat16, which
    numpy has no type for, comes back as float32 (exactly). A mesh
    step's ``LogitShards`` are refused, as by ``as_tensor``."""
    if isinstance(x, LogitShards):
        raise TypeError(_NAME_IT)
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            x = x.float()
        return x.detach().cpu().numpy()
    return np.asarray(x)


class LogitShards:
    """A model step's logits on a mesh, as this rank holds them: ``local``
    (..., V_loc), this rank's block of the padded vocabulary when
    ``sharded`` (the 'model' axis cuts it: ids from rank * V_loc on), or
    all of it. The lanes are whole on every rank. ``vocab`` is the
    number of real ids (the predictor's ``vocab_size``). The reader
    names what it takes: ``topk_cdf`` (and the functions here that build
    a top-K CDF) take ``topk_quantized``, the serve step's top-K (the
    sharded one when the vocabulary is cut, with collectives over
    'model', so no rank gathers it); ``full_logits`` and the
    full-vocabulary CDF take ``whole()``, the gathered (..., vocab)
    logits. ``as_tensor``, ``to_numpy`` and an index that reaches the
    vocabulary axis raise. Every rank must make the same calls in the
    same order: they run collectives."""

    def __init__(self, local: torch.Tensor, mesh, *, sharded: bool,
                 vocab: int):
        self.local = local
        self.mesh = mesh
        self.sharded = bool(sharded)
        self.vocab = int(vocab)

    def whole(self) -> torch.Tensor:
        """The (..., vocab) logits, gathered over 'model' if cut."""
        x = self.local
        if self.sharded:
            x = self.mesh.all_gather(x, "model", dim=-1)
        return x[..., :self.vocab]

    def __getitem__(self, idx):
        """An index of the leading axes only (lanes, positions): the same
        layout. An index that may reach the vocabulary axis raises."""
        t = idx if isinstance(idx, tuple) else (idx,)
        if len(t) >= self.local.dim() or any(
                i is Ellipsis or i is None for i in t):
            raise TypeError(f"index {idx!r} of {_NAME_IT}")
        return self.with_local(self.local[idx])

    def with_local(self, local: torch.Tensor) -> "LogitShards":
        """Other logits of the same layout (e.g. a stack of steps)."""
        return LogitShards(local, self.mesh, sharded=self.sharded,
                           vocab=self.vocab)

    def topk_quantized(self, k: int, precision: int):
        """(ids (..., k) int32, qpmf (..., k+1) int32) of these logits: the
        sharded top-K when the vocabulary is cut, else the top-K kernel on
        the real ids (the padding columns, whose logits are -1e30, carry
        no mass either way)."""
        if self.sharded:
            return topk_quantized_sharded(self.local, k, precision,
                                          self.mesh)
        ids, cdf = topk_cdf(self.local[..., :self.vocab], k, precision)
        return ids, torch.diff(cdf, dim=-1)


def _rows(logits) -> tuple[torch.Tensor, tuple]:
    x = full_logits(logits)
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
    device, with cdf[..., 0] == 0 and cdf[..., -1] == 2**precision. A
    mesh step's ``LogitShards`` take the sharded top-K."""
    if isinstance(logits, LogitShards):
        ids, q = logits.topk_quantized(k, precision)
        zero = torch.zeros_like(q[..., :1])
        return ids, torch.cat([zero, torch.cumsum(q, dim=-1,
                                                  dtype=torch.int32)], -1)
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


def topk_quantized_sharded(logits, k: int, precision: int, mesh):
    """Top-K + escape quantization of VOCAB-SHARDED logits (..., V_loc),
    this rank's block of the padded vocabulary (ids from rank * V_loc
    on), as the JAX package's ``topk_quantized_sharded`` computes it
    without gathering the logits: each rank's max m_r, its sum of exp
    from that max s_r, and its top-K candidates (values and global ids)
    are gathered over 'model' (tp * (K + 1) values, not V), the max is
    M = max_r m_r, the softmax denominator sum_r s_r exp(m_r - M), and
    the top-K of the candidates is quantized as ``quantize_pmf`` does.
    JAX gathers with a ``pmax``, a ``psum`` and two ``all_gather``s; here
    one ``all_gather`` carries them all (the ids as float32, exact below
    2**24) and every rank reduces in rank order, the same bits on each:
    one collective a step where a collective (a host round trip over
    gloo) costs more than the reduction. Each row is reduced as a row of
    a (rows, V_loc) matrix, whatever the leading axes (the grouped encoder
    passes (B, C, V_loc), the decoder (B, V_loc): a sum's order must not
    depend on them). Ties go to the lower global id
    at both stages (stable descending sorts; the candidates come in rank
    order, each rank's in id order among equals), so the ids are the
    unsharded ``topk_quantized``'s. The padding ids (on the last rank)
    carry logits of -1e30: exp gives 0 and they are never among the top
    K. Returns (ids (..., K) int32, qpmf (..., K+1) int32), the same on
    every rank of 'model'."""
    lead = tuple(logits.shape[:-1])
    lg = logits.reshape(-1, logits.shape[-1]).float()      # (rows, V_loc)
    v_loc = lg.shape[-1]
    if v_loc * mesh.axis_size("model") >= 1 << 24:
        raise ValueError(f"a vocabulary of {v_loc} x "
                         f"{mesh.axis_size('model')} ids: float32 gathers "
                         f"them exactly below 2**24")
    m = lg.amax(dim=-1, keepdim=True)
    s = torch.exp(lg - m).sum(dim=-1, keepdim=True)
    vals, idx = torch.sort(lg, dim=-1, descending=True, stable=True)
    vals, idx = vals[..., :k], idx[..., :k]
    idx = idx + mesh.axis_index("model") * v_loc
    mine = torch.cat([m, s, vals, idx.float()], dim=-1)
    parts = mesh.all_gather(mine[None], "model", dim=0)  # (tp, rows, ...)
    m_r, s_r = parts[..., 0], parts[..., 1]
    gmax = m_r.amax(dim=0)
    denom = s_r[0] * torch.exp(m_r[0] - gmax)
    for r in range(1, parts.shape[0]):                      # rank order
        denom = denom + s_r[r] * torch.exp(m_r[r] - gmax)
    denom = denom[:, None]
    cand_v = torch.cat(list(parts[..., 2:2 + k]), dim=-1)
    cand_i = torch.cat(list(parts[..., 2 + k:]), dim=-1)
    vals2, pos = torch.sort(cand_v, dim=-1, descending=True, stable=True)
    vals2, pos = vals2[..., :k], pos[..., :k]
    ids = torch.gather(cand_i, -1, pos)
    top_p = torch.exp(vals2 - gmax[..., None]) / denom
    esc = (1.0 - top_p.sum(dim=-1, keepdim=True)).clamp(0.0, 1.0)
    pmf = torch.cat([top_p, esc], dim=-1)
    pmf = pmf / pmf.sum(dim=-1, keepdim=True)
    return (ids.to(torch.int32).reshape(*lead, k),
            quantize_pmf(pmf, precision).reshape(*lead, k + 1))


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
