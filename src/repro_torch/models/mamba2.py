"""Mamba2 -- SSD (state-space duality, arXiv:2405.21060) blocks: the
PyTorch counterpart of the JAX package's ``models/mamba2.py``.

Chunked SSD for teacher-forced scoring, whose intra-chunk part runs in
the port's ``ssd_intra`` kernel (``kernels/ops.py``; its plain version on
the CPU), or, for training, in plain differentiable PyTorch (the kernel
has no backward; ``forward(ssd_impl="plain")``, each layer under
``torch.utils.checkpoint`` when ``cfg.remat`` is set), and the O(1)
recurrent decode step.

Per layer:  x -> [z | xc | B | C | dt] projections; causal conv1d over
(xc, B, C); SSD recurrence with per-head scalar decay A; gated output.
State per head: (P, N) with P = headdim, N = ssm_state.

Rounding follows the reference: dt * A and its cumsum are fp32 (A is);
the state entering a chunk is cast to x's dtype before it meets C; the
recurrent state stays fp32 and is cast to x's dtype in the output
product; a sequence is padded to a chunk multiple with dt = 0.

On a mesh (``layers.mesh_context``, the serve layout) where 'model' cuts
``ssm_inner`` (the heads and d_inner divide it: ``sharding.specs``
rules), a rank runs its block of heads: its columns of ``in_z``,
``in_x`` and ``in_dt``, its heads of ``A_log``, ``D_skip`` and
``dt_bias``, ``in_B`` and ``in_C`` whole, its conv channels in the
port's layout [its xc block | B | C] (``sharding.specs.cut_conv``), the
scan (``ssd_intra``) over its H / tp heads, and its rows of
``out_proj``, whose products are summed over 'model' (one ``psum`` a
layer: ``layers.tp_down_proj``). The head count and d_inner of a call
are its weights' (``_local_dims``). Where ``ssm_inner`` is not cut the
mixer runs whole on every rank, with no collective. JAX's
``shard(xc, ("pod", "data"), None, None)`` in ``ssm_block`` replicates
xc's channels while scoring: where the data sits, not what is computed;
the port keeps the heads cut.

In the train layout (``models.api.loss_fn(mesh=...)``) a layer first
gathers its weights' D rows over 'data' (``layers.gather_layer``), the
normed input ``enter``s the column-parallel ``in_z``/``in_x``/``in_dt``,
and B and C, whole on every rank but read by this rank's heads only,
``enter`` the scan after the conv: their cotangent is summed over
'model', so ``in_B``, ``in_C`` and conv_w's B and C channels come out
whole on every rank, and ``out_proj``'s psum is the identity backward.

One deliberate difference: JAX is functional and returns a new cache;
here ``decode_step`` writes the conv and SSM states and ``pos`` into the
cache tensors in place, as the dense family does with its K/V, so a
captured CUDA graph of the step reads and writes fixed addresses.
"""
from __future__ import annotations

from functools import partial

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from .layers import column_input, gather_layer, rms_norm, tp_down_proj
from .transformer import (check_impl, embed_tokens, layer_weights,
                          lm_logits, remat, torch_dtype)

#: the chunked scan's intra-chunk part: "kernel" runs it in
#: ``ops.ssd_intra`` (scoring, under ``no_grad``), "plain" in
#: differentiable PyTorch (training)
SSD_IMPLS = ("kernel", "plain")


def _conv1d_causal(x, w, state=None):
    """Causal depthwise conv. x (B, S, C), w (K, C). If ``state`` (B, K-1,
    C) is given it prefixes x (decode). Returns (silu(y), new_state)."""
    K = w.shape[0]
    if state is None:
        pad = torch.zeros((x.shape[0], K - 1, x.shape[2]), dtype=x.dtype,
                          device=x.device)
    else:
        pad = state
    xp = torch.cat([pad, x], dim=1)
    y = sum(xp[:, i:i + x.shape[1]] * w[i] for i in range(K))
    return F.silu(y), xp[:, -(K - 1):]


def _ssd_intra_plain(x, dt, A, Bm, Cm):
    """The intra-chunk part of the scan in plain, differentiable PyTorch,
    as the JAX package's ``ssd_chunked`` computes it (its training
    formulation): x (R, Q, H, P), dt (R, Q, H), A (H,) fp32, Bm/Cm (R,
    Q, N) -> (y (R, Q, H, P), chunk-end state (R, H, P, N)), both fp32,
    with a zero entering state. cum = the inclusive cumsum of dt * A
    (fp32); y_i = sum_{j <= i} (C_i . B_j) exp(cum_i - cum_j) dt_j x_j,
    C . B in x's dtype. The (R, Q, Q, H) fp32 decays and weights are the
    memory: a full-width layer holds a few hundred MB of them, so
    training remats per layer."""
    Q = x.shape[1]
    x = x.float()
    cum = torch.cumsum(dt * A, dim=1)                         # fp32
    seg = cum[:, :, None, :] - cum[:, None, :, :]             # (R, i, j, H)
    causal = torch.ones((Q, Q), dtype=torch.bool,
                        device=x.device).tril()[:, :, None]
    # mask BEFORE exp: an acausal difference is large and positive, and
    # its exp (inf) times a mask's 0 is NaN in the backward
    L = torch.exp(seg.masked_fill(~causal, float("-inf")))
    G = torch.einsum("rin,rjn->rij", Cm, Bm)                  # x's dtype
    W = G.float()[..., None] * L * dt.float()[:, None]
    y = torch.einsum("rijh,rjhp->rihp", W, x)
    end = torch.exp(cum[:, -1:] - cum) * dt                   # (R, Q, H)
    state = torch.einsum("rjhp,rjn->rhpn", x * end[..., None], Bm.float())
    return y, state


def ssd_chunked(x, dt, A, Bm, Cm, *, chunk: int, initial_state=None,
                impl: str = "kernel"):
    """Chunked SSD scan.

    x (B, S, H, P), dt (B, S, H), A (H,) negative fp32, Bm/Cm (B, S, N)
    (one group). Returns y (B, S, H, P) and the final state (B, H, P, N),
    both in x's dtype. The intra-chunk part (B x chunks folded into R) is
    one ``ops.ssd_intra`` launch ("kernel") or ``_ssd_intra_plain``
    ("plain", which autograd can differentiate); the recurrence across
    chunks is a loop in fp32."""
    check_impl("impl", impl, SSD_IMPLS)
    Bsz, S0, H, P = x.shape
    N = Bm.shape[-1]
    Q = min(chunk, S0)
    if S0 % Q:  # pad the sequence to a chunk multiple (dt=0: identity steps)
        pad = Q - S0 % Q
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        Bm = F.pad(Bm, (0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, pad))
    S = x.shape[1]
    nc = S // Q
    intra = ops.ssd_intra if impl == "kernel" else _ssd_intra_plain
    y_intra, s_in = intra(
        x.reshape(Bsz * nc, Q, H, P), dt.reshape(Bsz * nc, Q, H), A,
        Bm.reshape(Bsz * nc, Q, N), Cm.reshape(Bsz * nc, Q, N))
    y_intra = y_intra.reshape(Bsz, nc, Q, H, P)
    s_in = s_in.reshape(Bsz, nc, H, P, N)
    if initial_state is None and nc == 1:
        # a fresh single chunk (scoring, the router probe): the entering
        # state is zero, so the inter-chunk part below adds exactly
        # nothing (0 * decay + s_in is s_in, y + 0 is y)
        y = y_intra.reshape(Bsz, S, H, P)[:, :S0]
        return y.to(x.dtype), s_in[:, 0].to(x.dtype)

    # the intra part keeps the TPU kernel's contract (y, state): what the
    # inter-chunk part needs of cum is recomputed here
    cum = torch.cumsum(dt.reshape(Bsz, nc, Q, H) * A, dim=2)   # fp32
    chunk_decay = torch.exp(cum[:, :, -1])                     # (B, nc, H)
    s = torch.zeros((Bsz, H, P, N), dtype=x.dtype, device=x.device) \
        if initial_state is None else initial_state
    s = s.float()
    enter = []
    for c in range(nc):                 # state ENTERING each chunk
        enter.append(s)
        s = s * chunk_decay[:, c, :, None, None] + s_in[:, c]
    s_enter = torch.stack(enter, dim=1).to(x.dtype)            # (B,nc,H,P,N)

    # inter-chunk: y_inter[i] = exp(cum_i) * C_i . S_enter
    Cc = Cm.reshape(Bsz, nc, Q, N)
    y_inter = torch.einsum("bcin,bchpn->bcihp", Cc.float(),
                           s_enter.float()) * torch.exp(cum)[..., None]
    y = (y_intra + y_inter).reshape(Bsz, S, H, P)[:, :S0]
    return y.to(x.dtype), s.to(x.dtype)


def _projections(lp: dict, h):
    hc = column_input(h, "ssm_inner")
    return (hc @ lp["in_z"], hc @ lp["in_x"], h @ lp["in_B"],
            h @ lp["in_C"], hc @ lp["in_dt"])


def _local_dims(cfg: ModelConfig, lp: dict) -> tuple[int, int, int, int]:
    """(d_inner, N, heads, headdim) of a layer's weights ``lp``: on a
    mesh that cuts ``ssm_inner``, this rank's d_inner / tp and H / tp."""
    return (lp["in_x"].shape[-1], cfg.ssm_state, lp["A_log"].shape[-1],
            cfg.ssm_headdim)


def ssm_block(cfg: ModelConfig, lp: dict, x, ssd_impl: str = "kernel"):
    """Full mamba2 layer (teacher-forced). x (B, S, D) -> (B, S, D); the
    scan's intra-chunk part is ``ssd_impl``'s (``ssd_chunked``).

    In the train layout the layer's weights are gathered over 'data'
    first, and where 'model' cuts ``ssm_inner`` the conv's B and C
    channels (whole on every rank, each feeding only this rank's heads)
    ``enter`` the scan: the backward sums their cotangent over 'model',
    so ``in_B``, ``in_C``, conv_w's B and C channels and the normed
    input get their whole gradient on every rank."""
    lp = gather_layer(lp)           # FSDP: whole over 'data' (train layout)
    B, S, _ = x.shape
    di, N, H, P = _local_dims(cfg, lp)
    h = rms_norm(x, lp["ln"], cfg.norm_eps)
    z, xc, Bm, Cm, dt_raw = _projections(lp, h)
    conv_out, _ = _conv1d_causal(torch.cat([xc, Bm, Cm], dim=-1),
                                 lp["conv_w"])
    xc, bc = torch.split(conv_out, [di, 2 * N], dim=-1)       # views
    Bm, Cm = torch.split(column_input(bc, "ssm_inner"), [N, N], dim=-1)
    dt = F.softplus(dt_raw + lp["dt_bias"])
    A = -torch.exp(lp["A_log"].float())
    xh = xc.reshape(B, S, H, P)
    y, _ = ssd_chunked(xh, dt, A, Bm, Cm, chunk=cfg.ssm_chunk,
                       impl=ssd_impl)
    y = y + lp["D_skip"][None, None, :, None] * xh
    y = (y.reshape(B, S, di) * F.silu(z)).to(x.dtype)
    return x + tp_down_proj(y, lp["out_proj"], "ssm_inner")


def forward(params, cfg: ModelConfig, batch: dict, *,
            ssd_impl: str = "kernel", return_hidden: bool = False):
    """Teacher-forced scoring: batch["tokens"] (B, S) -> logits (B, S, Vp)
    (or, with ``return_hidden``, the final-normed (B, S, D)). "kernel":
    one ``ssd_intra`` launch per layer; "plain": the same scan with its
    intra-chunk part in plain PyTorch, which autograd can differentiate."""
    check_impl("ssd_impl", ssd_impl, SSD_IMPLS)
    x = embed_tokens(cfg, params, batch["tokens"])
    for layer in range(cfg.n_layers):
        x = remat(cfg, partial(ssm_block, cfg, layer_weights(params, layer),
                               ssd_impl=ssd_impl), x)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return x if return_hidden else lm_logits(cfg, params, x)


# ------------------------------------------------------------------ decode
#: the cache leaves a speculative rollback restores per lane: the
#: recurrence carries its whole context in them
ROLLBACK_LEAVES = ("conv", "state", "pos")


def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=None,
               device=None):
    """Recurrent cache {"conv": (L, B, K-1, di+2N) in the model dtype,
    "state": (L, B, H, P, N) fp32, "pos": (B,) int32}. Its size does not
    depend on ``max_len``; ``pos`` is per lane, as the dense cache's, so
    the scheduler can reset one slot while the rest keep stepping."""
    dtype = dtype or torch_dtype(cfg.dtype)
    L, di, N = cfg.n_layers, cfg.ssm_d_inner, cfg.ssm_state
    return {
        "conv": torch.zeros((L, batch, cfg.ssm_conv - 1, di + 2 * N),
                            dtype=dtype, device=device),
        "state": torch.zeros((L, batch, cfg.ssm_heads, cfg.ssm_headdim, N),
                             dtype=torch.float32, device=device),
        "pos": torch.zeros((batch,), dtype=torch.int32, device=device),
    }


def ssm_decode_step(cfg: ModelConfig, lp: dict, x, conv_state, ssm_state):
    """One-token mamba2 step of one layer: x (B, 1, D) -> (B, 1, D).
    ``conv_state`` (B, K-1, C) and ``ssm_state`` (B, H, P, N) fp32 are
    updated in place (on a mesh, this rank's channels and heads)."""
    B = x.shape[0]
    di, N, H, P = _local_dims(cfg, lp)
    h = rms_norm(x, lp["ln"], cfg.norm_eps)
    z, xc, Bm, Cm, dt_raw = _projections(lp, h)
    conv_out, new_conv = _conv1d_causal(torch.cat([xc, Bm, Cm], dim=-1),
                                        lp["conv_w"], conv_state)
    conv_state.copy_(new_conv)
    xc, Bm, Cm = torch.split(conv_out[:, 0], [di, N, N], dim=-1)
    dt = F.softplus(dt_raw[:, 0] + lp["dt_bias"])                  # (B, H)
    A = -torch.exp(lp["A_log"].float())
    xh = xc.reshape(B, H, P)
    dA = torch.exp(dt * A)                                         # fp32
    upd = dt[..., None, None] * xh[..., None] * Bm[:, None, None, :]
    ssm_state.mul_(dA[..., None, None]).add_(upd.float())
    y = torch.einsum("bhpn,bn->bhp", ssm_state.to(x.dtype), Cm)
    y = y + lp["D_skip"][None, :, None] * xh
    y = (y.reshape(B, 1, di) * F.silu(z)).to(x.dtype)
    return x + tp_down_proj(y, lp["out_proj"], "ssm_inner")


def decode_step(params, cfg: ModelConfig, cache, prev_tokens):
    """One autoregressive step: (cache, prev (B,)) -> (logits (B, Vp),
    cache). The cache is updated in place; ``pos`` advances by one."""
    x = embed_tokens(cfg, params, prev_tokens[:, None])
    for layer in range(cfg.n_layers):
        x = ssm_decode_step(cfg, layer_weights(params, layer), x,
                            cache["conv"][layer], cache["state"][layer])
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = lm_logits(cfg, params, x)[:, 0]
    cache["pos"].add_(1)    # in place: every cache leaf keeps its storage
    return logits, cache
