"""Collective traffic and roofline terms of a dry-run step: the port's
counterpart of the JAX package's ``launch/hlo_analysis.py``, under the
same name so that a reader finds it.

The port has no HLO: its steps are eager PyTorch programs of one rank.
What JAX reads from the optimized HLO, the dry run (``launch/dryrun.py``)
gets from the trace of rank 0's step on the meta device:

  * the collectives from the stand-in mesh's log
    (``launch.mesh.StandInMesh``: one entry per collective and axis,
    with its input and output bytes), which ``collective_stats`` sums
    under JAX's keys (``all-reduce`` for a psum or pmax, ``all-gather``
    for a gather; the port makes no reduce-scatter, all-to-all or
    collective-permute, and keeps their keys at 0);
  * the FLOPs from ``torch.utils.flop_counter.FlopCounterMode`` and the
    kernel wrappers' formulas (``kernels.ops.META_FLOPS``).

``analytic_memory_bytes`` is JAX's traffic model, the same arithmetic;
``Roofline`` takes one NVIDIA H100 SXM's published peaks (NVIDIA's data
sheet, dense rates, at the 700 W limit): 989 TFLOP/s in bf16, 67 TFLOP/s
in fp32 outside the tensor cores, 3.35 TB/s of HBM, and NVLink's 450
GB/s each way. Its times are projections against those peaks, never
measurements.
"""
from __future__ import annotations

from dataclasses import dataclass

H100_PEAK_FLOPS_BF16 = 989e12
H100_PEAK_FLOPS_FP32 = 67e12
H100_HBM_BW = 3.35e12            # bytes/s per card
H100_NVLINK_BW = 450e9           # bytes/s each way per card
H100_POWER_LIMIT_W = 700         # the limit the peaks assume

#: JAX's collective kinds, and the port's ops that count under each
_KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
          "collective-permute")
_KIND_OF = {"psum": "all-reduce", "pmax": "all-reduce",
            "all_gather": "all-gather", "agree": "all-gather"}


def collective_stats(log: list) -> dict:
    """Per-kind output bytes (per participant) and op counts of a mesh's
    collective ``log`` (``launch.mesh.Mesh.record``, entries (op, axis,
    shape, dtype, input bytes, output bytes)), under the keys of JAX's
    ``collective_stats``. ``bf16_promotion_correction_bytes`` is 0: the
    port's payloads are what the collectives carry."""
    by_kind = {k: {"bytes": 0, "count": 0} for k in _KINDS}
    for op, _axis, _shape, _dtype, _n_in, n_out in log:
        kind = by_kind[_KIND_OF[op]]
        kind["bytes"] += int(n_out)
        kind["count"] += 1
    return {"total_bytes": sum(v["bytes"] for v in by_kind.values()),
            "by_kind": by_kind, "bf16_promotion_correction_bytes": 0}


def analytic_memory_bytes(cfg, shape, *, n_chips: int, tp: int,
                          num_microbatches: int = 1) -> float:
    """Per-device HBM traffic of one step assuming flash-style attention
    and fused elementwise chains: the JAX package's model, term for term
    (weights read once a pass, AdamW's state and the gradient
    accumulator, C_ACT touches of the residual stream, the fp32 logits
    chain, the KV cache or SSM state a decode step reads)."""
    from repro_torch.models.schema import count_params
    dtype_b = 2 if cfg.dtype == "bfloat16" else 4
    P = count_params(cfg)
    dp = max(1, n_chips // tp)
    B, S = shape.global_batch, shape.seq_len
    kind = shape.kind
    D = cfg.d_model
    L = cfg.n_layers + (cfg.n_enc_layers if cfg.family == "encdec" else 0)
    tok_loc = B * (S if kind != "decode" else 1) / dp

    C_ACT_F, C_ACT_B = 12, 30
    C_LOGIT_F, C_LOGIT_B = 6, 10

    w_slice = P * dtype_b / tp
    Vp_loc = cfg.padded_vocab / tp
    logit_loc = tok_loc * Vp_loc * 4

    if kind == "train":
        weights = 3 * w_slice * num_microbatches
        optim = (P / n_chips) * (dtype_b * 2 + 16 + 4)
        gacc = 2 * (P / n_chips) * 4 * num_microbatches
        acts = tok_loc * D * dtype_b * L * (C_ACT_F + C_ACT_B)
        logits = logit_loc * (C_LOGIT_F + C_LOGIT_B)
        return weights + optim + gacc + acts + logits
    if kind == "prefill":
        weights = w_slice
        acts = tok_loc * D * dtype_b * L * C_ACT_F
        logits = logit_loc * C_LOGIT_F
        return weights + acts + logits
    weights = w_slice
    kv_heads = getattr(cfg, "padded_kv_heads", 0)
    if cfg.family in ("ssm", "hybrid"):
        N = cfg.ssm_state
        state = cfg.n_layers * (B / dp) * cfg.ssm_heads * cfg.ssm_headdim \
            * N * 4
        cache = 2 * state
        if cfg.family == "hybrid":
            n_app = cfg.n_layers // cfg.hybrid_ssm_per_block
            eff_S = min(S, cfg.sliding_window or S)
            cache += n_app * B * eff_S * kv_heads * cfg.head_dim * 2 * \
                dtype_b / n_chips
    else:
        eff_S = min(S, cfg.sliding_window or S)
        kv_b = 1 if getattr(cfg, "kv_cache_dtype", None) == "int8" \
            else dtype_b
        cache = L * B * eff_S * kv_heads * cfg.head_dim * 2 * kv_b / n_chips
        if kv_b == 1:
            cache += L * B * eff_S * kv_heads * 2 * 2 * 2 / n_chips
    acts = tok_loc * D * dtype_b * L * C_ACT_F
    logits = logit_loc * C_LOGIT_F
    return weights + cache + acts + logits


@dataclass
class Roofline:
    """The least time a step could take on ``n_chips`` H100s, from its
    FLOPs, bytes and collective bytes (JAX's ``Roofline`` with the H100's
    peaks): projected, not measured."""
    hlo_flops: float
    hlo_bytes: float
    collective_bytes: float   # per participant
    n_chips: int
    model_flops: float = 0.0
    memory_bytes_analytic: float = 0.0
    peak_flops: float = H100_PEAK_FLOPS_BF16

    @property
    def t_compute(self) -> float:
        return self.hlo_flops / (self.n_chips * self.peak_flops)

    @property
    def t_memory(self) -> float:
        if self.memory_bytes_analytic:
            return self.memory_bytes_analytic / H100_HBM_BW
        return self.hlo_bytes / (self.n_chips * H100_HBM_BW)

    @property
    def t_memory_probe(self) -> float:
        return self.hlo_bytes / (self.n_chips * H100_HBM_BW)

    @property
    def t_collective(self) -> float:
        return self.collective_bytes / H100_NVLINK_BW

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def useful_flops_ratio(self) -> float:
        return self.model_flops / self.hlo_flops if self.hlo_flops else 0.0

    @property
    def t_star(self) -> float:
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def roofline_fraction(self) -> float:
        if self.t_star == 0:
            return 0.0
        return self.model_flops / (self.n_chips * self.peak_flops) \
            / self.t_star

    def attainment(self, measured_s: float) -> float:
        """``t_star`` over a measured step time (0.0 where either side
        is missing)."""
        if measured_s is None or measured_s <= 0 or self.t_star <= 0:
            return 0.0
        return self.t_star / float(measured_s)

    def to_dict(self) -> dict:
        return {
            "hlo_flops": self.hlo_flops, "hlo_bytes": self.hlo_bytes,
            "collective_bytes": self.collective_bytes,
            "n_chips": self.n_chips, "model_flops": self.model_flops,
            "memory_bytes_analytic": self.memory_bytes_analytic,
            "peak_flops": self.peak_flops,
            "t_compute_s": self.t_compute, "t_memory_s": self.t_memory,
            "t_memory_probe_s": self.t_memory_probe,
            "t_collective_s": self.t_collective,
            "t_star_s": self.t_star,
            "bottleneck": self.bottleneck,
            "useful_flops_ratio": self.useful_flops_ratio,
            "roofline_fraction": self.roofline_fraction,
            "projected": f"H100 SXM published peaks at "
                         f"{H100_POWER_LIMIT_W} W, not measured",
        }
