"""Model/run configuration.

One `ModelConfig` covers all six assigned families (dense / moe / ssm /
hybrid / encdec / vlm); family-specific fields are zero/None when unused.
`ShapeConfig` describes the four assigned input-shape cells.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field, replace
from typing import Optional

FAMILIES = ("dense", "moe", "ssm", "hybrid", "encdec", "vlm")


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    d_head: Optional[int] = None          # default d_model // n_heads
    # attention details
    qk_norm: bool = False
    sliding_window: Optional[int] = None  # SWA window (h2o-danube)
    rope_theta: float = 1e6
    tie_embeddings: bool = False
    # moe
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    # ssm (mamba2 / SSD)
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_headdim: int = 64
    ssm_chunk: int = 256
    # hybrid (zamba2): groups of `hybrid_ssm_per_block` ssm layers, each
    # followed by ONE application of a single shared attention block.
    hybrid_ssm_per_block: int = 0
    # encdec (whisper): n_layers is the decoder depth; encoder depth below.
    n_enc_layers: int = 0
    max_source_len: int = 1500
    # vlm (llava-next): anyres tiling stub — patch embeddings are inputs.
    n_img_tokens: int = 0
    # numerics / padding for the production mesh (TP degree 16)
    dtype: str = "bfloat16"
    kv_cache_dtype: Optional[str] = None   # None => model dtype; "int8"
    head_pad_multiple: int = 16
    vocab_pad_multiple: int = 256
    # runtime
    remat: bool = True
    scan_layers: bool = True
    use_pallas: bool = False   # ref (XLA) path by default; kernels validated separately
    norm_eps: float = 1e-6

    # ------------------------------------------------------------ derived
    @property
    def head_dim(self) -> int:
        return self.d_head if self.d_head else self.d_model // self.n_heads

    @property
    def padded_heads(self) -> int:
        m = self.head_pad_multiple
        return math.ceil(self.n_heads / m) * m if self.n_heads % m else self.n_heads

    @property
    def padded_kv_heads(self) -> int:
        """KV heads after padding. GQA group size must stay integral: if the
        padded Q heads are not a multiple of the (possibly padded) KV count,
        pad KV up to the largest divisor pattern (MHA pads to padded_heads)."""
        if self.n_kv_heads == self.n_heads:       # MHA — pad together
            return self.padded_heads
        kv = self.n_kv_heads
        while self.padded_heads % kv:
            kv += 1
        return kv

    @property
    def q_per_kv(self) -> int:
        return self.padded_heads // self.padded_kv_heads

    @property
    def padded_vocab(self) -> int:
        m = self.vocab_pad_multiple
        return math.ceil(self.vocab_size / m) * m

    # ssm derived
    @property
    def ssm_d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.ssm_d_inner // self.ssm_headdim

    @property
    def is_autoregressive(self) -> bool:
        return True  # every assigned family has an autoregressive decoder

    def n_params(self) -> int:
        """Analytic parameter count (logical, unpadded) for MODEL_FLOPS."""
        D, F, V = self.d_model, self.d_ff, self.vocab_size
        hd, H, K = self.head_dim, self.n_heads, self.n_kv_heads
        attn = D * hd * (H + 2 * K) + H * hd * D
        mlp = 3 * D * F
        if self.family == "moe":
            mlp = self.n_experts * 3 * D * self.d_ff + D * self.n_experts
        ssm = 0
        if self.family in ("ssm", "hybrid"):
            di, N, Hs = self.ssm_d_inner, self.ssm_state, self.ssm_heads
            # in_proj (z,x,B,C,dt) + out_proj + conv + A,D
            ssm = D * (2 * di + 2 * N + Hs) + di * D + self.ssm_conv * (di + 2 * N) + 2 * Hs
        emb = V * D * (1 if self.tie_embeddings else 2)
        per_layer = {"dense": attn + mlp, "moe": attn + mlp, "vlm": attn + mlp,
                     "ssm": ssm, "encdec": attn + mlp,
                     "hybrid": ssm}[self.family]
        total = self.n_layers * per_layer + emb
        if self.family == "hybrid":
            n_blocks = self.n_layers // max(1, self.hybrid_ssm_per_block)
            total += attn + mlp  # one shared attention+mlp block
        if self.family == "encdec":
            total += self.n_enc_layers * (attn + mlp) + self.n_layers * attn  # cross-attn
        return total

    def n_active_params(self) -> int:
        """Active params per token (MoE: top_k experts only)."""
        if self.family != "moe":
            return self.n_params()
        D, F = self.d_model, self.d_ff
        dense_moe = self.n_experts * 3 * D * F
        active_moe = self.top_k * 3 * D * F
        return self.n_params() - self.n_layers * (dense_moe - active_moe)

    def with_(self, **kw) -> "ModelConfig":
        return replace(self, **kw)


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


def tiny_variant(cfg: ModelConfig, **overrides) -> ModelConfig:
    """Reduced same-family config for CPU smoke tests."""
    kw = dict(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=min(cfg.n_kv_heads, 2) or 2,
        d_head=16, d_ff=128, vocab_size=257,
        head_pad_multiple=1, vocab_pad_multiple=1,
        dtype="float32", remat=False,
    )
    if cfg.family == "moe":
        kw.update(n_experts=4, top_k=2, d_ff=32)
    if cfg.family in ("ssm", "hybrid"):
        kw.update(ssm_state=16, ssm_headdim=16, ssm_chunk=16, ssm_expand=2)
    if cfg.family == "hybrid":
        kw.update(n_layers=4, hybrid_ssm_per_block=2)
    if cfg.family == "encdec":
        kw.update(n_enc_layers=2, max_source_len=32)
    if cfg.family == "vlm":
        kw.update(n_img_tokens=8)
    if cfg.sliding_window:
        kw.update(sliding_window=16)
    kw.update(overrides)
    return cfg.with_(**kw)
