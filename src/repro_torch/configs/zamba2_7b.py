"""zamba2-7b [hybrid] — 81L d_model=3584 32H (MHA kv=32) d_ff=14336
vocab=32000, ssm_state=64 — Mamba2 + shared attn blocks
[arXiv:2411.15242; unverified]. 81 SSD layers; ONE shared attention+MLP
block applied after every 13 SSM layers (6 applications; 3 trailing SSM
layers). d_head=112 (3584/32): the attention kernels take it as it is
(the bf16 prefill kernel pads its tiles to 128 channels inside)."""
from repro_torch.configs.base import ModelConfig, tiny_variant

CONFIG = ModelConfig(
    name="zamba2-7b", family="hybrid",
    n_layers=81, d_model=3584, n_heads=32, n_kv_heads=32, d_head=112,
    d_ff=14336, vocab_size=32000, rope_theta=1e4,
    ssm_state=64, ssm_conv=4, ssm_expand=2, ssm_headdim=64, ssm_chunk=256,
    hybrid_ssm_per_block=13,
)
SMOKE_CONFIG = tiny_variant(CONFIG)
