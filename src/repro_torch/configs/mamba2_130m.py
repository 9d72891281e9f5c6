"""mamba2-130m [ssm] — 24L d_model=768 (attn-free) vocab=50280,
ssm_state=128 — SSD (state-space duality) [arXiv:2405.21060; unverified]."""
from repro_torch.configs.base import ModelConfig, tiny_variant

CONFIG = ModelConfig(
    name="mamba2-130m", family="ssm",
    n_layers=24, d_model=768, n_heads=0, n_kv_heads=0, d_head=64,
    d_ff=0, vocab_size=50280,
    ssm_state=128, ssm_conv=4, ssm_expand=2, ssm_headdim=64, ssm_chunk=256,
    tie_embeddings=True,   # mamba2-130m ties embed/lm_head
)
SMOKE_CONFIG = tiny_variant(CONFIG)
