"""granite-moe-1b-a400m [moe] — 24L d_model=1024 16H (GQA kv=8) d_ff=512
(per expert) vocab=49155, MoE 32e top-8
[hf:ibm-granite/granite-3.0-1b-a400m-base; hf]. 1.39 B parameters, of
which 32 experts x 3 x 1024 x 512 a layer; V = 49,155 is odd, so the
top-k kernel's slices past the first start unaligned."""
from repro_torch.configs.base import ModelConfig, tiny_variant

CONFIG = ModelConfig(
    name="granite-moe-1b-a400m", family="moe",
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=8, d_head=64,
    d_ff=512, vocab_size=49155, rope_theta=1e4,
    n_experts=32, top_k=8,
)
SMOKE_CONFIG = tiny_variant(CONFIG)
