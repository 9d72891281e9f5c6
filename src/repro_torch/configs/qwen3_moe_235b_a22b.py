"""qwen3-moe-235b-a22b [moe] — 94L d_model=4096 64H (GQA kv=4) d_ff=1536
(per expert) vocab=151936, MoE 128e top-8 [hf:Qwen/Qwen3-30B-A3B; hf].
qk_norm per qwen3; d_head=128 (independent of d_model/n_heads). 64
q-heads over 4 kv-heads: G = 16 per kv-head. ~235 B parameters (~470 GB
in bf16): one card holds it only at a reduced depth
(``CONFIG.with_(n_layers=4)``: ~21 GB)."""
from repro_torch.configs.base import ModelConfig, tiny_variant

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b", family="moe",
    n_layers=94, d_model=4096, n_heads=64, n_kv_heads=4, d_head=128,
    d_ff=1536, vocab_size=151936, qk_norm=True, rope_theta=1e6,
    n_experts=128, top_k=8,
)
SMOKE_CONFIG = tiny_variant(CONFIG)
