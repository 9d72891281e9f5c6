"""qwen3-14b [dense] — 40L d_model=5120 40H (GQA kv=8) d_ff=17408
vocab=151936 — qk_norm, GQA [hf:Qwen/Qwen3-8B; hf].
40 q-heads pad to 48 for TP=16 (DESIGN.md §4), so G = 6 per kv-head."""
from repro_torch.configs.base import ModelConfig, tiny_variant

CONFIG = ModelConfig(
    name="qwen3-14b", family="dense",
    n_layers=40, d_model=5120, n_heads=40, n_kv_heads=8, d_head=128,
    d_ff=17408, vocab_size=151936, qk_norm=True, rope_theta=1e6,
)
SMOKE_CONFIG = tiny_variant(CONFIG)
