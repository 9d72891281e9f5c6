"""deepseek-7b [dense] — 30L d_model=4096 32H (MHA kv=32) d_ff=11008
vocab=102400 — llama-arch [arXiv:2401.02954; hf]. MHA (G = 1) gives it
the largest K/V cache per token of the dense configs:
``CONFIG.with_(kv_cache_dtype="int8")`` halves it."""
from repro_torch.configs.base import ModelConfig, tiny_variant

CONFIG = ModelConfig(
    name="deepseek-7b", family="dense",
    n_layers=30, d_model=4096, n_heads=32, n_kv_heads=32, d_head=128,
    d_ff=11008, vocab_size=102400, rope_theta=1e4,
)
SMOKE_CONFIG = tiny_variant(CONFIG)
