"""h2o-danube-3-4b [dense] — 24L d_model=3840 32H (GQA kv=8) d_ff=10240
vocab=32000 — llama+mistral mix, SWA (window 4096)
[arXiv:2401.16818; unverified]. d_head=120 (3840/32): not a multiple of
16, so the bf16 decode-attention kernel scores on CUDA cores rather than
the tensor cores. The decode cache is a ring of min(max_len, 4096)
positions."""
from repro_torch.configs.base import ModelConfig, tiny_variant

CONFIG = ModelConfig(
    name="h2o-danube-3-4b", family="dense",
    n_layers=24, d_model=3840, n_heads=32, n_kv_heads=8, d_head=120,
    d_ff=10240, vocab_size=32000, sliding_window=4096, rope_theta=1e4,
)
SMOKE_CONFIG = tiny_variant(CONFIG)
