"""whisper-large-v3 [audio] — 32L(+32L enc) d_model=1280 20H (MHA kv=20)
d_ff=5120 vocab=51866 — enc-dec, conv frontend STUB (a caller hands
precomputed frame embeddings (B, S_enc, d_model) to the model as
``frames``) [arXiv:2212.04356; unverified]. 20 heads pad to 32 (hd 64,
G 1); the vocabulary pads to 51,968. The decoder's self-attention uses
RoPE, as in the JAX package (an adaptation from learned positions).
2.40 B stored parameters; the cross-attention K/V of one source of
1,500 frames is 32 x 1,500 x 2,048 x 2 x 2 B = 393 MB."""
from repro_torch.configs.base import ModelConfig, tiny_variant

CONFIG = ModelConfig(
    name="whisper-large-v3", family="encdec",
    n_layers=32, d_model=1280, n_heads=20, n_kv_heads=20, d_head=64,
    d_ff=5120, vocab_size=51866, rope_theta=1e4,
    n_enc_layers=32, max_source_len=1500,
)
SMOKE_CONFIG = tiny_variant(CONFIG)
