"""llava-next-34b [vlm] — 60L d_model=7168 56H (GQA kv=8) d_ff=20480
vocab=64000; anyres tiling [hf:llava-hf/llava-v1.6-mistral-7b-hf;
unverified]. The dense backbone; the anyres patch frontend is a stub, as
in the JAX package: a caller hands precomputed patch embeddings (B,
n_img_tokens, d_model) to ``forward`` as ``img_embeds``. 56 heads pad to
64 over 8 kv-heads (G 8, hd 128): 35.3 B stored parameters at 60 layers,
572.5 M a layer."""
from repro_torch.configs.base import ModelConfig, tiny_variant

CONFIG = ModelConfig(
    name="llava-next-34b", family="vlm",
    n_layers=60, d_model=7168, n_heads=56, n_kv_heads=8, d_head=128,
    d_ff=20480, vocab_size=64000, rope_theta=1e6,
    n_img_tokens=576,            # one anyres base tile (24x24 patches)
)
SMOKE_CONFIG = tiny_variant(CONFIG)
