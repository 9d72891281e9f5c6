"""Small byte-level predictor LMs for the MEASURED compression experiments
(the paper's 1B-14B Llama/Qwen models scaled to this CPU container; the
architecture family is the same llama-style dense decoder).

Vocab 258 = 256 bytes + BOS + PAD. Three sizes give the paper's model-size
sweep (§5.5).
"""
from repro_torch.configs.base import ModelConfig

def _mk(name, L, D, H, F):
    return ModelConfig(
        name=name, family="dense", n_layers=L, d_model=D, n_heads=H,
        n_kv_heads=max(1, H // 2), d_head=D // H, d_ff=F, vocab_size=258,
        head_pad_multiple=1, vocab_pad_multiple=1, dtype="float32",
        remat=False, rope_theta=1e4,
    )

PRED_TINY = _mk("pred-tiny", 2, 64, 4, 192)       # ~0.1M
PRED_SMALL = _mk("pred-small", 4, 128, 8, 384)    # ~0.9M
PRED_BASE = _mk("pred-base", 6, 256, 8, 768)      # ~5M
PRED_LARGE = _mk("pred-large", 8, 384, 12, 1152)  # ~16M
