"""Byte-level tokenizer for the measured compression experiments.

Vocab layout: 0..255 = raw bytes, 256 = PAD, 257 = BOS (matches the
paper_predictors configs with vocab_size = 258). Lossless by construction
(identity on bytes), which makes bits-per-byte reporting exact — see
DESIGN.md §6 for why the measured runs use bytes rather than BPE.
"""
from __future__ import annotations

import numpy as np

VOCAB_SIZE = 258
PAD_ID = 256
BOS_ID = 257


def encode(data: bytes) -> np.ndarray:
    return np.frombuffer(data, dtype=np.uint8).astype(np.int32)


def decode(tokens: np.ndarray) -> bytes:
    t = np.asarray(tokens)
    t = t[t < 256]
    return t.astype(np.uint8).tobytes()
