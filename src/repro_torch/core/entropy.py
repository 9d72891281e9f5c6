"""Compressibility analysis tools — paper §3 (Fig 2, Table 2). A copy
of the JAX package's ``core/entropy.py`` (pure Python and numpy):
``analyze`` gives the same floats.

N-gram redundancy, entropy-per-byte at several tokenization granularities,
and mutual information between consecutive words.
"""
from __future__ import annotations

import math
import re
from collections import Counter

import numpy as np


def ngram_top_coverage(text: str, n: int, top: int = 10) -> float:
    """Fraction of all n-grams covered by the ``top`` most frequent ones
    (paper Fig 2: low coverage => dedup won't help)."""
    toks = text.split()
    grams = list(zip(*(toks[i:] for i in range(n)))) if len(toks) >= n else []
    if not grams:
        return 0.0
    c = Counter(grams)
    return sum(f for _, f in c.most_common(top)) / len(grams)


def _entropy(counter: Counter) -> float:
    total = sum(counter.values())
    return -sum((f / total) * math.log2(f / total) for f in counter.values())


def char_entropy_per_byte(text: str) -> float:
    c = Counter(text)
    avg_len = float(np.mean([len(ch.encode()) for ch in c.elements()]))
    return _entropy(c) / avg_len


def word_entropy_per_byte(text: str) -> float:
    words = re.findall(r"\S+", text)
    c = Counter(words)
    total = sum(c.values())
    avg_len = sum(f * (len(w.encode()) + 1) for w, f in c.items()) / total
    return _entropy(c) / avg_len


def subword_entropy_per_byte(text: str, piece: int = 4) -> float:
    """Fixed-length piece tokenization as a BPE stand-in (deterministic,
    dependency-free)."""
    pieces = [text[i:i + piece] for i in range(0, len(text), piece)]
    c = Counter(pieces)
    total = sum(c.values())
    avg_len = sum(f * len(p.encode()) for p, f in c.items()) / total
    return _entropy(c) / avg_len


def consecutive_word_mutual_information(text: str) -> float:
    """MI(W_i; W_{i+1}) in bits — paper Table 2's predictability probe."""
    words = re.findall(r"\S+", text)
    if len(words) < 2:
        return 0.0
    uni = Counter(words)
    bi = Counter(zip(words, words[1:]))
    n_uni = sum(uni.values())
    n_bi = sum(bi.values())
    mi = 0.0
    for (a, b), f in bi.items():
        p_ab = f / n_bi
        p_a = uni[a] / n_uni
        p_b = uni[b] / n_uni
        mi += p_ab * math.log2(p_ab / (p_a * p_b))
    return mi


def analyze(text: str) -> dict[str, float]:
    return {
        "char_entropy_per_byte": round(char_entropy_per_byte(text), 3),
        "subword_entropy_per_byte": round(subword_entropy_per_byte(text), 3),
        "word_entropy_per_byte": round(word_entropy_per_byte(text), 3),
        "mutual_info_bits": round(consecutive_word_mutual_information(text), 3),
        "unigram_top10_coverage": round(ngram_top_coverage(text, 1), 4),
        "bigram_top10_coverage": round(ngram_top_coverage(text, 2), 4),
        "trigram_top10_coverage": round(ngram_top_coverage(text, 3), 4),
        "fourgram_top10_coverage": round(ngram_top_coverage(text, 4), 4),
    }
