"""Synthetic corpora for the paper's experiments.

Two kinds of text:
  * "human-like" — procedurally generated English-ish prose from a large
    template/vocabulary pool with per-domain wordlists (wiki / code /
    math / clinical / web / science / novel / article — the paper's 8
    dataset categories). Deterministic given a seed; statistically
    human-like (entropy/byte ~ paper Table 2).
  * "LLM-generated" — sampled from a trained predictor LM at a given
    temperature (the paper's central setting: text produced BY a model is
    highly predictable FOR a model).
"""
from __future__ import annotations

import numpy as np

_DOMAIN_WORDS = {
    "wiki": ("the history of", "was established in", "is a city in",
             "population", "according to the census", "the region",
             "notable for", "culture and", "economy", "university",
             "founded", "century", "located in", "the municipality",
             "references", "the government", "during the war",
             "independence", "the river", "climate is"),
    "code": ("def", "return", "import numpy as np", "for i in range(",
             "if __name__ ==", "class", "self.", "print(", "lambda x:",
             "# compute the", "raise ValueError(", "try:", "except:",
             "while True:", "break", "assert", "np.zeros(", "result =",
             "value", "index"),
    "math": ("therefore", "the sum of", "equals", "let x be",
             "we have", "subtract", "multiply by", "the answer is",
             "dollars", "apples", "how many", "each day", "in total",
             "half of", "twice", "remainder", "per week", "costs",
             "solve for", "fraction"),
    "clinical": ("the patient", "was admitted", "presented with",
                 "history of", "diagnosis", "treatment with", "mg daily",
                 "discharged", "follow-up", "symptoms", "examination",
                 "laboratory", "no acute", "chronic", "hypertension",
                 "diabetes", "prescribed", "stable condition",
                 "recommended", "vital signs"),
    "web": ("this movie", "the plot", "I think", "really great",
            "the acting", "would recommend", "disappointing",
            "the director", "special effects", "the characters",
            "worth watching", "a masterpiece", "overrated", "the ending",
            "performances", "soundtrack", "script", "cinematography",
            "sequel", "rating"),
    "science": ("the experiment", "hypothesis", "the results show",
                "velocity", "the energy", "measured", "particles",
                "temperature", "pressure", "the equation", "constant",
                "observed", "quantum", "field", "force", "acceleration",
                "wavelength", "the system", "approximately", "theory"),
    "novel": ("she walked", "the morning", "he said", "quietly",
              "the old house", "remembered", "in the distance",
              "her eyes", "the journey", "suddenly", "whispered",
              "the mountains", "beneath", "a long time", "the sea",
              "shadows", "the road", "wondered", "smiled", "the night"),
    "article": ("we propose", "in this paper", "our method",
                "experimental results", "state-of-the-art", "baseline",
                "the model", "performance", "dataset", "we evaluate",
                "significantly", "approach", "in conclusion",
                "furthermore", "related work", "the algorithm",
                "we observe", "table shows", "outperforms", "accuracy"),
}

_FILLER = ("and", "of", "to", "in", "a", "is", "that", "it", "with", "as",
           "for", "was", "on", "are", "by", "at", "an", "be", "this",
           "which", "or", "from", "had", "not", "but", "what", "all",
           "were", "when", "we", "there", "can", "more", "if", "so")


def human_like(domain: str, n_bytes: int, seed: int = 0) -> bytes:
    """Markov-ish procedural text: domain phrases + fillers + punctuation.
    Entropy/byte lands near real English (~4.5 bits char-level)."""
    rng = np.random.default_rng(seed + hash(domain) % 2**16)
    words = _DOMAIN_WORDS[domain]
    out = []
    size = 0
    sentence_len = 0
    while size < n_bytes:
        r = rng.random()
        if r < 0.35:
            w = words[rng.integers(len(words))]
        elif r < 0.9:
            w = _FILLER[rng.integers(len(_FILLER))]
        else:
            w = "".join(chr(97 + rng.integers(26))
                        for _ in range(rng.integers(3, 9)))
        sentence_len += 1
        if sentence_len > rng.integers(8, 18):
            w += "." if domain != "code" else "\n"
            sentence_len = 0
        out.append(w)
        size += len(w) + 1
    text = " ".join(out)
    raw = text.encode()
    if len(raw) < n_bytes:  # join undercounts separators; pad with filler
        raw = raw + (b" " + b" ".join(
            _FILLER[i % len(_FILLER)].encode() for i in range(40)))
        raw = (raw * (n_bytes // max(1, len(raw)) + 1))
    return raw[:n_bytes]


DOMAINS = tuple(_DOMAIN_WORDS)

_OOD_WORDS = ("galvanize", "heuristic", "ephemeral", "quixotic", "zeitgeist",
              "labyrinthine", "mercurial", "obfuscate", "penumbra",
              "serendipity", "vignette", "juxtapose", "cacophony",
              "perfunctory", "recalcitrant", "vicissitude", "antediluvian",
              "grandiloquent", "pusillanimous", "sesquipedalian")


def human_like_ood(domain: str, n_bytes: int, seed: int = 0,
                   ood_frac: float = 0.25) -> bytes:
    """Human-like text with out-of-training-distribution lexical mass.
    Any finite training corpus leaves real human text with OOV content;
    the plain procedural generator unrealistically lacks it (it IS the
    training distribution). Used as the 'realistic human' condition in the
    Fig 9 experiment."""
    base = human_like(domain, n_bytes * 2, seed=seed).decode()
    rng = np.random.default_rng(seed + 999)
    words = base.split()
    mixed = " ".join(
        _OOD_WORDS[rng.integers(len(_OOD_WORDS))]
        if rng.random() < ood_frac else w for w in words)
    return mixed.encode()[:n_bytes]


def llm_generated(predictor, n_bytes: int, *, temperature=0.8, seed=0,
                  batch=8) -> bytes:
    """Sample `n_bytes` of byte-level text from a predictor LM — the
    paper's 'LLM-generated data'."""
    per = -(-n_bytes // batch)
    toks = predictor.generate(per, batch=batch, temperature=temperature,
                              seed=seed)
    from .tokenizer import decode
    return decode(toks.ravel())[:n_bytes]
