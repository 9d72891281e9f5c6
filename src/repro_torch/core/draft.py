"""Self-draft proposers for speculative decompression (DESIGN.md §9).

A proposer guesses the next K tokens of each lane from nothing but that
lane's already-decoded prefix — no model, no side channel. Guesses only
buy speed, never correctness: the rANS decoder arbitrates every position
against the coded stream, so a wrong draft costs one wasted verify slot
and nothing else (the mismatching position still decodes its true token).

``SuffixDraft`` is the production proposer: longest-suffix match (order
down to 1) against the decoded prefix, continuation copied from the most
recent prior occurrence. On LLM-generated text — the paper's target
distribution — local reuse is heavy (§3's n-gram redundancy analysis),
so suffix continuation is a strong, free draft. ``ConstantDraft`` exists
for adversarial tests (an always-wrong proposer must degrade speculative
decode to lock-step rate, never corrupt it).
"""
from __future__ import annotations

import numpy as np

from repro_torch.obs import metrics as _metrics


class DraftProposer:
    """Protocol: propose K next tokens per lane from decoded prefixes."""

    def propose(self, tokens: np.ndarray, pos: np.ndarray,
                k: int) -> np.ndarray:
        """tokens (B, C) decoded-so-far (valid up to pos[b] per lane),
        pos (B,) next undecoded position -> drafts (B, k) int32."""
        raise NotImplementedError


class SuffixDraft(DraftProposer):
    """N-gram / suffix-match proposer over the decoded prefix, per lane.

    For each lane, match the longest suffix of length <= max_order
    against earlier text; on a hit, propose the continuation that
    followed the most recent occurrence. The copy is LZ-style and may
    OVERLAP the frontier: when the source catches up to the undecoded
    boundary it re-reads the tokens just drafted, so a period-p loop
    (argmax cycles, repeated delimiters, table rows) extrapolates
    exactly instead of stuttering on its last token.
    """

    def __init__(self, max_order: int = 3):
        self.max_order = int(max_order)

    def propose(self, tokens, pos, k):
        tokens = np.asarray(tokens)
        pos = np.asarray(pos)
        B = tokens.shape[0]
        _metrics.registry().counter(
            "draft.proposed_tokens",
            "draft tokens proposed (suffix matcher)").inc(B * k)
        out = np.zeros((B, k), np.int32)
        for b in range(B):
            out[b] = self._lane(tokens[b], int(pos[b]), k)
        return out

    def _lane(self, toks, p, k):
        draft = np.zeros(k, np.int32)
        if p == 0:
            return draft
        for order in range(min(self.max_order, p), 0, -1):
            j = self._last_match(toks, p, order)
            if j < 0:
                continue
            s = j + order               # continuation source; s <= p - 1
            for i in range(k):          # overlapping copy, period p - s
                draft[i] = toks[s + i] if s + i < p else draft[i - (p - s)]
            return draft
        draft[:] = toks[p - 1]          # no match at any order: repeat
        return draft

    @staticmethod
    def _last_match(toks, p, order):
        """Start index of the most recent occurrence of toks[p-order:p]
        ending strictly before p-1, or -1. Shifted-slice conjunction
        (order small) — cheaper than materializing a window view for the
        short per-lane prefixes this runs on every round."""
        n = p - order                   # candidate start indices: [0, n)
        if n < 1:
            return -1
        pat = toks[p - order:p]
        ok = toks[:n] == pat[0]
        for d in range(1, order):
            ok &= toks[d:d + n] == pat[d]
        hits = np.nonzero(ok)[0]
        return int(hits[-1]) if hits.size else -1


class ConstantDraft(DraftProposer):
    """Always proposes one fixed token — the adversarial 'always wrong'
    proposer when that token never occurs in the data (tests), or a
    trivially right one on constant streams."""

    def __init__(self, token: int):
        self.token = int(token)

    def propose(self, tokens, pos, k):
        return np.full((np.asarray(tokens).shape[0], k), self.token,
                       np.int32)


class OracleDraft(DraftProposer):
    """Proposes the true continuation (tests only: exercises the
    every-position-accepted bonus-token path at 100% accept rate).
    The decoder announces each group's first chunk index through the
    optional ``begin_group`` hook."""

    def __init__(self, truth: np.ndarray, chunk_size: int):
        self.truth = np.asarray(truth, np.int32).ravel()
        self.C = int(chunk_size)
        self._base = 0

    def begin_group(self, chunk_offset: int) -> None:
        self._base = int(chunk_offset)

    def propose(self, tokens, pos, k):
        B = np.asarray(tokens).shape[0]
        out = np.zeros((B, k), np.int32)
        for b in range(B):
            lo = (self._base + b) * self.C + int(pos[b])
            cont = self.truth[lo:lo + k]
            out[b, :cont.size] = cont
        return out
