"""Radix-tree shared-prefix cache for the compression service (v6).

Jobs that share a system prompt / template prefix should pay its prefill
once, not once per chunk: the scheduler prefills the first slot that
needs a given prefix, snapshots that lane's post-prefill KV state
(``predictor.snapshot_slot``), and stores it here keyed by the prefix
*tokens*. Every later slot that needs the same prefix restores the
snapshot (``predictor.restore_slot``) instead of re-running prefill —
the sglang-style radix-attention idea (SNIPPETS.md) applied to the
decode-side entropy coder.

The tree is path-compressed: each edge carries a token-array label, and
a node holds a value when a stored prefix ends exactly there. ``lookup``
returns the **deepest stored ancestor** of the query, so a job whose
prefix extends a cached one still reuses the cached part and only
prefills the tail (partial hit).

Eviction is LRU by *stored prefix tokens* against ``capacity_tokens`` —
the sglang accounting: what the cache protects is prefill compute, which
is linear in prefix length. Evicting a value leaves the skeleton nodes
in place (host-side token labels only; the device snapshot is what is
released).

Correctness note: a snapshot is only ever restored for a query whose
tokens extend the snapshot's exact insertion path, so a restore can
never substitute a different context — a hash collision cannot occur
because the key IS the token sequence.

Counters (in the owning registry): ``prefix_cache.hits``,
``prefix_cache.misses``, ``prefix_cache.evictions``,
``prefix_cache.tokens_reused`` (prefill steps avoided).
"""
from __future__ import annotations

from typing import Any, Optional

import numpy as np

from repro_torch.obs import MetricsRegistry


class _Node:
    __slots__ = ("edges", "value", "depth", "tick")

    def __init__(self, depth: int = 0):
        # first token of the edge label -> (label tokens, child node)
        self.edges: dict[int, tuple[np.ndarray, "_Node"]] = {}
        self.value: Any = None          # stored snapshot (None = skeleton)
        self.depth = depth              # tokens from root to this node
        self.tick = 0                   # LRU clock at last touch


class RadixPrefixCache:
    """Longest-stored-prefix lookup over token sequences, LRU-bounded."""

    def __init__(self, capacity_tokens: int = 1 << 16,
                 registry: Optional[MetricsRegistry] = None):
        if capacity_tokens <= 0:
            raise ValueError("capacity_tokens must be positive")
        self.capacity = int(capacity_tokens)
        self._root = _Node()
        self._entries: list[_Node] = []     # nodes currently holding values
        self._clock = 0
        self._size = 0                      # sum of stored prefix depths
        reg = registry if registry is not None \
            else MetricsRegistry(name="prefix_cache")
        self._c_hits = reg.counter(
            "prefix_cache.hits", "lookups that reused a stored KV prefix")
        self._c_misses = reg.counter(
            "prefix_cache.misses", "lookups with no stored ancestor")
        self._c_evict = reg.counter(
            "prefix_cache.evictions", "stored prefixes dropped by LRU")
        self._c_reused = reg.counter(
            "prefix_cache.tokens_reused",
            "prefill token-steps avoided via cache hits")

    # ------------------------------------------------------------- queries
    def __len__(self) -> int:
        return len(self._entries)

    @property
    def size_tokens(self) -> int:
        return self._size

    def lookup(self, tokens: np.ndarray) -> tuple[int, Any]:
        """Longest stored prefix of ``tokens``: returns ``(matched, value)``
        where the stored prefix is exactly ``tokens[:matched]``; (0, None)
        on a miss. Counts a hit only when a value is reused."""
        tokens = np.asarray(tokens, np.int32).ravel()
        self._clock += 1
        node, pos = self._root, 0
        best_node = None
        while pos < len(tokens):
            edge = node.edges.get(int(tokens[pos]))
            if edge is None:
                break
            label, child = edge
            n = len(label)
            if pos + n > len(tokens) or \
                    not np.array_equal(label, tokens[pos:pos + n]):
                break               # partial edge match: no node down there
            node, pos = child, pos + n
            if node.value is not None:
                best_node = node
        if best_node is None:
            self._c_misses.inc()
            return 0, None
        best_node.tick = self._clock
        self._c_hits.inc()
        self._c_reused.inc(best_node.depth)
        return best_node.depth, best_node.value

    # ------------------------------------------------------------- updates
    def insert(self, tokens: np.ndarray, value: Any) -> None:
        """Store ``value`` (a per-lane KV snapshot) for exactly
        ``tokens``. Replaces any previous value at that key; evicts LRU
        entries if the stored-token budget is exceeded."""
        tokens = np.asarray(tokens, np.int32).ravel()
        if tokens.size == 0:
            raise ValueError("cannot cache an empty prefix")
        self._clock += 1
        node, pos = self._root, 0
        while pos < len(tokens):
            first = int(tokens[pos])
            edge = node.edges.get(first)
            if edge is None:
                child = _Node(depth=len(tokens))
                node.edges[first] = (tokens[pos:].copy(), child)
                node = child
                pos = len(tokens)
                break
            label, child = edge
            n = int(min(len(label), len(tokens) - pos))
            common = 0
            while common < n and label[common] == tokens[pos + common]:
                common += 1
            if common == len(label):        # full edge consumed, descend
                node, pos = child, pos + common
                continue
            # split the edge at the divergence point
            mid = _Node(depth=pos + common)
            mid.edges[int(label[common])] = (label[common:], child)
            node.edges[first] = (label[:common].copy(), mid)
            node, pos = mid, pos + common
        if node.value is None:
            self._entries.append(node)
            self._size += len(tokens)
        node.value = value
        node.depth = len(tokens)
        node.tick = self._clock
        while self._size > self.capacity and len(self._entries) > 1:
            self._evict_lru(keep=node)

    def _evict_lru(self, keep: Optional[_Node] = None) -> None:
        victims = [e for e in self._entries if e is not keep]
        if not victims:
            return
        v = min(victims, key=lambda e: e.tick)
        self._entries.remove(v)
        self._size -= v.depth
        v.value = None                  # skeleton stays; snapshot released
        self._c_evict.inc()

    def clear(self) -> None:
        """Drop every stored snapshot (e.g. when the owning decode state
        is rebuilt with a different cache geometry — stale snapshots would
        shape-mismatch on restore)."""
        self._root = _Node()
        self._entries = []
        self._size = 0
