"""Deterministic, sharded, resumable data pipeline (a copy of the JAX
package's ``data/pipeline.py``, which is numpy only: the same tokens,
seed and step give the same batches in both packages).

Design for 1000+ hosts:
  * the corpus is addressed as (shard, offset) with a fixed document->shard
    assignment; every host computes its own slice from (step, host_id) —
    no coordinator, no communication;
  * the pipeline cursor is a pure function of `step`, so checkpoint resume
    is exact: restoring `step` reproduces the identical batch sequence
    (held against the JAX package in tests/test_torch_train.py);
  * straggler mitigation: `reassign(lost_hosts)` re-splits the lost hosts'
    shard ranges among survivors deterministically (same decision on every
    survivor — again no coordination).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Sequence

import numpy as np


@dataclass
class PipelineState:
    step: int = 0
    active_hosts: tuple = ()   # host ids currently serving data

    def to_dict(self):
        return {"step": self.step, "active_hosts": list(self.active_hosts)}

    @staticmethod
    def from_dict(d):
        return PipelineState(step=int(d["step"]),
                             active_hosts=tuple(d["active_hosts"]))


class TokenPipeline:
    """Serves (global_batch, seq_len+1) int32 token batches from a flat
    token array (memory-mapped in production; in-memory here)."""

    def __init__(self, tokens: np.ndarray, *, global_batch: int,
                 seq_len: int, n_hosts: int = 1, host_id: int = 0,
                 seed: int = 0):
        self.tokens = np.asarray(tokens, dtype=np.int32)
        self.global_batch = global_batch
        self.seq_len = seq_len
        self.n_hosts = n_hosts
        self.host_id = host_id
        self.seed = seed
        self.state = PipelineState(step=0,
                                   active_hosts=tuple(range(n_hosts)))
        n_windows = max(1, (self.tokens.size - 1) // seq_len)
        self._n_windows = n_windows

    # ------------------------------------------------------------ addressing
    def _window_ids(self, step: int) -> np.ndarray:
        """Deterministic global window assignment for `step` (all hosts
        agree without communication)."""
        rng = np.random.default_rng(self.seed + step)
        return rng.integers(0, self._n_windows, size=self.global_batch)

    def _host_slice(self, step: int) -> np.ndarray:
        """Rows of the global batch owned by this host under the current
        active-host set (lost hosts' rows re-split among survivors)."""
        hosts = self.state.active_hosts
        rows = np.arange(self.global_batch)
        owner = rows % len(hosts)
        return rows[np.asarray([hosts[o] for o in owner]) == self.host_id]

    def host_batch(self, step: Optional[int] = None) -> np.ndarray:
        """(rows_for_this_host, seq_len+1) int32."""
        step = self.state.step if step is None else step
        ids = self._window_ids(step)
        mine = self._host_slice(step)
        out = np.stack([
            self.tokens[i * self.seq_len:(i * self.seq_len) + self.seq_len + 1]
            for i in ids[mine]])
        return out

    def global_batch_array(self, step: Optional[int] = None) -> np.ndarray:
        """Full (global_batch, seq_len+1) — single-host mode / tests."""
        step = self.state.step if step is None else step
        ids = self._window_ids(step)
        return np.stack([
            self.tokens[i * self.seq_len:(i * self.seq_len) + self.seq_len + 1]
            for i in ids])

    def advance(self):
        self.state.step += 1

    # -------------------------------------------------------- fault handling
    def reassign(self, lost_hosts: Sequence[int]):
        """Straggler/failure mitigation: drop lost hosts; their batch rows
        are deterministically re-split among the survivors."""
        survivors = tuple(h for h in self.state.active_hosts
                          if h not in set(lost_hosts))
        if not survivors:
            raise RuntimeError("all hosts lost")
        self.state.active_hosts = survivors
