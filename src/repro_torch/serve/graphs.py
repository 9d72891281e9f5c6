"""Captured decode programs: the port's counterpart of the JAX engine's
jitted step programs (``src/repro/serve/engine.py`` ``_decode``,
``_prefill`` and ``_verify``).

An eager decode step issues one host launch per operator (2,593 for
qwen3-1.7b, 1,121 for mamba2-130m, 4,530 for zamba2-7b's 81 SSD layers
and 6 shared-block applications), and the card idles while the host
issues them. On the card, ``ModelPredictor`` therefore runs each step as
the replay of one CUDA graph, captured over the storage of one cache:

* ``DecodePrograms.fresh_cache(B, S)`` hands out a decode cache. A cache
  whose last holder has let it go is handed out again, zeroed in place,
  together with the graphs captured over it: the grouped compressor opens
  a cache per group of chunks, and captures once per (B, S).
* ``step(cache, prev)`` copies ``prev`` (B,) into a static device buffer
  and replays the captured step. The logits come back in a static (B, V)
  buffer that the next call on the same cache overwrites: read them, or
  copy them, before the next call.
* ``verify(cache, seq)`` replays T steps captured as one graph (one graph
  per T), with the copies a rollback needs, so a speculative round is one
  launch, as the JAX verify program is one dispatch. Its logits (B, T, V)
  and its ``Snapshots`` are static too: the next verify overwrites them.
  The copies are each whole leaf that ``rollback_leaves`` names (``pos``;
  an SSM's conv and state) after every step, and, in a ring cache (a
  sliding window: ``ring_leaves``), the T rows per lane and layer that
  the round will overwrite, taken before its first step. The JAX verify
  keeps T + 1 copies of the whole cache instead; a ring of 4096 slots at
  full width is GBs, so the port keeps only the rows a rollback needs.

Capture. A graph reads and writes fixed addresses, so every cache leaf
keeps its storage: the models write in place, and ``_slot`` refuses a
cache that ``fresh_cache`` did not hand out, or whose leaves were
rebound. Before capture the body runs once
eagerly on the capture stream, with the cache leaves saved and restored
around it. That builds and loads every kernel, makes each kernel's
``cudaFuncSetAttribute`` and cuBLAS's workspace for the stream (none of
which may happen under capture), and leaves the caller's cache stepped
exactly once per call. Python's cyclic garbage collector is paused while
a graph is captured: a predictor that only a reference cycle still holds
(its programs refer back to it) would otherwise be collected at any
allocation of the body, and destroying its graphs in the middle of
another capture invalidates that capture (seen on the card: graph
resets refused "while the stream is capturing", then the capture
failed). A failed capture raises: nothing falls back to the eager step
on the card.

Launch counting. ``kernels.ops.LAUNCHES`` counts in Python, where a
wrapper launches its kernel. Under capture nothing launches, so the
capture's own increments are taken back; each program records how many
launches of each kernel it holds and adds them at every replay. The
warm-up launches for real and counts as such. ``STATS`` counts captures
(with their host ms, warm-up included), the decode steps their warm-ups
ran, and the replays of each kind, so that a kernel's launches are
(replayed steps + warm-up steps) x its launches per step. A captured
step holds ``decode_attention`` n_layers times for the dense and moe
families, never for the ssm family (its step is the recurrence) and once
per application of the shared block for the hybrid (6 for zamba2-7b).
"""
from __future__ import annotations

import gc
import time
import weakref

import numpy as np
import torch

from repro_torch.kernels import ops

#: captures, their host ms (warm-up included), the decode steps their
#: warm-ups ran, and replays of each kind
STATS = {"captures": 0, "capture_ms": 0.0, "warmup_steps": 0,
         "step_replays": 0, "verify_replays": 0}


def reset_stats() -> None:
    STATS.update(captures=0, capture_ms=0.0, warmup_steps=0,
                 step_replays=0, verify_replays=0)


class Program:
    """One CUDA graph of ``body()`` (``steps`` decode steps) over the
    tensors of ``leaves``, which the body may write in place; ``replay()``
    returns the body's output, held in the graph's own memory."""

    def __init__(self, body, leaves: dict, stream: torch.cuda.Stream,
                 kind: str, steps: int):
        t0 = time.perf_counter()
        self.kind = kind
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream):
            saved = {k: v.clone() for k, v in leaves.items()}
            body()                              # the warm-up
            for k, v in leaves.items():
                v.copy_(saved[k])
            del saved
        torch.cuda.current_stream().wait_stream(stream)
        before = dict(ops.LAUNCHES)
        self.graph = torch.cuda.CUDAGraph()
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(self.graph, stream=stream):
                self.out = body()
        finally:
            if collecting:
                gc.enable()
            # nothing launched under capture: keep what the graph holds
            self.launches = {k: n - before[k]
                             for k, n in ops.LAUNCHES.items()
                             if n != before[k]}
            ops.LAUNCHES.update(before)
        STATS["captures"] += 1
        STATS["warmup_steps"] += steps
        STATS["capture_ms"] += (time.perf_counter() - t0) * 1e3

    def replay(self):
        self.graph.replay()
        for k, n in self.launches.items():
            ops.LAUNCHES[k] += n
        STATS[f"{self.kind}_replays"] += 1
        return self.out


class Snapshots:
    """What ``verify`` returns for ``rollback``: the live cache; per leaf
    that a rollback restores whole, its value before the round and after
    each of its T steps, (T + 1, *leaf.shape); and, for a ring cache,
    ``ring``: the slots the round wrote, "slots" (B, T), and per ring
    leaf the rows those slots held before it, (L, B, T, ...)."""

    def __init__(self, state: dict, leaves: dict, ring: dict | None = None):
        self.state = state
        self.leaves = leaves
        self.ring = ring or {}


def verify_body(eager_step, cache: dict, seq: torch.Tensor, names,
                ring=()):
    """T = seq.shape[0] eager decode steps over ``cache`` (inputs seq[t],
    (B,) each), with the leaves ``names`` copied before the first step
    and after each, and the rows of the ``ring`` leaves ((L, B, S, ...),
    a sliding-window cache) that the steps will overwrite, slots (pos +
    t) % S, copied before the first: (logits (B, T, V), {name: (T + 1,
    *leaf.shape)}, {"slots": (B, T), name: (L, B, T, ...)} or {}). The
    slots of one round must be distinct, so T <= S."""
    T = seq.shape[0]
    snaps = {k: torch.empty((T + 1,) + cache[k].shape,
                            dtype=cache[k].dtype, device=cache[k].device)
             for k in names}
    for k in names:
        snaps[k][0].copy_(cache[k])
    rows = {}
    if ring:
        S = cache[ring[0]].shape[2]
        if T > S:
            raise ValueError(f"verify: {T} steps would overwrite their own "
                             f"slots in a ring of {S}")
        pos = cache["pos"]
        slots = (pos.long()[:, None] + torch.arange(
            T, device=pos.device)) % S
        lanes = torch.arange(pos.shape[0], device=pos.device)[:, None]
        rows = {"slots": slots}
        rows.update({k: cache[k][:, lanes, slots] for k in ring})
    steps = []
    for t in range(T):
        steps.append(eager_step(cache, seq[t]))
        for k in names:
            snaps[k][t + 1].copy_(cache[k])
    return torch.stack(steps, dim=1), snaps, rows


def rollback(snaps: Snapshots, accepted) -> dict:
    """Lane b of the cache takes the value it had after ``accepted[b]``
    of the round's inputs (0: before the round), in place: the whole
    leaves from the snapshot after that many steps, and in a ring the
    slots of steps accepted[b]..T-1 from their rows before the round
    (the steps before those wrote the same values in lock-step)."""
    state = snaps.state
    pos = state["pos"]
    acc = np.asarray(accepted, np.int64).ravel()
    T = next(iter(snaps.leaves.values())).shape[0] - 1
    if acc.shape != tuple(pos.shape) or acc.min(initial=0) < 0 \
            or acc.max(initial=0) > T:
        raise ValueError(f"rollback: accepted {acc.tolist()} must give "
                         f"each of {pos.shape[0]} lanes a count in [0, {T}]")
    acc_t = torch.as_tensor(acc, device=pos.device)
    lanes = torch.arange(pos.shape[0], device=pos.device)
    for k, s in snaps.leaves.items():
        if k == "pos":
            state[k].copy_(s[acc_t, lanes])
        else:                       # (T+1, L, B, ...) -> (B, L, ...)
            state[k].copy_(s[acc_t, :, lanes].transpose(0, 1))
    if snaps.ring:
        b, t = np.nonzero(np.arange(T)[None, :] >= acc[:, None])
        if b.size:
            b = torch.as_tensor(b, device=pos.device)
            t = torch.as_tensor(t, device=pos.device)
            slots = snaps.ring["slots"][b, t]
            for k, rows in snaps.ring.items():
                if k != "slots":
                    state[k][:, b, slots] = rows[:, b, t]
    return state


class DecodeCache(dict):
    """A decode cache handed out on the card: the leaves of
    ``models.api.init_cache``, whose storage the graphs of ``slot`` were
    captured over."""


class _Slot:
    """Cache leaves on the card and the programs captured over them."""

    def __init__(self, leaves: dict):
        self.leaves = dict(leaves)
        self.holder = None          # weakref to the DecodeCache handed out
        self.prev = None            # static (B,) int64 step input
        self.step = None            # the captured step
        self.verify = {}            # T -> (static (T, B) input, program)


class DecodePrograms:
    """The captured step and verify programs of one predictor on the card.

    ``init_cache(B, S)`` makes cache leaves; ``eager_step(cache, prev)``
    is the eager step body (logits (B, V)); ``names`` are the leaves that
    a rollback restores whole, ``ring`` the ring leaves whose overwritten
    rows it puts back."""

    def __init__(self, init_cache, eager_step, names, device, ring=()):
        self._init = init_cache
        self._eager = eager_step
        self._names = tuple(names)
        self._ring = tuple(ring)
        self._device = device
        self._stream = torch.cuda.Stream(device)
        self._slots: dict[tuple, list[_Slot]] = {}

    def fresh_cache(self, batch: int, max_len: int) -> DecodeCache:
        """A zeroed cache of ``batch`` lanes and ``max_len`` positions:
        one that no caller holds any longer, zeroed in place, or a new
        one."""
        slots = self._slots.setdefault((batch, max_len), [])
        slot = self._free(slots)
        if slot is None and slots:
            # a holder that only a reference cycle keeps (a finished
            # service and its jobs) is let go before a new capture
            gc.collect()
            slot = self._free(slots)
        if slot is None:
            slot = _Slot(self._init(batch, max_len))
            slots.append(slot)
        else:
            for leaf in slot.leaves.values():
                leaf.zero_()
        cache = DecodeCache(slot.leaves)
        cache.slot = slot
        slot.holder = weakref.ref(cache)
        return cache

    @staticmethod
    def _free(slots):
        return next((s for s in slots if s.holder() is None), None)

    @staticmethod
    def _slot(cache: dict) -> _Slot:
        slot = getattr(cache, "slot", None)
        if slot is None:
            raise ValueError("a decode cache on the card comes from "
                             "begin_decode, which captures its programs")
        if cache.keys() != slot.leaves.keys() or any(
                slot.leaves[k] is not v for k, v in cache.items()):
            raise ValueError(
                "decode cache leaves were rebound: a captured step reads "
                "the storage it was captured over, so every leaf must be "
                "written in place")
        return slot

    @staticmethod
    def _check_in_place(slot: _Slot, view: dict) -> None:
        """A body runs on a copy of the slot's leaf dict: it must not have
        put a new tensor in it."""
        if any(view[k] is not v for k, v in slot.leaves.items()):
            raise RuntimeError("the decode step rebound a cache leaf; a "
                               "captured step needs every leaf written in "
                               "place")

    def step(self, cache: dict, prev) -> torch.Tensor:
        """One captured decode step: logits (B, V), overwritten by the
        next call on this cache."""
        slot = self._slot(cache)
        if slot.step is None:
            slot.prev = torch.zeros(cache["pos"].shape, dtype=torch.int64,
                                    device=self._device)

            def body():
                view = dict(slot.leaves)
                out = self._eager(view, slot.prev)
                self._check_in_place(slot, view)
                return out
            slot.step = Program(body, slot.leaves, self._stream, "step", 1)
        # pageable source: staged at once, no wait for the stream
        slot.prev.copy_(torch.from_numpy(np.ascontiguousarray(prev,
                                                              np.int64)),
                        non_blocking=True)
        return slot.step.replay()

    def verify(self, cache: dict, seq: np.ndarray):
        """``seq`` (B, T) through T captured steps in one replay: (logits
        (B, T, V), Snapshots), both overwritten by the next verify of the
        same T on this cache."""
        slot = self._slot(cache)
        B, T = seq.shape
        if T not in slot.verify:
            inp = torch.zeros((T, B), dtype=torch.int64, device=self._device)

            def body():
                view = dict(slot.leaves)
                out = verify_body(self._eager, view, inp, self._names,
                                  self._ring)
                self._check_in_place(slot, view)
                return out
            slot.verify[T] = (inp, Program(body, slot.leaves, self._stream,
                                           "verify", T))
        inp, prog = slot.verify[T]
        inp.copy_(torch.from_numpy(np.ascontiguousarray(
            np.asarray(seq, np.int64).T)), non_blocking=True)
        logits, snaps, rows = prog.replay()
        return logits, Snapshots(cache, snaps, rows)
