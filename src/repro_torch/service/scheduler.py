"""Slot-based continuous-batching scheduler (DESIGN.md §8).

One fixed-shape jitted decode program serves mixed compress/decompress
traffic: the B slots each hold one chunk-stream; every ``step()`` runs
exactly one model ``decode_step`` over all B lanes plus one vectorized
rANS coder step over the active lanes. The grouped decoder
(``LLMCompressor._decode_group``) runs every step to ``valid.max()`` of
its group, so one long chunk holds the other slots idle; here a finished
slot is refilled from the priority queue on the next step, and the model
program never recompiles (B is constant, the masks are runtime inputs).

Both directions share each step's CDF tables, computed once per step
from the same logits:

* decompress slots pull their next token from the rANS decoder
  (per-slot streams attached/detached on refill);
* compress slots run teacher-forced "exact" scoring (DESIGN.md §6):
  the ground-truth token is fed back, its (start, freq) interval
  recorded in the per-slot LIFO encoder, and the slot's stream is
  flushed the moment the chunk completes (out-of-order completion —
  the v4 index footer puts the chunks back in order).

Bit-exactness across batch compositions: each lane's logits are a
function of that lane's cache and input only (attention/SSM/MoE-dropless
are lane-independent by construction — the same property the lock-step
decoder already relies on), and per-slot cache positions make a refilled
lane's computation identical to a fresh-cache decode. So a container
compressed by the service decodes through ``LLMCompressor`` and vice
versa, regardless of what traffic shared the batch.

Telemetry (DESIGN.md §10): the scheduler owns a ``MetricsRegistry``
(private by default, injectable). Its load-bearing counters
(``scheduler.model_steps`` …) are ALWAYS maintained — ``SchedulerStats``
is now a thin attribute view over them — while everything optional
(per-slot code-length accrual for chunk diagnostics, the
``chunk.bits_per_token`` histogram, step spans, periodic progress lines)
is gated on ``registry.enabled``, and none of it can change output
bytes: every telemetry read happens *after* the coder ops it describes.
"""
from __future__ import annotations

import heapq

import numpy as np

from repro_torch import obs
from repro_torch.core import rans
from repro_torch.core.cdf import (DEFAULT_PRECISION, full_cdf, to_numpy,
                                  topk_cdf)
from repro_torch.core.compressor import ContainerError, escape_error
from repro_torch.models.transformer import decode_requires_lockstep
from repro_torch.obs import ChunkDiagnostics, MetricsRegistry
from .session import COMPRESS, ChunkTask

_HELP = {
    "model_steps": "fixed-shape decode_step invocations",
    "lane_steps": "model_steps x B (capacity offered)",
    "token_steps": "active-lane tokens actually coded",
    "chunks_completed": "chunk tasks finished (either direction)",
    "refills": "slot assignments from the queue",
    "chunk_failures": "chunk tasks that completed with an error",
    "escapes": "escape symbols coded (top-k mode, both directions)",
    "prefill_steps": "lane-steps spent consuming context prefixes (v6)",
}


class _CounterField:
    """Read/write attribute backed by a ``scheduler.<name>`` counter, so
    ``stats.model_steps += 1`` and ``registry.value(...)`` are one value."""

    __slots__ = ("metric",)

    def __init__(self, name: str):
        self.metric = "scheduler." + name

    def __get__(self, obj, objtype=None):
        if obj is None:
            return self
        return obj.registry.counter(self.metric).value

    def __set__(self, obj, v) -> None:
        obj.registry.counter(self.metric).value = v


class SchedulerStats:
    """Compatibility view over the scheduler's registry counters.

    Older code (tests, service_bench) reads and writes
    ``stats.model_steps`` etc. as plain attributes; those now pass
    through to ``scheduler.*`` counters in a ``MetricsRegistry``.
    Constructed standalone it carries its own private registry, so
    ``SchedulerStats()`` in one test cannot see another test's traffic.
    Calling the instance returns the structured snapshot.
    """

    model_steps = _CounterField("model_steps")
    lane_steps = _CounterField("lane_steps")
    token_steps = _CounterField("token_steps")
    chunks_completed = _CounterField("chunks_completed")
    refills = _CounterField("refills")
    chunk_failures = _CounterField("chunk_failures")
    escapes = _CounterField("escapes")
    prefill_steps = _CounterField("prefill_steps")

    def __init__(self, registry: MetricsRegistry | None = None):
        self.registry = registry if registry is not None \
            else MetricsRegistry(name="scheduler")
        for f in _HELP:
            self.registry.counter("scheduler." + f, _HELP[f])

    @property
    def steps(self) -> int:
        """Alias for ``model_steps`` (its older name)."""
        return self.model_steps

    @property
    def occupancy(self) -> float:
        """Fraction of offered lane-steps that coded a real token.
        0.0 when ``run()`` completed without executing a step (e.g. every
        job rejected at submit) — never a ZeroDivisionError."""
        lane = self.lane_steps
        if lane == 0:
            return 0.0
        return self.token_steps / lane

    def snapshot(self) -> dict:
        out = {f: getattr(self, f) for f in _HELP}
        out["occupancy"] = self.occupancy
        return out

    def __call__(self) -> dict:
        return self.snapshot()

    def __repr__(self) -> str:  # close to the old dataclass repr
        body = ", ".join(f"{f}={getattr(self, f)}" for f in _HELP)
        return f"SchedulerStats({body})"


class SlotScheduler:
    """Continuous-batching executor over ``n_slots`` model lanes.

    The scheduler is codec-fixed to rANS (codec id 1): the interleaved
    coder is what makes one vectorized coder step per position possible.
    Legacy AC containers take the grouped path in the service API.
    """

    #: emit a ``scheduler.progress`` log line every N model steps
    #: (0 disables; only when the registry is enabled)
    log_every = 4096

    #: time one full ``service.step`` span every N model steps (sampled:
    #: a per-step span costs more than the whole telemetry budget on a
    #: model-free predictor; the histogram notes the sampling rate)
    span_every = 16

    def __init__(self, predictor, *, n_slots: int, chunk_size: int,
                 topk: int = 0, precision: int = DEFAULT_PRECISION,
                 registry: MetricsRegistry | None = None,
                 prefix_cache=None, router=None):
        if not 0 < precision <= rans.MAX_PRECISION:
            raise ValueError(f"precision {precision} outside rANS range "
                             f"(1..{rans.MAX_PRECISION})")
        # The seq-sharded TP decode path collapses per-lane cache positions
        # to their max: lock-step only, and under slot refill it would
        # corrupt streams silently. Refuse up front (the predicate the
        # model's decode dispatch uses, so the two cannot drift); such
        # predictors take LLMCompressor's grouped decoder.
        cfg = getattr(predictor, "cfg", None)
        if cfg is not None and decode_requires_lockstep(
                cfg, getattr(predictor, "mesh", None)):
            raise ValueError(
                "continuous batching needs per-lane cache positions; the "
                "seq-sharded TP decode path (padded_kv_heads not divisible "
                "by TP) is lock-step only — use a replicated-cache "
                "predictor or LLMCompressor's grouped decoder")
        self.predictor = predictor
        self.B = int(n_slots)
        self.C = int(chunk_size)
        self.topk = int(topk)
        self.precision = int(precision)
        self._esc_bits = rans.uniform_bits(predictor.vocab_size)

        B, C = self.B, self.C
        self._queue: list = []          # heap of (priority, seq, task)
        self._seq = 0
        self._tasks: list[ChunkTask | None] = [None] * B
        self._active = np.zeros(B, bool)
        self._is_dec = np.zeros(B, bool)
        self._t = np.zeros(B, np.int64)         # next position per slot
        self._valid = np.zeros(B, np.int64)
        self._prev = np.zeros(B, np.int32)
        self._tok_buf = np.zeros((B, C), np.int32)   # per-slot chunk tokens
        self._dec = rans.BatchedRansDecoder([b""] * B)
        self._enc = rans.SlotRansEncoder(B)
        self._state = None              # model decode state, created lazily
        self._used = np.zeros(B, bool)  # lanes that have held a chunk
        # v6 context prefill: a slot whose _cpos < _ctxlen is consuming its
        # context prefix — it takes a model step but is excluded from both
        # coder masks; _ctx holds the per-slot context tokens and _cachekey
        # the prefix to snapshot into the radix cache once prefill ends
        self.prefix_cache = prefix_cache
        self.router = router            # probe-vs-realized calibration sink
        self._ctx: list = [None] * B
        self._ctxlen = np.zeros(B, np.int64)
        self._cpos = np.zeros(B, np.int64)
        self._cachekey: list = [None] * B
        # decode-length geometry the model state was built for: every
        # lane runs at chunk_size + _ctx_budget positions. Cache length
        # is coding geometry (it changes the jitted program's logits
        # bitwise), so this must equal each job's recorded ctx_budget
        # exactly — not merely bound it
        self._ctx_budget = 0
        self.registry = registry if registry is not None \
            else MetricsRegistry(name="scheduler")
        self.stats = SchedulerStats(self.registry)
        # hot-path counters, resolved once (property/setter would re-hash
        # the metric name every model step)
        self._c_steps = self.registry.counter("scheduler.model_steps")
        self._c_lanes = self.registry.counter("scheduler.lane_steps")
        self._c_tokens = self.registry.counter("scheduler.token_steps")
        self._c_chunks = self.registry.counter("scheduler.chunks_completed")
        self._c_refills = self.registry.counter("scheduler.refills")
        self._c_failures = self.registry.counter("scheduler.chunk_failures")
        self._c_escapes = self.registry.counter("scheduler.escapes")
        self._c_prefill = self.registry.counter("scheduler.prefill_steps")
        self._h_bpt = self.registry.histogram(
            "chunk.bits_per_token", "realized payload bits/token per chunk")
        self._h_step = self.registry.histogram(
            "span.service.step.seconds",
            f"wall seconds per scheduler step (1-in-{self.span_every} "
            f"sampled; every step while a timeline recorder is installed)")
        # per-slot diagnostics accrual (registry.enabled only). Decode
        # lanes: the coder's interval freq for position t lands in
        # _fbuf[b, t] (one fancy write per step, all log2 math deferred
        # to _finish_slot); compress lanes cost nothing per step — the
        # slot encoder's recorded steps are priced at flush. _nesc
        # counts escape symbols per slot (both directions).
        self._lanes = np.arange(B)
        self._fbuf = np.ones((B, C), np.int64)
        self._nesc = np.zeros(B, np.int64)
        # router-decision counters (DESIGN.md §11) — only move when the
        # service submits routed chunks (task.fallback attached)
        self._c_route_llm = self.registry.counter(
            obs.ROUTER_CHUNKS_LLM, "chunks routed to the LLM entropy path")
        self._c_route_fb = self.registry.counter(
            obs.ROUTER_CHUNKS_FALLBACK,
            "chunks routed to a fallback byte codec")
        self._c_route_flips = self.registry.counter(
            obs.ROUTER_FLIPS,
            "chunks where LLM encode ran but the fallback stream won")

    # ------------------------------------------------------------- intake
    def submit(self, task: ChunkTask, priority: int = 0) -> None:
        if task.valid == 0:         # empty chunk: no coded bytes, no slot
            task.complete(b"" if task.kind == COMPRESS
                          else np.zeros(0, np.int32))
            return
        need = int(getattr(task, "ctx_budget", 0))
        if need != self._ctx_budget:
            # geometry change: rebuild the model state while fully idle
            # (queued work counts as busy — its chunks must encode at the
            # geometry they were submitted under), never mid-flight
            if self._state is not None:
                if self._active.any() or self._queue:
                    raise ValueError(
                        f"task needs context budget {need} but the decode "
                        f"state runs at {self._ctx_budget} with work in "
                        f"flight; drain before mixing context geometries")
                self._state = None
                if self.prefix_cache is not None:
                    self.prefix_cache.clear()   # snapshots shape-mismatch
            self._ctx_budget = need
        ctx = getattr(task, "ctx", None)
        if ctx is not None and ctx.size > need:
            raise ValueError(
                f"chunk {task.chunk_index}: context of {ctx.size} tokens "
                f"exceeds the job's declared budget ({need})")
        if task.kind != COMPRESS and len(task.stream) < rans._STATE_BYTES:
            # any chunk that coded >= 1 token carries at least the coder
            # state flush; shorter means a corrupt length varint — fail at
            # submit, not mid-step in a shared batch (where the attach
            # would raise a bare ValueError and strand the slot)
            raise ContainerError(
                f"chunk {task.chunk_index}: stream of {len(task.stream)} "
                f"bytes cannot code {task.valid} tokens (corrupt container)")
        heapq.heappush(self._queue, (priority, self._seq, task))
        self._seq += 1

    @property
    def idle(self) -> bool:
        return not self._queue and not self._active.any()

    # -------------------------------------------------------------- slots
    def _ensure_state(self):
        if self._state is None:
            if hasattr(self.predictor, "set_decode_len"):
                self.predictor.set_decode_len(self.C + self._ctx_budget)
            self._state = self.predictor.begin_decode(self.B)

    def _refill(self) -> None:
        """Assign queued chunk tasks to free slots; reset their cache
        lanes to a fresh context in ONE jitted call (mask input)."""
        free = np.nonzero(~self._active)[0]
        if not free.size or not self._queue:
            return
        # timeline-only span (DESIGN.md §13): placed after the idle early-
        # out so it marks productive refills, not every step's free-slot
        # check — the recording leg's overhead budget is 10%
        sp = obs.span("service.refill", self.registry, mirror=False) \
            if obs.timeline.active() is not None else obs.trace.NULL
        with sp:
            self._refill_slots(free)

    def _refill_slots(self, free) -> None:
        mask = np.zeros(self.B, bool)
        bos = getattr(self.predictor, "bos_id")
        restores: list[tuple[int, object]] = []
        for b in free:
            if not self._queue:
                break
            _, _, task = heapq.heappop(self._queue)
            self._tasks[b] = task
            self._active[b] = True
            self._is_dec[b] = task.kind != COMPRESS
            self._t[b] = 0
            self._valid[b] = task.valid
            self._prev[b] = bos
            self._nesc[b] = 0
            self._ctx[b] = None
            self._ctxlen[b] = self._cpos[b] = 0
            self._cachekey[b] = None
            ctx = getattr(task, "ctx", None)
            if ctx is not None and ctx.size:
                ctx = np.asarray(ctx, np.int32).ravel()
                L = len(ctx)
                self._ctx[b] = ctx
                self._ctxlen[b] = L
                can_cache = (self.prefix_cache is not None
                             and hasattr(self.predictor, "restore_slot"))
                if can_cache and getattr(task, "cacheable", False):
                    with obs.span("prefix_cache.lookup", self.registry,
                                  mirror=False) \
                            if obs.timeline.active() is not None \
                            else obs.trace.NULL:
                        matched, snap = self.prefix_cache.lookup(ctx)
                    if matched:
                        # resume from the stored post-prefill state: the
                        # snapshot's cache consumed [BOS, ctx[:matched-1]]
                        # and ctx[matched-1] is the next decode input
                        restores.append((b, snap))
                        self._cpos[b] = matched
                        self._prev[b] = ctx[matched - 1]
                    if matched < L:
                        self._cachekey[b] = ctx
            if task.kind == COMPRESS:
                self._tok_buf[b, :] = 0
                self._tok_buf[b, :task.valid] = task.tokens
                self._dec.detach(b)
            else:
                self._dec.attach(b, task.stream)
            mask[b] = True
            self._c_refills.inc()
        if mask.any() and self._state is not None:
            if hasattr(self.predictor, "reset_slots"):
                self._state = self.predictor.reset_slots(self._state, mask)
            elif (mask & self._used).any():
                # a stateful predictor without per-slot reset would hand a
                # refilled lane the previous chunk's context — corrupt
                # streams with no error. Refuse rather than degrade.
                raise ValueError(
                    "stateful predictor lacks reset_slots(state, mask); "
                    "slot refill needs a per-lane cache reset (see "
                    "serve/engine.ModelPredictor) — or use the grouped "
                    "decoder")
        if self._state is not None:
            for b, snap in restores:    # after reset: restore overwrites
                lane = np.zeros(self.B, bool)
                lane[b] = True
                self._state = self.predictor.restore_slot(self._state, snap,
                                                          lane)
        self._used |= mask

    # --------------------------------------------------------------- step
    def step(self) -> bool:
        """One fixed-shape model step + one coder step over all active
        slots. Returns False when there was nothing to do."""
        tel = self.registry.enabled
        # a live timeline recorder lifts the 1-in-N span sampling: phase
        # attribution needs every step on the timeline (≥90% coverage),
        # and the recording leg has its own ≤10% overhead budget
        rec = obs.timeline.active()
        sp = obs.span("service.step", self.registry,
                      mirror=rec is None) \
            if rec is not None or (tel and self.span_every
                                   and self._c_steps.value
                                   % self.span_every == 0) else obs.trace.NULL
        with sp:
            self._ensure_state()
            self._refill()
            m = self._active
            if not m.any():
                return False
            # model phase attribution: only worth a span while a timeline
            # is recording (serve/steps.py predictors carry their own
            # model.* spans; plain predictors would otherwise attribute
            # model time to the scheduler)
            msp = obs.span("model.decode_step", self.registry,
                           mirror=False) \
                if rec is not None else obs.trace.NULL
            with msp:
                # the logits stay on the predictor's device: the CDF
                # kernels below read them there, and only the (B, K+2)
                # tables cross to the host
                logits, self._state = self.predictor.decode_step(
                    self._state, self._prev)
            pm = m & (self._cpos < self._ctxlen)     # prefilling context
            am = m & ~pm                             # coding this step
            dm = am & self._is_dec
            cm = am & ~self._is_dec
            tq = self._t % self.C
            truth = self._tok_buf[self._lanes, tq]
            # timeline-only span: the CDF tables' build and transfer and
            # the host rANS step (the "coder" phase of a PhaseReport)
            csp = obs.span("coder.step", self.registry, mirror=False) \
                if rec is not None else obs.trace.NULL
            with csp:
                if self.topk:
                    # fused device top-k -> quantized CDF (kernels/ac_cdf.py on
                    # TPU): no host pmf cumsum per step; same integers
                    ids, cdfs = topk_cdf(logits, self.topk, self.precision)
                    ids = to_numpy(ids)
                    cdfs = to_numpy(cdfs).astype(np.int64)           # (B, K+2)
                    syms = np.zeros(self.B, np.int64)
                    if dm.any():
                        slots = self._dec.get(cdfs, self.precision, dm)
                        if tel:   # coder-computed interval freqs, one write
                            self._fbuf[self._lanes, tq] = self._dec.last_freq
                        esc = dm & (slots == self.topk)
                        syms = np.take_along_axis(
                            ids, np.minimum(slots, self.topk - 1)[:, None],
                            axis=-1)[:, 0].astype(np.int64)
                        if esc.any():
                            u = self._dec.get_uniform(self._esc_bits, esc)
                            # an id past the vocabulary (a wrong model or
                            # kernel version) fails its chunk here, on the
                            # host, before it can reach the embedding gather
                            bad = esc & (u >= self.predictor.vocab_size)
                            for b in np.nonzero(bad)[0]:
                                self._finish_slot(int(b), escape_error(
                                    self._tasks[b].chunk_index, int(u[b]),
                                    self.predictor.vocab_size))
                            if bad.any():
                                esc &= ~bad
                                m, dm, am = m & ~bad, dm & ~bad, am & ~bad
                            syms = np.where(esc, u, syms)
                            self._c_escapes.inc(int(esc.sum()))
                            if tel:
                                self._nesc[esc] += 1
                    if cm.any():
                        match = ids == truth[:, None]
                        has = match.any(axis=-1)
                        slot_e = np.where(has, match.argmax(axis=-1),
                                          self.topk)
                        starts = np.take_along_axis(cdfs, slot_e[:, None],
                                                    axis=1)[:, 0]
                        ends = np.take_along_axis(cdfs, slot_e[:, None] + 1,
                                                  axis=1)[:, 0]
                        self._enc.put(starts, ends - starts, self.precision,
                                      cm)
                        em = cm & ~has
                        if em.any():
                            self._enc.put_uniform(truth, self._esc_bits, em)
                            self._c_escapes.inc(int(em.sum()))
                            if tel:
                                self._nesc[em] += 1
                else:
                    cdfs = to_numpy(full_cdf(logits, self.precision)
                                    ).astype(np.int64)            # (B, V+1)
                    syms = np.zeros(self.B, np.int64)
                    if dm.any():
                        syms = self._dec.get(cdfs, self.precision, dm)
                        if tel:
                            self._fbuf[self._lanes, tq] = self._dec.last_freq
                    if cm.any():
                        self._enc.put_symbols(truth.astype(np.int64), cdfs,
                                              self.precision, cm)
            # write decoded tokens; advance every coding lane. Prefill
            # lanes feed their next context token instead — their logits
            # this step are discarded (context conditioning only).
            nxt = np.where(dm, syms, truth).astype(np.int32)
            for b in np.nonzero(pm)[0]:
                nxt[b] = self._ctx[b][self._cpos[b]]
            self._tok_buf[dm, self._t[dm]] = nxt[dm]
            self._prev = np.where(m, nxt, self._prev).astype(np.int32)
            self._t[am] += 1
            self._cpos[pm] += 1
            self._c_steps.inc()
            self._c_lanes.inc(self.B)
            self._c_tokens.inc(int(am.sum()))
            if pm.any():
                self._c_prefill.inc(int(pm.sum()))
                for b in np.nonzero(pm & (self._cpos >=
                                          self._ctxlen))[0]:
                    # prefix fully consumed this step: the lane's cache now
                    # equals begin_decode(prefix=ctx) — snapshot it at the
                    # boundary so later jobs skip this prefill entirely
                    key = self._cachekey[int(b)]
                    if key is not None and self.prefix_cache is not None \
                            and hasattr(self.predictor, "snapshot_slot"):
                        self.prefix_cache.insert(
                            key, self.predictor.snapshot_slot(self._state,
                                                              int(b)))
                    self._cachekey[int(b)] = None
            for b in np.nonzero(m & (self._t >= self._valid))[0]:
                b = int(b)
                fin = self._tasks[b]
                with obs.span("service.finish_slot", self.registry,
                              tags={"job": fin.job.job_id,
                                    "chunk": fin.chunk_index},
                              mirror=False) \
                        if rec is not None else obs.trace.NULL:
                    self._finish_slot(b)
        if tel and self.log_every \
                and self._c_steps.value % self.log_every == 0:
            obs.log("scheduler.progress", steps=self._c_steps.value,
                    occupancy=round(self.stats.occupancy, 4),
                    chunks=self._c_chunks.value,
                    queued=len(self._queue),
                    failures=self._c_failures.value)
        return True

    def _finish_slot(self, b: int, error: Exception | None = None) -> None:
        """Complete slot ``b``'s task and free the slot; with ``error``,
        fail the task with it instead."""
        task = self._tasks[b]
        codec = None
        try:
            if error is not None:
                raise error
            coded = 0.0
            tel = self.registry.enabled
            if task.kind == COMPRESS:
                if tel:     # price the recorded steps before flush clears
                    coded = self._enc.slot_cost_bits(b)
                result = self._enc.flush_slot(b)
                nbytes = len(result)
                if task.fallback is not None and self.router is not None \
                        and getattr(task, "llm_bits_est", -1.0) >= 0:
                    # probe-vs-realized calibration for the adaptive skip
                    # margin — before the flip overwrites the LLM length
                    self.router.observe(task.llm_bits_est, 8.0 * nbytes,
                                        len(task.fallback))
                if task.fallback is not None:
                    # routed chunk: the probe kept the LLM path, but the
                    # realized fallback stream still wins if smaller —
                    # flip post-hoc (lane count stays coding geometry;
                    # lane composition is free, DESIGN.md §11)
                    if len(task.fallback) < nbytes:
                        result = task.fallback
                        nbytes = len(result)
                        codec = task.fallback_codec
                        coded = 8.0 * nbytes
                        self._c_route_fb.inc()
                        self._c_route_flips.inc()
                    else:
                        self._c_route_llm.inc()
            else:
                if not self._dec.exhausted(b):
                    raise ContainerError(
                        f"chunk {task.chunk_index}: rANS stream not "
                        f"exhausted after {task.valid} tokens (corrupt "
                        f"stream, wrong model, or a slot count different "
                        f"from the encoder's batch — see the container's "
                        f"recorded encode batch)")
                self._dec.detach(b)
                result = self._tok_buf[b, :task.valid].copy()
                nbytes = len(task.stream)
                if tel:     # deferred log2 over the chunk's coder freqs
                    f = np.maximum(self._fbuf[b, :task.valid], 1)
                    coded = (task.valid * self.precision
                             - float(np.log2(f).sum())
                             + int(self._nesc[b]) * self._esc_bits)
            diag = None
            if tel:
                ctx_name = ""
                rk, rp = getattr(task, "recipe", (0, 0))
                if rk and not codec:    # flipped chunks are context-free
                    ctx_name = f"carry({rp})" if rk == 1 else f"shared[{rp}]"
                diag = ChunkDiagnostics(
                    chunk_index=task.chunk_index, n_tokens=task.valid,
                    stream_bytes=nbytes, coded_bits=float(coded),
                    n_escapes=int(self._nesc[b]),
                    codec=codec or "rans", context=ctx_name)
                self._h_bpt.observe(diag.bits_per_token)
            task.complete(result, diag, codec=codec)
        except Exception as e:
            self._c_failures.inc()
            obs.log_exception("scheduler.chunk_failed", e,
                              job=task.job.job_id, chunk=task.chunk_index,
                              kind=task.kind)
            task.fail(e)
        self._tasks[b] = None
        self._active[b] = False
        self._is_dec[b] = False
        self._ctx[b] = None
        self._ctxlen[b] = self._cpos[b] = 0
        self._cachekey[b] = None
        self._c_chunks.inc()

    def run(self) -> SchedulerStats:
        """Drain queue + slots to completion."""
        while self.step():
            pass
        return self.stats
