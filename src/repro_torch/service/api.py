"""Public API of the compression service: submit → await.

``CompressionService`` owns one predictor (one jitted model program at a
fixed slot count) and multiplexes any number of concurrent compress and
decompress jobs through the continuous-batching scheduler. Results come
back through ``JobHandle.result()``, which cooperatively drives the
scheduler until that job completes — submit many handles first, then
await them in any order, and all jobs share every model step.

Containers: writes v4 (seekable index footer + xxh64 checksums; the
out-of-order chunk completion of the scheduler needs the index anyway),
or v5 when adaptive routing is on (``route != "llm"`` — per-chunk codec
tags, DESIGN.md §11). Routing happens at submit: every chunk's realized
best-fallback stream is built up front, the probe marks poorly-modelled
chunks, and those complete *immediately* — they never occupy a model
slot, so unpredictable traffic stops costing model steps. Chunks that do
enter the batch still flip to their fallback at completion if the
fallback stream turned out smaller (``SlotScheduler._finish_slot``).

Context (v6, DESIGN.md §12): ``submit_compress(shared_prefix=...,
context_window=W)`` upgrades the job's container to v6 with per-chunk
context recipes. Shared prefixes prefill once per slot wave and are
snapshotted into a radix prefix cache (``service.prefix_cache``), so
jobs sharing a system prompt/template reuse one prefilled KV prefix —
``prefix_cache.hits``/``misses``/``evictions`` count the reuse.

Reads v2–v6; legacy AC-codec containers (and all v2 archives) cannot
ride the interleaved-rANS slot machine, so they are decoded eagerly at
submit time through the grouped path — same result, no await needed;
v6 archives with carried/shared recipes take the same eager grouped
path (carry chains need in-order predecessors, not out-of-order slots).
Fallback-tagged v5/v6 chunks similarly decode eagerly at submit (they
need no model); only the LLM-tagged chunks are queued.
AC archives above the rANS precision cap can't construct a matching
service at all (the cap guards the service's own rANS coding) — decode
those through ``LLMCompressor`` directly, as the ``llmc`` CLI does.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core import rans
from repro_torch.core.cdf import DEFAULT_PRECISION
from repro_torch.core.compressor import (CODEC_AC, CODEC_RANS,
                                         FALLBACK_CODEC_IDS, RECIPE_NONE,
                                         RECIPE_SHARED, VERSION_V4, VERSION_V5,
                                         VERSION_V6, CompressionStats,
                                         ContainerError, LLMCompressor,
                                         assign_context_recipes,
                                         check_container_config, context_budget,
                                         chunk_valid_lengths, parse_container,
                                         recipe_context, write_container)
from repro_torch.core.router import (ROUTE_AUTO, ROUTE_LLM, CodecRouter,
                                     RouterConfig, route_chunks)
from repro_torch.device import resolve_device
from repro_torch.obs import MetricsRegistry
from .prefix_cache import RadixPrefixCache
from .scheduler import SlotScheduler
from .session import COMPRESS, DECOMPRESS, ChunkTask, Job, JobHandle


class ServiceError(RuntimeError):
    """Internal service failure (scheduler stall, double completion)."""


class ServiceStats:
    """``service.stats`` — both the old attribute API and the new
    structured snapshot.

    Attribute reads (``svc.stats.occupancy``, ``svc.stats.model_steps``)
    delegate to the scheduler's counter-backed ``SchedulerStats`` view,
    so older callers are unchanged; *calling* it
    (``svc.stats()``) returns the full structured snapshot dict —
    the ``CompressionService.stats()`` surface."""

    __slots__ = ("_service",)

    def __init__(self, service: "CompressionService"):
        self._service = service

    def __getattr__(self, name):
        return getattr(self._service.scheduler.stats, name)

    def __call__(self) -> dict:
        return self._service.snapshot()

    def __repr__(self) -> str:
        return f"ServiceStats({self._service.scheduler.stats!r})"


class CompressionService:
    """Continuous-batching compression/decompression server over one
    predictor. See repro.service.__init__ for usage."""

    def __init__(self, predictor, *, slots: int = 8, chunk_size: int = 256,
                 topk: int = 0, precision: int = DEFAULT_PRECISION,
                 container_version: int | None = None,
                 route: str = ROUTE_LLM,
                 router: CodecRouter | RouterConfig | None = None,
                 registry: MetricsRegistry | None = None,
                 prefix_cache_tokens: int = 1 << 16,
                 trace: "str | obs.TimelineRecorder | None" = None,
                 device=None):
        # the card unless the caller asks for the CPU; a predictor that
        # names its device must live there too
        self.device = resolve_device(device)
        pdev = getattr(predictor, "device", None)
        if pdev is not None and torch.device(pdev).type != self.device.type:
            raise ValueError(f"predictor runs on {pdev}, service on "
                             f"{self.device}")
        if topk and topk >= predictor.vocab_size:
            topk = 0
        if (1 << precision) <= (topk + 1 if topk else predictor.vocab_size):
            raise ValueError("precision too small for alphabet")
        if precision > rans.MAX_PRECISION:
            raise ValueError(f"precision {precision} exceeds rANS coder "
                             f"limit {rans.MAX_PRECISION}")
        if route not in (ROUTE_LLM, ROUTE_AUTO) \
                and route not in FALLBACK_CODEC_IDS:
            raise ValueError(
                f"unknown route {route!r} (choose 'llm', 'auto', or a "
                f"fallback codec from {sorted(FALLBACK_CODEC_IDS)})")
        if container_version is None:
            container_version = VERSION_V4 if route == ROUTE_LLM \
                else VERSION_V5
        if route != ROUTE_LLM and container_version < VERSION_V5:
            raise ValueError(
                f"route={route!r} requires a v5+ container (per-chunk "
                f"codec tags); cannot write v{container_version}")
        self.route = route
        if isinstance(router, CodecRouter):
            self.router = router
        elif isinstance(router, RouterConfig):
            self.router = CodecRouter(router)
        elif route in FALLBACK_CODEC_IDS:
            self.router = CodecRouter(RouterConfig(fallbacks=(route,)))
        else:
            self.router = CodecRouter()
        self.predictor = predictor
        self.slots = int(slots)
        self.chunk_size = int(chunk_size)
        self.topk = int(topk)
        self.precision = int(precision)
        self.container_version = int(container_version)
        # private per-service registry by default: stats() must describe
        # THIS service's traffic, not every service in the process. Pass
        # obs.registry() to aggregate into the process-global view.
        self.registry = registry if registry is not None \
            else MetricsRegistry(name="service")
        # shared-prefix KV reuse across jobs (v6): only touched when a
        # submit declares a cacheable context — model-free traffic and
        # plain v4/v5 jobs never reach it
        self.prefix_cache = RadixPrefixCache(
            capacity_tokens=int(prefix_cache_tokens),
            registry=self.registry)
        self.scheduler = SlotScheduler(predictor, n_slots=self.slots,
                                       chunk_size=self.chunk_size,
                                       topk=self.topk,
                                       precision=self.precision,
                                       registry=self.registry,
                                       prefix_cache=self.prefix_cache,
                                       router=self.router)
        self._next_job = 0
        self._legacy: LLMCompressor | None = None
        self._stats = ServiceStats(self)
        # performance attribution (DESIGN.md §13): trace= installs a
        # process-wide TimelineRecorder for this service's lifetime —
        # every span lands on the timeline, JobHandle.diagnostics gains a
        # per-job PhaseReport, and write_timeline() exports Chrome-trace
        # JSON. trace may be a path (saved by write_timeline/close), a
        # recorder instance, or None (no recording, no overhead).
        self.trace_path = None
        self.trace_recorder: obs.TimelineRecorder | None = None
        if trace is not None:
            if isinstance(trace, obs.TimelineRecorder):
                self.trace_recorder = trace
            else:
                self.trace_path = trace
                self.trace_recorder = obs.TimelineRecorder()
            obs.timeline.install(self.trace_recorder)

    # ------------------------------------------------------------- submit
    def submit_compress(self, tokens, *, priority: int = 0,
                        shared_prefix=None,
                        context_window: int = 0) -> JobHandle:
        """Queue a token stream for compression into a v4 container
        (v5 with per-chunk codec tags when routing is enabled).

        Context (v6): ``shared_prefix`` conditions every stripe-head
        chunk on the given token prefix (the radix prefix cache makes
        jobs sharing it pay its prefill once), ``context_window=W``
        carries each previous chunk's W-token tail into the next chunk
        of the stripe. Either option upgrades this job's container to
        v6 — the recipes ride in the index footer so any decoder can
        rematerialize the same context."""
        tokens = np.asarray(tokens, np.int32).ravel()
        n = int(tokens.size)
        C = self.chunk_size
        n_chunks = -(-n // C)            # 0 tokens => 0 chunks

        sp = None
        if shared_prefix is not None:
            sp = np.asarray(shared_prefix, np.int32).ravel()
            if sp.size == 0:
                sp = None
        ctx_on = sp is not None or context_window > 0
        version = max(self.container_version, VERSION_V6) if ctx_on \
            else self.container_version
        recipes = None
        chunks2d = valids = None
        if n_chunks:
            padded = np.zeros(n_chunks * C, np.int32)
            padded[:n] = tokens
            chunks2d = padded.reshape(n_chunks, C)
            valids = chunk_valid_lengths(n, C)
        ctx_budget = 0
        if ctx_on and n_chunks:
            # one stripe per slot: carry chains decode round-robin across
            # the recorded lane count, so carry never serializes decode
            recipes = assign_context_recipes(
                n_chunks, context_window=int(context_window),
                stripes=min(self.slots, n_chunks), shared=sp is not None)
            # job-wide decode-length geometry, recorded in the v6 footer:
            # every chunk of the job — context-free heads included — runs
            # the model program at chunk_size + ctx_budget positions
            ctx_budget = context_budget(
                recipes, valids, [("shared", sp)] if sp is not None else [])

        decisions = fb = None
        if self.route != ROUTE_LLM and n_chunks:
            decisions, fb = route_chunks(
                self.router, self.predictor, chunks2d,
                valids, "rans", auto=self.route == ROUTE_AUTO)

        sp_list = [("shared", sp)] if sp is not None else []

        def assemble(streams: list[bytes]):
            tags = None
            if version >= VERSION_V5:
                # late-bound through the job: fallback codec names were
                # recorded per chunk as completions arrived
                tags = [FALLBACK_CODEC_IDS.get(job._codecs.get(i),
                                               CODEC_RANS)
                        for i in range(n_chunks)]
            rec = None
            if version >= VERSION_V6 and recipes is not None:
                # fallback chunks are context-free by format law: zero the
                # recipe wherever the router (or a flip) won the chunk
                rec = [(RECIPE_NONE, 0) if i in job._codecs else recipes[i]
                       for i in range(n_chunks)]
            blob = write_container(
                streams, version=version, chunk_size=C,
                n_tokens=n, vocab=self.predictor.vocab_size,
                topk=self.topk, precision=self.precision,
                codec_id=CODEC_RANS, encode_batch=self.slots,
                codec_tags=tags, recipes=rec,
                shared_prefixes=sp_list if rec is not None else None,
                ctx_budget=ctx_budget)
            payload = sum(len(s) for s in streams)
            return blob, CompressionStats(
                n_tokens=n, payload_bytes=payload,
                header_bytes=len(blob) - payload)

        job = Job(self._new_job_id(), COMPRESS, priority, n_chunks, n,
                  assemble, codec="rans", registry=self.registry)
        self.registry.counter("service.jobs_submitted").inc()
        self.registry.counter("service.compress_jobs").inc()
        if n_chunks == 0:
            # empty input: a valid zero-chunk container, no scheduler
            # involvement (there is no chunk completion to wait for)
            job.resolve(assemble([]))
            return JobHandle(job, self)
        for i in range(n_chunks):
            lo, hi = i * C, min((i + 1) * C, n)
            valid = max(0, hi - lo)
            if decisions is not None and decisions[i].codec != "rans":
                # the probe (or a forced route) diverted this chunk: it
                # completes right now and never takes a model slot
                name, stream = fb[i]
                self.registry.counter(obs.ROUTER_CHUNKS_FALLBACK).inc()
                if decisions[i].llm_bits_est >= 0:
                    self.registry.counter(obs.ROUTER_PROBE_SKIPS).inc()
                diag = None
                if self.registry.enabled:
                    diag = obs.ChunkDiagnostics(
                        chunk_index=i, n_tokens=valid,
                        stream_bytes=len(stream),
                        coded_bits=8.0 * len(stream), codec=name)
                job._chunk_done(i, stream, diag, codec=name)
                continue
            task = ChunkTask(job, i, COMPRESS, valid, tokens=tokens[lo:hi],
                             ctx_budget=ctx_budget)
            if decisions is not None:
                task.fallback, task.fallback_codec = fb[i][1], fb[i][0]
                task.llm_bits_est = decisions[i].llm_bits_est
            if recipes is not None and recipes[i][0] != RECIPE_NONE:
                task.recipe = recipes[i]
                # same materialization the v6 decoder will use, so the
                # encode-side context cannot drift from the format's
                task.ctx = recipe_context(recipes, chunks2d, valids, i,
                                          sp_list)
                task.cacheable = recipes[i][0] == RECIPE_SHARED
            self.scheduler.submit(task, priority)
        return JobHandle(job, self)

    def submit_decompress(self, blob: bytes, *, priority: int = 0) -> JobHandle:
        """Queue a container for decompression. The container is parsed
        and integrity-checked up front (raises ContainerError on corrupt
        or configuration-mismatched blobs — bad input fails at submit,
        not mid-flight in a shared batch)."""
        info, streams = parse_container(blob)
        check_container_config(info, vocab=self.predictor.vocab_size,
                               chunk_size=self.chunk_size, topk=self.topk,
                               precision=self.precision)
        if info.codec == CODEC_RANS:
            # reject before anything is queued, so a corrupt container
            # cannot leave a partial job's chunks orphaned in the queue
            for i, (s, e) in enumerate(zip(streams, info.entries)):
                if e.is_llm and e.n_tokens > 0 \
                        and len(s) < rans._STATE_BYTES:
                    raise ContainerError(
                        f"chunk {i}: stream of {len(s)} bytes cannot code "
                        f"{e.n_tokens} tokens (corrupt container)")
        # fallback-tagged v5 chunks need no model: decode them NOW, before
        # anything is queued — a corrupt fallback stream therefore fails
        # the whole submit (ContainerError) without orphaning queued work
        fb_tokens: dict[int, np.ndarray] = {}
        for i, (stream, entry) in enumerate(zip(streams, info.entries)):
            if entry.is_llm or entry.n_tokens == 0:
                continue
            try:
                fb_tokens[i] = CodecRouter.decode_fallback(
                    entry.codec_name, stream, entry.n_tokens, info.vocab)
            except ValueError as e:
                raise ContainerError(f"corrupt container: chunk {i}: {e}")
        job = Job(self._new_job_id(), DECOMPRESS, priority, info.n_chunks,
                  info.n_tokens,
                  lambda chunks: np.concatenate(chunks)[:info.n_tokens]
                  if chunks else np.zeros(0, np.int32),
                  codec="rans" if info.codec == CODEC_RANS else "ac",
                  registry=self.registry)
        self.registry.counter("service.jobs_submitted").inc()
        self.registry.counter("service.decompress_jobs").inc()
        if info.n_chunks == 0:
            job.resolve(np.zeros(0, np.int32))   # valid empty container
            return JobHandle(job, self)
        carried = any(e.recipe_kind != RECIPE_NONE for e in info.entries)
        if info.codec == CODEC_AC or carried:
            # legacy codec, or v6 carried context: grouped lock-step
            # decode, resolved eagerly. Carried chunks need their
            # predecessors' tokens before they can decode — that ordering
            # is the grouped decoder's chain scheduling, not the slot
            # machine's out-of-order refill. (An all-fallback v6 archive
            # has every recipe zeroed by format law, so it never lands
            # here and stays model-free below.)
            job.resolve(self._legacy_compressor().decompress(blob))
            return JobHandle(job, self)
        for i, (stream, entry) in enumerate(zip(streams, info.entries)):
            if i in fb_tokens:
                self.registry.counter(
                    "decompress.fallback_chunks",
                    "fallback-tagged chunks decoded without the "
                    "model").inc()
                job._chunk_done(i, fb_tokens[i],
                                codec=entry.codec_name)
                continue
            self.scheduler.submit(
                ChunkTask(job, i, DECOMPRESS, entry.n_tokens,
                          stream=stream,
                          ctx_budget=getattr(info, "ctx_budget", 0)),
                priority)
        return JobHandle(job, self)

    # -------------------------------------------------------------- drive
    def poll(self) -> bool:
        """Advance the scheduler by one fixed-shape step; False if idle."""
        return self.scheduler.step()

    def run(self) -> None:
        """Drain every queued job to completion."""
        self.scheduler.run()

    def _run_until(self, job: Job) -> None:
        while not job.done:
            if not self.scheduler.step():
                raise ServiceError(
                    f"scheduler idle but job {job.job_id} incomplete "
                    f"({len(job._results)}/{job.n_chunks} chunks)")

    @property
    def stats(self) -> ServiceStats:
        """Attribute-compatible stats view; call it (``svc.stats()``) for
        the structured snapshot."""
        return self._stats

    def snapshot(self) -> dict:
        """Structured telemetry snapshot of this service: scheduler
        counters + occupancy, job counters, chunk bits/token summary,
        draft-acceptance rate (None until a speculative decode ran), and
        the raw registry dump (JSON-serializable)."""
        reg = self.registry
        sched = self.scheduler.stats.snapshot()
        h = reg.get("chunk.bits_per_token")
        bpt = None
        if h is not None and h.count:
            bpt = {"count": h.count, "mean": h.mean,
                   "p50": h.quantile(0.5), "p95": h.quantile(0.95),
                   "p99": h.quantile(0.99)}
        offered = reg.value("spec.drafted_tokens")
        acc = reg.value("spec.drafted_accepted")
        return {
            "scheduler": sched,
            "occupancy": sched["occupancy"],
            "jobs": {
                "submitted": reg.value("service.jobs_submitted"),
                "failed": reg.value("service.jobs_failed"),
                "compress": reg.value("service.compress_jobs"),
                "decompress": reg.value("service.decompress_jobs"),
            },
            "chunk_bits_per_token": bpt,
            "draft_acceptance": (acc / offered) if offered else None,
            "prefix_cache": {
                "hits": reg.value("prefix_cache.hits"),
                "misses": reg.value("prefix_cache.misses"),
                "evictions": reg.value("prefix_cache.evictions"),
                "tokens_reused": reg.value("prefix_cache.tokens_reused"),
                "entries": len(self.prefix_cache),
                "size_tokens": self.prefix_cache.size_tokens,
            },
            "metrics": reg.snapshot(),
            "phases": {k: round(v, 6) for k, v in
                       obs.timeline.phases_from_registry(reg).items()},
        }

    # -------------------------------------------------------- attribution
    def write_timeline(self, path=None) -> "str | None":
        """Export the service's recorded timeline as Chrome-trace JSON
        (loads in chrome://tracing / ui.perfetto.dev). ``path`` defaults
        to the ``trace=`` path given at construction; returns the path
        written, or None when the service records no timeline."""
        rec = self.trace_recorder
        path = path if path is not None else self.trace_path
        if rec is None or path is None:
            return None
        rec.save(path)
        return str(path)

    def close(self) -> None:
        """Uninstall this service's timeline recorder (and save to the
        ``trace=`` path, if one was given). Idempotent; a service without
        tracing closes as a no-op."""
        rec = self.trace_recorder
        if rec is None:
            return
        self.write_timeline()
        if obs.timeline.active() is rec:
            obs.timeline.uninstall()
        self.trace_recorder = None

    # ------------------------------------------------------------ helpers
    def _new_job_id(self) -> int:
        self._next_job += 1
        return self._next_job

    def _legacy_compressor(self) -> LLMCompressor:
        if self._legacy is None:
            self._legacy = LLMCompressor(
                self.predictor, chunk_size=self.chunk_size, topk=self.topk,
                precision=self.precision, decode_batch=self.slots,
                registry=self.registry)
        return self._legacy
