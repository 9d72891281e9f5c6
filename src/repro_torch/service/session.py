"""Job and session bookkeeping for the compression service.

A *job* is one client request (compress a token stream / decompress a
container). The session layer splits jobs into independent per-chunk
work items (``ChunkTask``), hands them to the scheduler, and reassembles
completed chunks — which arrive **out of order** — into the job's final
result. Chunk independence is the format's own guarantee (paper §5.4,
DESIGN.md §2): nothing here needs cross-chunk state.

Telemetry rides along, out-of-band: the scheduler attaches an optional
``obs.ChunkDiagnostics`` to each chunk completion, and
``JobHandle.diagnostics`` assembles them into an ``obs.JobDiagnostics``
(bits/token, cross-entropy, escape rate per chunk) once the job is done.
Diagnostics never enter the container bytes; ``handle.write_sidecar()``
puts them in a ``<path>.diag.json`` file next to it.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable, Optional

import numpy as np

from repro_torch import obs

COMPRESS = "compress"
DECOMPRESS = "decompress"


@dataclass
class ChunkTask:
    """One chunk's worth of work — the scheduler's unit of slot refill.

    Exactly one of ``tokens`` (compress: the chunk's token ids, unpadded)
    or ``stream`` (decompress: the chunk's coded bytes) is set. ``valid``
    is the chunk's true token count (< chunk_size only for a job's final
    chunk).

    Routed compress chunks (DESIGN.md §11) carry their realized
    best-fallback stream in ``fallback``: the scheduler compares it
    against the slot encoder's flushed bytes at completion and keeps the
    smaller — the chunk still took a model slot (the probe kept it), but
    the container never pays more than the fallback would.

    Context (v6, DESIGN.md §12): ``ctx`` is the chunk's declared context
    prefix — the scheduler prefills it through the slot's lane before any
    token is coded, and ``recipe`` is the (kind, param) pair the v6
    container records so a decoder can rematerialize the same context.
    ``cacheable`` marks ``ctx`` as a shared prefix worth storing in the
    service's radix prefix cache (carry windows are chunk-unique — caching
    them would only churn the LRU). ``ctx_budget`` is the job-wide
    decode-length budget (the v6 footer's ``ctx_budget``): cache length
    is coding geometry, so every chunk of a job — context-free ones
    included — must run the model program at chunk_size + ctx_budget
    positions, and the scheduler refuses to mix geometries mid-flight.
    ``llm_bits_est`` is the router probe's estimate, fed back to
    ``CodecRouter.observe`` at completion."""
    job: "Job"
    chunk_index: int
    kind: str
    valid: int
    tokens: Optional[np.ndarray] = None
    stream: Optional[bytes] = None
    fallback: Optional[bytes] = None
    fallback_codec: str = ""
    ctx: Optional[np.ndarray] = None
    recipe: tuple = (0, 0)
    cacheable: bool = False
    ctx_budget: int = 0
    llm_bits_est: float = -1.0

    def complete(self, result,
                 diag: Optional[obs.ChunkDiagnostics] = None,
                 codec: Optional[str] = None) -> None:
        self.job._chunk_done(self.chunk_index, result, diag, codec)

    def fail(self, err: Exception) -> None:
        self.job._fail(err)


@dataclass
class Job:
    """One submitted request, decomposed into ``n_chunks`` ChunkTasks."""
    job_id: int
    kind: str
    priority: int
    n_chunks: int
    n_tokens: int
    # called with the in-order list of per-chunk results once all chunks
    # are done; returns the job's final result (container bytes / tokens)
    assemble: Callable[[list], Any]
    codec: str = ""                     # codec label for diagnostics
    registry: Optional[obs.MetricsRegistry] = None
    _results: dict = field(default_factory=dict)
    _diags: dict = field(default_factory=dict)
    # chunk_index -> fallback codec *name* for chunks the router diverted
    # (absent => the container's entropy codec). The compress assemble
    # closure turns these into v5 per-chunk codec tags.
    _codecs: dict = field(default_factory=dict)
    _result: Any = None
    _error: Optional[Exception] = None
    _done: bool = False
    # submit→done wall interval, on the same perf_counter clock the span
    # timeline records with — so a job's PhaseReport window is exact
    t_submit: float = field(default_factory=time.perf_counter)
    t_done: float = 0.0

    def _chunk_done(self, chunk_index: int, result,
                    diag: Optional[obs.ChunkDiagnostics] = None,
                    codec: Optional[str] = None) -> None:
        if self._done:
            return
        if chunk_index in self._results:
            raise RuntimeError(
                f"job {self.job_id}: chunk {chunk_index} completed twice")
        self._results[chunk_index] = result
        if codec:
            self._codecs[chunk_index] = codec
        if diag is not None:
            self._diags[chunk_index] = diag
        if len(self._results) == self.n_chunks:
            try:
                ordered = [self._results[i] for i in range(self.n_chunks)]
                self._result = self.assemble(ordered)
            except Exception as e:          # surface through the handle
                obs.log_exception("service.assemble_failed", e,
                                  job=self.job_id, kind=self.kind)
                self._count_failure()
                self._error = e
            self._done = True
            self.t_done = time.perf_counter()

    def _fail(self, err: Exception) -> None:
        if self._error is None:         # count each job's failure once
            self._count_failure()
        self._error = err
        self._done = True
        self.t_done = time.perf_counter()

    def _count_failure(self) -> None:
        if self.registry is not None:
            self.registry.counter(
                "service.jobs_failed",
                "jobs resolved with an error (await re-raises)").inc()

    def resolve(self, result) -> None:
        """Complete the whole job immediately (no scheduler involvement —
        e.g. legacy-codec containers decoded through the grouped path)."""
        self._result = result
        self._done = True
        self.t_done = time.perf_counter()

    @property
    def done(self) -> bool:
        return self._done


class JobHandle:
    """Client-side future for a submitted job. ``result()`` drives the
    service's scheduler until this job completes (cooperative, single
    process — the service owns the model program)."""

    def __init__(self, job: Job, service):
        self._job = job
        self._service = service

    @property
    def job_id(self) -> int:
        return self._job.job_id

    def done(self) -> bool:
        return self._job.done

    def result(self):
        """Block (drive the scheduler) until the job finishes; returns the
        decompressed tokens or (container bytes, stats), or re-raises the
        job's failure."""
        self._service._run_until(self._job)
        if self._job._error is not None:
            raise self._job._error
        return self._job._result

    @property
    def diagnostics(self) -> obs.JobDiagnostics:
        """The job's per-chunk compression diagnostics, assembled after
        ``result()``. Chunks are in order; empty-at-submit chunks and
        telemetry-disabled runs contribute no entries."""
        job = self._job
        self._service._run_until(job)
        container_bytes = 0
        if job.kind == COMPRESS and isinstance(job._result, tuple):
            container_bytes = len(job._result[0])
        d = obs.JobDiagnostics(
            job_id=job.job_id, kind=job.kind, codec=job.codec,
            n_tokens=job.n_tokens, container_bytes=container_bytes,
            chunks=[job._diags[i] for i in sorted(job._diags)])
        if job.t_done:
            d.wall_s = max(0.0, job.t_done - job.t_submit)
        rep = self.phase_report()
        if rep is not None:
            d.phases = rep.to_dict()
        return d

    def phase_report(self):
        """Per-phase wall-time attribution of this job's submit→done
        interval (``obs.PhaseReport``), from the service's timeline
        recorder — None when the service wasn't constructed with
        ``trace=`` (DESIGN.md §13)."""
        job = self._job
        self._service._run_until(job)
        rec = getattr(self._service, "trace_recorder", None)
        if rec is None or not job.t_done:
            return None
        return obs.PhaseReport.from_events(
            rec.events(), t0=job.t_submit - rec.t_start,
            t1=job.t_done - rec.t_start, dropped=rec.dropped)

    def write_sidecar(self, container_path):
        """Write ``diagnostics`` as JSON next to ``container_path``
        (``<name>.diag.json``); returns the sidecar path."""
        return obs.write_sidecar(container_path, self.diagnostics)
