"""repro_torch.obs — unified observability: metrics, spans, logs, diagnostics.

One import surface for the whole stack::

    from repro_torch import obs

    obs.registry().counter("compress.jobs").inc()
    with obs.trace.span("decode.verify_round"):
        ...
    obs.log("scheduler.progress", steps=n, occupancy=occ)

See DESIGN.md §10 for the naming scheme, the span hierarchy, and the
overhead budget (<2% enabled on the service bench, ~0 disabled —
CI-gated by ``benchmarks/run.py telemetry_overhead``).
"""
from __future__ import annotations

from . import timeline  # noqa: F401  (TimelineRecorder / PhaseReport)
from . import trace  # noqa: F401  (obs.trace.span / obs.trace.current)
from .diagnostics import (  # noqa: F401
    ChunkDiagnostics,
    JobDiagnostics,
    read_sidecar,
    sidecar_path,
    write_sidecar,
)
from .logs import (  # noqa: F401
    configure,
    console,
    exception_record,
    format_event,
    get_logger,
    log,
    log_error,
    log_exception,
)
from .metrics import (  # noqa: F401
    ROUTER_CHUNKS_FALLBACK,
    ROUTER_CHUNKS_LLM,
    ROUTER_FLIPS,
    ROUTER_PROBE_SKIPS,
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    registry,
    set_registry,
)
from .timeline import PhaseReport, TimelineRecorder  # noqa: F401
from .trace import span  # noqa: F401

__all__ = [
    "ChunkDiagnostics",
    "ROUTER_CHUNKS_FALLBACK",
    "ROUTER_CHUNKS_LLM",
    "ROUTER_FLIPS",
    "ROUTER_PROBE_SKIPS",
    "Counter",
    "Gauge",
    "Histogram",
    "JobDiagnostics",
    "MetricsRegistry",
    "PhaseReport",
    "TimelineRecorder",
    "configure",
    "console",
    "exception_record",
    "format_event",
    "get_logger",
    "log",
    "log_error",
    "log_exception",
    "read_sidecar",
    "registry",
    "set_registry",
    "sidecar_path",
    "span",
    "timeline",
    "trace",
    "write_sidecar",
]
