"""Host-side span tracing.

``with obs.trace.span("decode.verify_round"): ...`` times a region of
host code and records the wall time into a log2 histogram named
``span.<path>.seconds`` — where ``<path>`` is the slash-joined nesting
path (``service.step/model.decode_step``), built from a thread-local
span stack, so one histogram exists per distinct call *position*, not
just per label.

The JAX package mirrors every span into ``jax.profiler``; this copy has
no device mirror yet (a ``torch.profiler`` / NVTX mirror is planned).
``mirror=`` is still accepted so call sites stay identical.

Spans follow the registry switch: ``span()`` returns a shared null
context manager when the target registry (argument, else the process
default) is disabled, so a disabled process pays one attribute check
per span site.

When a ``obs.timeline.TimelineRecorder`` is installed, every closing
span additionally appends one event (name, path, start, duration,
thread, tags) to the recorder's ring buffer — the raw material for
Chrome-trace export and per-job phase attribution (DESIGN.md §13).
With no recorder installed that costs one module-attribute check.
"""
from __future__ import annotations

import threading
import time
from . import metrics as _metrics
from . import timeline as _timeline

_tls = threading.local()
_enabled = True          # module master switch (obs.trace.enable(False))


def enable(on: bool = True) -> None:
    global _enabled
    _enabled = bool(on)


def _stack() -> list:
    s = getattr(_tls, "stack", None)
    if s is None:
        s = _tls.stack = []
    return s


def current() -> str:
    """Slash-joined path of the innermost open span ('' outside spans)."""
    s = _stack()
    return "/".join(s) if s else ""


class _NullSpan:
    """Shared no-op context manager for disabled tracing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL = _NullSpan()

#: shared no-op span — for call sites that sample their own spans
#: (e.g. the scheduler times every Nth step) and need the "not this
#: time" branch to cost one attribute read
NULL = _NULL


class Span:
    __slots__ = ("name", "_reg", "_t0", "path", "tags", "_mirror")

    def __init__(self, name: str, reg, tags=None, mirror=True):
        self.name = name
        self._reg = reg
        self.path = name
        self.tags = tags
        self._mirror = mirror

    def __enter__(self):
        stack = _stack()
        stack.append(self.name)
        self.path = "/".join(stack)
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self._t0
        _stack().pop()
        if self._reg is not None:
            self._reg.histogram(
                "span." + self.path + ".seconds",
                "wall seconds spent in this span path").observe(dt)
        rec = _timeline._recorder
        if rec is not None:
            rec.record(self.name, self.path, self._t0, dt, self.tags)
        return False


def span(name: str, registry=None, tags=None, mirror=True):
    """Open a traced region. Records into ``registry`` (default: the
    process-global one). Returns a shared null context manager when
    tracing or the target registry is disabled. ``tags`` (e.g.
    ``{"job": 3, "chunk": 7}``) ride along on timeline events only —
    they never fan out histogram names. ``mirror`` marks hot-loop spans
    that a device-trace mirror should skip (no mirror exists yet).

    A process-wide timeline recorder (obs.timeline.install) overrides
    the registry gate: spans still land on the timeline even when their
    target registry is disabled or is not the recording service's own —
    the recorder is process-scoped, so the timeline must see every span
    in the process (a service's private registry would otherwise hide
    the coder/model spans that record against the global one). Such
    timeline-only spans skip the histogram observe."""
    if not _enabled:
        return _NULL
    reg = registry if registry is not None else _metrics.registry()
    if reg.enabled:
        return Span(name, reg, tags, mirror)
    if _timeline._recorder is None:
        return _NULL
    return Span(name, None, tags, mirror)   # timeline-only span
