"""Host-side span tracing, mirrored into the CUDA profilers.

``with obs.trace.span("decode.verify_round"): ...`` times a region of
host code and records the wall time into a log2 histogram named
``span.<path>.seconds`` — where ``<path>`` is the slash-joined nesting
path (``service.step/model.decode_step``), built from a thread-local
span stack, so one histogram exists per distinct call *position*, not
just per label.

The device mirror: every span whose ``mirror`` is true also opens a
``torch.profiler.record_function`` and an NVTX range of the same name,
so a ``torch.profiler`` trace (or ``nsys``) shows ``compress.job``,
``decode.group``, ``model.decode_step``, ``router.probe`` and the rest
around the kernels they launch: one vocabulary on the host's and the
device's timelines. It costs next to nothing when nobody is looking:

* ``record_function`` is entered only while the autograd profiler is
  enabled (``torch.profiler.profile`` and the legacy profiler both set
  ``torch.autograd.profiler._is_profiler_enabled``, one module-attribute
  read per span); entering it with no profiler would cost a dispatcher
  call per span for nothing.
* NVTX ranges are pushed only when a tool has injected itself into NVTX
  (``$NVTX_INJECTION64_PATH`` set, as ``nsys`` does for the process it
  launches) and a card is present; without an injected tool NVTX's own
  calls are no-ops, so skipping them loses nothing. Decided once per
  process, at the first mirrored span.
* ``mirror=False`` spans — the scheduler's per-step ``service.refill``,
  ``coder.step``, ``prefix_cache.lookup`` and ``service.finish_slot`` —
  never mirror. ``set_torch_mirror(False)`` turns the mirror off for the
  whole process.

CUDA-graph capture: the first ``decode_step`` of a new (lanes, length)
captures its graph inside the ``model.decode_step`` span, so a mirror
range is open across the capture. Both mirrors are host-side only (no
event is recorded into the stream), so nothing of them enters the
graph, and the mirror is not skipped while a stream captures.
``chip_smoke.py`` phase 7 holds that on an H100: a compress profiled
with ``torch.profiler`` across a capture gets every captured
``decode_attention`` launch inside its ``model.decode_step`` span, and
the same bytes as without the profiler.

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

import os
import threading
import time
from . import metrics as _metrics
from . import timeline as _timeline

_tls = threading.local()
_enabled = True          # module master switch (obs.trace.enable(False))
_torch_mirror = True     # mirror into record_function / NVTX
_profiler = None         # torch.autograd.profiler, resolved at first use
_nvtx = None             # torch.cuda.nvtx when a tool listens, else False


def enable(on: bool = True) -> None:
    global _enabled
    _enabled = bool(on)


def set_torch_mirror(on: bool) -> None:
    """Turn the ``record_function`` / NVTX mirror on or off."""
    global _torch_mirror
    _torch_mirror = bool(on)


def _resolve_mirror() -> None:
    global _profiler, _nvtx
    import torch
    import torch.autograd.profiler
    _profiler = torch.autograd.profiler
    _nvtx = torch.cuda.nvtx if os.environ.get("NVTX_INJECTION64_PATH") \
        and torch.cuda.is_available() else False


def _mirror_enter(name: str):
    """Open the mirror of one span: (record_function or None, NVTX pushed),
    or None when nothing was opened."""
    if _profiler is None:
        _resolve_mirror()
    rf = None
    if _profiler._is_profiler_enabled:
        rf = _profiler.record_function(name)
        rf.__enter__()
    if _nvtx:
        _nvtx.range_push(name)
    return (rf, bool(_nvtx)) if rf is not None or _nvtx else None


def _mirror_exit(mir, exc) -> None:
    rf, pushed = mir
    if pushed:
        _nvtx.range_pop()
    if rf is not None:
        rf.__exit__(*exc)


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
    __slots__ = ("name", "_reg", "_t0", "_mir", "path", "tags", "_mirror")

    def __init__(self, name: str, reg, tags=None, mirror=True):
        self.name = name
        self._reg = reg
        self._mir = None
        self.path = name
        self.tags = tags
        self._mirror = mirror

    def __enter__(self):
        stack = _stack()
        stack.append(self.name)
        self.path = "/".join(stack)
        if _torch_mirror and self._mirror:
            self._mir = _mirror_enter(self.name)
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self._t0
        if self._mir is not None:
            _mirror_exit(self._mir, exc)
            self._mir = None
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
    they never fan out histogram names. ``mirror=False`` keeps a per-step
    hot-loop span out of the ``record_function`` / NVTX mirror.

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
