"""Trace timeline recording + Chrome-trace export + phase attribution.

DESIGN.md §13. Three layers on top of the span vocabulary of
``obs.trace``:

* ``TimelineRecorder`` — a bounded ring buffer of **span events**. When
  a recorder is installed (``timeline.install(rec)`` / ``with rec:``),
  every closing ``obs.trace.span`` appends one ``SpanEvent`` (name,
  nesting path, thread id, start time, duration, optional job/chunk
  tags). The buffer is a fixed-capacity ring: sustained load overwrites
  the oldest events and counts the drops — recording can never grow
  memory without bound. When no recorder is installed the cost per span
  is one module-attribute check (the <2% disabled-overhead gate).

* Chrome-trace export — ``rec.to_chrome_trace()`` emits the Trace Event
  Format dict (``{"traceEvents": [...], "displayTimeUnit": "ms"}``,
  complete ``"X"`` events with microsecond ``ts``/``dur``) that
  chrome://tracing and Perfetto load directly; ``rec.save(path)``
  writes it as JSON. Timestamps come from the same
  ``time.perf_counter`` clock the spans measure with, zeroed at the
  recorder's start so traces from one process line up.

* ``PhaseReport`` — rolls span events up into a per-job wall-time
  breakdown: **exclusive** seconds (child-span time subtracted) per
  phase — model / coder / scheduler / router / prefix_cache / other —
  plus an ``unattributed`` residual so the phases always sum to the
  report's total wall. ``PhaseReport.from_events`` attributes a
  ``[t0, t1]`` window (a job's submit→done interval, clipping events at
  the edges); ``phases_from_registry`` derives the same breakdown from
  the ``span.<path>.seconds`` histograms alone (no recorder, zero extra
  overhead — what benchmarks/run.py puts in the bench history).
"""
from __future__ import annotations

import json
import threading
import time
from dataclasses import dataclass, field
from typing import Optional

#: phase name -> span-name prefixes (first match wins, in this order).
#: Matching is on the span *name* (the last path segment), so nesting
#: cannot reclassify a span: model.decode_step inside service.step is
#: model time, and the step span's exclusive time is scheduler time.
PHASE_PREFIXES = (
    ("model", ("model.",)),
    ("coder", ("coder.", "rans.", "compress.encode", "decode.coder")),
    ("router", ("router.", "compress.route")),
    ("prefix_cache", ("prefix_cache.",)),
    ("scheduler", ("service.", "scheduler.", "compress.job",
                   "decompress.job", "decode.group", "decode.verify_round")),
    ("host", ("host.", "container.", "data.")),
)

UNATTRIBUTED = "unattributed"


def phase_of(name: str) -> str:
    """Phase bucket for a span name (see PHASE_PREFIXES); 'other' when
    no prefix matches."""
    for phase, prefixes in PHASE_PREFIXES:
        for p in prefixes:
            if name.startswith(p):
                return phase
    return "other"


@dataclass
class SpanEvent:
    """One closed span, as recorded at ``Span.__exit__`` time."""
    name: str           # span label (last path segment)
    path: str           # slash-joined nesting path
    t0: float           # start, seconds on the recorder's clock
    dur: float          # wall seconds
    tid: int            # recording thread's ident
    tags: Optional[dict] = None     # e.g. {"job": 3, "chunk": 7}

    @property
    def t1(self) -> float:
        return self.t0 + self.dur


class TimelineRecorder:
    """Bounded ring buffer of span events + Chrome-trace export.

    Install with ``timeline.install(rec)`` (or use the recorder as a
    context manager) to start receiving events from every ``obs.span``
    in the process; ``timeline.uninstall()`` stops recording. One
    recorder at a time — installing a second replaces the first.
    """

    def __init__(self, capacity: int = 1 << 16):
        if capacity <= 0:
            raise ValueError(f"capacity must be positive, got {capacity}")
        self.capacity = int(capacity)
        self.t_start = time.perf_counter()
        self._ring: list = [None] * self.capacity
        self._n = 0                      # total events ever recorded
        self._lock = threading.Lock()

    # ------------------------------------------------------------ recording
    def record(self, name: str, path: str, t0: float, dur: float,
               tags: Optional[dict] = None) -> None:
        """Append one event (called from ``Span.__exit__``). Lock-held
        only for the two index ops — recording is cheap and safe from
        any thread."""
        ev = SpanEvent(name=name, path=path, t0=t0 - self.t_start,
                       dur=dur, tid=threading.get_ident(), tags=tags)
        with self._lock:
            self._ring[self._n % self.capacity] = ev
            self._n += 1

    @property
    def dropped(self) -> int:
        """Events overwritten by the ring (0 until capacity overflows)."""
        return max(0, self._n - self.capacity)

    def __len__(self) -> int:
        return min(self._n, self.capacity)

    def events(self) -> list:
        """Retained events, oldest first (start-time order within each
        thread; recording order is span-exit order)."""
        with self._lock:
            n, ring = self._n, list(self._ring)
        if n <= self.capacity:
            out = ring[:n]
        else:
            head = n % self.capacity
            out = ring[head:] + ring[:head]
        out.sort(key=lambda e: (e.t0, -e.dur))
        return out

    def now(self) -> float:
        """Current time on the recorder's clock (for [t0, t1] windows)."""
        return time.perf_counter() - self.t_start

    # -------------------------------------------------------------- export
    def to_chrome_trace(self, process_name: str = "repro") -> dict:
        """Trace Event Format dict: complete ('X') events, µs units —
        loads in chrome://tracing and ui.perfetto.dev unmodified."""
        trace_events = [{
            "name": "process_name", "ph": "M", "pid": 1, "tid": 0,
            "args": {"name": process_name},
        }]
        for ev in self.events():
            rec = {
                "name": ev.name, "cat": phase_of(ev.name), "ph": "X",
                "ts": round(ev.t0 * 1e6, 3),
                "dur": round(ev.dur * 1e6, 3),
                "pid": 1, "tid": ev.tid,
                "args": {"path": ev.path},
            }
            if ev.tags:
                rec["args"].update(ev.tags)
            trace_events.append(rec)
        return {
            "traceEvents": trace_events,
            "displayTimeUnit": "ms",
            "otherData": {"dropped_events": self.dropped},
        }

    def save(self, path) -> None:
        with open(path, "w") as f:
            json.dump(self.to_chrome_trace(), f)

    # ------------------------------------------------------ install helpers
    def __enter__(self) -> "TimelineRecorder":
        install(self)
        return self

    def __exit__(self, *exc) -> bool:
        if active() is self:
            uninstall()
        return False


# ------------------------------------------------------- process-wide hook
_recorder: Optional[TimelineRecorder] = None


def install(rec: TimelineRecorder) -> TimelineRecorder:
    """Start recording every span in the process into ``rec`` (replaces
    any previously installed recorder); returns ``rec``."""
    global _recorder
    _recorder = rec
    return rec


def uninstall() -> Optional[TimelineRecorder]:
    """Stop recording; returns the recorder that was installed."""
    global _recorder
    rec, _recorder = _recorder, None
    return rec


def active() -> Optional[TimelineRecorder]:
    """The installed recorder, or None. Hot paths may consult this to
    stop sampling spans (record every step) while a timeline is live."""
    return _recorder


# --------------------------------------------------------- phase rollup
@dataclass
class PhaseReport:
    """Per-job (or per-window) wall-time attribution.

    ``phases`` maps phase name -> **exclusive** wall seconds; it always
    contains an ``unattributed`` entry (window wall not covered by any
    span), so ``sum(phases.values()) == total_s`` up to float rounding.
    ``coverage`` is the fraction of the window covered by at least one
    span event (the ≥90% acceptance signal).
    """
    total_s: float
    phases: dict = field(default_factory=dict)
    n_events: int = 0
    dropped_events: int = 0

    @property
    def coverage(self) -> float:
        if self.total_s <= 0:
            return 0.0
        covered = self.total_s - self.phases.get(UNATTRIBUTED, 0.0)
        return max(0.0, min(1.0, covered / self.total_s))

    def to_dict(self) -> dict:
        return {
            "total_s": self.total_s,
            "phases": {k: round(v, 9) for k, v in sorted(
                self.phases.items()) if v > 0 or k == UNATTRIBUTED},
            "coverage": round(self.coverage, 4),
            "n_events": self.n_events,
            "dropped_events": self.dropped_events,
        }

    @classmethod
    def from_events(cls, events, t0: float = None, t1: float = None,
                    dropped: int = 0) -> "PhaseReport":
        """Attribute the wall-time window ``[t0, t1]`` to phases.

        Defaults the window to the events' own extent. Events are
        clipped to the window; nested spans contribute only their
        exclusive time (duration minus direct children, per thread), so
        a model span inside a scheduler step counts as model, and the
        step's remaining time as scheduler. Time no span covers lands
        in ``unattributed``.
        """
        evs = [e for e in events if e.dur >= 0]
        if t0 is None:
            t0 = min((e.t0 for e in evs), default=0.0)
        if t1 is None:
            t1 = max((e.t1 for e in evs), default=t0)
        total = max(0.0, t1 - t0)
        # clip to the window, drop events fully outside it
        win = []
        for e in evs:
            a, b = max(e.t0, t0), min(e.t1, t1)
            if b > a:
                win.append((a, b, e))
        phases: dict = {}
        covered = 0.0
        # per-thread sweep: events sorted by (start, -duration) nest
        # properly (a parent sorts before its children), so a stack
        # yields each event's exclusive time in one pass
        by_tid: dict = {}
        for rec in win:
            by_tid.setdefault(rec[2].tid, []).append(rec)
        for tid_events in by_tid.values():
            tid_events.sort(key=lambda r: (r[0], -(r[1] - r[0])))
            stack: list = []    # [a, b, event, child_time]
            cover_end = None

            def close(frame):
                a, b, e, child = frame
                excl = max(0.0, (b - a) - child)
                ph = phase_of(e.name)
                phases[ph] = phases.get(ph, 0.0) + excl
                if stack:
                    stack[-1][3] += b - a

            for a, b, e in tid_events:
                while stack and a >= stack[-1][1]:
                    close(stack.pop())
                # union coverage for this thread (threads overlap in
                # wall time; coverage counts wall once — use the union
                # across ALL threads below)
                stack.append([a, b, e, 0.0])
            while stack:
                close(stack.pop())
        # wall coverage: union of all event intervals across threads
        ivs = sorted((a, b) for a, b, _ in win)
        end = None
        for a, b in ivs:
            if end is None or a > end:
                covered += b - a
                end = b
            elif b > end:
                covered += b - end
                end = b
        phases[UNATTRIBUTED] = max(0.0, total - covered)
        # exclusive sums can overshoot the union when threads overlap;
        # the report stays honest: phases describe thread-time, the
        # unattributed term describes wall — both are real quantities
        return cls(total_s=total, phases=phases, n_events=len(win),
                   dropped_events=dropped)

    @classmethod
    def from_recorder(cls, rec: TimelineRecorder, t0: float = None,
                      t1: float = None) -> "PhaseReport":
        return cls.from_events(rec.events(), t0=t0, t1=t1,
                               dropped=rec.dropped)


def phases_from_registry(reg) -> dict:
    """Phase -> exclusive seconds from the ``span.<path>.seconds``
    histograms alone (no recorder needed). The nesting path IS the tree:
    a path's exclusive time is its sum minus its direct children's sums.
    Sampled spans (scheduler step 1-in-N) under-count proportionally —
    this is the cheap trajectory signal, the recorder is the precise one.
    """
    sums: dict = {}
    for name, m in getattr(reg, "_metrics", {}).items():
        if not (name.startswith("span.") and name.endswith(".seconds")):
            continue
        path = name[len("span."):-len(".seconds")]
        sums[path] = getattr(m, "sum", 0.0)
    phases: dict = {}
    for path, s in sums.items():
        child_time = sum(cs for cp, cs in sums.items()
                         if cp.startswith(path + "/")
                         and "/" not in cp[len(path) + 1:])
        leaf = path.rsplit("/", 1)[-1]
        ph = phase_of(leaf)
        phases[ph] = phases.get(ph, 0.0) + max(0.0, s - child_time)
    return phases
