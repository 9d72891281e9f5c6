"""Low-overhead metrics registry: counters, gauges, log2-bucket histograms.

Design (DESIGN.md §10)
----------------------
* **Instruments are always functional.** A ``Counter`` is an attribute
  add on a Python int — load-bearing scheduler state (occupancy,
  model-step counts) reads straight through them, so there is no
  "metrics off means the scheduler forgets how many steps it ran".
* **``enabled`` gates the optional work.** Hot paths consult
  ``registry.enabled`` before doing anything beyond the core counters —
  per-slot code-length accumulation, histogram observes, span timing,
  periodic log lines. With ``enabled=False`` the telemetry cost of a
  scheduler step is one boolean attribute check (~0; gated in CI by
  ``benchmarks/run.py telemetry_overhead``).
* **Process-global default + injectable instances.** Module-level code
  (spans, structured logs, dryrun error counters) records into
  ``obs.registry()``; components that need isolation (a
  ``CompressionService`` whose ``stats()`` must describe *its own*
  traffic) construct or accept their own ``MetricsRegistry``. Inject
  ``obs.registry()`` to aggregate a component into the process view.

Naming scheme: dot-separated lowercase ``<subsystem>.<noun>[_<unit>]``
(``scheduler.model_steps``, ``compress.escapes``,
``chunk.bits_per_token``, ``span.<path>.seconds``). Prometheus
exposition mangles dots and slashes to underscores.

Histogram buckets are fixed powers of two: value v lands in the bucket
``(2**(e-1), 2**e]`` with ``e = frexp(v)[1]``, clamped to e ∈ [-31, 32]
(64 buckets + a zero bucket). One scheme serves seconds (µs..minutes)
and bits/token (0.01..1000) without per-metric configuration, and two
snapshots taken at different times always have aligned bucket edges —
what a trajectory tracker (results/BENCH_*.metrics.json) needs.
"""
from __future__ import annotations

import json
import math
import threading
from typing import Union

_EXP_LO = -31            # smallest bucket exponent (le = 2**-31 ≈ 4.7e-10)
_EXP_HI = 32             # largest  bucket exponent (le = 2**32)
_NBUCKETS = _EXP_HI - _EXP_LO + 2   # + zero bucket + overflow-into-last

# Canonical router-decision counter names (DESIGN.md §11). Defined here —
# not in core/ — so the compressor, the service scheduler, and dashboards
# all key the same strings; drift between producers would silently split
# one decision stream across two metric names.
ROUTER_CHUNKS_LLM = "router.chunks_llm"
ROUTER_CHUNKS_FALLBACK = "router.chunks_fallback"
ROUTER_PROBE_SKIPS = "router.probe_skips"
ROUTER_FLIPS = "router.flips"


class Counter:
    """Monotonic counter. ``value`` is plain read/write on purpose: the
    SchedulerStats compatibility view assigns through it."""

    __slots__ = ("name", "help", "value")

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self.value: Union[int, float] = 0

    def inc(self, n: Union[int, float] = 1) -> None:
        self.value += n

    def reset(self) -> None:
        self.value = 0


class Gauge:
    """Last-write-wins instantaneous value."""

    __slots__ = ("name", "help", "value")

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self.value: float = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)


class Histogram:
    """Fixed log2-bucket histogram (see module docstring)."""

    __slots__ = ("name", "help", "counts", "count", "sum")

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self.counts = [0] * _NBUCKETS
        self.count = 0
        self.sum = 0.0

    @staticmethod
    def bucket_index(v: float) -> int:
        if v <= 0.0:
            return 0
        e = math.frexp(v)[1]            # v in (2**(e-1), 2**e]
        return min(max(e, _EXP_LO), _EXP_HI) - _EXP_LO + 1

    @staticmethod
    def bucket_le(idx: int) -> float:
        """Upper bound of bucket ``idx`` (0 is the v<=0 bucket)."""
        if idx == 0:
            return 0.0
        return 2.0 ** (idx - 1 + _EXP_LO)

    def observe(self, v: float) -> None:
        v = float(v)
        self.count += 1
        self.sum += v
        self.counts[self.bucket_index(v)] += 1

    def observe_many(self, values) -> None:
        for v in values:
            self.observe(float(v))

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else 0.0

    def quantile(self, q: float) -> float:
        """Bucket-resolution quantile (upper bound of the bucket holding
        the q'th observation) — coarse by design, trajectory-stable."""
        if not self.count:
            return 0.0
        target = q * self.count
        acc = 0
        for i, c in enumerate(self.counts):
            acc += c
            if acc >= target:
                return self.bucket_le(i)
        return self.bucket_le(_NBUCKETS - 1)

    def nonzero_buckets(self) -> dict:
        """{le: count} for occupied buckets (sparse snapshot form)."""
        return {self.bucket_le(i): c
                for i, c in enumerate(self.counts) if c}


class MetricsRegistry:
    """Name -> instrument store with snapshot/exposition surfaces.

    Thread-safe for instrument *creation*; increments are plain attribute
    arithmetic (the GIL makes them atomic enough for telemetry, and the
    hot paths must not pay a lock).
    """

    def __init__(self, enabled: bool = True, name: str = ""):
        self.enabled = bool(enabled)
        self.name = name
        self._metrics: dict = {}
        self._lock = threading.Lock()

    # ----------------------------------------------------------- factories
    def _get(self, cls, name: str, help: str):
        m = self._metrics.get(name)
        if m is None:
            with self._lock:
                m = self._metrics.get(name)
                if m is None:
                    m = cls(name, help)
                    self._metrics[name] = m
        if not isinstance(m, cls):
            raise TypeError(f"metric {name!r} already registered as "
                            f"{type(m).__name__}, not {cls.__name__}")
        return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get(Gauge, name, help)

    def histogram(self, name: str, help: str = "") -> Histogram:
        return self._get(Histogram, name, help)

    def get(self, name: str):
        """Metric by name, or None (read-side: no accidental creation)."""
        return self._metrics.get(name)

    def value(self, name: str, default=0):
        m = self._metrics.get(name)
        return default if m is None or isinstance(m, Histogram) else m.value

    def clear(self) -> None:
        with self._lock:
            self._metrics.clear()

    # ------------------------------------------------------------- export
    def snapshot(self) -> dict:
        """Structured dump: {name: typed dict}, JSON-serializable."""
        out = {}
        for name in sorted(self._metrics):
            m = self._metrics[name]
            if isinstance(m, Counter):
                out[name] = {"type": "counter", "value": m.value}
            elif isinstance(m, Gauge):
                out[name] = {"type": "gauge", "value": m.value}
            else:
                out[name] = {
                    "type": "histogram", "count": m.count,
                    "sum": m.sum, "mean": m.mean,
                    "p50": m.quantile(0.5), "p95": m.quantile(0.95),
                    "p99": m.quantile(0.99),
                    "buckets": {repr(le): c
                                for le, c in m.nonzero_buckets().items()},
                }
        return out

    def to_json(self, indent: int = 1) -> str:
        return json.dumps(self.snapshot(), indent=indent)

    def to_prometheus(self) -> str:
        """Prometheus text exposition (text/plain; version 0.0.4)."""
        lines = []
        for name in sorted(self._metrics):
            m = self._metrics[name]
            pname = _prom_name(name)
            if m.help:
                lines.append(f"# HELP {pname} {_prom_help(m.help)}")
            if isinstance(m, Counter):
                lines.append(f"# TYPE {pname} counter")
                lines.append(f"{pname} {_prom_num(m.value)}")
            elif isinstance(m, Gauge):
                lines.append(f"# TYPE {pname} gauge")
                lines.append(f"{pname} {_prom_num(m.value)}")
            else:
                lines.append(f"# TYPE {pname} histogram")
                acc = 0
                for i, c in enumerate(m.counts):
                    if not c:
                        continue
                    acc += c
                    le = _prom_num(m.bucket_le(i))
                    lines.append(f'{pname}_bucket{{le="{le}"}} {acc}')
                lines.append(f'{pname}_bucket{{le="+Inf"}} {m.count}')
                lines.append(f"{pname}_sum {_prom_num(m.sum)}")
                lines.append(f"{pname}_count {m.count}")
                # bucket-resolution quantiles as companion gauges (the
                # native histogram type has no quantile series; scrapers
                # that can't run histogram_quantile() still get p50/95/99)
                for q, suffix in ((0.5, "p50"), (0.95, "p95"),
                                  (0.99, "p99")):
                    qname = f"{pname}_{suffix}"
                    lines.append(f"# TYPE {qname} gauge")
                    lines.append(f"{qname} {_prom_num(m.quantile(q))}")
        return "\n".join(lines) + ("\n" if lines else "")


def _prom_name(name: str) -> str:
    out = "".join(c if c.isalnum() or c == "_" else "_" for c in name)
    if not out or out[0].isdigit():
        out = "m_" + out
    return "repro_" + out


def _prom_help(text: str) -> str:
    """Escape HELP text per the 0.0.4 exposition format: backslash and
    newline only (HELP lines; label values would also escape quotes)."""
    return text.replace("\\", "\\\\").replace("\n", "\\n")


def _prom_num(v) -> str:
    if isinstance(v, int):
        return str(v)
    f = float(v)
    return repr(f) if f != int(f) else str(int(f))


# --------------------------------------------------------- process default
_default = MetricsRegistry(name="default")


def registry() -> MetricsRegistry:
    """The process-global default registry."""
    return _default


def set_registry(reg: MetricsRegistry) -> MetricsRegistry:
    """Swap the process-global registry; returns the previous one."""
    global _default
    old = _default
    _default = reg
    return old
