"""Structured logging: one event name + key=value fields per line.

``obs.log("scheduler.progress", steps=4096, occupancy=0.97)`` emits

    scheduler.progress steps=4096 occupancy=0.97

through the stdlib ``repro`` logger (so handlers, capture, and level
control all behave normally under pytest / services), and every
``obs.log_error``/``obs.log_exception`` call additionally increments
``errors.total`` and ``errors.<event>`` counters in the process-global
registry — failures are *countable* in ``stats()``/exposition, not just
greppable in text.

``exception_record(exc)`` is the structured replacement for
``traceback.format_exc()`` string concatenation: a JSON-serializable
dict with the exception type, message, and frame list, suitable for
error sidecar files (see launch/dryrun.py).

The repo lint (tools/lint_no_print.py, wired into CI) forbids bare
``print(`` anywhere in src/repro outside cli.py — operational output
goes through this module so it carries a level, a logger name, and a
counter.
"""
from __future__ import annotations

import logging
import os
import sys
import traceback

from . import metrics as _metrics

_LOGGER_NAME = "repro"
_configured = False


def get_logger(name: str = _LOGGER_NAME) -> logging.Logger:
    """The repo logger, lazily fitted with a stderr handler + level from
    $REPRO_LOG_LEVEL (default INFO) unless the application configured
    logging itself."""
    global _configured
    logger = logging.getLogger(name)
    if not _configured:
        _configured = True
        root = logging.getLogger(_LOGGER_NAME)
        if not root.handlers and not logging.getLogger().handlers:
            h = logging.StreamHandler()
            h.setFormatter(logging.Formatter(
                "%(asctime)s %(levelname).1s %(name)s %(message)s",
                datefmt="%H:%M:%S"))
            root.addHandler(h)
        root.setLevel(os.environ.get("REPRO_LOG_LEVEL", "INFO").upper())
    return logger


def configure(stream=None, level: str | None = None) -> logging.Logger:
    """Explicitly fit the repro logger with exactly one handler writing
    to ``stream`` (default stderr) — for CLI entrypoints whose
    operational log *is* their stdout contract (launch/train.py: the
    watchdog test greps the trainer's stdout for train.resume /
    train.done). Replaces any handler a previous configuration installed
    and marks the logger configured so ``get_logger`` leaves it alone."""
    global _configured
    _configured = True
    root = logging.getLogger(_LOGGER_NAME)
    for h in list(root.handlers):
        root.removeHandler(h)
    h = logging.StreamHandler(stream)
    h.setFormatter(logging.Formatter(
        "%(asctime)s %(levelname).1s %(name)s %(message)s",
        datefmt="%H:%M:%S"))
    root.addHandler(h)
    root.setLevel((level or os.environ.get("REPRO_LOG_LEVEL",
                                           "INFO")).upper())
    return root


def console(msg="", *, err: bool = False) -> None:
    """Raw console line for CLI-style tools (benchmarks/, tools/) whose
    stdout IS their contract — result tables, gate verdicts, usage text.
    Unlike ``log()`` there is no level/timestamp prefix; unlike bare
    ``print()`` it is the one funnel the no-print lint allows, so every
    operational emit site is enumerable."""
    stream = sys.stderr if err else sys.stdout
    stream.write(str(msg) + "\n")


def _fmt_value(v) -> str:
    if isinstance(v, float):
        return f"{v:.6g}"
    s = str(v)
    return repr(s) if " " in s or "=" in s else s


def format_event(event: str, fields: dict) -> str:
    if not fields:
        return event
    return event + " " + " ".join(
        f"{k}={_fmt_value(v)}" for k, v in fields.items())


def log(event: str, _level: int = logging.INFO, **fields) -> None:
    """Emit one structured line: ``event k=v k=v ...``."""
    get_logger().log(_level, format_event(event, fields))


def log_error(event: str, **fields) -> None:
    """ERROR-level structured line + errors.total / errors.<event>
    counters in the process-global registry."""
    reg = _metrics.registry()
    reg.counter("errors.total", "structured error events").inc()
    reg.counter("errors." + event).inc()
    log(event, _level=logging.ERROR, **fields)


def log_exception(event: str, exc: BaseException, **fields) -> None:
    """log_error + exception type/message fields + DEBUG traceback."""
    log_error(event, error=f"{type(exc).__name__}: {exc}", **fields)
    get_logger().debug("".join(traceback.format_exception(
        type(exc), exc, exc.__traceback__)))


def exception_record(exc: BaseException) -> dict:
    """JSON-serializable structured form of an exception + traceback."""
    return {
        "type": type(exc).__name__,
        "message": str(exc),
        "traceback": [
            {"file": f.filename, "line": f.lineno, "func": f.name,
             "code": f.line or ""}
            for f in traceback.extract_tb(exc.__traceback__)
        ],
    }
