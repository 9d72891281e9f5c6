"""The port's ``obs`` layer held to the JAX package's tests, on the CPU.

``tests/test_obs.py`` (registry, spans, logs, scheduler stats, service
stats, diagnostics and sidecars, byte identity with telemetry on and off)
and ``tests/test_attribution.py`` (timeline ring, Chrome-trace export,
span failure safety, per-thread span stacks, phase reports, Prometheus
exposition) replayed against ``repro_torch.obs`` and the port's
``CompressionService`` / ``LLMCompressor`` over the ``GoldenPredictor``
table. The benchmark-history, regression-gate and roofline tests stay
with the benchmark, which the port does not have yet.

On top of the replay:

* the two packages' services, given the same tokens, expose the same
  Prometheus text (apart from time-valued series) and snapshots with the
  same keys and counters;
* the device mirror: under ``torch.profiler`` a mirrored span is a
  ``record_function`` event of its name and a ``mirror=False`` span is
  not; with no profiler active ``record_function`` is never entered; the
  coded bytes are the same with the mirror on and off;
* ``tools/lint_no_print.py`` finds no bare ``print(`` in the port outside
  ``cli.py``.
"""
import importlib.util
import json
import pathlib
import re
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401  (caps torch's threads)

from _hypo import given, settings, st  # noqa: E402
from helpers import GoldenPredictor  # noqa: E402
from repro.service import CompressionService as JaxService  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch.core import ContainerError, LLMCompressor  # noqa: E402
from repro_torch.obs.metrics import (Histogram,  # noqa: E402
                                     MetricsRegistry)
from repro_torch.obs.timeline import (PhaseReport, SpanEvent,  # noqa: E402
                                      TimelineRecorder, phase_of,
                                      phases_from_registry)
from repro_torch.service import CompressionService  # noqa: E402
from repro_torch.service.scheduler import SchedulerStats  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parents[1]


def _service(**kw):
    return CompressionService(GoldenPredictor(), device="cpu", **kw)


# ------------------------------------------------------------- registry
def test_counter_gauge_roundtrip():
    reg = MetricsRegistry()
    c = reg.counter("x.count", "help text")
    c.inc()
    c.inc(4)
    assert c.value == 5 and reg.value("x.count") == 5
    g = reg.gauge("x.level")
    g.set(2.5)
    assert reg.get("x.level").value == 2.5
    assert reg.value("missing", default=-1) == -1
    assert reg.counter("x.count") is c
    with pytest.raises(TypeError):
        reg.gauge("x.count")


def test_histogram_buckets_quantiles():
    h = Histogram("h")
    for v in (0.0, 0.75, 1.5, 3.0, 3.9, 100.0):
        h.observe(v)
    assert h.count == 6
    assert h.sum == pytest.approx(109.15)
    assert h.nonzero_buckets() == {0.0: 1, 1.0: 1, 2.0: 1, 4.0: 2, 128.0: 1}
    assert h.quantile(0.5) == 2.0
    assert h.quantile(1.0) == 128.0
    assert h.mean == pytest.approx(109.15 / 6)


def test_snapshot_and_prometheus():
    reg = MetricsRegistry(name="t")
    reg.counter("a.total", "things").inc(3)
    reg.histogram("b.seconds").observe(0.5)
    snap = reg.snapshot()
    assert snap["a.total"] == {"type": "counter", "value": 3}
    assert snap["b.seconds"]["count"] == 1
    json.loads(reg.to_json())
    prom = reg.to_prometheus()
    assert "# TYPE repro_a_total counter" in prom
    assert "repro_a_total 3" in prom
    assert 'repro_b_seconds_bucket{le="+Inf"} 1' in prom
    assert "repro_b_seconds_count 1" in prom


# ---------------------------------------------------------------- spans
def test_span_nesting_records_path_histogram():
    reg = MetricsRegistry()
    with obs.span("outer", reg):
        assert obs.trace.current() == "outer"
        with obs.span("inner", reg):
            assert obs.trace.current() == "outer/inner"
    assert obs.trace.current() == ""
    assert reg.get("span.outer.seconds").count == 1
    assert reg.get("span.outer/inner.seconds").count == 1


def test_span_disabled_is_noop():
    reg = MetricsRegistry(enabled=False)
    sp = obs.span("quiet", reg)
    assert sp is obs.trace.NULL
    with sp:
        pass
    assert reg.get("span.quiet.seconds") is None


# ----------------------------------------------------------------- logs
def test_log_error_increments_counters():
    prev = obs.set_registry(MetricsRegistry())
    try:
        obs.log_error("unit.test_event", detail="x y")
        reg = obs.registry()
        assert reg.value("errors.total") == 1
        assert reg.value("errors.unit.test_event") == 1
    finally:
        obs.set_registry(prev)
    assert obs.format_event("e", {"a": 1, "b": "x y"}) == "e a=1 b='x y'"


def test_exception_record_structure():
    try:
        raise ValueError("boom")
    except ValueError as e:
        rec = obs.exception_record(e)
    assert rec["type"] == "ValueError" and rec["message"] == "boom"
    assert rec["traceback"][-1]["func"] == "test_exception_record_structure"
    json.dumps(rec)


# -------------------------------------------------- SchedulerStats view
def test_scheduler_stats_attribute_compat():
    s = SchedulerStats()
    assert s.occupancy == 0.0
    s.model_steps += 3
    s.lane_steps += 12
    s.token_steps += 9
    assert (s.model_steps, s.steps) == (3, 3)
    assert s.occupancy == pytest.approx(0.75)
    assert s.registry.value("scheduler.model_steps") == 3
    assert s.snapshot()["occupancy"] == pytest.approx(0.75)
    assert SchedulerStats().model_steps == 0


# --------------------------------------------------- service stats surface
def _roundtrip_service(toks, enabled=True, topk=8, slots=4, chunk=16):
    svc = _service(slots=slots, chunk_size=chunk, topk=topk)
    svc.registry.enabled = enabled
    ch = svc.submit_compress(toks)
    blob, _ = ch.result()
    dh = svc.submit_decompress(blob)
    assert np.array_equal(dh.result(), toks)
    return svc, ch, dh, blob


def test_service_stats_dual_api():
    toks = np.random.default_rng(7).integers(0, 63, 150).astype(np.int32)
    svc, *_ = _roundtrip_service(toks)
    assert svc.stats.model_steps > 0
    assert 0.0 < svc.stats.occupancy <= 1.0
    snap = svc.stats()
    assert snap == svc.snapshot()
    assert snap["jobs"] == {"submitted": 2, "failed": 0,
                            "compress": 1, "decompress": 1}
    assert snap["occupancy"] == pytest.approx(svc.stats.occupancy)
    assert snap["chunk_bits_per_token"]["count"] == 2 * 10
    assert snap["draft_acceptance"] is None
    assert snap["metrics"]["scheduler.model_steps"]["value"] \
        == svc.stats.model_steps
    json.dumps(snap, default=str)


def test_service_stats_prometheus_exposition():
    toks = np.random.default_rng(8).integers(0, 63, 40).astype(np.int32)
    svc, *_ = _roundtrip_service(toks)
    prom = svc.registry.to_prometheus()
    assert "repro_scheduler_model_steps" in prom
    assert "repro_chunk_bits_per_token_count" in prom


_TIMED = re.compile(r"seconds|phase")


def _keys(d, prefix=""):
    out = set()
    for k, v in d.items():
        out.add(prefix + k)
        if isinstance(v, dict) and k != "metrics":
            out |= _keys(v, prefix + k + ".")
    return out


def test_service_telemetry_matches_jax():
    """The same tokens through both packages' services: the same
    Prometheus text apart from time-valued series, and snapshots with the
    same keys and the same counters."""
    toks = np.random.default_rng(7).integers(0, 63, 150).astype(np.int32)
    svcs = []
    for make in (lambda: JaxService(GoldenPredictor(), slots=4,
                                    chunk_size=16, topk=8),
                 lambda: _service(slots=4, chunk_size=16, topk=8)):
        svc = make()
        blob, _ = svc.submit_compress(toks).result()
        assert np.array_equal(svc.submit_decompress(blob).result(), toks)
        svcs.append(svc)
    j, p = (s.registry.to_prometheus().splitlines() for s in svcs)
    assert [ln for ln in p if not _TIMED.search(ln)] \
        == [ln for ln in j if not _TIMED.search(ln)]
    js, ps = (s.snapshot() for s in svcs)
    assert _keys(ps) == _keys(js)
    assert set(ps["metrics"]) == set(js["metrics"])
    for key in ("scheduler", "occupancy", "jobs", "prefix_cache",
                "draft_acceptance", "chunk_bits_per_token"):
        assert ps[key] == js[key], key
    assert set(ps["phases"]) == set(js["phases"])


# -------------------------------------------------------- job diagnostics
def test_job_diagnostics_and_sidecar(tmp_path):
    n, chunk = 150, 16
    toks = np.random.default_rng(9).integers(0, 63, n).astype(np.int32)
    svc, ch, dh, blob = _roundtrip_service(toks, chunk=chunk)
    for h, kind in ((ch, "compress"), (dh, "decompress")):
        diag = h.diagnostics
        assert diag.kind == kind and diag.codec == "rans"
        assert diag.n_tokens == n
        assert len(diag.chunks) == -(-n // chunk)
        assert [c.chunk_index for c in diag.chunks] == list(range(10))
        assert sum(c.n_tokens for c in diag.chunks) == n
        assert all(c.bits_per_token > 0 for c in diag.chunks)
        for c in diag.chunks:
            assert 0 < c.coded_bits <= 8 * c.stream_bytes
        assert diag.draft_acceptance is None
    assert ch.diagnostics.container_bytes == len(blob)
    for cc, dc in zip(ch.diagnostics.chunks, dh.diagnostics.chunks):
        assert cc.coded_bits == pytest.approx(dc.coded_bits, rel=1e-9)
        assert cc.n_escapes == dc.n_escapes
    target = tmp_path / "a.llmc"
    target.write_bytes(blob)
    path = dh.write_sidecar(target)
    assert path == tmp_path / "a.llmc.diag.json"
    rec = obs.read_sidecar(target)
    assert rec["kind"] == "decompress" and rec["n_tokens"] == n
    assert len(rec["chunks"]) == 10


def test_diagnostics_empty_when_disabled():
    toks = np.random.default_rng(10).integers(0, 63, 50).astype(np.int32)
    svc, ch, dh, _ = _roundtrip_service(toks, enabled=False)
    assert ch.diagnostics.chunks == []
    assert dh.diagnostics.chunks == []
    assert svc.stats.model_steps > 0
    assert svc.snapshot()["chunk_bits_per_token"] is None


def test_job_failure_counted_once():
    """A mid-flight chunk failure (a v3 stream flipped: no checksums)
    counts one chunk failure and one job failure."""
    pred = GoldenPredictor()
    comp = LLMCompressor(pred, chunk_size=16, topk=8, decode_batch=4,
                         container_version=3)
    toks = np.random.default_rng(11).integers(0, 63, 64).astype(np.int32)
    blob, _ = comp.compress(toks)
    bad = bytearray(blob)
    bad[len(bad) // 2] ^= 0x10
    svc = _service(slots=4, chunk_size=16, topk=8)
    with pytest.raises(ContainerError):
        svc.submit_decompress(bytes(bad)).result()
    assert svc.stats.chunk_failures >= 1
    assert svc.registry.value("service.jobs_failed") == 1
    assert svc.snapshot()["jobs"]["failed"] == 1
    assert obs.registry().value("errors.scheduler.chunk_failed") >= 1


# --------------------------------------- byte-identity: the hard invariant
def _compress_blob(pred, toks, enabled, *, topk, codec, draft_k=0):
    reg = MetricsRegistry(enabled=enabled)
    comp = LLMCompressor(pred, chunk_size=16, topk=topk, decode_batch=4,
                         codec=codec, draft_k=draft_k, registry=reg)
    blob, _ = comp.compress(toks)
    assert np.array_equal(comp.decompress(blob), toks), "LOSSLESS VIOLATION"
    return blob


@settings(max_examples=8, deadline=None)
@given(st.integers(0, 2**31 - 1), st.integers(1, 120))
def test_byte_identity_enabled_vs_disabled(seed, n):
    pred = GoldenPredictor()
    toks = np.random.default_rng(seed).integers(0, 63, n).astype(np.int32)
    for codec, topk, draft_k in (("rans", 0, 0), ("rans", 8, 0),
                                 ("rans", 8, 4), ("ac", 8, 0)):
        on = _compress_blob(pred, toks, True, topk=topk, codec=codec,
                            draft_k=draft_k)
        off = _compress_blob(pred, toks, False, topk=topk, codec=codec,
                             draft_k=draft_k)
        assert on == off, f"telemetry changed bytes ({codec}, k={topk})"


def test_byte_identity_service_paths():
    toks = np.random.default_rng(13).integers(0, 63, 300).astype(np.int32)
    _, _, _, blob_on = _roundtrip_service(toks, enabled=True)
    _, _, _, blob_off = _roundtrip_service(toks, enabled=False)
    assert blob_on == blob_off
    ref = LLMCompressor(GoldenPredictor(), chunk_size=16, topk=8,
                        decode_batch=4, container_version=4)
    assert blob_on == ref.compress(toks)[0]


def test_speculative_diagnostics_counters():
    pred = GoldenPredictor()
    argmax = pred._table.argmax(axis=-1)
    toks = np.zeros(256, np.int32)
    prev = pred.bos_id
    for i in range(256):
        prev = toks[i] = argmax[prev]
    reg = MetricsRegistry()
    comp = LLMCompressor(pred, chunk_size=32, topk=8, decode_batch=4,
                         draft_k=4, registry=reg)
    blob, _ = comp.compress(toks)
    assert np.array_equal(comp.decompress(blob), toks)
    assert reg.value("spec.rounds") > 0
    assert reg.value("spec.drafted_tokens") > 0
    assert 0 <= reg.value("spec.drafted_accepted") \
        <= reg.value("spec.drafted_tokens")
    h = reg.get("spec.accept_depth")
    assert h is not None and h.count > 0


# ------------------------------------------------------ timeline recorder
def test_ring_buffer_bounds_and_drop_counter():
    rec = TimelineRecorder(capacity=8)
    for i in range(20):
        rec.record(f"s{i}", f"s{i}", t0=float(i), dur=0.5)
    assert len(rec) == 8
    assert rec.dropped == 12
    evs = rec.events()
    assert [e.name for e in evs] == [f"s{i}" for i in range(12, 20)]
    with pytest.raises(ValueError):
        TimelineRecorder(capacity=0)


def test_spans_feed_installed_recorder():
    reg = MetricsRegistry()
    with TimelineRecorder() as rec:
        with obs.span("outer", reg, tags={"job": 1}):
            with obs.span("model.step", reg):
                pass
    assert obs.timeline.active() is None
    evs = rec.events()
    assert [e.name for e in evs] == ["outer", "model.step"]
    assert evs[1].path == "outer/model.step"
    assert evs[0].tags == {"job": 1}
    assert evs[0].t0 <= evs[1].t0 and evs[1].t1 <= evs[0].t1 + 1e-9
    with obs.span("after", reg):
        pass
    assert len(rec.events()) == 2


def test_timeline_only_span_overrides_registry_gate():
    reg = MetricsRegistry(enabled=False)
    assert obs.span("quiet", reg) is obs.trace.NULL
    with TimelineRecorder() as rec:
        sp = obs.span("quiet", reg)
        assert sp is not obs.trace.NULL
        with sp:
            pass
    assert [e.name for e in rec.events()] == ["quiet"]
    assert reg.get("span.quiet.seconds") is None


def test_chrome_trace_structure(tmp_path):
    reg = MetricsRegistry()
    with TimelineRecorder() as rec:
        with obs.span("service.step", reg):
            with obs.span("model.decode_step", reg):
                pass
    path = tmp_path / "trace.json"
    rec.save(path)
    doc = json.loads(path.read_text())
    assert doc["displayTimeUnit"] == "ms"
    assert doc["otherData"]["dropped_events"] == 0
    evs = doc["traceEvents"]
    meta = [e for e in evs if e["ph"] == "M"]
    assert meta and meta[0]["name"] == "process_name"
    xs = [e for e in evs if e["ph"] == "X"]
    assert {e["name"] for e in xs} == {"service.step", "model.decode_step"}
    for e in xs:
        assert e["ts"] >= 0 and e["dur"] >= 0
        assert isinstance(e["tid"], int) and e["pid"] == 1
        assert e["cat"] == phase_of(e["name"])
        assert "path" in e["args"]


# --------------------------------------------------- span failure safety
def test_span_exception_restores_nesting_path():
    reg = MetricsRegistry()
    with pytest.raises(RuntimeError):
        with obs.span("outer", reg):
            with obs.span("inner", reg):
                raise RuntimeError("boom")
    assert obs.trace.current() == ""
    assert reg.get("span.outer.seconds").count == 1
    assert reg.get("span.outer/inner.seconds").count == 1


def test_span_stack_is_per_thread():
    reg = MetricsRegistry()
    paths = {}

    def worker(tag):
        with obs.span(tag, reg):
            paths[tag] = obs.trace.current()

    with obs.span("main_outer", reg):
        ts = [threading.Thread(target=worker, args=(f"t{i}",))
              for i in range(4)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=30)
        assert not any(t.is_alive() for t in ts)
        assert obs.trace.current() == "main_outer"
    assert paths == {f"t{i}": f"t{i}" for i in range(4)}


def test_recorder_safe_from_many_threads():
    rec = TimelineRecorder(capacity=64)
    barrier = threading.Barrier(8)

    def pound():
        barrier.wait()
        for i in range(100):
            rec.record("x", "x", t0=float(i), dur=0.1)

    ts = [threading.Thread(target=pound) for _ in range(8)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in ts)
    assert len(rec) == 64
    assert rec.dropped == 8 * 100 - 64
    assert len(rec.events()) == 64


# -------------------------------------------------------- phase rollup
def test_phase_report_exclusive_attribution():
    evs = [
        SpanEvent("service.step", "service.step", 1.0, 8.0, tid=1),
        SpanEvent("model.decode_step", "service.step/model.decode_step",
                  2.0, 3.0, tid=1),
        SpanEvent("rans.flush_slot", "service.step/rans.flush_slot",
                  6.0, 2.0, tid=1),
    ]
    rep = PhaseReport.from_events(evs, t0=0.0, t1=10.0)
    assert rep.total_s == 10.0
    assert rep.phases["scheduler"] == pytest.approx(3.0)
    assert rep.phases["model"] == pytest.approx(3.0)
    assert rep.phases["coder"] == pytest.approx(2.0)
    assert rep.phases["unattributed"] == pytest.approx(2.0)
    assert sum(rep.phases.values()) == pytest.approx(rep.total_s)
    assert rep.coverage == pytest.approx(0.8)
    clipped = PhaseReport.from_events(evs, t0=3.0, t1=10.0)
    assert clipped.phases["model"] == pytest.approx(2.0)
    d = rep.to_dict()
    assert d["coverage"] == pytest.approx(0.8)
    json.dumps(d)


def test_phase_report_empty_window():
    rep = PhaseReport.from_events([], t0=0.0, t1=0.0)
    assert rep.total_s == 0.0 and rep.coverage == 0.0
    assert sum(rep.phases.values()) == 0.0


def test_phases_from_registry_direct_child_subtraction():
    reg = MetricsRegistry()
    reg.histogram("span.service.step.seconds").observe(10.0)
    reg.histogram("span.service.step/model.decode_step.seconds").observe(6.0)
    reg.histogram(
        "span.service.step/model.decode_step/host.pack.seconds").observe(1.0)
    ph = phases_from_registry(reg)
    assert ph["scheduler"] == pytest.approx(4.0)
    assert ph["model"] == pytest.approx(5.0)
    assert ph["host"] == pytest.approx(1.0)


# ------------------------------------- traced service run (end to end)
def _traced_roundtrip(tmp_path, n=300, chunk=16):
    toks = np.random.default_rng(21).integers(0, 63, n).astype(np.int32)
    out_path = tmp_path / "svc.trace.json"
    svc = _service(slots=4, chunk_size=chunk, topk=8, trace=str(out_path))
    try:
        ch = svc.submit_compress(toks)
        blob, _ = ch.result()
        dh = svc.submit_decompress(blob)
        assert np.array_equal(dh.result(), toks)
        reports = [h.phase_report() for h in (ch, dh)]
        diags = [h.diagnostics for h in (ch, dh)]
    finally:
        svc.close()
    return blob, out_path, reports, diags


def test_service_trace_export_and_phase_report(tmp_path):
    blob, out_path, reports, diags = _traced_roundtrip(tmp_path)
    doc = json.loads(out_path.read_text())
    xs = [e for e in doc["traceEvents"] if e["ph"] == "X"]
    assert len(xs) > 10
    assert {"scheduler", "model", "coder"} <= {e["cat"] for e in xs}
    for rep, diag in zip(reports, diags):
        assert rep.total_s > 0
        assert sum(rep.phases.values()) == pytest.approx(
            rep.total_s, rel=0.05)
        assert rep.coverage >= 0.90, \
            f"coverage {rep.coverage:.3f} < 0.90 ({rep.phases})"
        assert rep.phases.get("model", 0.0) > 0
        assert diag.phases is not None
        assert diag.wall_s > 0
    assert obs.timeline.active() is None


def test_trace_keeps_bytes_identical(tmp_path):
    toks = np.random.default_rng(21).integers(0, 63, 200).astype(np.int32)
    plain, _ = _service(slots=4, chunk_size=16, topk=8) \
        .submit_compress(toks).result()
    traced, *_ = _traced_roundtrip(tmp_path, n=200)
    assert traced == plain


def test_snapshot_quantiles_and_phases():
    toks = np.random.default_rng(23).integers(0, 63, 150).astype(np.int32)
    svc = _service(slots=4, chunk_size=16, topk=8)
    blob, _ = svc.submit_compress(toks).result()
    assert np.array_equal(svc.submit_decompress(blob).result(), toks)
    snap = svc.snapshot()
    bpt = snap["chunk_bits_per_token"]
    for k in ("p50", "p95", "p99"):
        assert k in bpt and bpt[k] >= 0
    assert bpt["p50"] <= bpt["p95"] <= bpt["p99"]
    assert "phases" in snap
    assert all(v >= 0 for v in snap["phases"].values())
    json.dumps(snap, default=str)


# ------------------------------------ Prometheus exposition conformance
def _parse_prometheus(text):
    samples, types = {}, {}
    for line in text.splitlines():
        if not line.strip():
            continue
        if line.startswith("# TYPE "):
            _, _, name, typ = line.split()
            types[name] = typ
            continue
        if line.startswith("#"):
            continue
        name_part, _, val = line.rpartition(" ")
        assert name_part, f"unparseable sample line: {line!r}"
        if "{" in name_part:
            name, _, rest = name_part.partition("{")
            labels = rest.rstrip("}")
        else:
            name, labels = name_part, ""
        float(val)
        samples.setdefault(name, {})[labels] = float(val)
    return samples, types


def test_prometheus_exposition_conformance():
    reg = MetricsRegistry(name="t")
    reg.counter("jobs.total", "jobs").inc(3)
    reg.gauge("queue.depth").set(2)
    h = reg.histogram("step.seconds", "step wall")
    for v in (0.001, 0.002, 0.004, 0.1, 1.5, 30.0):
        h.observe(v)
    samples, types = _parse_prometheus(reg.to_prometheus())
    assert types["repro_jobs_total"] == "counter"
    assert types["repro_queue_depth"] == "gauge"
    assert types["repro_step_seconds"] == "histogram"
    buckets = samples["repro_step_seconds_bucket"]
    pairs = []
    for labels, v in buckets.items():
        le = labels.split('le="')[1].rstrip('"')
        pairs.append((float("inf") if le == "+Inf" else float(le), v))
    pairs.sort()
    counts = [v for _, v in pairs]
    assert counts == sorted(counts), "buckets must be cumulative"
    assert pairs[-1][0] == float("inf")
    assert pairs[-1][1] == samples["repro_step_seconds_count"][""] == 6
    assert samples["repro_step_seconds_sum"][""] == pytest.approx(31.607)
    for q in ("p50", "p95", "p99"):
        assert samples[f"repro_step_seconds_{q}"][""] >= 0
    assert samples["repro_step_seconds_p50"][""] \
        <= samples["repro_step_seconds_p99"][""]


# --------------------------------------------------------- device mirror
def _profiled_events(fn):
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return [e.name for e in prof.events()]


def test_mirrored_spans_reach_the_profiler():
    reg = MetricsRegistry()

    def spans():
        with obs.span("mirror.outer", reg):
            with obs.span("mirror.quiet", reg, mirror=False):
                torch.ones(4).add_(1)
    names = _profiled_events(spans)
    assert "mirror.outer" in names
    assert "mirror.quiet" not in names
    # switched off for the process: no span reaches the profiler
    obs.trace.set_torch_mirror(False)
    try:
        assert "mirror.outer" not in _profiled_events(spans)
    finally:
        obs.trace.set_torch_mirror(True)


def test_a_service_job_is_on_the_profile():
    """A compress job's own spans are record_function events; the
    scheduler's per-step coder span is not."""
    toks = np.random.default_rng(3).integers(0, 63, 100).astype(np.int32)
    comp = LLMCompressor(GoldenPredictor(), chunk_size=16, topk=8,
                         decode_batch=4)
    names = _profiled_events(lambda: comp.compress(toks))
    assert "compress.job" in names
    svc = _service(slots=4, chunk_size=16, topk=8, trace=TimelineRecorder())
    try:
        names = _profiled_events(
            lambda: svc.submit_compress(toks).result())
    finally:
        svc.close()
    assert "rans.finish" in names or "rans.flush_slot" in names
    assert "coder.step" not in names and "service.refill" not in names


def test_no_record_function_without_a_profiler(monkeypatch):
    entered = []

    class Counting(torch.autograd.profiler.record_function):
        def __enter__(self):
            entered.append(self.name)
            return super().__enter__()

    monkeypatch.setattr(torch.autograd.profiler, "record_function",
                        Counting)
    toks = np.random.default_rng(4).integers(0, 63, 80).astype(np.int32)
    comp = LLMCompressor(GoldenPredictor(), chunk_size=16, topk=8,
                         decode_batch=4)
    blob, _ = comp.compress(toks)
    assert np.array_equal(comp.decompress(blob), toks)
    _roundtrip_service(toks)
    assert entered == []
    # the same code under a profiler does enter it
    _profiled_events(lambda: comp.compress(toks))
    assert "compress.job" in entered


def test_mirror_keeps_bytes_identical():
    """Under a profiler, with the mirror on and off: the same bytes from
    the grouped path and the service."""
    toks = np.random.default_rng(6).integers(0, 63, 120).astype(np.int32)
    blobs = []

    def both_paths():
        comp = LLMCompressor(GoldenPredictor(), chunk_size=16, topk=8,
                             decode_batch=4, container_version=4)
        svc = _service(slots=4, chunk_size=16, topk=8)
        blobs.append((comp.compress(toks)[0],
                      svc.submit_compress(toks).result()[0]))
    for on in (True, False):
        obs.trace.set_torch_mirror(on)
        try:
            _profiled_events(both_paths)
        finally:
            obs.trace.set_torch_mirror(True)
    assert blobs[0] == blobs[1]
    assert blobs[0][0] == blobs[0][1]


# ------------------------------------------------------------- repo lint
def _load_lint():
    spec = importlib.util.spec_from_file_location(
        "lint_no_print", REPO / "tools" / "lint_no_print.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_port_tree_passes_lint():
    assert _load_lint().lint(REPO / "src" / "repro_torch") == []
