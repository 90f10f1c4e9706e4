"""The port's observability core against the JAX package: the tracer, the
metrics registry, the event classes, event logs (written by either package,
replayed in the other), the LightGBM path's events, and ``annotate`` in a
``torch.profiler`` trace.

Reference modules are imported inside fixtures and tests (the card machine
imports this file without jax). Timings (``t``, ``start``, ``end``,
``duration``, ``wall_start``, ``wt``) are the only fields left out of the
comparisons.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from test_torch_gbdt import _import_reference

# At import, so that every pytest worker has the JAX package's fit path
# before it collects the JAX package's own test files (see
# tests/test_torch_gbdt.py); the card machine has no jax.
try:
    _import_reference()
except ModuleNotFoundError as err:
    if err.name != "jax":
        raise

from mmlspark_tpu_torch import runtime as truntime
from mmlspark_tpu_torch.core import profiling as tprof
from mmlspark_tpu_torch.core import utils as tutils
from mmlspark_tpu_torch.data.table import Table
from mmlspark_tpu_torch.lightgbm import LightGBMClassifier
from mmlspark_tpu_torch.observability import events as tevents
from mmlspark_tpu_torch.observability import registry as tregistry
from mmlspark_tpu_torch.observability import tracing as ttracing

TIMING = {"t", "start", "end", "duration", "wall_start", "wt"}


@pytest.fixture(scope="module")
def ref():
    from mmlspark_tpu.observability import events as jevents
    from mmlspark_tpu.observability import registry as jregistry
    from mmlspark_tpu.observability import tracing as jtracing

    return dict(events=jevents, registry=jregistry, tracing=jtracing)


def _untimed(rec):
    if isinstance(rec, dict):
        return {k: _untimed(v) for k, v in rec.items() if k not in TIMING}
    if isinstance(rec, list):
        return [_untimed(v) for v in rec]
    return rec


# -- tracer -----------------------------------------------------------------------


def _trace_calls(tracing):
    """One script of tracer calls; returns (export, span tree, header dicts)."""
    tr = tracing.Tracer(xprof=False)
    with tr.span("request", rid="r1") as root:
        with tr.span("batch", size=3):
            with tr.span("apply"):
                pass
        try:
            with tr.span("bad"):
                raise KeyError("x")
        except KeyError:
            pass
        manual = tr.start_span("attempt", task=4)
        tr.finish(manual, status="retried", worker=1)
    ctx = tracing.TraceContext.from_span(root)
    remote = tr.start_span("remote", context=ctx)
    tr.finish(remote)
    with tr.span("other-trace"):
        pass
    headers = [ctx.to_headers(), tracing.TraceContext("t9").to_headers(), ctx.to_dict(),
               tracing.TraceContext.from_headers({"X-Trace-Id": "t1"}).to_dict(),
               tracing.TraceContext.from_headers({}), tracing.TraceContext.from_dict(None)]
    return tr.export(), tr.span_tree(root.trace_id), headers, json.loads(tr.to_json(root.trace_id))


def test_tracer_export_and_tree_equal_the_references(ref):
    got = _trace_calls(ttracing)
    want = _trace_calls(ref["tracing"])
    for g, w in zip(got, want):
        assert _untimed(g) == _untimed(w)
    export = got[0]
    assert [s["status"] for s in export][:3] == ["ok", "ok", "KeyError"]
    assert all(s["duration"] >= 0 for s in export)


def test_trace_context_headers_equal_the_references(ref, monkeypatch):
    monkeypatch.setenv("MMLSPARK_TPU_EVENT_LOG_PROCESS", "worker3")
    for tracing in (ttracing, ref["tracing"]):
        tr = tracing.Tracer(xprof=False)
        with tr.span("edge") as sp:
            pass
        ctx = tracing.TraceContext.from_span(sp)
        assert ctx.to_headers() == {"X-Trace-Id": "t00000001",
                                    "X-Parent-Span-Id": "worker3:00000001"}
        child = tr.start_span("child",
                              context=tracing.TraceContext.from_headers(ctx.to_headers()))
        assert (child.trace_id, child.parent_id) == ("t00000001", "worker3:00000001")


def test_finished_spans_are_published_when_the_bus_listens():
    bus = tevents.get_bus()
    got = []
    bus.add_listener(got.append)
    try:
        tr = ttracing.Tracer(xprof=False)
        with tr.span("s", n=1, obj=object()):
            pass
    finally:
        bus.remove_listener(got.append)
    (ev,) = got
    assert isinstance(ev, tevents.SpanRecorded) and ev.tags == {"n": 1} and ev.parent_id == ""


# -- registry -----------------------------------------------------------------------


def _registry_calls(registry):
    reg = registry.MetricsRegistry()
    reg.counter("requests_total", "Requests").inc()
    reg.counter("requests_total").inc(2)
    c = reg.counter("retries_total", "Retries by reason")
    c.labels(reason="timeout").inc()
    c.labels(reason='quote"d').inc(3)
    g = reg.gauge("queue_depth", "Depth")
    g.set(4)
    g.set_max(2)
    g.labels(pool="a").set_max(7.5)
    h = reg.histogram("latency_seconds", "Latency")
    for v in (0.0002, 0.003, 0.04, 0.04, 2.0, 30.0):
        h.observe(v)
    hf = reg.histogram("fit_seconds", "", buckets=registry.FIT_BUCKETS)
    hf.labels(stage="bin").observe(12.0)
    with pytest.raises(ValueError):
        reg.gauge("requests_total")
    with pytest.raises(ValueError):
        reg.counter("x").inc(-1)
    return reg.exposition(), reg.summary(), [h.percentile(q) for q in (0.0, 0.5, 0.95, 1.0)]


def test_registry_renders_the_references_text(ref):
    got, want = _registry_calls(tregistry), _registry_calls(ref["registry"])
    assert got == want
    assert "latency_seconds_bucket{le=\"+Inf\"} 6" in got[0]
    assert tregistry.get_registry() is tregistry.get_registry()


# -- events -----------------------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(tevents._EVENT_TYPES))
def test_event_class_fields_equal_the_references(ref, name):
    mine = dataclasses.fields(tevents._EVENT_TYPES[name])
    theirs = dataclasses.fields(ref["events"]._EVENT_TYPES[name])
    assert [f.name for f in mine] == [f.name for f in theirs]
    assert [f.default for f in mine] == [f.default for f in theirs]


def test_every_reference_event_class_is_ported(ref):
    assert sorted(tevents._EVENT_TYPES) == sorted(ref["events"]._EVENT_TYPES)


def _sample_events(events_mod):
    """One event of each of a few kinds, nested values included."""
    E = events_mod
    return [
        E.StageStarted(job_id=3, stage_id=0, name="LightGBMClassifier"),
        E.StageCompleted(job_id=3, stage_id=0, name="LightGBMClassifier", duration=1.5,
                         status="KeyError"),
        E.HistogramChunked(rows=10, k_packed=128, chunk_rows=4, num_chunks=3,
                           budget_bytes=100, acc_dtype="int16", bytes_saved=7),
        E.MemoryPressure(source="device", level="critical", used_bytes=0.0, limit_bytes=0.0,
                         detail="RESOURCE_EXHAUSTED"),
        E.SpanRecorded(name="fit:X", trace_id="t1", span_id="2", tags={"stage": 0, "ok": True}),
        E.RecordsDeadLettered(source="pipeline.fit", epoch=0, count=12, reasons="rows=1"),
        E.ModelCommitted(model="PipelineModel", version=2, detail="1 stages"),
    ]


@pytest.mark.parametrize("direction", ["port_to_ref", "ref_to_port"])
def test_event_log_replays_in_the_other_package(ref, tmp_path, direction):
    writer, reader = (tevents, ref["events"]) if direction == "port_to_ref" else \
        (ref["events"], tevents)
    path = str(tmp_path / "events.jsonl")
    sink = writer.EventLogSink(path, max_bytes=400, process="driver")  # rotates
    written = _sample_events(writer)
    for ev in written:
        sink(ev)
    sink.close()
    assert len(reader.log_segments(path)) > 1
    replayed = reader.replay(path)
    assert [type(e).__name__ for e in replayed] == [type(e).__name__ for e in written]
    assert [e.to_record() for e in replayed] == [e.to_record() for e in written]
    assert all(e.process == "driver" and e.wt > 0 for e in replayed)
    with pytest.raises(ValueError, match="unknown event type"):
        reader.from_record({"event": "NoSuchEvent"})


def _value(annotation, i, field):
    """A deterministic value for an event field by its annotation."""
    ann = str(annotation)
    if ann.startswith(("Dict", "dict")):
        return {"k": i % 3}
    if ann.startswith(("Optional", "List", "list")):
        return None
    if "float" in ann:
        return 0.25 * (i % 7) + 0.125
    if "bool" in ann:
        return i % 2 == 0
    if "int" in ann:
        return (i * 7 + len(field)) % 5
    if field == "level":
        return ("ok", "warn", "critical")[i % 3]
    return f"{field}{i % 3}"


def _every_event(events_mod, copies=3):
    """``copies`` events of every class, each field filled by its type,
    with fixed ``t`` stamps, in a fixed interleaved order."""
    out = []
    for i in range(copies):
        for j, name in enumerate(sorted(events_mod._EVENT_TYPES)):
            cls = events_mod._EVENT_TYPES[name]
            kw = {f.name: _value(f.type, i + j, f.name) for f in dataclasses.fields(cls)
                  if f.name != "t"}
            out.append(cls(t=1000.0 + 10 * i + 0.01 * j, **kw))
    return out


def test_timeline_and_its_text_equal_the_references(ref):
    port = tevents.timeline(_every_event(tevents))
    jref = ref["events"].timeline(_every_event(ref["events"]))
    assert port == jref
    assert tevents.format_timeline(port) == ref["events"].format_timeline(jref)
    assert port["tasks"]["dispatched"] == 3 and port["quality"]["detected"] == 3
    assert "== tasks ==" in tevents.format_timeline(port)


def _federated_log(events_mod, path):
    """A driver log and two child siblings, each size-bounded so that it
    rotates; events interleaved across the three writers."""
    sinks = {"driver": events_mod.EventLogSink(path, max_bytes=600, process="driver")}
    for label in ("exec1", "exec2"):
        sinks[label] = events_mod.EventLogSink(events_mod.process_log_path(path, label),
                                               max_bytes=600, process=label)
    written = _every_event(events_mod, copies=1)[:30]
    labels = list(sinks)
    for i, ev in enumerate(written):
        sinks[labels[i % 3]](ev)
    for sink in sinks.values():
        sink.close()


@pytest.mark.parametrize("direction", ["port_to_ref", "ref_to_port"])
def test_federated_log_merges_as_the_reference_does(ref, tmp_path, direction):
    writer, other = (tevents, ref["events"]) if direction == "port_to_ref" else \
        (ref["events"], tevents)
    path = str(tmp_path / "fleet.jsonl")
    _federated_log(writer, path)
    collected = {k: [os.path.relpath(p, tmp_path) for p in v]
                 for k, v in tevents.collect(path).items()}
    assert collected == {k: [os.path.relpath(p, tmp_path) for p in v]
                         for k, v in ref["events"].collect(path).items()}
    assert sorted(collected) == ["driver", "exec1", "exec2"]
    assert all(len(v) > 1 for v in collected.values())  # every writer rotated
    port_merged, ref_merged = tevents.merge(path), ref["events"].merge(path)
    assert [(e.to_record(), e.process, e.wt) for e in port_merged] == \
        [(e.to_record(), e.process, e.wt) for e in ref_merged]
    assert tevents._merged_records(path) == ref["events"]._merged_records(path)
    n_port = tevents.write_merged(path, str(tmp_path / "port.jsonl"))
    n_ref = other.write_merged(path, str(tmp_path / "ref.jsonl"))
    assert n_port == n_ref == 30
    assert (tmp_path / "port.jsonl").read_bytes() == (tmp_path / "ref.jsonl").read_bytes()
    summary = tevents.timeline(port_merged)
    assert summary == ref["events"].timeline(ref_merged)
    assert summary["by_process"] == {"driver": 10, "exec1": 10, "exec2": 10}
    assert tevents.format_timeline(summary) == ref["events"].format_timeline(summary)


def test_merged_tail_is_the_tail_of_the_merged_log(tmp_path):
    """The flight recorder's bundle tail: the last n records of the merged
    fleet log, in its order, across rotated segments of three processes
    (nested ``wt`` keys and equal stamps included)."""
    import random

    base = str(tmp_path / "ev.jsonl")
    sinks = {"driver": tevents.EventLogSink(base, max_bytes=3000, process="driver")}
    for label in ("replica-0", "replica-1"):
        sinks[label] = tevents.EventLogSink(tevents.process_log_path(base, label),
                                            max_bytes=2500, process=label)
    rng = random.Random(0)
    for i in range(600):
        sinks[rng.choice(sorted(sinks))](tevents.SpanRecorded(
            name="x", trace_id="t", span_id=str(i), tags={"wt": 5, "k": i},
            wall_start=rng.random()))
    for sink in sinks.values():
        sink.close()
    full = tevents._merged_records(base)
    assert len(full) == 600
    for n in (1, 5, 100, 600, 700):
        assert tevents._merged_tail(base, n) == full[-n:]
    assert tevents._merged_tail(base, 0) == []


def test_env_sink_follows_the_environment(tmp_path, monkeypatch):
    path = str(tmp_path / "log.jsonl")
    monkeypatch.setenv("MMLSPARK_TPU_EVENT_LOG", path)
    monkeypatch.setenv("MMLSPARK_TPU_EVENT_LOG_PROCESS", "exec1")
    bus = tevents.get_bus()
    assert bus.active
    bus.publish(tevents.TaskRecovered(job_id=1, task_id=2))
    monkeypatch.delenv("MMLSPARK_TPU_EVENT_LOG")
    assert not tevents.get_bus().active
    (ev,) = tevents.replay(path + "@exec1")
    assert isinstance(ev, tevents.TaskRecovered) and ev.process == "exec1"
    with pytest.raises(ValueError):
        tevents.process_log_path(path, "a.b")


def _efb_fit(Classifier, T, runtime, bus, **kw):
    """A small quantized U fit with EFB, chunked passes (the U budget is set
    low), sibling subtraction and an injected device OOM at iteration 1.
    A validation set makes both packages run one iteration at a time, so
    ``HistogramDegraded`` reports the loop stage at the failed iteration."""

    class Chunked(Classifier):
        def _extra_train_options(self):
            return {"histogram_method": "u", "use_quantized_grad": True}

    rng = np.random.default_rng(3)
    n = 3000
    onehot = np.zeros((n, 6))
    onehot[np.arange(n), rng.integers(0, 6, n)] = 1
    X = np.hstack([rng.normal(size=(n, 3)), onehot])
    y = (X[:, 0] + onehot[:, 2] + 0.5 * rng.normal(size=n) > 0).astype(np.float64)
    got = []
    bus.add_listener(got.append)
    try:
        with runtime.inject_faults(runtime.FaultPlan().oom_task(1, kind="device")):
            Chunked(numIterations=4, numLeaves=7, featureBundling=True, weightCol="w",
                    validationIndicatorCol="v", **kw).fit(
                T({"features": X, "label": y, "w": rng.uniform(0.5, 2, n),
                   "v": np.arange(n) % 5 == 0}))
    finally:
        bus.remove_listener(got.append)
    return got


def test_small_fit_publishes_the_references_events(ref, monkeypatch):
    from mmlspark_tpu import runtime as jruntime
    from mmlspark_tpu.data.table import Table as JTable
    from mmlspark_tpu.lightgbm import LightGBMClassifier as JClassifier

    monkeypatch.setenv("MMLSPARK_TPU_U_BUDGET", "200000")
    got = _efb_fit(LightGBMClassifier, Table, truntime, tevents.get_bus(), device="cpu")
    want = _efb_fit(JClassifier, JTable, jruntime, ref["events"].get_bus(), parallelism="serial")
    assert [type(e).__name__ for e in got] == [
        "FeatureBundled", "HistogramChunked", "HistogramSubtracted", "MemoryPressure",
        "HistogramDegraded", "ModelCommitted"]
    degraded = got[4]
    assert (degraded.stage, degraded.iteration) == ("loop", 1)
    assert [_untimed(e.to_record()) for e in got] == [_untimed(e.to_record()) for e in want]


def test_quiet_bus_builds_no_events(monkeypatch):
    """With no listener the path builds no event: a fit under a bus whose
    event classes would raise still runs."""

    def boom(*a, **k):
        raise AssertionError("an event was built on a quiet bus")

    for name in ("FeatureBundled", "HistogramSubtracted", "ModelCommitted"):
        monkeypatch.setattr(tevents, name, boom)
    assert not tevents.get_bus().active
    rng = np.random.default_rng(0)
    X = rng.normal(size=(300, 3))
    LightGBMClassifier(device="cpu", numIterations=2, numLeaves=4, featureBundling=True).fit(
        Table({"features": X, "label": (X[:, 0] > 0).astype(float)}))


# -- profiling ------------------------------------------------------------------------------


def test_annotate_is_a_named_region_of_a_cpu_profiler_trace(tmp_path):
    tracer = ttracing.Tracer()
    with tprof.profile_trace(str(tmp_path)) as prof:
        with tprof.annotate("gbdt-region"):
            torch.ones(64, 64) @ torch.ones(64, 64)
        with tracer.span("fit:Traced"):
            torch.zeros(8).sum()
    names = {e.key for e in prof.key_averages()}
    assert {"gbdt-region", "fit:Traced"} <= names
    (trace,) = os.listdir(tmp_path)
    events = json.load(open(tmp_path / trace))["traceEvents"]
    assert {"gbdt-region", "fit:Traced"} <= {e.get("name") for e in events}


def test_stopwatch_logger_and_utils():
    sw = tprof.StopWatch()
    with sw.measure("a"):
        pass
    sw.add("a", 1.0)
    sw.add("b", 0.5)
    assert sw.summary()["a"] >= 1.0 and sw.summary()["b"] == 0.5
    sw.log(prefix="fit: ")
    assert tprof.get_logger("mmlspark_tpu_torch.x").name == "mmlspark_tpu_torch.x"
    calls = []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise OSError("again")
        return "ok"

    assert tutils.retry(flaky, attempts=5, initial_delay_s=0.0) == "ok" and len(calls) == 3
    assert tutils.buffered_parallel_map(lambda v: v * v, [1, 2, 3]) == [1, 4, 9]
    watch = tutils.StopWatch()
    with watch.measure():
        pass
    assert watch.elapsed_s >= 0
