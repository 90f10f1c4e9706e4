"""The port's SLO layer (observability/slo.py, alerts.py, history.py): the
cases of tests/test_profiler.py (TestSLOReport and the history render),
tests/test_observability.py (the fleet histogram fold) and
tests/test_quality.py (TestAlertEvaluator) against the port, and parity
with the JAX package: the same events and registry samples, built in both
packages from a numpy seed, give the same ``SLOReport.to_json()``, alerts
that fire and resolve at the same samples, and the same history HTML once
the roofline section's platform label and device-peak cells are masked.

Reference modules are imported inside fixtures (the card machine imports
this file without jax).
"""

import json
import os
import re
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

from test_torch_gbdt import _import_reference

# At import, so that every pytest worker has the JAX package's fit path
# before it collects the JAX package's own test files (see
# tests/test_torch_gbdt.py); the card machine has no jax.
try:
    _import_reference()
except ModuleNotFoundError as err:
    if err.name != "jax":
        raise

from mmlspark_tpu_torch import observability as obs
from mmlspark_tpu_torch.observability import alerts as talerts
from mmlspark_tpu_torch.observability import events as tevents
from mmlspark_tpu_torch.observability import federation as tfederation
from mmlspark_tpu_torch.observability import history as thistory
from mmlspark_tpu_torch.observability import incidents as tincidents
from mmlspark_tpu_torch.observability import registry as tregistry
from mmlspark_tpu_torch.observability import slo as tslo
from mmlspark_tpu_torch.observability.events import EventLogSink
from mmlspark_tpu_torch.observability.history import main as history_main
from mmlspark_tpu_torch.observability.history import render_report
from mmlspark_tpu_torch.observability.registry import MetricsRegistry
from mmlspark_tpu_torch.observability.slo import SLOReport, SLOTargets, fleet_summary

REPO = Path(__file__).resolve().parents[1]

PORT = SimpleNamespace(events=tevents, registry=tregistry, slo=tslo, alerts=talerts,
                       history=thistory)


@pytest.fixture(scope="module")
def ref():
    from mmlspark_tpu.observability import alerts as jalerts
    from mmlspark_tpu.observability import events as jevents
    from mmlspark_tpu.observability import history as jhistory
    from mmlspark_tpu.observability import registry as jregistry
    from mmlspark_tpu.observability import slo as jslo

    return SimpleNamespace(events=jevents, registry=jregistry, slo=jslo, alerts=jalerts,
                           history=jhistory)


# -- the reference's cases (tests/test_profiler.py::TestSLOReport) ------------


class TestSLOReport:
    def _served(self, n, latency=0.002, status=200):
        return [obs.RequestServed(rid=f"r{i}", status=status, latency=latency)
                for i in range(n)]

    def test_fold_determinism_under_seeded_chaos(self, monkeypatch):
        """The report equals the registry fold exactly, even with unrelated
        seeded-chaos events (task kills, retries) in the stream."""
        monkeypatch.setenv("MMLSPARK_TPU_FAULT_SEED", "0")
        from mmlspark_tpu_torch import runtime

        plan = runtime.FaultPlan(seed=0).kill_task(1)
        pol = runtime.SchedulerPolicy(max_workers=2, backoff_base=0.01, faults=plan)
        bus = obs.get_bus()
        chaos = []
        bus.add_listener(chaos.append)
        try:
            out = runtime.run_partitioned(lambda x: x * 2, [1, 2, 3], pol)
        finally:
            bus.remove_listener(chaos.append)
        assert out == [2, 4, 6]
        assert any(isinstance(e, obs.TaskFailed) for e in chaos)

        reg = MetricsRegistry()
        reg.counter("serving_requests_total").inc(6)
        reg.counter("serving_shed_total").inc(2)
        q = reg.histogram("serving_queue_wait_seconds")
        a = reg.histogram("serving_apply_latency_seconds")
        for v in (0.001, 0.002, 0.003):
            q.observe(v)
            a.observe(v)
        events = chaos + self._served(5) + self._served(1, status=503)

        report = SLOReport.fold(reg, events=events)
        summary = reg.summary()
        assert report.requests == summary["serving_requests_total"]
        assert report.shed == summary["serving_shed_total"]
        assert report.stages["queue"] == summary["serving_queue_wait_seconds"]
        assert report.stages["apply"] == summary["serving_apply_latency_seconds"]
        assert report.e2e["count"] == 6  # chaos events never count
        assert report.errors == 1
        # folding the summary dict (the history server's path) equals
        # folding the registry object
        assert SLOReport.fold(summary, events=events).to_dict() == report.to_dict()
        assert SLOReport.fold(reg, events=events).to_json() == report.to_json()

    def test_shed_pct_and_error_budget(self):
        reg = MetricsRegistry()
        reg.counter("serving_requests_total").inc(98)
        reg.counter("serving_shed_total").inc(2)
        events = self._served(97) + self._served(1, status=500)
        report = SLOReport.fold(reg, events=events)
        assert report.shed_pct == pytest.approx(2.0)
        assert report.error_rate == pytest.approx(1 / 98)
        # 3 nines = 0.1% budget; 1/98 errors blows it
        assert report.error_budget_consumed > 1.0
        assert not report.ok()

    def test_event_only_fold(self):
        report = SLOReport.fold(None, events=self._served(4, latency=0.01))
        assert report.requests == 4
        assert report.e2e["p50"] == pytest.approx(0.01)

    def test_renderers(self):
        report = SLOReport.fold(None, events=self._served(3), targets=SLOTargets(p50_ms=1.0))
        md = report.to_markdown()
        assert "| apply p50 |" in md and "| stage |" in md
        parsed = json.loads(report.to_json())
        assert parsed["requests"] == 3
        assert "stages" in parsed and "targets" in parsed


# -- the fleet histogram fold (tests/test_observability.py) -------------------


def _replica_exposition(latencies, inflight, shed, registry_mod=tregistry):
    """One fake replica's /metrics body, built from a real registry so
    parse_exposition stays the exact inverse of exposition()."""
    reg = registry_mod.MetricsRegistry()
    h = reg.histogram("serving_queue_wait_seconds", "Queue wait")
    for v in latencies:
        h.observe(v)
    reg.gauge("serving_inflight").set(inflight)
    reg.counter("serving_shed_total").inc(shed)
    return reg.exposition()


def _fetch_from(bodies):
    def fetch(url, timeout_s):
        for part, body in bodies.items():
            if part in url:
                return body
        raise OSError(f"no route to {url}")

    return fetch


SERVICES = [{"name": "replica-0", "host": "h", "port": 9000},
            {"name": "replica-1", "host": "h", "port": 9001}]


def test_fleet_summary_merges_histogram_children():
    fed = tfederation.MetricsFederator("http://registry:0", fetch=_fetch_from({
        ":9000": _replica_exposition([0.002, 0.004], 0, 0),
        ":9001": _replica_exposition([0.2, 0.4], 0, 0),
    }))
    reg = fed.scrape(SERVICES)
    # the parent histogram has no direct observations, so the plain
    # summary reports count=0 — the fleet fold must merge children
    assert reg.summary()["serving_queue_wait_seconds"]["count"] == 0
    merged = fleet_summary(reg)["serving_queue_wait_seconds"]
    assert merged["count"] == 4
    # the fleet fold interpolates over the union of observations
    report = SLOReport.fold_fleet(reg)
    assert report.stages["queue"]["count"] == 4
    assert report.stages["queue"]["p99"] > 0


def test_fleet_fold_equals_the_references(ref):
    """A federated registry of three replicas (one whose scrape fails)
    folds to the reference's summary and report JSON."""
    from mmlspark_tpu.observability import federation as jfederation

    rng = np.random.default_rng(16)
    lat = [list(rng.lognormal(-5.0, 1.0, size=n)) for n in (40, 25, 0)]
    out = []
    for pkg, fed_mod in ((PORT, tfederation), (ref, jfederation)):
        bodies = {f":{9000 + i}": _replica_exposition(lat[i], i + 1, 3 * i, pkg.registry)
                  for i in range(3)}
        fed = fed_mod.MetricsFederator("http://registry:0", fetch=_fetch_from(bodies))
        services = SERVICES + [{"name": "replica-2", "host": "h", "port": 9002},
                               {"name": "replica-gone", "host": "h", "port": 9999}]
        reg = fed.scrape(services)
        out.append((pkg.slo.fleet_summary(reg), pkg.slo.SLOReport.fold_fleet(reg).to_json()))
    assert out[0] == out[1]


def test_federator_attaches_to_the_flight_recorder(tmp_path):
    """The recorder's metrics.json is the federator's fleet snapshot."""
    fed = tfederation.MetricsFederator("http://registry:0", fetch=_fetch_from({
        "registry:0/services": json.dumps(SERVICES),
        ":9000": _replica_exposition([0.002, 0.004], 1, 0),
        ":9001": _replica_exposition([0.2], 2, 1),
    }))
    recorder = tincidents.FlightRecorder(str(tmp_path), registry=MetricsRegistry(),
                                         federator=fed)
    path = recorder.record("alert_fired", detail="latency burn 2.40x/1.50x")
    assert path is not None
    metrics = json.loads((Path(path) / "metrics.json").read_text())
    assert metrics == json.loads(json.dumps(fed.snapshot()))
    assert metrics["metrics"]["serving_inflight"] == {"replica=replica-0": 1.0,
                                                      "replica=replica-1": 2.0}
    assert [s["name"] for s in metrics["services"]] == ["replica-0", "replica-1"]
    assert metrics["errors"] == {}
    manifest = json.loads((Path(path) / "manifest.json").read_text())
    assert manifest["trigger"] == "alert_fired"


def test_breaker_trip_bundle_is_written_aside(tmp_path):
    """A breaker tripping inside a request publishes BreakerTripped on the
    request's thread: the bundle (here with a slow fleet snapshot) is
    written on a thread of its own, so the publisher returns at once; the
    bundle holds the trigger and the events before it."""
    from mmlspark_tpu_torch.observability.events import BreakerTripped, RequestServed

    class SlowFederator:
        def snapshot(self):
            time.sleep(0.5)
            return {"metrics": {}}

    recorder = tincidents.FlightRecorder(str(tmp_path), registry=MetricsRegistry(),
                                         federator=SlowFederator()).install()
    bus = obs.get_bus()
    try:
        bus.publish(RequestServed(rid="r1", status=200, latency=0.001))
        t0 = time.perf_counter()
        bus.publish(BreakerTripped(breaker="replica-0", failures=3, window_s=10.0))
        published_s = time.perf_counter() - t0
        recorder.wait(30)
    finally:
        recorder.uninstall()
    assert published_s < 0.25
    [path] = recorder.recorded
    manifest = json.loads((Path(path) / "manifest.json").read_text())
    assert manifest["trigger"] == "breaker_tripped"
    assert "3 failures" in manifest["detail"]
    kinds = [json.loads(line)["event"]
             for line in (Path(path) / "events.jsonl").read_text().splitlines()]
    assert kinds == ["RequestServed", "BreakerTripped"]


# -- SLOReport parity -----------------------------------------------------------


def _registry_samples(seed):
    """Seeded serving samples: counter increments and histogram
    observations, labeled and not, as (kind, name, labels, value)."""
    rng = np.random.default_rng(seed)
    out = [("counter", "serving_requests_total", {}, float(rng.integers(500, 900))),
           ("counter", "serving_shed_total", {}, float(rng.integers(0, 40))),
           ("counter", "serving_expired_total", {}, float(rng.integers(0, 5))),
           ("counter", "serving_replies_failed_total", {}, float(rng.integers(0, 3))),
           ("counter", "serving_batches_total", {}, float(rng.integers(50, 90))),
           ("gauge", "alerts_active", {}, float(rng.integers(0, 3)))]
    for v in rng.lognormal(-6.5, 0.8, size=300):
        out.append(("histogram", "serving_queue_wait_seconds", {}, float(v)))
    for v in rng.lognormal(-5.5, 0.6, size=300):
        out.append(("histogram", "serving_apply_latency_seconds", {}, float(v)))
    for f in ("features[0]", "features[1]"):
        labels = {"model": "m", "version": "2", "feature": f}
        out.append(("gauge", "quality_psi", labels, float(rng.random())))
        out.append(("gauge", "quality_ks", labels, float(rng.random())))
        out.append(("gauge", "quality_drift_active", {"feature": f},
                    float(rng.integers(0, 2))))
    return out


def _build_registry(registry_mod, samples):
    reg = registry_mod.MetricsRegistry()
    for kind, name, labels, value in samples:
        metric = getattr(reg, kind)(name)
        if labels:
            metric = metric.labels(**labels)
        {"counter": lambda m, v: m.inc(v), "gauge": lambda m, v: m.set(v),
         "histogram": lambda m, v: m.observe(v)}[kind](metric, value)
    return reg


def _serving_event_specs(seed):
    """Seeded event specs (class name, kwargs, t) of a serving run with
    drift and alert transitions."""
    rng = np.random.default_rng(seed)
    specs = []
    for i in range(400):
        status = 503 if rng.random() < 0.01 else 200
        specs.append(("RequestServed", dict(rid=f"r{i}", status=status,
                                            latency=float(rng.lognormal(-5.0, 0.7))),
                      1.0 + i * 0.01))
        if rng.random() < 0.05:
            specs.append(("RequestShed", dict(reason="queue_full",
                                              queue_depth=int(rng.integers(1, 64))),
                          1.0 + i * 0.01 + 0.001))
    specs += [
        ("DriftDetected", dict(feature="features[0]", stat="psi",
                               value=float(rng.random() + 0.3), threshold=0.25, model="m",
                               version=2), 6.0),
        ("AlertFired", dict(alert="latency", slo="p99<=50ms", burn_short=2.4, burn_long=1.6,
                            window_short_s=2.0, window_long_s=8.0), 6.5),
        ("DriftCleared", dict(feature="features[0]", stat="psi",
                              value=float(rng.random() * 0.1), threshold=0.25, model="m",
                              version=2), 7.0),
        ("AlertResolved", dict(alert="latency", slo="p99<=50ms", burn_short=0.4,
                               burn_long=1.1, window_short_s=2.0, window_long_s=8.0), 7.5),
    ]
    return specs


def _build_events(events_mod, specs):
    return [getattr(events_mod, name)(**kw, t=t) for name, kw, t in specs]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_slo_report_json_equals_the_references(ref, seed):
    samples, specs = _registry_samples(seed), _serving_event_specs(seed)
    got = []
    for pkg in (PORT, ref):
        reg = _build_registry(pkg.registry, samples)
        events = _build_events(pkg.events, specs)
        targets = pkg.slo.SLOTargets(p50_ms=4.0, p99_ms=40.0, availability=0.99)
        report = pkg.slo.SLOReport.fold(reg, events=events, targets=targets)
        got.append((report.to_json(), report.to_markdown(), report.ok(),
                    pkg.slo.SLOReport.fold(None, events=events).to_json(),
                    pkg.slo.SLOReport.fold(reg.summary()).to_json()))
    assert got[0] == got[1]
    assert json.loads(got[0][0])["quality"]["drift"]  # the drift table is in the fold


# -- the reference's cases (tests/test_quality.py::TestAlertEvaluator) ---------


def _run_evaluator(alerts_mod, slo_mod, registry_mod, events_mod, mean_apply_ms,
                   failures=None):
    """Drive one evaluator over a scripted metric timeline; returns
    (evaluator, fired, resolved, registry, per-tick transitions)."""
    t = {"now": 0.0}
    state = {"req": 0.0, "bad": 0.0, "apply_sum": 0.0, "count": 0.0}

    def source():
        return {
            "serving_requests_total": state["req"],
            "serving_replies_failed_total": state["bad"],
            "serving_apply_latency_seconds": {"sum": state["apply_sum"],
                                              "count": state["count"]},
        }

    reg = registry_mod.MetricsRegistry()
    ev = alerts_mod.AlertEvaluator(targets=slo_mod.SLOTargets(), source=source, registry=reg,
                                   windows=(2.0, 8.0), clock=lambda: t["now"])
    seen = []
    bus = events_mod.get_bus()
    bus.add_listener(seen.append)
    ticks = []
    try:
        for step, ms in enumerate(mean_apply_ms):
            t["now"] = step * 1.0
            state["req"] += 10
            state["count"] += 10
            state["apply_sum"] += 10 * ms / 1e3
            state["bad"] += 0.0 if failures is None else failures[step]
            before = len(seen)
            burns = ev.tick()
            ticks.append((step, {k: list(v) for k, v in burns.items()}, ev.active_alerts(),
                          [(type(e).__name__, e.alert, e.burn_short, e.burn_long)
                           for e in seen[before:]
                           if type(e).__name__ in ("AlertFired", "AlertResolved")],
                          reg.summary()["alerts_active"]))
    finally:
        bus.remove_listener(seen.append)
    fired = [e for e in seen if isinstance(e, events_mod.AlertFired)]
    resolved = [e for e in seen if isinstance(e, events_mod.AlertResolved)]
    return ev, fired, resolved, reg, ticks


def _port_run(timeline, failures=None):
    return _run_evaluator(talerts, tslo, tregistry, tevents, timeline, failures)


class TestAlertEvaluator:
    def test_latency_storm_fires_and_resolves(self):
        # 10 quiet ticks (ring spans the 8 s window), 12 storm ticks at
        # 120 ms mean (2.4x the 50 ms budget), then recovery
        timeline = [5.0] * 10 + [120.0] * 12 + [5.0] * 12
        ev, fired, resolved, reg, _ = _port_run(timeline)
        assert [e.alert for e in fired] == ["latency"]
        assert fired[0].burn_short > 1.0 and fired[0].burn_long > 1.0
        assert fired[0].window_short_s == 2.0
        assert [e.alert for e in resolved] == ["latency"]
        assert ev.active_alerts() == ()
        assert reg.summary()["alerts_active"] == 0.0

    def test_short_blip_does_not_page(self):
        """The long window is the flap guard: a 2-tick spike burns the
        short window but never the long one."""
        timeline = [5.0] * 10 + [120.0] * 2 + [5.0] * 14
        _, fired, _, _, _ = _port_run(timeline)
        assert fired == []

    def test_young_ring_never_fires(self):
        _, fired, _, _, _ = _port_run([500.0] * 5)  # < long window of history
        assert fired == []

    def test_active_alerts_pins_fleet_controller(self):
        """The advisory hook: a firing alert blocks the idle scale-down
        path until it resolves."""
        from mmlspark_tpu_torch.serving.fleet import FleetController

        alerts = {"active": ("latency",)}
        ctl = FleetController(
            supervisor=SimpleNamespace(live_count=3, _procs={}),
            registry=SimpleNamespace(services=[]),
            min_replicas=1, max_replicas=4,
            cooldown_s=0.0, down_sustain_s=1.0,
            clock=lambda: 0.0,
            alert_advisor=lambda: alerts["active"],
        )
        idle = []  # no registered replicas -> zero inflight, zero shed
        for now in (0.0, 2.0, 4.0):
            assert ctl.decide(idle, now=now) is None
        alerts["active"] = ()
        assert ctl.decide(idle, now=5.0) is None  # idle clock restarts
        decision = ctl.decide(idle, now=7.0)
        assert decision is not None and decision[0] == "down"


def test_evaluator_feeds_the_fleet_controller():
    """A real evaluator's ``active_alerts`` as the controller's advisory: a
    firing latency alert holds the fleet, and its resolution frees it."""
    from mmlspark_tpu_torch.serving.fleet import FleetController

    timeline = [5.0] * 10 + [120.0] * 6
    ev, fired, _, _, _ = _port_run(timeline)
    assert ev.active_alerts() == ("latency",) and fired
    ctl = FleetController(
        supervisor=SimpleNamespace(live_count=3, _procs={}),
        registry=SimpleNamespace(services=[]), min_replicas=1, max_replicas=4,
        cooldown_s=0.0, down_sustain_s=1.0, clock=lambda: 0.0,
        alert_advisor=ev.active_alerts)
    assert ctl.decide([], now=0.0) is None
    assert ctl.decide([], now=2.0) is None


def test_evaluator_ticks_publish_and_record(tmp_path, monkeypatch):
    """A firing tick trips the env-installed flight recorder with
    ``alert_fired``."""
    monkeypatch.setenv("MMLSPARK_TPU_INCIDENT_DIR", str(tmp_path))
    try:
        _, fired, _, _, _ = _port_run([5.0] * 10 + [120.0] * 4)
        recorder = tincidents.get_recorder()
    finally:
        monkeypatch.delenv("MMLSPARK_TPU_INCIDENT_DIR")
        tincidents.get_recorder()  # unset: uninstalls the process-global recorder
    assert fired
    triggers = [json.loads((Path(p) / "manifest.json").read_text())["trigger"]
                for p in recorder.recorded]
    assert "alert_fired" in triggers


@pytest.mark.parametrize("seed", [3, 4, 5])
def test_alerts_fire_and_resolve_at_the_references_samples(ref, seed):
    """A seeded timeline of latency storms and error bursts: every tick's
    burn rates, active alerts, transitions and gauge equal the
    reference's."""
    rng = np.random.default_rng(seed)
    n = 60
    ms = rng.lognormal(np.log(8.0), 0.5, size=n)
    failures = np.zeros(n)
    for _ in range(3):
        lo = int(rng.integers(10, n - 8))
        if rng.random() < 0.5:
            ms[lo:lo + int(rng.integers(2, 10))] *= rng.uniform(10.0, 30.0)
        else:
            failures[lo:lo + int(rng.integers(2, 10))] = rng.integers(1, 4)
    got = [_run_evaluator(pkg.alerts, pkg.slo, pkg.registry, pkg.events, list(ms),
                          list(failures))[4] for pkg in (PORT, ref)]
    assert got[0] == got[1]
    assert any(t[3] for t in got[0])  # something fired on this timeline


# -- the history server (tests/test_profiler.py::TestHistoryReport) -----------


def _history_events():
    return [
        obs.StageStarted(job_id=0, stage_id=0, name="Binning", t=1.0),
        obs.StageCompleted(job_id=0, stage_id=0, name="Binning", duration=0.5, t=1.5),
        obs.StageStarted(job_id=0, stage_id=1, name="Boost", t=1.5),
        obs.StageCompleted(job_id=0, stage_id=1, name="Boost", duration=1.0,
                           status="ValueError", t=2.5),
        obs.TaskFailed(job_id=0, task_id=1, reason="executor_death", worker=0, duration=0.1,
                       attempt=0),
        obs.TaskFailed(job_id=0, task_id=1, reason="timeout", worker=1, duration=0.2,
                       attempt=1, speculative=True),
        obs.RequestServed(rid="r1", status=200, latency=0.002),
        obs.RequestShed(reason="queue_full", queue_depth=9),
        obs.BreakerTripped(breaker="apply", failures=3, window_s=30.0),
        obs.ModelSwapped(name="m", version=2, server="s1"),
        obs.ProfileCompiled(name="gbdt.step", seconds=0.4, flops=1e9, bytes_accessed=1e8),
        obs.ProfileExecuted(name="gbdt.step", seconds=0.01),
        obs.StreamEpochCommitted(query="q", epoch=0, rows=100),
    ]


class TestHistoryReport:
    def test_render_contains_all_sections(self):
        doc = render_report(_history_events(), title="t")
        for needle in (
            "Stage timeline", "Task attempts", "Serving SLO",
            "Profiler roofline", "Resilience", "Streaming",
            "executor_death", "gbdt.step", "apply p50",
            "bar failed",  # the failed Boost stage renders red
        ):
            assert needle in doc, f"report missing {needle!r}"
        # self-contained: no external refs
        assert "http://" not in doc and "https://" not in doc

    def test_render_escapes_html(self):
        evs = [obs.StageStarted(job_id=0, stage_id=0, name="<script>alert(1)</script>")]
        doc = render_report(evs)
        assert "<script>alert(1)" not in doc
        assert "&lt;script&gt;" in doc

    def test_cli_writes_report(self, tmp_path, capsys):
        log = tmp_path / "ev.jsonl"
        sink = EventLogSink(str(log))
        for e in _history_events():
            sink(e)
        sink.close()
        metrics = tmp_path / "metrics.json"
        metrics.write_text(json.dumps({"serving_requests_total": 1.0}))
        out = tmp_path / "report.html"
        rc = history_main([str(log), "-o", str(out), "--metrics", str(metrics),
                           "--title", "ci run"])
        assert rc == 0
        assert capsys.readouterr().out.strip() == str(out)
        doc = out.read_text()
        assert "ci run" in doc and "Stage timeline" in doc

    def test_cli_default_output_path(self, tmp_path, capsys):
        log = tmp_path / "ev.jsonl"
        sink = EventLogSink(str(log))
        sink(obs.RequestServed(rid="r", status=200, latency=0.001))
        sink.close()
        assert history_main([str(log)]) == 0
        assert (tmp_path / "ev.jsonl.html").exists()


def test_history_module_runs_as_a_script(tmp_path):
    """``python -m mmlspark_tpu_torch.observability.history <log> -o <html>``."""
    log = tmp_path / "ev.jsonl"
    sink = EventLogSink(str(log))
    for e in _history_events():
        sink(e)
    sink.close()
    out = tmp_path / "report.html"
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    proc = subprocess.run([sys.executable, "-m", "mmlspark_tpu_torch.observability.history",
                           str(log), "-o", str(out)], env=env, cwd=str(tmp_path),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == str(out)
    assert "Stage timeline" in out.read_text()
    assert "RuntimeWarning" not in proc.stderr  # no double import under -m


def _full_specs(seed):
    """Seeded specs of one event of every class the report renders, across
    a router and two replica processes."""
    rng = np.random.default_rng(seed)
    specs = _serving_event_specs(seed)[:60]
    t = 10.0
    for s in range(3):
        specs.append(("StageStarted", dict(job_id=0, stage_id=s, name=f"stage-{s}"), t))
        t += float(rng.uniform(0.1, 0.5))
        specs.append(("StageCompleted", dict(job_id=0, stage_id=s, name=f"stage-{s}",
                                             duration=float(rng.uniform(0.1, 0.5)),
                                             status="ok" if s != 1 else "KeyError"), t))
    for task in range(4):
        specs.append(("TaskDispatched", dict(job_id=0, task_id=task, attempt=0,
                                             queue_depth=int(rng.integers(0, 4))), t))
    specs += [
        ("TaskFailed", dict(job_id=0, task_id=2, reason="executor_death", worker=1,
                            duration=float(rng.uniform(0.01, 0.1)), attempt=0), t + 0.1),
        ("TaskRetried", dict(job_id=0, task_id=2, failures=1, reason="executor_death"), t + 0.2),
        ("TaskSpeculated", dict(job_id=0, task_id=3, original_worker=0, age=1.5, median=0.4),
         t + 0.3),
        ("TaskFailed", dict(job_id=0, task_id=3, reason="superseded", worker=0, duration=0.5,
                            attempt=0, speculative=True, permanent=True), t + 0.4),
        ("TaskRecovered", dict(job_id=0, task_id=2), t + 0.5),
        ("ProcessStarted", dict(member=0, pid=100, epoch=0), t + 0.6),
        ("ProcessStarted", dict(member=1, pid=101, epoch=0), t + 0.6),
        ("ProcessLost", dict(member=1, pid=101, reason="signal:9", epoch=0), t + 0.7),
        ("GroupReformed", dict(epoch=1, members=2, lost=[1]), t + 0.8),
        ("FleetScaled", dict(direction="up", replicas=3, replica=2, reason="inflight"), t + 0.9),
        ("FleetScaled", dict(direction="down", replicas=2, replica=2, reason="idle"), t + 1.0),
        ("BreakerTripped", dict(breaker="replica-1", failures=3, window_s=10.0), t + 1.1),
        ("ModelSwapped", dict(name="m", version=2, server="replica-0"), t + 1.2),
        ("ModelCommitted", dict(model="m", version=2, detail="stream epoch 1"), t + 1.3),
        ("ProfileCompiled", dict(name="gbdt.step", seconds=0.4, flops=1e9,
                                 bytes_accessed=1e8), t + 1.4),
        ("ProfileExecuted", dict(name="gbdt.step", seconds=0.01), t + 1.5),
        ("ProfileExecuted", dict(name="gbdt.step", seconds=0.02), t + 1.6),
        ("StreamEpochStarted", dict(query="q", epoch=0, start=0, end=1), t + 1.7),
        ("StreamSourceAdvanced", dict(query="q", start=0, end=1, units=1), t + 1.7),
        ("StreamEpochCommitted", dict(query="q", epoch=0, rows=100, duration=0.3), t + 1.8),
        ("StreamEpochCommitted", dict(query="q", epoch=1, rows=80, duration=0.2), t + 1.9),
        ("IncidentRecorded", dict(incident_id="inc-1", trigger="alert_fired",
                                  path="/incidents/inc-1", events=12, trace_id="tr-0",
                                  detail="latency burn"), t + 2.0),
    ]
    for r in range(6):
        specs.append(("RequestRouted", dict(rid=f"q{r}", replica=f"replica-{r % 2}",
                                            hops=1 + (r == 3), status=200,
                                            latency=float(rng.uniform(0.002, 0.02)),
                                            trace_id=f"tr-{r % 2}"), t + 2.1 + r * 0.01))
    spans = []
    for tr in range(2):
        base = t + 3.0 + tr
        spans += [
            ("SpanRecorded", dict(name="router.request", trace_id=f"tr-{tr}", span_id="a",
                                  start=base, duration=0.02, wall_start=base, tags={}),
             "router"),
            ("SpanRecorded", dict(name="serving.request", trace_id=f"tr-{tr}", span_id="b",
                                  parent_id="router:a", start=base + 0.002, duration=0.015,
                                  wall_start=base + 0.002, tags={}), f"replica-{tr}"),
            ("SpanRecorded", dict(name="serving.apply", trace_id=f"tr-{tr}", span_id="c",
                                  parent_id="b", start=base + 0.004, duration=0.01,
                                  wall_start=base + 0.004,
                                  status="ok" if tr == 0 else "error", tags={}),
             f"replica-{tr}"),
        ]
    return specs, spans


def _build_full(events_mod, specs, spans):
    events = _build_events(events_mod, specs)
    for name, kw, process in spans:
        ev = getattr(events_mod, name)(**kw, t=kw["wall_start"])
        ev.process = process
        events.append(ev)
    return events


#: The masked fields, by name: the roofline section's platform label (the
#: card's name, or the reference's backend) and its device-peak cells (the
#: shares of the peaks and the bound each row's peaks give). Nothing else
#: may differ.
MASKS = {
    "roofline platform label": re.compile(r'<p class="muted">peaks: [^<]*</p>'),
    "roofline device-peak cells": re.compile(
        r"(<tr><td>[^<]*</td>(?:<td>[^<]*</td>){6})(?:<td>[^<]*</td>){3}</tr>"),
}


def _mask(doc):
    doc = MASKS["roofline platform label"].sub("<p>PEAKS</p>", doc)
    head, sep, tail = doc.partition("<h2>Profiler roofline</h2>")
    tail = MASKS["roofline device-peak cells"].sub(r"\1<td>PEAK</td></tr>", tail)
    return head + sep + tail


@pytest.mark.parametrize("seed", [6, 7])
def test_history_html_equals_the_references_outside_the_masked_fields(ref, seed):
    specs, spans = _full_specs(seed)
    samples = _registry_samples(seed)
    docs = []
    for pkg in (PORT, ref):
        events = _build_full(pkg.events, specs, spans)
        metrics = _build_registry(pkg.registry, samples).summary()
        docs.append(pkg.history.render_report(events, metrics=metrics, title=f"run {seed}"))
    port_doc, ref_doc = docs
    # each mask hits the roofline section, and only there
    assert len(MASKS["roofline platform label"].findall(port_doc)) == 1
    assert "gbdt.step" in port_doc and "lane: replica-1" in port_doc
    for needle in ("Streaming", "Fleet", "Model quality", "Incidents", "Process groups",
                   "Distributed traces", "Resilience"):
        assert needle in port_doc, needle
    assert _mask(port_doc) == _mask(ref_doc)
    assert _mask(port_doc) != port_doc  # the masks did hide something


def test_history_renders_the_card_s_peaks(monkeypatch):
    """With peaks known (an override, as on the card) the roofline section
    labels its platform and fills the peak cells."""
    monkeypatch.setenv("MMLSPARK_TPU_PEAK_FLOPS", "6.7e13")
    monkeypatch.setenv("MMLSPARK_TPU_PEAK_HBM_BYTES", "3.35e12")
    doc = render_report(_history_events())
    assert '<p class="muted">peaks: env-override</p>' in doc
    row = re.search(r"<tr><td>gbdt.step</td>.*?</tr>", doc).group(0)
    assert "&mdash;" not in row and "%" in row


def test_campaign_clients_run_in_their_own_process():
    """tools/torch_loadgen.py's closed-loop clients post from a process of
    their own: phase labels and concurrency reach it on its stdin, and its
    records come back under their labels at stop, beside this process's
    probes."""
    import importlib.util

    from mmlspark_tpu_torch.core.pipeline import Transformer
    from mmlspark_tpu_torch.serving import ServingServer

    class Double(Transformer):
        def transform(self, table):
            x = np.asarray(table.column("input"), dtype=np.float64)
            return table.with_column("prediction", 2.0 * x)

    spec = importlib.util.spec_from_file_location(
        "torch_loadgen", REPO / "tools" / "torch_loadgen.py")
    loadgen = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(loadgen)
    with ServingServer(Double(), max_latency_ms=1.0) as srv:
        clients = loadgen.LoadClients(srv.info.url)
        try:
            clients.phase = "warmup"
            assert clients._one(4.0) == (200, 8.0)
            clients.set_concurrency(2)
            time.sleep(0.5)
            clients.phase = "ramp"
            time.sleep(0.5)
            clients.set_concurrency(0)
        finally:
            clients.stop()
    stats = clients.phase_stats()
    assert stats["warmup"]["ok"] >= 2 and stats["ramp"]["ok"] >= 1
    assert all(s["errors_5xx"] == 0 and s["transport"] == 0 for s in stats.values())
    assert all(out == 2.0 * x for _, status, _, x, out in clients.records if status == 200)
    assert clients._procs == []


def test_slo_modules_import_neither_jax_nor_the_jax_package():
    code = (
        "import sys, mmlspark_tpu_torch.observability, "
        "mmlspark_tpu_torch.observability.slo, mmlspark_tpu_torch.observability.alerts, "
        "mmlspark_tpu_torch.observability.history\n"
        "from mmlspark_tpu_torch.observability import render_report\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'mmlspark_tpu.'))"
        " or m == 'mmlspark_tpu']\n"
        "assert not bad, bad\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    subprocess.run([sys.executable, "-c", code], check=True, env=env, cwd=str(REPO),
                   timeout=120)


def test_observability_exports_the_references_names(ref):
    import mmlspark_tpu.observability as jobs

    assert obs.__all__ == jobs.__all__
    for name in ("AlertEvaluator", "SLOReport", "SLOTargets", "fleet_summary",
                 "render_report"):
        assert getattr(obs, name) is not None
