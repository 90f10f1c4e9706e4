"""The port's serving fleet (mmlspark_tpu_torch.serving: router,
autoscaler, replicas, campaign payloads) and the HTTP planes around it: the
cases of tests/test_fleet.py against the port (real HTTP servers and an
in-process registry), the HTTP cases of tests/test_partition_tolerance.py
(network directives on HTTP targets, the lease journal, a registry outage),
the metrics federation cases of tests/test_observability.py, parity of the
network-chaos gate and the federation with the JAX package, and one
ReplicaSupervisor with a real replica process (ready, SIGKILL, respawn).

The SAR payload case waits for ``recommendation.sar``'s port. The SLO fold
over a merged event log and over a federated registry use the port's
``observability/slo.py``.
"""

import json
import os
import signal
import socket
import threading
import time
import urllib.error
import urllib.request
import zlib
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import pytest

from mmlspark_tpu_torch.data.table import Table
from mmlspark_tpu_torch.observability.events import (
    EventLogSink,
    FleetScaled,
    LeaseRecovered,
    RegistryUnavailable,
    RequestRouted,
    RequestServed,
    SpanRecorded,
    get_bus,
    merge,
    process_log_path,
    timeline,
    write_merged,
)
from mmlspark_tpu_torch.observability.federation import MetricsFederator, parse_exposition
from mmlspark_tpu_torch.observability.registry import MetricsRegistry, get_registry
from mmlspark_tpu_torch.observability.slo import SLOReport, fleet_summary
from mmlspark_tpu_torch.observability.tracing import TRACE_HEADER
from mmlspark_tpu_torch.resilience.budget import RetryBudget
from mmlspark_tpu_torch.resilience.policy import RetryPolicy
from mmlspark_tpu_torch.runtime.faults import FaultPlan, check_net, inject_faults
from mmlspark_tpu_torch.runtime.journal import ModelStore
from mmlspark_tpu_torch.serving import (
    FleetController,
    FleetRouter,
    RegistrationService,
    ReplicaSupervisor,
    ServiceInfo,
    ServingServer,
)
from mmlspark_tpu_torch.serving.fleet import store_model_factory, store_model_loader


def _import_reference():
    """Import the JAX package's fit path through the u_histogram shim (see
    tests/test_torch_gbdt.py), so every pytest worker has the module before
    it collects the JAX package's own test files."""
    from jax._src.lax import lax as lax_internal
    from jax.interpreters import batching

    saved = batching.primitive_batchers
    batching.primitive_batchers = {lax_internal.optimization_barrier_p: None}
    try:
        import mmlspark_tpu.ops.u_histogram  # noqa: F401
    finally:
        batching.primitive_batchers = saved


try:
    _import_reference()
except ModuleNotFoundError as err:
    if err.name != "jax":
        raise


def _const_model(value):
    """table->table callable answering ``value`` for every row — replicas
    with distinct values make routing decisions observable from replies."""

    def model(table):
        n = len(np.atleast_1d(np.asarray(table.column("input"))))
        return Table({"prediction": np.full(n, float(value))})

    return model


def _post(url, payload, timeout=10, headers=None):
    req = urllib.request.Request(
        url, data=json.dumps(payload).encode(), method="POST",
        headers={"Content-Type": "application/json", **(headers or {})},
    )
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        body = e.read()
        return e.code, (json.loads(body) if body else None)


def _post_headers(url, payload, timeout=10, headers=None):
    """Like _post, but also returns the response headers — the trace id
    rides every reply, error paths included."""
    req = urllib.request.Request(
        url, data=json.dumps(payload).encode(), method="POST",
        headers={"Content-Type": "application/json", **(headers or {})},
    )
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read()), dict(r.headers.items())
    except urllib.error.HTTPError as e:
        body = e.read()
        return (
            e.code,
            (json.loads(body) if body else None),
            dict(e.headers.items()),
        )


class _Fleet:
    """Two in-process replicas (answers 1.0 and 2.0) registered in an
    in-process registry, with isolated metrics registries so per-replica
    request counts are assertable."""

    def __init__(self):
        self.registry = RegistrationService().start()
        self.regs = {}
        self.servers = {}
        for name, value in (("replica-0", 1.0), ("replica-1", 2.0)):
            reg = MetricsRegistry()
            srv = ServingServer(
                _const_model(value), name=name, max_latency_ms=0.5,
                registry=reg,
            ).start()
            self.regs[name] = reg
            self.servers[name] = srv
            self.registry.register(srv.info)

    def requests_served(self, name):
        return self.regs[name].counter("serving_requests_total").value

    def close(self):
        # each listener's shutdown waits out one serve_forever poll (0.5 s):
        # stop them side by side
        stoppers = [threading.Thread(target=srv.stop) for srv in self.servers.values()]
        stoppers.append(threading.Thread(target=self.registry.stop))
        for t in stoppers:
            t.start()
        for t in stoppers:
            t.join()


@pytest.fixture()
def fleet():
    f = _Fleet()
    yield f
    f.close()


def _router(fleet, **kwargs):
    kwargs.setdefault("registry", fleet.registry)
    kwargs.setdefault("discovery_interval_s", 60.0)  # tests refresh by hand
    return FleetRouter(**kwargs)


class TestRouterRouting:
    def test_routes_and_answers(self, fleet):
        with _router(fleet) as router:
            status, out = _post(router.url, {"input": 3.0})
            assert status == 200
            assert out["prediction"] in (1.0, 2.0)

    def test_least_loaded_prefers_idle_replica(self, fleet):
        # replica-0 heartbeats heavy load; every pick must go to replica-1
        fleet.registry.heartbeat("replica-0", inflight=50)
        fleet.registry.heartbeat("replica-1", inflight=0)
        with _router(fleet) as router:
            answers = {_post(router.url, {"input": 1.0})[1]["prediction"]
                       for _ in range(8)}
            assert answers == {2.0}

    def test_consistent_hash_is_sticky_and_spreads(self, fleet):
        with _router(fleet, policy="consistent_hash") as router:
            for key in ("alpha", "beta", "gamma", "delta"):
                answers = {
                    _post(router.url, {"input": 1.0},
                          headers={"X-Routing-Key": key})[1]["prediction"]
                    for _ in range(5)
                }
                assert len(answers) == 1, f"key {key} moved between replicas"
            spread = {
                _post(router.url, {"input": 1.0},
                      headers={"X-Routing-Key": f"key-{i}"})[1]["prediction"]
                for i in range(32)
            }
            assert spread == {1.0, 2.0}

    def test_deregistered_replica_never_receives_a_request(self, fleet):
        with _router(fleet) as router:
            fleet.registry.deregister("replica-1")
            router.refresh()
            before = fleet.requests_served("replica-1")
            for _ in range(20):
                status, out = _post(router.url, {"input": 1.0})
                assert status == 200
                assert out["prediction"] == 1.0  # only replica-0 answers
            assert fleet.requests_served("replica-1") == before

    def test_dead_replica_costs_one_hop_not_an_error(self, fleet):
        # a ghost lease for an endpoint nobody listens on (the window
        # between a replica dying and its lease expiring)
        fleet.registry.register(ServiceInfo("replica-9", "127.0.0.1", 9))
        fleet.registry.heartbeat("replica-9", inflight=0)
        fleet.registry.heartbeat("replica-0", inflight=10)
        fleet.registry.heartbeat("replica-1", inflight=10)
        with _router(fleet) as router:
            failovers0 = router._m_failovers.value
            for _ in range(5):
                status, out = _post(router.url, {"input": 1.0})
                assert status == 200
                assert out["prediction"] in (1.0, 2.0)
            assert router._m_failovers.value > failovers0

    def test_dead_replica_fails_over_even_with_drained_retry_budget(
        self, fleet
    ):
        # the budget rations retries of attempts a replica actually
        # processed; a connection fast-fail to a dead port did no work
        # anywhere, so failover must happen even with zero retry tokens —
        # otherwise a SIGKILL'd replica's stale lease turns into
        # user-visible 502s until the TTL prunes it
        fleet.registry.register(ServiceInfo("replica-9", "127.0.0.1", 9))
        fleet.registry.heartbeat("replica-9", inflight=0)
        fleet.registry.heartbeat("replica-0", inflight=10)
        fleet.registry.heartbeat("replica-1", inflight=10)
        policy = RetryPolicy(
            max_attempts=3, budget=RetryBudget(ratio=0.0, min_tokens=0.0)
        )
        with _router(fleet, retry_policy=policy) as router:
            for _ in range(5):
                status, out = _post(router.url, {"input": 1.0})
                assert status == 200
                assert out["prediction"] in (1.0, 2.0)

    def test_no_replicas_is_503(self):
        with RegistrationService() as registry:
            with FleetRouter(registry=registry,
                             discovery_interval_s=60.0) as router:
                status, out = _post(router.url, {"input": 1.0})
                assert status == 503
                assert "no live replicas" in out["error"]


class _CaptureReplica:
    """A bare HTTP endpoint that records request headers and answers a
    fixed prediction — for asserting what the router forwards."""

    def __init__(self):
        seen = self.seen = []

        class Handler(BaseHTTPRequestHandler):
            def do_POST(self):  # noqa: N802
                self.rfile.read(int(self.headers.get("Content-Length", 0)))
                seen.append(dict(self.headers.items()))
                body = b'{"prediction": 7.0}'
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *args):
                pass

        self.httpd = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.httpd.daemon_threads = True
        import threading

        threading.Thread(target=self.httpd.serve_forever, daemon=True).start()
        self.info = ServiceInfo(
            "capture", "127.0.0.1", self.httpd.server_address[1]
        )

    def close(self):
        self.httpd.shutdown()
        self.httpd.server_close()


class TestRouterDeadlines:
    def test_deadline_header_shrinks_across_the_hop(self):
        capture = _CaptureReplica()
        try:
            with RegistrationService() as registry:
                registry.register(capture.info)
                with FleetRouter(registry=registry,
                                 discovery_interval_s=60.0) as router:
                    status, _ = _post(router.url, {"input": 1.0},
                                      headers={"X-Deadline-Ms": "800"})
                    assert status == 200
            forwarded = float(capture.seen[0]["X-Deadline-Ms"])
            assert 0 < forwarded <= 800
        finally:
            capture.close()

    def test_request_never_exceeds_deadline_under_storm(self, fleet):
        # every hop answers an injected 503; retries must stay inside the
        # client's 250 ms budget (waits are clipped to the deadline)
        plan = FaultPlan(seed=3).http_storm(count=100, status=503)
        with _router(fleet) as router:
            with inject_faults(plan):
                t0 = time.monotonic()
                status, _ = _post(router.url, {"input": 1.0},
                                  headers={"X-Deadline-Ms": "250"})
                elapsed = time.monotonic() - t0
            assert status in (503, 504)
            assert elapsed < 0.25 + 0.25, f"blew the deadline: {elapsed:.3f}s"

    def test_retry_budget_bounds_failover(self, fleet):
        # an empty budget means one hop per request, storm or not
        policy = RetryPolicy(
            max_attempts=4, base=0.001, cap=0.002, seed=0,
            budget=RetryBudget(ratio=0.0, min_tokens=0.0),
        )
        plan = FaultPlan(seed=3).http_storm(count=50, status=503)
        with _router(fleet, retry_policy=policy) as router:
            hops0 = router._m_hops.value
            with inject_faults(plan):
                for _ in range(5):
                    status, _ = _post(router.url, {"input": 1.0})
                    assert status == 503  # passed through, not retried
            assert router._m_hops.value - hops0 == 5

    def test_retry_lands_on_a_different_replica(self, fleet):
        # storm only replica-0's port; least-loaded prefers it (idle),
        # the failover must answer from replica-1
        fleet.registry.heartbeat("replica-0", inflight=0)
        fleet.registry.heartbeat("replica-1", inflight=10)
        port = fleet.servers["replica-0"].info.port
        with _router(fleet) as router:
            plan = FaultPlan(seed=3).http_storm(
                count=1, status=503, url_part=f":{port}/"
            )
            with inject_faults(plan):
                status, out = _post(router.url, {"input": 1.0})
            assert status == 200
            assert out["prediction"] == 2.0
            assert plan.fired, "the storm never hit replica-0"

    def test_tripped_breaker_takes_replica_out_of_rotation(self, fleet):
        from mmlspark_tpu_torch.resilience.breaker import BreakerRegistry

        fleet.registry.heartbeat("replica-0", inflight=0)
        fleet.registry.heartbeat("replica-1", inflight=10)
        port = fleet.servers["replica-0"].info.port
        breakers = BreakerRegistry(
            failure_threshold=2, window_s=10.0, reset_timeout_s=30.0
        )
        with _router(fleet, breakers=breakers) as router:
            plan = FaultPlan(seed=3).http_storm(
                count=2, status=503, url_part=f":{port}/"
            )
            with inject_faults(plan):
                for _ in range(2):
                    status, _ = _post(router.url, {"input": 1.0})
                    assert status == 200  # failover absorbed each 503
            skips0 = router._m_skipped.value
            for _ in range(4):
                status, out = _post(router.url, {"input": 1.0})
                assert status == 200
                assert out["prediction"] == 2.0  # straight to replica-1
            assert router._m_skipped.value > skips0


class _FakeClock:
    def __init__(self, t=100.0):
        self.t = t

    def __call__(self):
        return self.t


class _StubSupervisor:
    """The process plane reduced to bookkeeping — decide()/step() logic
    is testable with zero subprocesses."""

    def __init__(self, live=2, name="replica"):
        self.name = name
        self._procs = {i: object() for i in range(live)}
        self._next_index = live
        self.added = []
        self.retired = []
        self.polls = 0

    @property
    def live_count(self):
        return len(self._procs)

    def poll(self):
        self.polls += 1
        return []

    def add_replica(self, ready_timeout_s=None):
        index = self._next_index
        self._next_index += 1
        self._procs[index] = object()
        self.added.append(index)
        return index

    def retire_replica(self, index, grace_s=5.0):
        del self._procs[index]
        self.retired.append(index)


class _FakeRegistry:
    """Just the two surfaces FleetController touches in-process."""

    def __init__(self, services=()):
        self.services = list(services)
        self.deregistered = []

    def deregister(self, name):
        self.deregistered.append(name)
        return True


def _svc(i, inflight=0, shed=0, p99=1.0, name="replica"):
    return ServiceInfo(f"{name}-{i}", "127.0.0.1", 10000 + i,
                       inflight=inflight, shed_total=shed, p99_ms=p99)


class TestFleetControllerDecide:
    def _controller(self, sup, services, **kwargs):
        clock = kwargs.pop("clock", _FakeClock())
        kwargs.setdefault("min_replicas", 1)
        kwargs.setdefault("max_replicas", 4)
        kwargs.setdefault("scale_up_inflight", 4.0)
        kwargs.setdefault("scale_down_inflight", 1.0)
        kwargs.setdefault("cooldown_s", 3.0)
        kwargs.setdefault("down_sustain_s", 2.0)
        ctl = FleetController(sup, registry=_FakeRegistry(services),
                              clock=clock, **kwargs)
        return ctl, clock

    def test_scales_up_on_inflight(self):
        sup = _StubSupervisor(live=2)
        ctl, _ = self._controller(sup, [])
        decision = ctl.decide([_svc(0, inflight=6), _svc(1, inflight=8)])
        assert decision is not None and decision[0] == "up"

    def test_scales_up_on_shed_rate(self):
        sup = _StubSupervisor(live=2)
        ctl, clock = self._controller(sup, [])
        assert ctl.decide([_svc(0, shed=0), _svc(1, shed=0)]) is None
        clock.t += 1.0
        decision = ctl.decide([_svc(0, shed=10), _svc(1, shed=0)])
        assert decision is not None and decision[0] == "up"
        assert "shed" in decision[1]

    def test_no_scale_up_at_max(self):
        sup = _StubSupervisor(live=2)
        ctl, _ = self._controller(sup, [], max_replicas=2)
        assert ctl.decide([_svc(0, inflight=9), _svc(1, inflight=9)]) is None

    def test_scale_down_needs_sustained_idle(self):
        sup = _StubSupervisor(live=3)
        ctl, clock = self._controller(sup, [])
        idle = [_svc(i, inflight=0) for i in range(3)]
        assert ctl.decide(idle) is None  # first quiet sample: not yet
        clock.t += 1.0
        assert ctl.decide(idle) is None  # still inside down_sustain_s
        clock.t += 1.5
        decision = ctl.decide(idle)
        assert decision is not None and decision[0] == "down"

    def test_busy_sample_resets_the_idle_window(self):
        sup = _StubSupervisor(live=3)
        ctl, clock = self._controller(sup, [])
        idle = [_svc(i, inflight=0) for i in range(3)]
        assert ctl.decide(idle) is None
        clock.t += 1.5
        assert ctl.decide([_svc(i, inflight=9) for i in range(3)]) != \
            (None, None)  # busy (scales up); idle window must reset
        clock.t += 1.0
        assert ctl.decide(idle) is None  # idle restarts from zero

    def test_never_retires_below_min(self):
        sup = _StubSupervisor(live=2)
        ctl, clock = self._controller(sup, [], min_replicas=2)
        idle = [_svc(0, inflight=0), _svc(1, inflight=0)]
        ctl.decide(idle)
        clock.t += 10.0
        assert ctl.decide(idle) is None

    def test_below_min_scales_up_even_when_idle(self):
        sup = _StubSupervisor(live=1)
        ctl, _ = self._controller(sup, [], min_replicas=2)
        decision = ctl.decide([_svc(0, inflight=0)])
        assert decision is not None and decision[0] == "up"
        assert "below min" in decision[1]


class TestFleetControllerStep:
    def test_step_scales_up_publishes_and_cools_down(self):
        sup = _StubSupervisor(live=2)
        clock = _FakeClock()
        busy = [_svc(0, inflight=8), _svc(1, inflight=8)]
        registry = _FakeRegistry(busy)
        ctl = FleetController(
            sup, registry=registry, min_replicas=2, max_replicas=4,
            scale_up_inflight=4.0, cooldown_s=3.0, clock=clock,
        )
        seen = []
        bus = get_bus()
        bus.add_listener(seen.append)
        try:
            assert ctl.step() == ("up", "inflight 8.0 >= 4")
            assert sup.added == [2]
            assert sup.polls == 1
            # cooldown: the same pressure produces no second action
            clock.t += 1.0
            assert ctl.step() is None
            clock.t += 5.0
            assert ctl.step() == ("up", "inflight 8.0 >= 4")
        finally:
            bus.remove_listener(seen.append)
        scaled = [e for e in seen if isinstance(e, FleetScaled)]
        assert [e.direction for e in scaled] == ["up", "up"]
        assert scaled[0].replicas == 3

    def test_step_retires_least_loaded_and_deregisters(self):
        sup = _StubSupervisor(live=3)
        clock = _FakeClock()
        idle = [_svc(0, inflight=3), _svc(1, inflight=0), _svc(2, inflight=1)]
        registry = _FakeRegistry(idle)
        ctl = FleetController(
            sup, registry=registry, min_replicas=1, max_replicas=4,
            scale_down_inflight=2.0, down_sustain_s=1.0, cooldown_s=0.5,
            clock=clock,
        )
        assert ctl.step() is None  # idle window opens
        clock.t += 1.5
        assert ctl.step() == ("down", "idle 1.5s (inflight 1.3)")
        assert sup.retired == [1]  # the idlest replica went first
        assert registry.deregistered == ["replica-1"]


class TestRegistryLoadMetadata:
    def test_http_register_heartbeat_deregister_carry_load(self):
        with RegistrationService() as registry:
            base = registry.info.url.rstrip("/")

            def post(path, payload):
                req = urllib.request.Request(
                    base + path, data=json.dumps(payload).encode(),
                    method="POST",
                    headers={"Content-Type": "application/json"},
                )
                with urllib.request.urlopen(req, timeout=5) as r:
                    return r.status

            assert post("/register", {
                "name": "r0", "host": "127.0.0.1", "port": 12345,
                "inflight": 3, "shed_total": 1, "p99_ms": 2.5,
            }) == 200
            svc = registry.services[0]
            assert (svc.inflight, svc.shed_total, svc.p99_ms) == (3, 1, 2.5)

            assert post("/heartbeat", {
                "name": "r0", "inflight": 7, "shed_total": 4, "p99_ms": 9.0,
            }) == 200
            svc = registry.services[0]
            assert (svc.inflight, svc.shed_total, svc.p99_ms) == (7, 4, 9.0)

            with urllib.request.urlopen(base + "/services", timeout=5) as r:
                listed = json.loads(r.read())
            assert listed[0]["inflight"] == 7

            assert post("/deregister", {"name": "r0"}) == 200
            assert registry.services == []
            with pytest.raises(urllib.error.HTTPError) as err:
                post("/deregister", {"name": "r0"})
            assert err.value.code == 404

    def test_serving_server_reports_load_stats(self):
        with ServingServer(_const_model(1.0),
                           registry=MetricsRegistry()) as srv:
            _post(srv.info.url, {"input": 1.0})
            stats = srv.heartbeat_stats()
            assert stats["name"] == srv.info.name
            # the admission slot is released just AFTER the reply bytes
            # flush, so a fast client can observe inflight=1 for a tick;
            # the stat is eventually consistent
            deadline = time.monotonic() + 2.0
            while stats["inflight"] != 0 and time.monotonic() < deadline:
                time.sleep(0.01)
                stats = srv.heartbeat_stats()
            assert stats["inflight"] == 0  # idle again after the reply
            assert stats["shed_total"] == 0
            assert stats["p99_ms"] >= 0.0


class TestCampaignPayloads:
    def test_store_model_loader_parses_versions(self):
        model = store_model_loader('{"scale": 3.0, "bias": 1.0}')
        out = model(Table({"input": np.array([2.0, 4.0])}))
        assert list(out.column("prediction")) == [7.0, 13.0]

    def test_store_model_factory_serves_latest_commit(self, tmp_path):
        store = ModelStore(str(tmp_path / "models"))
        store.commit(json.dumps({"scale": 2.0}), name="model")
        store.commit(json.dumps({"scale": 5.0, "bias": 1.0}), name="model")
        model = store_model_factory(
            {"hot_swap": {"root": str(tmp_path), "name": "model"}}
        )
        out = model(Table({"input": np.array([2.0])}))
        assert out.column("prediction")[0] == 11.0


class TestFleetObservability:
    def test_timeline_folds_routing_and_fleet(self):
        events = [
            RequestRouted(rid="r1", replica="replica-0", hops=1,
                          status=200, latency=0.01),
            RequestRouted(rid="r2", replica="replica-1", hops=2,
                          status=200, latency=0.02),
            FleetScaled(direction="up", replicas=3, replica=2,
                        reason="inflight"),
        ]
        tl = timeline(events)
        assert tl["routing"]["count"] == 2
        assert tl["routing"]["hops"] == 3
        assert tl["routing"]["failovers"] == 1
        assert tl["routing"]["by_replica"] == {
            "replica-0": 1, "replica-1": 1,
        }
        (entry,) = tl["fleet"]
        assert entry["direction"] == "up"
        assert entry["replicas"] == 3
        assert entry["replica"] == 2
        assert entry["reason"] == "inflight"

    def test_router_publishes_request_routed(self, fleet):
        seen = []
        bus = get_bus()
        bus.add_listener(seen.append)
        try:
            with _router(fleet) as router:
                status, _ = _post(router.url, {"input": 1.0})
                assert status == 200
        finally:
            bus.remove_listener(seen.append)
        routed = [e for e in seen if isinstance(e, RequestRouted)]
        assert len(routed) == 1
        assert routed[0].status == 200
        assert routed[0].hops == 1
        assert routed[0].replica in ("replica-0", "replica-1")


class TestRouterTracing:
    def test_reply_carries_the_trace_id(self, fleet):
        seen = []
        bus = get_bus()
        bus.add_listener(seen.append)
        try:
            with _router(fleet) as router:
                status, _, headers = _post_headers(router.url, {"input": 1.0})
                assert status == 200
        finally:
            bus.remove_listener(seen.append)
        trace_id = headers.get(TRACE_HEADER)
        assert trace_id
        [routed] = [e for e in seen if isinstance(e, RequestRouted)]
        assert routed.trace_id == trace_id

    def test_error_reply_still_carries_the_trace_id(self):
        # a user quoting a failed request's trace id must join against
        # the event log, so 503s carry the header too
        with RegistrationService() as registry:
            with FleetRouter(registry=registry,
                             discovery_interval_s=60.0) as router:
                status, out, headers = _post_headers(
                    router.url, {"input": 1.0}
                )
                assert status == 503
                assert "no live replicas" in out["error"]
                assert headers.get(TRACE_HEADER)

    def test_replica_spans_join_the_router_trace(self, fleet):
        seen = []
        bus = get_bus()
        bus.add_listener(seen.append)
        try:
            with _router(fleet) as router:
                status, _, headers = _post_headers(router.url, {"input": 1.0})
                assert status == 200
        finally:
            bus.remove_listener(seen.append)
        trace_id = headers[TRACE_HEADER]
        spans = [e for e in seen
                 if isinstance(e, SpanRecorded) and e.trace_id == trace_id]
        names = {s.name for s in spans}
        assert {"router.request", "router.hop", "serving.request"} <= names
        hop = next(s for s in spans if s.name == "router.hop")
        serving = next(s for s in spans if s.name == "serving.request")
        # the wire context qualified the hop as the replica's parent
        assert serving.parent_id == f"driver:{hop.span_id}"

    def test_client_supplied_trace_is_adopted(self, fleet):
        with _router(fleet) as router:
            status, _, headers = _post_headers(
                router.url, {"input": 1.0},
                headers={TRACE_HEADER: "upstream-trace"},
            )
            assert status == 200
            assert headers[TRACE_HEADER] == "upstream-trace"


class TestFleetLogDeterminism:
    """The fold over a merged multi-process event log is deterministic
    under seeded chaos: re-merging the same segments is byte-identical, and
    the SLO report folds to the same JSON every time."""

    def test_merged_fold_is_deterministic_under_seeded_chaos(
        self, fleet, tmp_path
    ):
        base = str(tmp_path / "events.jsonl")
        plan = (
            FaultPlan(seed=11)
            .http_storm(count=3, status=503)
            .kill_process(1, iteration=4)
        )
        directives = plan.process_kill_directives()
        driver_sink = EventLogSink(base, process="driver")
        replica_sinks = {
            name: EventLogSink(process_log_path(base, name), process=name)
            for name in fleet.servers
        }
        seen = []
        bus = get_bus()
        bus.add_listener(seen.append)
        bus.add_listener(driver_sink)  # the driver books its real stream
        try:
            with _router(fleet) as router:
                with inject_faults(plan):
                    for i in range(20):
                        _post(router.url, {"input": float(i)})
        finally:
            bus.remove_listener(driver_sink)
            bus.remove_listener(seen.append)
        assert any(kind == "http_status" for kind, _, _ in plan.fired)
        # each replica books the requests it served into its own segment,
        # until the seeded kill directive ends its stream mid-run
        alive = {name: True for name in replica_sinks}
        iters = {name: 0 for name in replica_sinks}
        for e in (e for e in seen if isinstance(e, RequestRouted)):
            name = e.replica
            if name not in replica_sinks:
                continue
            member = int(name.rsplit("-", 1)[1])
            if FaultPlan.should_die(
                directives, member, iteration=iters[name], epoch=0
            ):
                alive[name] = False
            iters[name] += 1
            if alive[name] and e.status == 200:
                replica_sinks[name](RequestServed(
                    rid=e.rid, status=e.status, latency=e.latency,
                    trace_id=e.trace_id,
                ))
        driver_sink.close()
        for sink in replica_sinks.values():
            sink.close()
        assert not alive["replica-1"], "the seeded kill never landed"
        # re-merging the same segments is byte-identical
        out1, out2 = str(tmp_path / "m1.jsonl"), str(tmp_path / "m2.jsonl")
        n1 = write_merged(base, out1)
        n2 = write_merged(base, out2)
        assert n1 == n2 > 0
        with open(out1, "rb") as a, open(out2, "rb") as b:
            assert a.read() == b.read()
        # and the fleet SLO fold over the merged stream is deterministic
        events = merge(base)
        assert {getattr(e, "process", "") for e in events} >= {
            "driver", "replica-0", "replica-1",
        }
        report = SLOReport.fold(None, events=events)
        assert report.requests > 0
        assert report.to_json() == SLOReport.fold(
            None, events=merge(base)
        ).to_json()


# -- network directives on HTTP targets (tests/test_partition_tolerance.py) ----


class _Capture:
    """Event-bus listener collecting events by type name."""

    def __init__(self, *types):
        self.types = types
        self.events = []

    def __call__(self, event):
        if not self.types or isinstance(event, self.types):
            self.events.append(event)

    def __enter__(self):
        get_bus().add_listener(self)
        return self

    def __exit__(self, *exc):
        get_bus().remove_listener(self)


# ---------------------------------------------------------------------------
# network chaos plane
# ---------------------------------------------------------------------------


class TestNetDirectives:
    def test_gang_directives_are_epoch_scoped(self):
        plan = (
            FaultPlan(seed=1)
            .net_partition(0, 1, epoch=0, after_round=2)
            .net_corrupt(1, n=3, epoch=1)
        )
        assert plan.net_directives(0) == [{
            "target": "gang", "kind": "partition", "a": 0, "b": 1,
            "epoch": 0, "after_round": 2,
        }]
        assert [d["kind"] for d in plan.net_directives(1)] == ["corrupt"]
        assert len(plan.net_directives()) == 2
        assert plan.pending == 2

    def test_mark_net_fired_pops_and_books(self):
        plan = FaultPlan(seed=1).net_partition(0, 1, epoch=0)
        # either involved member acknowledges the partition
        assert plan.mark_net_fired("partition", member=1, epoch=0)
        assert not plan.mark_net_fired("partition", member=1, epoch=0)
        assert plan.fired == [("net_partition", 1, 0)]
        assert plan.pending == 0

    def test_mark_net_fired_respects_kind_and_epoch(self):
        plan = FaultPlan(seed=1).net_delay(1, ms=50.0, epoch=2)
        assert not plan.mark_net_fired("partition", member=1, epoch=2)
        assert not plan.mark_net_fired("delay", member=1, epoch=0)
        assert plan.mark_net_fired("delay", member=1, epoch=2)

    def test_http_partition_raises_unreachable(self):
        plan = FaultPlan(seed=1).net_partition("registry:1234")
        with inject_faults(plan):
            with pytest.raises(OSError, match="partition"):
                check_net("http://registry:1234/services")
            # consumed: the next call passes clean
            assert check_net("http://registry:1234/services") is None
        assert plan.fired == [("net_partition", 0, 0)]

    def test_http_drop_times_out_and_corrupt_passes_through(self):
        plan = (
            FaultPlan(seed=1)
            .net_drop("svc-a", p=1.0)
            .net_corrupt("svc-b", n=1)
        )
        with inject_faults(plan):
            with pytest.raises(socket.timeout):
                check_net("http://svc-a/predict")
            directive = check_net("http://svc-b/predict")
            assert directive["kind"] == "corrupt"
            assert check_net("http://unrelated/") is None
        assert [f[0] for f in plan.fired] == ["net_drop", "net_corrupt"]

    def test_unmatched_url_untouched(self):
        plan = FaultPlan(seed=1).net_partition("registry")
        with inject_faults(plan):
            assert check_net("http://replica-0:9/predict") is None
        assert plan.pending == 1


class FakeClock:
    def __init__(self, t=100.0):
        self.t = t

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


class TestLeaseExpiryFakeClock:
    def test_lease_expires_without_heartbeat(self):
        clock = FakeClock()
        reg = RegistrationService(ttl_s=5.0, clock=clock).start()
        reg.register(ServiceInfo("r-0", "127.0.0.1", 9000))
        assert [s.name for s in reg.services] == ["r-0"]
        clock.advance(5.1)
        assert reg.services == []
        # an expired lease's heartbeat is rejected: re-register required
        assert not reg.heartbeat("r-0")
        reg.stop()

    def test_heartbeat_extends_lease(self):
        clock = FakeClock()
        reg = RegistrationService(ttl_s=5.0, clock=clock).start()
        reg.register(ServiceInfo("r-0", "127.0.0.1", 9000))
        clock.advance(4.0)
        assert reg.heartbeat("r-0", inflight=3)
        clock.advance(4.0)  # 8s after register, 4s after heartbeat
        assert [s.name for s in reg.services] == ["r-0"]
        assert reg.services[0].inflight == 3
        reg.stop()


class TestLeaseJournal:
    def test_restart_recovers_leases_with_events(self, tmp_path):
        jd = str(tmp_path / "registry")
        first = RegistrationService(ttl_s=30.0, journal_dir=jd).start()
        first.register(ServiceInfo(
            "r-0", "127.0.0.1", 9100, model_version=3, inflight=2,
        ))
        first.register(ServiceInfo("r-1", "127.0.0.1", 9101))
        first.stop()

        with _Capture(LeaseRecovered) as cap:
            clock = FakeClock()
            second = RegistrationService(
                ttl_s=30.0, clock=clock, journal_dir=jd
            ).start()
        names = sorted(s.name for s in second.services)
        assert names == ["r-0", "r-1"]
        svc = {s.name: s for s in second.services}["r-0"]
        assert svc.model_version == 3 and svc.inflight == 2
        assert sorted(e.name for e in cap.events) == ["r-0", "r-1"]
        assert all(e.age_s >= 0.0 for e in cap.events)
        # the recovered lease got a FRESH grace period, so a replica that
        # keeps heartbeating never has to re-register from scratch
        clock.advance(29.0)
        assert second.heartbeat("r-0")
        second.stop()

    def test_deregister_drops_from_journal(self, tmp_path):
        jd = str(tmp_path / "registry")
        first = RegistrationService(journal_dir=jd).start()
        first.register(ServiceInfo("r-0", "127.0.0.1", 9100))
        first.register(ServiceInfo("r-1", "127.0.0.1", 9101))
        first.deregister("r-0")
        first.stop()
        second = RegistrationService(journal_dir=jd).start()
        assert [s.name for s in second.services] == ["r-1"]
        second.stop()

    def test_corrupt_journal_discarded(self, tmp_path):
        jd = tmp_path / "registry"
        first = RegistrationService(journal_dir=str(jd)).start()
        first.register(ServiceInfo("r-0", "127.0.0.1", 9100))
        first.stop()
        path = jd / RegistrationService.JOURNAL_NAME
        payload = path.read_bytes()
        path.write_bytes(payload[:-4] + b"!!!!")  # torn write
        assert f"{zlib.crc32(path.read_bytes()):08x}" != \
            (jd / (RegistrationService.JOURNAL_NAME + ".crc")).read_text()
        second = RegistrationService(journal_dir=str(jd)).start()
        assert second.services == []  # discarded, started empty
        second.stop()

    def test_no_journal_dir_keeps_old_behavior(self, tmp_path):
        reg = RegistrationService()
        reg.register(ServiceInfo("r-0", "127.0.0.1", 9100))
        assert reg._journal_path is None
        reg._httpd.server_close()


class _RawServer:
    """HTTP server answering GET /services with fixed raw bytes."""

    def __init__(self, raw: bytes):
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802
                self.send_response(200)
                self.send_header("Content-Length", str(len(outer.raw)))
                self.end_headers()
                self.wfile.write(outer.raw)

            def log_message(self, *args):
                pass

        self.raw = raw
        self._httpd = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.url = f"http://127.0.0.1:{self._httpd.server_address[1]}"

    def __enter__(self):
        threading.Thread(
            target=self._httpd.serve_forever, daemon=True
        ).start()
        return self

    def __exit__(self, *exc):
        self._httpd.shutdown()
        self._httpd.server_close()


class TestRouterRegistryOutage:
    def _table(self):
        return [{"name": "r-0", "host": "127.0.0.1", "port": 9200}]

    def test_connection_refused_keeps_stale_table(self):
        with socket.socket() as probe:
            probe.bind(("127.0.0.1", 0))
            dead_port = probe.getsockname()[1]
        router = FleetRouter(registry_url=f"http://127.0.0.1:{dead_port}")
        router._replicas = [ServiceInfo("r-0", "127.0.0.1", 9200)]
        with _Capture(RegistryUnavailable) as cap:
            table = router.refresh()
            router.refresh()  # second failure: same outage, no new event
        assert [s.name for s in table] == ["r-0"]
        assert router._stale
        assert len(cap.events) == 1
        assert cap.events[0].source == "router"
        assert cap.events[0].stale_replicas == 1
        router._httpd.server_close()

    def test_malformed_json_keeps_stale_table(self):
        with _RawServer(b'[{"name": "r-1", truncated') as srv:
            router = FleetRouter(registry_url=srv.url)
            router._replicas = [ServiceInfo("r-0", "127.0.0.1", 9200)]
            assert [s.name for s in router.refresh()] == ["r-0"]
            assert router._stale
            router._httpd.server_close()

    def test_corrupted_body_via_net_chaos_keeps_stale_table(self):
        with _RawServer(json.dumps(self._table()).encode()) as srv:
            router = FleetRouter(registry_url=srv.url)
            plan = FaultPlan(seed=1).net_corrupt(srv.url, n=1)
            with inject_faults(plan):
                router._replicas = [ServiceInfo("r-9", "127.0.0.1", 9300)]
                assert [s.name for s in router.refresh()] == ["r-9"]
                assert router._stale
                # chaos budget spent: next poll recovers the real table
                assert [s.name for s in router.refresh()] == ["r-0"]
                assert not router._stale
            assert plan.fired == [("net_corrupt", 0, 0)]
            router._httpd.server_close()

    def test_discovery_thread_survives_outage(self):
        with _RawServer(b"not json at all") as srv:
            router = FleetRouter(
                registry_url=srv.url, discovery_interval_s=0.02
            )
            router.start()
            try:
                import time

                time.sleep(0.2)  # many failing polls
                assert router._discover_thread.is_alive()
                assert router._stale
            finally:
                router.stop()

    def test_recovery_clears_stale_flag(self):
        with _RawServer(json.dumps(self._table()).encode()) as srv:
            router = FleetRouter(registry_url=srv.url)
            router._stale = True
            router._m_stale.set(1)
            assert [s.name for s in router.refresh()] == ["r-0"]
            assert not router._stale
            router._httpd.server_close()


# -- metrics federation (tests/test_observability.py) ---------------------------


def _replica_exposition(latencies, inflight, shed):
    """One fake replica's /metrics body, built from a real registry so
    parse_exposition stays the exact inverse of exposition()."""
    reg = MetricsRegistry()
    h = reg.histogram("serving_queue_wait_seconds", "Queue wait")
    for v in latencies:
        h.observe(v)
    reg.gauge("serving_inflight").set(inflight)
    reg.counter("serving_shed_total").inc(shed)
    return reg.exposition()


class TestMetricsFederation:
    def test_parse_exposition_inverts_registry_exposition(self):
        reg = MetricsRegistry()
        reg.counter("requests_total", "Requests").inc(3)
        reg.counter("failures_total").labels(reason="timeout").inc(2)
        reg.histogram("lat_seconds", buckets=[0.01, 0.1]).observe(0.05)
        kinds, samples = parse_exposition(reg.exposition())
        assert kinds["requests_total"] == "counter"
        assert kinds["lat_seconds"] == "histogram"
        by_name = {}
        for name, labels, value in samples:
            by_name.setdefault(name, []).append((labels, value))
        assert by_name["requests_total"] == [({}, 3.0)]
        assert by_name["failures_total"] == [({"reason": "timeout"}, 2.0)]
        buckets = dict(
            (labels["le"], value)
            for labels, value in by_name["lat_seconds_bucket"]
        )
        assert buckets["0.1"] == 1.0 and buckets["+Inf"] == 1.0

    def _federator(self, bodies):
        """A MetricsFederator whose fetch is served from ``bodies``:
        {url-substring: text}."""
        def fetch(url, timeout_s):
            for part, body in bodies.items():
                if part in url:
                    return body
            raise OSError(f"no route to {url}")

        return MetricsFederator("http://registry:0", fetch=fetch)

    def test_scrape_labels_every_series_with_the_replica(self):
        fed = self._federator({
            ":9000": _replica_exposition([0.002, 0.004], inflight=1, shed=0),
            ":9001": _replica_exposition([0.2, 0.4], inflight=3, shed=5),
        })
        services = [
            {"name": "replica-0", "host": "h", "port": 9000},
            {"name": "replica-1", "host": "h", "port": 9001},
        ]
        reg = fed.scrape(services)
        summary = reg.summary()
        assert summary["serving_inflight"] == {
            "replica=replica-0": 1.0, "replica=replica-1": 3.0,
        }
        hist = reg.histogram("serving_queue_wait_seconds")
        assert hist.labels(replica="replica-0").count == 2
        assert hist.labels(replica="replica-1").count == 2
        # reconstructed buckets interpolate per-replica quantiles
        assert hist.labels(replica="replica-0").percentile(0.5) < 0.05
        assert hist.labels(replica="replica-1").percentile(0.5) > 0.05

    def test_fleet_signals_read_load_at_the_source(self):
        fed = self._federator({
            ":9000": _replica_exposition([0.001] * 99, inflight=2, shed=1),
        })
        signals = fed.fleet_signals(
            services=[{"name": "replica-0", "host": "h", "port": 9000}]
        )
        sig = signals["replica-0"]
        assert sig["inflight"] == 2.0
        assert sig["shed_total"] == 1.0
        assert sig["p99_ms"] > 0

    def test_fleet_summary_merges_histogram_children(self):
        fed = self._federator({
            ":9000": _replica_exposition([0.002, 0.004], 0, 0),
            ":9001": _replica_exposition([0.2, 0.4], 0, 0),
        })
        reg = fed.scrape([
            {"name": "replica-0", "host": "h", "port": 9000},
            {"name": "replica-1", "host": "h", "port": 9001},
        ])
        # the parent histogram has no direct observations, so the plain
        # summary reports count=0 — the fleet fold must merge children
        assert reg.summary()["serving_queue_wait_seconds"]["count"] == 0
        merged = fleet_summary(reg)["serving_queue_wait_seconds"]
        assert merged["count"] == 4
        # the fleet fold interpolates over the union of observations
        report = SLOReport.fold_fleet(reg)
        assert report.stages["queue"]["count"] == 4
        assert report.stages["queue"]["p99"] > 0

    def test_fleet_fold_is_the_fold_of_one_registry_of_all_observations(self):
        """Merging the replicas' buckets gives the quantiles one registry
        holding every observation would give, not a mean of per-replica
        quantiles."""
        lat = [[0.001, 0.002, 0.003, 0.05], [0.2, 0.4, 0.004], [0.03]]
        fed = self._federator({f":{9000 + i}": _replica_exposition(v, i, i)
                               for i, v in enumerate(lat)})
        reg = fed.scrape([{"name": f"replica-{i}", "host": "h", "port": 9000 + i}
                          for i in range(3)])
        one = MetricsRegistry()
        h = one.histogram("serving_queue_wait_seconds", "Queue wait")
        for v in sum(lat, []):
            h.observe(v)
        want = one.summary()["serving_queue_wait_seconds"]
        got = fleet_summary(reg)["serving_queue_wait_seconds"]
        for key in ("count", "p50", "p95", "p99"):
            assert got[key] == want[key], key
        assert got["sum"] == pytest.approx(want["sum"], rel=1e-12)
        assert SLOReport.fold_fleet(reg).stages["queue"]["p99"] == want["p99"]
        # counters and gauges sum across the replica children in the fold
        assert SLOReport.fold_fleet(reg).shed == 3.0

    def test_scrape_failure_is_recorded_not_raised(self):
        fed = self._federator({":9000": _replica_exposition([], 0, 0)})
        services = [
            {"name": "replica-0", "host": "h", "port": 9000},
            {"name": "replica-gone", "host": "h", "port": 9999},
        ]
        reg = fed.scrape(services)
        assert "replica-gone" in fed.last_errors
        assert reg.summary()["serving_inflight"] == {
            "replica=replica-0": 0.0,
        }


# -- parity with the reference ---------------------------------------------------


def _net_trace(faults, registry_mod):
    """Every HTTP net directive through one package's check_net: what each
    call did, the plan's fired list and the counter it booked."""
    import socket as _socket

    plan = (faults.FaultPlan(seed=9).net_partition("registry", count=2)
            .net_delay("/score", 1.0).net_drop("/metrics", 0.5).net_corrupt("/services", n=2)
            .net_partition(0, 1, epoch=1).net_delay(1, 5.0, epoch=2))
    pending = [plan.pending]
    counter = registry_mod.get_registry().counter(
        "netchaos_http_faults_total",
        "Injected network degradations enacted on the HTTP client path")
    before = counter.value
    out = []
    with faults.inject_faults(plan):
        for url in ["http://registry:1/services", "http://h/score", "http://registry:1/x",
                    "http://h/metrics", "http://h/services", "http://h/services",
                    "http://h/services", "http://h/score", "http://other/"]:
            try:
                got = faults.check_net(url)
                out.append(("ok", got))
            except _socket.timeout as e:
                out.append(("timeout", str(e)))
            except OSError as e:
                out.append(("oserror", e.errno, str(e)))
            pending.append(plan.pending)
    return out, plan.fired, pending, counter.value - before, plan.net_directives()


def test_check_net_enacts_the_references_directives():
    import mmlspark_tpu.observability.registry as jreg
    import mmlspark_tpu.runtime.faults as jfaults

    import mmlspark_tpu_torch.observability.registry as treg
    import mmlspark_tpu_torch.runtime.faults as tfaults

    t, j = _net_trace(tfaults, treg), _net_trace(jfaults, jreg)
    assert t == j
    assert t[3] == 6  # partition x2, delay, drop, corrupt x2


def test_federation_folds_like_the_reference():
    import mmlspark_tpu.observability.federation as jfed
    import mmlspark_tpu.observability.registry as jreg

    bodies = {":9000": _replica_exposition([0.002, 0.004, 0.3], inflight=1, shed=2),
              ":9001": _replica_exposition([0.2, 0.4], inflight=3, shed=5)}
    services = [{"name": "replica-0", "host": "h", "port": 9000},
                {"name": "replica-1", "host": "h", "port": 9001},
                {"name": "replica-gone", "host": "h", "port": 9999}]

    def fetch(url, timeout_s):
        for part, body in bodies.items():
            if part in url:
                return body
        raise OSError(f"no route to {url}")

    out = []
    for fed_mod in (jfed, __import__("mmlspark_tpu_torch.observability.federation",
                                     fromlist=["MetricsFederator"])):
        fed = fed_mod.MetricsFederator("http://registry:0", fetch=fetch)
        reg = fed.scrape(services)
        out.append((reg.summary(), sorted(fed.last_errors),
                    fed.fleet_signals(services=services[:2]),
                    fed_mod.parse_exposition(jreg.MetricsRegistry().exposition())))
    assert out[0] == out[1]


def test_a_host_model_replica_starts_without_torch():
    """The replica entry point and the fleet's store payload import no
    torch: a replica serving a host model (the campaign's affine payload)
    starts without it (on the NVIDIA H100 machine, importing the replica
    with torch took 8.7 s)."""
    import subprocess
    import sys
    from pathlib import Path

    repo = Path(__file__).resolve().parents[1]
    code = ("import sys, mmlspark_tpu_torch.serving.replicas, mmlspark_tpu_torch.serving.fleet\n"
            "assert 'torch' not in sys.modules, sorted(m for m in sys.modules if 'torch' in m)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(repo)
    subprocess.run([sys.executable, "-c", code], check=True, env=env, cwd=str(repo), timeout=120)


# -- a real replica process -------------------------------------------------------


def test_replica_supervisor_respawns_a_killed_replica(tmp_path):
    """One replica process on the CPU serving the demo model: ready, answers,
    SIGKILLed, booked as an ExitStatus with the signal, respawned on a fresh
    port and answering again. The heartbeat timeout is shorter than a
    replica's start, so the respawn must not be judged by its predecessor's
    last beat."""
    sup = ReplicaSupervisor("mmlspark_tpu_torch.serving.replicas:demo_model_factory",
                            num_replicas=1, workdir=str(tmp_path / "fleet"), seed=3,
                            ready_timeout_s=20.0, heartbeat_timeout_s=1.0)
    t0 = time.monotonic()
    with sup:
        url = sup.urls()[0]
        assert _post(url, {"input": 4.0}) == (200, {"prediction": 8.0})
        pid = json.loads((tmp_path / "fleet" / "ready-0.json").read_text())["pid"]
        os.kill(pid, signal.SIGKILL)
        deadline = time.monotonic() + 10.0
        losses = []
        while not losses and time.monotonic() < deadline:
            losses = sup.poll()
            time.sleep(0.05)
        assert [(x.member, x.pid, x.reason, x.signal, x.epoch) for x in losses] == \
            [(0, pid, "signal:9", signal.SIGKILL, 0)]
        # supervise through the respawn's start: no second loss
        ready = tmp_path / "fleet" / "ready-0.json"
        while not ready.exists() and time.monotonic() < deadline + 10.0:
            assert sup.poll() == []
            time.sleep(0.05)
        sup.wait_ready(timeout_s=20.0)
        new_url = sup.urls()[0]
        assert new_url != url
        assert _post(new_url, {"input": 5.0}) == (200, {"prediction": 10.0})
    assert [x.reason for x in sup.exit_statuses] == ["signal:9"]
    assert time.monotonic() - t0 < 20.0
