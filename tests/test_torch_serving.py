"""The port's serving plane (mmlspark_tpu_torch.serving) and its request
guard (mmlspark_tpu_torch.dataguard.requestguard): the cases of
tests/test_serving.py and the request-guard cases of tests/test_dataguard.py
against the port (real servers and real clients), and a LightGBM model
served by both packages: the reference's fit, carried to the port through
``booster_from_jax``, answers the same 200 seeded requests (malformed ones
included) with the same statuses, error kinds, ``/metrics`` series,
``/healthz`` keys and event sequence, and probabilities within 1e-6."""

import json
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

from mmlspark_tpu_torch.core.pipeline import Transformer
from mmlspark_tpu_torch.data.table import Table
from mmlspark_tpu_torch.dataguard import MalformedRateBreaker, RequestValidator
from mmlspark_tpu_torch.lightgbm import LightGBMClassifier
from mmlspark_tpu_torch.serving import (
    DistributedServingServer,
    RegistrationService,
    ServingServer,
)


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


def _concurrent_load_latency(num_servers=3, num_clients=8, reqs_per_client=15,
                             kill_worker=True):
    """``num_clients`` threads hammer a DistributedServingServer; once half
    the requests are answered one listener stops, and its clients fail over
    to the others (the HTTPv2Suite.scala:315-387 shape)."""

    class Doubler(Transformer):
        def transform(self, table):
            x = np.asarray(table.column("input"), dtype=np.float64)
            return table.with_column("prediction", x * 2)

    results = {"times": [], "failovers": 0, "errors": 0}
    lock = threading.Lock()
    srv = DistributedServingServer(Doubler(), num_servers=num_servers,
                                   max_latency_ms=1.0).start()
    urls = [info.url for info in srv.service_info]
    kill_after = num_clients * reqs_per_client // 2
    done = {"count": 0}

    def client(cid):
        for i in range(reqs_per_client):
            want = float(cid * 1000 + i)
            t0 = time.perf_counter()
            ok = False
            for attempt in range(len(urls)):
                try:
                    _, out = _post(urls[(cid + attempt) % len(urls)], {"input": want})
                    assert out["prediction"] == want * 2, out
                    ok = True
                    break
                except AssertionError:
                    raise
                except Exception:
                    with lock:
                        results["failovers"] += 1
            with lock:
                results["times"].append(time.perf_counter() - t0)
                results["errors"] += 0 if ok else 1
                done["count"] += 1

    def killer():
        while True:
            with lock:
                if done["count"] >= kill_after:
                    break
            time.sleep(0.002)
        srv.servers[0].stop()

    threads = [threading.Thread(target=client, args=(c,)) for c in range(num_clients)]
    if kill_worker:
        threads.append(threading.Thread(target=killer))
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    srv.stop()
    times = sorted(results["times"])
    return {"requests": len(times), "failovers": results["failovers"],
            "errors": results["errors"], "p50_ms": times[len(times) // 2] * 1e3}


class _Doubler(Transformer):
    def transform(self, table):
        x = np.asarray(table.column("input"), dtype=np.float64)
        return table.with_column("prediction", x * 2)


def _post(url, payload, timeout=10):
    req = urllib.request.Request(
        url, data=json.dumps(payload).encode(), method="POST",
        headers={"Content-Type": "application/json"},
    )
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.status, json.loads(r.read())


class TestServingServer:
    def test_single_request(self):
        with ServingServer(_Doubler(), max_latency_ms=1.0) as srv:
            status, out = _post(srv.info.url, {"input": 21.0})
            assert status == 200 and out["prediction"] == 42.0

    def test_vector_payloads(self):
        class VecModel(Transformer):
            def transform(self, table):
                X = np.asarray(table.column("input"), dtype=np.float64)
                return table.with_column("prediction", X.sum(axis=1))

        with ServingServer(VecModel()) as srv:
            status, out = _post(srv.info.url, {"input": [1.0, 2.0, 3.0]})
            assert status == 200 and out["prediction"] == 6.0

    def test_concurrent_batching(self):
        with ServingServer(_Doubler(), max_batch_size=16, max_latency_ms=5.0) as srv:
            with ThreadPoolExecutor(max_workers=16) as pool:
                results = list(pool.map(
                    lambda i: _post(srv.info.url, {"input": float(i)}),
                    range(32),
                ))
            assert all(s == 200 for s, _ in results)
            assert [o["prediction"] for _, o in results] == [2.0 * i for i in range(32)]

    def test_model_error_returns_500(self):
        class Exploder(Transformer):
            def transform(self, table):
                raise RuntimeError("boom")

        with ServingServer(Exploder()) as srv:
            try:
                status, _ = _post(srv.info.url, {"input": 1.0})
            except urllib.error.HTTPError as e:
                status = e.code
            assert status == 500

    def test_invalid_json_400(self):
        with ServingServer(_Doubler()) as srv:
            req = urllib.request.Request(
                srv.info.url, data=b"{not json", method="POST")
            try:
                urllib.request.urlopen(req, timeout=5)
                status = 200
            except urllib.error.HTTPError as e:
                status = e.code
            assert status == 400

    def test_latency_single_row(self):
        # The BASELINE config-5 target: p50 < 5 ms end-to-end through the
        # HTTP edge (measured ~1.8 ms for this model; the real-model device
        # composition is benchmarks/serving_latency.py).
        with ServingServer(_Doubler(), max_latency_ms=0.5) as srv:
            for _ in range(5):
                _post(srv.info.url, {"input": 1.0})  # warmup
            times = []
            for i in range(50):
                t0 = time.perf_counter()
                _post(srv.info.url, {"input": float(i)})
                times.append(time.perf_counter() - t0)
            p50 = sorted(times)[len(times) // 2]
            # sanity bound only: wall-clock through a real socket flakes on
            # loaded CI hosts; the 5 ms target claim is measured and recorded
            # by benchmarks/serving_latency.py + docs/serving_latency.md
            assert p50 < 0.015, f"p50 {p50 * 1e3:.1f}ms"


class TestDistributedServing:
    def test_multiple_endpoints(self):
        with DistributedServingServer(_Doubler(), num_servers=3) as srv:
            infos = srv.service_info
            assert len({i.port for i in infos}) == 3
            for info in infos:
                status, out = _post(info.url, {"input": 2.0})
                assert status == 200 and out["prediction"] == 4.0


class TestFaultTolerance:
    def test_task_retry_rehydration(self):
        """A batch whose evaluation dies is re-enqueued and replayed — the
        client still gets a 200 (``registerPartition`` re-hydration,
        HTTPSourceV2.scala:470-487)."""

        class FlakyOnce(Transformer):
            def __init__(self, **kw):
                super().__init__(**kw)
                self.calls = 0

            def transform(self, table):
                self.calls += 1
                if self.calls == 1:
                    raise RuntimeError("transient task death")
                x = np.asarray(table.column("input"), dtype=np.float64)
                return table.with_column("prediction", x * 2)

        model = FlakyOnce()
        with ServingServer(model, max_retries=2) as srv:
            status, out = _post(srv.info.url, {"input": 5.0})
            assert status == 200 and out["prediction"] == 10.0
            assert model.calls == 2  # first attempt died, replay answered

    def test_retries_exhausted_500(self):
        class AlwaysDies(Transformer):
            def transform(self, table):
                raise RuntimeError("permanent")

        with ServingServer(AlwaysDies(), max_retries=1) as srv:
            try:
                status, _ = _post(srv.info.url, {"input": 1.0})
            except urllib.error.HTTPError as e:
                status = e.code
            assert status == 500

    def test_recover_replays_uncommitted_epoch(self):
        """Kill the worker mid-batch; recover() re-hydrates the uncommitted
        epoch and a restarted worker answers it."""
        import threading

        release = threading.Event()
        died = threading.Event()

        class BlocksThenDies(Transformer):
            def __init__(self, **kw):
                super().__init__(**kw)
                self.calls = 0

            def transform(self, table):
                self.calls += 1
                if self.calls == 1:
                    died.set()
                    release.wait(timeout=10)
                    raise SystemExit  # hard worker death mid-epoch
                x = np.asarray(table.column("input"), dtype=np.float64)
                return table.with_column("prediction", x + 1)

        model = BlocksThenDies()
        srv = ServingServer(model, max_retries=0).start()
        try:
            from concurrent.futures import ThreadPoolExecutor

            with ThreadPoolExecutor(max_workers=1) as pool:
                fut = pool.submit(_post, srv.info.url, {"input": 41.0}, 15)
                assert died.wait(timeout=5)  # worker is inside the doomed epoch
                release.set()  # let it die
                time.sleep(0.2)
                assert srv.loop.uncommitted_epochs  # epoch never committed
                replayed = srv.loop.recover()
                assert replayed == 1
                srv.loop.start()  # restarted worker
                status, out = fut.result(timeout=10)
                assert status == 200 and out["prediction"] == 42.0
        finally:
            srv.stop()


class TestDistributedV2:
    def test_cross_listener_reply_routing(self):
        """Requests hitting DIFFERENT listeners are answered through the one
        shared loop — reply routing is by request id, not by listener
        (the cross-worker reply HTTPSourceV2.scala:509-533 left
        unimplemented)."""
        calls = []

        class Recorder(Transformer):
            def transform(self, table):
                x = np.asarray(table.column("input"), dtype=np.float64)
                calls.append(len(x))
                return table.with_column("prediction", x * 3)

        with DistributedServingServer(
            Recorder(), num_servers=3, max_batch_size=8, max_latency_ms=50.0
        ) as srv:
            urls = [i.url for i in srv.service_info]
            with ThreadPoolExecutor(max_workers=6) as pool:
                results = list(pool.map(
                    lambda i: _post(urls[i % 3], {"input": float(i)}), range(6)
                ))
            assert all(s == 200 for s, _ in results)
            assert [o["prediction"] for _, o in results] == [3.0 * i for i in range(6)]
        # the shared loop batched across listeners (fewer calls than requests)
        assert sum(calls) == 6 and len(calls) < 6

    def test_registration_service(self):
        with RegistrationService() as reg:
            with DistributedServingServer(
                _Doubler(), num_servers=2, registry_url=reg.info.url
            ) as srv:
                # client-side discovery via the driver service
                with urllib.request.urlopen(reg.info.url + "services", timeout=5) as r:
                    services = json.loads(r.read())
                assert len(services) == 2
                ports = {s["port"] for s in services}
                assert ports == {i.port for i in srv.service_info}
                # discovered endpoints actually answer
                s0 = services[0]
                status, out = _post(f"http://{s0['host']}:{s0['port']}/", {"input": 7.0})
                assert status == 200 and out["prediction"] == 14.0


class TestConcurrentLoad:
    def test_distributed_under_load_with_worker_death(self):
        """The HTTPv2Suite.scala:315-387 shape: concurrent clients hammer
        multiple listeners; one listener dies mid-stream and its clients
        fail over to the surviving endpoints. Every request must succeed
        with the correct answer and the latency distribution stays sane."""
        out = _concurrent_load_latency(
            num_servers=3, num_clients=8, reqs_per_client=15, kill_worker=True
        )
        assert out["requests"] == 8 * 15
        assert out["errors"] == 0, out  # failover absorbed the worker death
        assert out["failovers"] >= 1, out  # the death actually happened mid-stream
        assert out["p50_ms"] < 250, out


def test_distributed_base_port_binds_sequential_ports():
    """base_port pins listener ports (the k8s Service contract)."""
    srv = DistributedServingServer(_Doubler(), num_servers=2, base_port=28970)
    with srv:
        ports = [i.port for i in srv.service_info]
        assert ports == [28970, 28971]
        status, out = _post(srv.service_info[1].url, {"input": 4.0})
        assert status == 200 and out["prediction"] == 8.0


class TestSchedulerBackedDispatch:
    """DistributedServingServer routed through mmlspark_tpu_torch.runtime — the
    Spark-cluster posture where micro-batches evaluate on executors the
    driver can lose (and replace) without a client ever seeing it."""

    def _policy(self, **kw):
        from mmlspark_tpu_torch import runtime

        base = dict(max_workers=2, backoff_base=0.01, heartbeat_interval=0.02)
        base.update(kw)
        return runtime.SchedulerPolicy(**base)

    def test_num_executors_routes_batches_through_scheduler(self):
        srv = DistributedServingServer(
            _Doubler(), num_servers=2, num_executors=2, max_latency_ms=1.0
        )
        with srv:
            for i, info in enumerate(srv.service_info):
                status, out = _post(info.url, {"input": float(i)})
                assert status == 200 and out["prediction"] == i * 2.0
        assert srv.scheduler is not None
        assert srv.scheduler.metrics.summary()["tasks_done"] >= 2

    def test_injected_executor_death_absorbed(self):
        """An executor killed mid-batch retries its partition; the client
        still gets 200 with the right answer, and metrics show the death."""
        from mmlspark_tpu_torch import runtime

        plan = runtime.FaultPlan(seed=9).kill_task(0)
        srv = DistributedServingServer(
            _Doubler(), num_servers=1, num_executors=2,
            executor_policy=self._policy(faults=plan), max_latency_ms=1.0,
        )
        with srv:
            status, out = _post(srv.service_info[0].url, {"input": 21.0})
            assert status == 200 and out["prediction"] == 42.0
        assert plan.fired == [("kill", 0, 0)]
        s = srv.scheduler.metrics.summary()
        assert s["failures_executor_death"] == 1 and s["retries_total"] == 1

    def test_ambient_policy_activates_scheduler(self):
        from mmlspark_tpu_torch import runtime

        with runtime.policy(max_workers=2, backoff_base=0.01):
            srv = DistributedServingServer(
                _Doubler(), num_servers=1, max_latency_ms=1.0
            )
        with srv:
            status, out = _post(srv.service_info[0].url, {"input": 3.0})
            assert status == 200 and out["prediction"] == 6.0
        assert srv.scheduler is not None

    def test_batch_split_preserves_request_order(self):
        """A >1-request micro-batch splits across executor tasks; replies
        must route back to the right requester."""
        srv = DistributedServingServer(
            _Doubler(), num_servers=2, num_executors=3,
            max_batch_size=16, max_latency_ms=30.0,
        )
        with srv:
            urls = [i.url for i in srv.service_info]
            with ThreadPoolExecutor(max_workers=8) as ex:
                futs = [
                    ex.submit(_post, urls[k % len(urls)], {"input": float(k)})
                    for k in range(24)
                ]
                results = [f.result() for f in futs]
        for k, (status, out) in enumerate(results):
            assert status == 200 and out["prediction"] == k * 2.0


class TestRegistrationLeases:
    """Registration-service TTL: registrations are leases refreshed by
    replica heartbeats; a silent crash drops out of discovery."""

    class _Clock:
        def __init__(self):
            self.t = 1000.0

        def now(self):
            return self.t

    def _svc(self, name, port=9001):
        from mmlspark_tpu_torch.serving.server import ServiceInfo

        return ServiceInfo(name=name, host="127.0.0.1", port=port)

    def test_lease_expires_without_heartbeat(self):
        clock = self._Clock()
        reg = RegistrationService(ttl_s=10.0, clock=clock.now)
        reg.register(self._svc("replica-0"))
        reg.register(self._svc("replica-1", port=9002))
        assert {s.name for s in reg.services} == {"replica-0", "replica-1"}
        # replica-1 keeps heartbeating; replica-0 goes silent
        clock.t += 8.0
        assert reg.heartbeat("replica-1")
        clock.t += 4.0  # replica-0 is now 12 s stale, replica-1 only 4 s
        assert {s.name for s in reg.services} == {"replica-1"}

    def test_heartbeat_refreshes_lease_indefinitely(self):
        clock = self._Clock()
        reg = RegistrationService(ttl_s=10.0, clock=clock.now)
        reg.register(self._svc("replica-0"))
        for _ in range(5):
            clock.t += 9.0
            assert reg.heartbeat("replica-0")
        assert {s.name for s in reg.services} == {"replica-0"}

    def test_heartbeat_after_expiry_demands_reregistration(self):
        clock = self._Clock()
        reg = RegistrationService(ttl_s=10.0, clock=clock.now)
        reg.register(self._svc("replica-0"))
        clock.t += 11.0
        # the lease lapsed: heartbeat is refused, replica must re-register
        assert not reg.heartbeat("replica-0")
        assert reg.services == []
        reg.register(self._svc("replica-0"))
        assert {s.name for s in reg.services} == {"replica-0"}

    def test_no_ttl_means_everlasting_registrations(self):
        clock = self._Clock()
        reg = RegistrationService(clock=clock.now)  # ttl_s=None
        reg.register(self._svc("replica-0"))
        clock.t += 1e9
        assert {s.name for s in reg.services} == {"replica-0"}

    def test_http_heartbeat_endpoint(self):
        with RegistrationService(ttl_s=30.0) as reg:
            reg.register(self._svc("replica-0"))
            req = urllib.request.Request(
                reg.info.url + "heartbeat",
                data=json.dumps({"name": "replica-0"}).encode(),
                method="POST", headers={"Content-Type": "application/json"},
            )
            with urllib.request.urlopen(req, timeout=5) as r:
                assert r.status == 200
            # unknown replica -> 404, the re-register signal
            req = urllib.request.Request(
                reg.info.url + "heartbeat",
                data=json.dumps({"name": "ghost"}).encode(),
                method="POST", headers={"Content-Type": "application/json"},
            )
            with pytest.raises(urllib.error.HTTPError) as ei:
                urllib.request.urlopen(req, timeout=5)
            assert ei.value.code == 404

    def test_distributed_server_heartbeats_keep_lease_alive(self):
        with RegistrationService(ttl_s=1.0) as reg:
            with DistributedServingServer(
                _Doubler(), num_servers=2, registry_url=reg.info.url,
                registry_heartbeat_s=0.2,
            ) as srv:
                deadline = time.monotonic() + 2.5
                while time.monotonic() < deadline:
                    # the replicas outlive several TTL windows because the
                    # heartbeat thread keeps refreshing the lease
                    assert len(reg.services) == 2
                    time.sleep(0.25)
            # servers stopped -> heartbeats stop -> leases lapse
            deadline = time.monotonic() + 5.0
            while reg.services and time.monotonic() < deadline:
                time.sleep(0.1)
            assert reg.services == []


# -- the request guard (tests/test_dataguard.py) -----------------------------


class TestRequestValidator:
    def test_structural_rejections(self):
        v = RequestValidator(input_col="input", width=3)
        assert v.check_payload(None) == (
            "empty-payload", "request body is empty"
        )
        assert v.check_payload({"other": 1})[0] == "missing-input-col"
        assert v.check_payload({"input": float("nan")})[0] == \
            "non-finite-value"
        assert v.check_payload({"input": [1.0, None, 2.0]})[0] == "null-value"
        assert v.check_payload({"input": [1.0, 2.0]})[0] == "shape-mismatch"
        assert v.check_payload({"input": [[1.0, 2.0, 3.0], [1.0, 2.0]]})[0] \
            == "shape-mismatch"
        assert v.check_payload({"input": [1.0, 2.0, 3.0]}) is None
        assert v.check_payload({"input": "some text"}) is None

    def test_for_model_infers_booster_width(self, tmp_path):
        rng = np.random.default_rng(0)
        X = rng.normal(size=(60, 4))
        y = (X[:, 0] > 0).astype(np.float64)
        model = LightGBMClassifier(numIterations=2, numLeaves=7, device="cpu").fit(
            Table({"features": X, "label": y})
        )
        v = RequestValidator.for_model(model, input_col="features")
        assert v.width == 4

    def test_for_model_unknown_width_validates_structure_only(self):
        v = RequestValidator.for_model(object())
        assert v.width is None
        assert v.check_payload({"input": [1.0, 2.0]}) is None
        assert v.check_payload({"input": float("inf")})[0] == \
            "non-finite-value"

    def test_disabled_passes_everything(self):
        v = RequestValidator(enabled=False)
        assert v.check_payload(None) is None


class TestMalformedRateBreaker:
    def test_trip_and_release_with_injected_clock(self):
        now = [0.0]
        b = MalformedRateBreaker(
            threshold=3, window_s=10.0, reset_s=5.0, clock=lambda: now[0]
        )
        assert b.record_malformed("evil") is False
        assert b.record_malformed("evil") is False
        assert b.record_malformed("evil") is True  # third one trips
        assert b.blocked("evil") is True
        assert b.blocked("innocent") is False  # per-client isolation
        now[0] = 5.1
        assert b.blocked("evil") is False  # released after reset_s
        assert b.record_malformed("evil") is False  # window restarts

    def test_old_events_age_out_of_window(self):
        now = [0.0]
        b = MalformedRateBreaker(
            threshold=3, window_s=2.0, reset_s=1.0, clock=lambda: now[0]
        )
        b.record_malformed("c")
        b.record_malformed("c")
        now[0] = 3.0  # both events aged out
        assert b.record_malformed("c") is False
        assert b.blocked("c") is False


def _post_raw(url, data, headers=None, timeout=10):
    req = urllib.request.Request(
        url, data=data, method="POST",
        headers={"Content-Type": "application/json", **(headers or {})},
    )
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, r.read(), dict(r.headers)
    except urllib.error.HTTPError as e:
        return e.code, e.read(), dict(e.headers)


class TestServingEdge:
    """Pre-admission hardening: structured, traced 400s and the breaker."""

    def _model(self):
        rng = np.random.default_rng(1)
        X = rng.normal(size=(60, 3))
        y = (X[:, 0] > 0).astype(np.float64)
        return LightGBMClassifier(numIterations=2, numLeaves=7, device="cpu").fit(
            Table({"features": X, "label": y})
        )

    def test_invalid_json_gets_traced_structured_400(self):
        from mmlspark_tpu_torch.serving import ServingServer

        with ServingServer(self._model(), input_col="features") as srv:
            status, body, headers = _post_raw(
                srv.info.url, b'{"features": [1.0, broken'
            )
            assert status == 400
            # the regression this guards: the 400 path must carry the
            # trace id even though no span existed before the parse
            assert headers.get("X-Trace-Id")
            err = json.loads(body)["error"]
            assert err["kind"] == "invalid-json" and err["rid"]

    def test_schema_violations_get_structured_400(self):
        from mmlspark_tpu_torch.serving import ServingServer

        with ServingServer(self._model(), input_col="features") as srv:
            cases = [
                (json.dumps({"wrong": [1.0]}).encode(), "missing-input-col"),
                (b'{"features": [1.0, 2.0]}', "shape-mismatch"),
                (b'{"features": [NaN, 1.0, 2.0]}', "non-finite-value"),
            ]
            for payload, kind in cases:
                status, body, headers = _post_raw(srv.info.url, payload)
                assert status == 400, (kind, status, body)
                assert json.loads(body)["error"]["kind"] == kind
                assert headers.get("X-Trace-Id")
            # a valid request on the same (kept-alive) endpoint still serves
            status, _, _ = _post_raw(
                srv.info.url, json.dumps({"features": [0.1, 0.2, 0.3]}).encode()
            )
            assert status == 200

    def test_poison_client_shed_then_released(self):
        from mmlspark_tpu_torch.serving import ServingServer

        with ServingServer(
            self._model(), input_col="features",
            malformed_threshold=3, malformed_window_s=30.0,
            malformed_reset_s=0.3,
        ) as srv:
            poison = {"X-Client-Id": "poison"}
            for _ in range(3):
                status, _, _ = _post_raw(
                    srv.info.url, b'{"features": bad', headers=poison
                )
                assert status == 400
            good = json.dumps({"features": [0.1, 0.2, 0.3]}).encode()
            status, body, headers = _post_raw(srv.info.url, good, headers=poison)
            assert status == 429, body
            assert "Retry-After" in headers
            assert json.loads(body)["error"]["kind"] == "malformed-rate"
            # a different client on the same replica is untouched
            status, _, _ = _post_raw(
                srv.info.url, good, headers={"X-Client-Id": "healthy"}
            )
            assert status == 200
            time.sleep(0.35)
            status, _, _ = _post_raw(srv.info.url, good, headers=poison)
            assert status == 200

    def test_validator_off_restores_old_edge(self):
        from mmlspark_tpu_torch.serving import ServingServer

        with ServingServer(
            self._model(), input_col="features", request_validator="off"
        ) as srv:
            # shape garbage reaches the model unchecked (the booster
            # happens to tolerate short rows) — the point is that the
            # edge no longer pre-rejects: opt-out is explicit
            status, _, _ = _post_raw(srv.info.url, b'{"features": [1.0]}')
            assert status != 400

    def test_request_span_recorded_before_the_reply(self):
        """The reply's ``serving.request`` span is recorded before the reply
        is written, on the served path and on the poison breaker's 429: a
        replica that dies once the client holds its answer keeps the span
        (the fleet campaign's trace continuity)."""
        from mmlspark_tpu_torch.observability.tracing import get_tracer
        from mmlspark_tpu_torch.serving import ServingServer

        def span_of(headers):
            spans = [s for s in get_tracer().export(headers["X-Trace-Id"])
                     if s["name"] == "serving.request"]
            return spans[0]["status"] if len(spans) == 1 else spans

        good = json.dumps({"features": [0.1, 0.2, 0.3]}).encode()
        with ServingServer(
            self._model(), input_col="features",
            malformed_threshold=1, malformed_window_s=30.0, malformed_reset_s=30.0,
        ) as srv:
            status, _, headers = _post_raw(srv.info.url, good)
            assert status == 200 and span_of(headers) == "200"
            poison = {"X-Client-Id": "poison"}
            status, _, headers = _post_raw(srv.info.url, b'{"features": bad', headers=poison)
            assert status == 400 and span_of(headers) == "400"
            status, _, headers = _post_raw(srv.info.url, good, headers=poison)
            assert status == 429 and span_of(headers) == "429"

    def test_lost_reply_is_traced_and_counted(self, monkeypatch):
        """A reply whose write fails (a client that hung up) keeps its
        ``serving.request`` span with the status that was computed, gains a
        zero-length ``serving.reply`` child with status ``disconnect``, and
        counts in ``serving_replies_failed_total``: on the served path and
        on the 400."""
        from mmlspark_tpu_torch.observability.tracing import get_tracer
        from mmlspark_tpu_torch.serving import ServingServer
        from mmlspark_tpu_torch.serving import server as server_mod

        make = server_mod._ListenerMixin._make_handler

        def failing_posts(self, loop, input_col):
            class Handler(make(self, loop, input_col)):
                def _reply_bytes(self, status, data, **kw):
                    if self.command == "POST":
                        self.close_connection = True
                        raise BrokenPipeError("the client hung up")
                    return super()._reply_bytes(status, data, **kw)

            return Handler

        monkeypatch.setattr(server_mod._ListenerMixin, "_make_handler", failing_posts)
        seen = {s["span_id"] for s in get_tracer().export()}
        with ServingServer(self._model(), input_col="features") as srv:
            for body in (json.dumps({"features": [0.1, 0.2, 0.3]}).encode(),
                         b'{"features": bad'):
                with pytest.raises((urllib.error.URLError, ConnectionError)):
                    _post_raw(srv.info.url, body, timeout=5)
            failed = srv.loop._reg_replies_failed.value
        spans = [s for s in get_tracer().export() if s["span_id"] not in seen]
        lost = [s for s in spans if s["name"] == "serving.reply"]
        assert [s["status"] for s in lost] == ["disconnect", "disconnect"]
        assert all(s["duration"] >= 0.0 for s in lost)
        parents = {s["span_id"]: s for s in spans if s["name"] == "serving.request"}
        assert [parents[s["parent_id"]]["status"] for s in lost] == ["200", "400"]
        assert failed == 2


class TestFaultPlanMalformed:
    def test_take_malformed_drains_in_order(self):
        from mmlspark_tpu_torch.runtime.faults import FaultPlan

        plan = FaultPlan(seed=1)
        plan.malformed_request(count=2, kind="json")
        plan.malformed_request(count=1, kind="nan")
        kinds = [plan.take_malformed() for _ in range(4)]
        assert kinds == ["json", "json", "nan", None]
        fired = [f for f in plan.fired if f[0] == "malformed_request"]
        assert len(fired) == 3

    def test_unknown_kind_rejected(self):
        from mmlspark_tpu_torch.runtime.faults import FaultPlan

        with pytest.raises(ValueError, match="malformed-request kind"):
            FaultPlan(seed=1).malformed_request(kind="gibberish")


# -- a LightGBM model served by both packages ---------------------------------

PARITY_ROWS, PARITY_REQUESTS, HIGGS_WIDTH = 2000, 200, 28

#: event fields that carry times or generated ids
_VOLATILE = {"t", "rid", "trace_id", "span_id", "parent_id", "start", "end", "duration",
             "wall_start", "latency", "process", "pid", "uptime_seconds"}


def _higgs_rows(n, seed):
    """bench.py's HIGGS-width generator with 10% label noise and U(0.5, 2)
    row weights."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, HIGGS_WIDTH))
    logit = X[:, 0] * 1.5 + X[:, 1] * X[:, 2] + 0.8 * np.sin(X[:, 3]) + 0.5 * rng.normal(size=n)
    y = (logit > 0).astype(np.float64)
    flip = rng.random(n) < 0.1
    y[flip] = 1.0 - y[flip]
    return X, y, rng.uniform(0.5, 2.0, n)


def _parity_requests(seed=7):
    """200 seeded requests: (client id, body bytes). About a fifth are
    malformed (undecodable JSON, NaN, wrong width, missing key), all from
    the client ``poison``; valid rows come from ``poison`` and ``healthy``."""
    rng = np.random.default_rng(seed)
    X, _, _ = _higgs_rows(PARITY_REQUESTS, seed + 1)
    out = []
    for i in range(PARITY_REQUESTS):
        r = rng.random()
        row = [float(v) for v in X[i]]
        if r < 0.08:
            out.append(("poison", b'{"features": [0.5, broken'))
        elif r < 0.13:
            out.append(("poison", json.dumps({"features": row[:5] + [float("nan")] + row[6:]},
                                             allow_nan=True).encode()))
        elif r < 0.18:
            out.append(("poison", json.dumps({"features": row[:-3]}).encode()))
        elif r < 0.20:
            out.append(("poison", json.dumps({"wrong": row}).encode()))
        else:
            client = "poison" if rng.random() < 0.3 else "healthy"
            out.append((client, json.dumps({"features": row}).encode()))
    return out


def _post_raw(url, data, headers=None, timeout=10):
    req = urllib.request.Request(
        url, data=data, method="POST",
        headers={"Content-Type": "application/json", **(headers or {})},
    )
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, r.read(), dict(r.headers)
    except urllib.error.HTTPError as e:
        return e.code, e.read(), dict(e.headers)


def _serve_parity(pkg, model):
    """Drive one package's ServingServer with the seeded requests, one at a
    time: each request ends with its RequestServed or RequestShed event
    before the next is sent, so the event sequence is the packages', not
    the threads'. The poison breaker runs on a clock that moves 10 ms per
    request."""
    import importlib

    serving = importlib.import_module(f"{pkg}.serving")
    events = importlib.import_module(f"{pkg}.observability.events")
    registry = importlib.import_module(f"{pkg}.observability.registry")
    guard = importlib.import_module(f"{pkg}.dataguard.requestguard")
    now = [0.0]
    reg = registry.MetricsRegistry()
    breaker = guard.MalformedRateBreaker(threshold=6, window_s=1000.0, reset_s=0.5,
                                         clock=lambda: now[0], registry=reg)
    seen, ends = [], threading.Semaphore(0)

    def listen(e):
        seen.append(e)
        if type(e).__name__ in ("RequestServed", "RequestShed"):
            ends.release()

    bus = events.get_bus()
    bus.add_listener(listen)
    replies = []
    try:
        with serving.ServingServer(model, input_col="features", output_col="probability",
                                   registry=reg, malformed_breaker=breaker,
                                   max_latency_ms=0.5) as srv:
            for client, body in _parity_requests():
                status, data, headers = _post_raw(srv.info.url, body,
                                                  headers={"X-Client-Id": client})
                assert ends.acquire(timeout=10)
                assert headers.get("X-Trace-Id")
                replies.append((status, json.loads(data)))
                now[0] += 0.01
            health = json.loads(urllib.request.urlopen(srv.info.url + "healthz",
                                                       timeout=5).read())
            metrics = urllib.request.urlopen(srv.info.url + "metrics", timeout=5).read().decode()
    finally:
        bus.remove_listener(listen)
    def fields(d):
        return {k: fields(v) if isinstance(v, dict) else v
                for k, v in d.items() if k not in _VOLATILE}

    trail = [(type(e).__name__, fields(vars(e))) for e in seen]
    series = set()
    for line in metrics.splitlines():
        if line and not line.startswith("#"):
            name, _, _ = line.rpartition(" ")
            series.add(name)
    return replies, trail, series, set(health)


@pytest.fixture(scope="module")
def parity_models():
    """The reference's classifier fitted on 2,000 noisy, weighted HIGGS-width
    rows (20 iterations), and the port's model of the same booster."""
    from mmlspark_tpu.lightgbm import LightGBMClassifier as JClassifier

    from mmlspark_tpu_torch.lightgbm import LightGBMClassificationModel
    from mmlspark_tpu_torch.lightgbm.convert import booster_from_jax

    X, y, w = _higgs_rows(PARITY_ROWS, 0)
    jm = JClassifier(numIterations=20, weightCol="w", parallelism="serial").fit(
        Table({"features": X, "label": y, "w": w}))
    tm = LightGBMClassificationModel(device="cpu")
    tm.set_booster(booster_from_jax(jm.booster.to_dict()))
    return jm, tm


def test_lightgbm_model_serves_like_the_reference(parity_models):
    jm, tm = parity_models
    t_replies, t_trail, t_series, t_health = _serve_parity("mmlspark_tpu_torch", tm)
    j_replies, j_trail, j_series, j_health = _serve_parity("mmlspark_tpu", jm)
    assert [s for s, _ in t_replies] == [s for s, _ in j_replies]
    statuses = {s for s, _ in t_replies}
    assert {200, 400, 429} <= statuses, statuses
    for (status, t), (_, j) in zip(t_replies, j_replies):
        if status == 200:
            np.testing.assert_allclose(t["probability"], j["probability"], rtol=0, atol=1e-6)
        else:
            assert t["error"]["kind"] == j["error"]["kind"]
    assert t_trail == j_trail
    kinds = {name for name, _ in t_trail}
    assert {"RequestServed", "BatchFormed", "PoisonClientBlocked",
            "PoisonClientReleased", "RequestShed"} <= kinds, kinds
    assert t_series == j_series
    assert t_health == j_health


def test_serving_modules_import_neither_jax_nor_the_jax_package():
    code = (
        "import sys\n"
        "import mmlspark_tpu_torch.serving, mmlspark_tpu_torch.resilience\n"
        "import mmlspark_tpu_torch.io.http, mmlspark_tpu_torch.dataguard\n"
        "import mmlspark_tpu_torch.observability.federation\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'mmlspark_tpu')]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


# -- the card -------------------------------------------------------------------


@pytest.mark.cuda
def test_lightgbm_model_served_on_the_card_equals_transform():
    """A port model fitted on the card answers through ServingServer with
    transform's probabilities within 1e-6, and stays on the card."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from mmlspark_tpu_torch.device import resolve_device

    X, y, w = _higgs_rows(20_000, 3)
    model = LightGBMClassifier(numIterations=20, weightCol="w").fit(
        Table({"features": X, "label": y, "w": w}))
    assert resolve_device(model.getDevice()).type == "cuda"
    rows = _higgs_rows(64, 4)[0]
    want = np.asarray(model.transform(Table({"features": rows})).column("probability"))
    with ServingServer(model, input_col="features", output_col="probability") as srv:
        with ThreadPoolExecutor(max_workers=8) as pool:
            got = list(pool.map(lambda r: _post(srv.info.url, {"features": list(map(float, r))}),
                                rows))
    assert all(s == 200 for s, _ in got)
    np.testing.assert_allclose(np.array([o["probability"] for _, o in got]), want,
                               rtol=0, atol=1e-6)
    assert resolve_device(srv.model.getDevice()).type == "cuda"
