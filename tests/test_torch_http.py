"""The port's io/http (mmlspark_tpu_torch.io.http): the cases of
tests/test_http.py against the port (real in-process servers and real
clients), the schema, the clients' retry, breaker and ``http_storm`` paths,
``PortForwarder``, and parity with the JAX package's clients and schema on
the same mock service and seeded fault plan."""

import http.client
import json
import socket
import threading
import time
import urllib.request

import numpy as np
import pytest

from http_mock import MockService
from mmlspark_tpu_torch.data.table import Table
from mmlspark_tpu_torch.io.http import (
    AsyncHTTPClient,
    EntityData,
    HeaderData,
    HTTPClient,
    HTTPRequestData,
    HTTPResponseData,
    HTTPTransformer,
    JSONInputParser,
    JSONOutputParser,
    PartitionConsolidator,
    PortForwarder,
    SimpleHTTPTransformer,
    StatusLineData,
    StringOutputParser,
)
from mmlspark_tpu_torch.io.http.clients import ConnectionPool, _do_request
from mmlspark_tpu_torch.observability.registry import MetricsRegistry
from mmlspark_tpu_torch.resilience import BreakerRegistry, RetryPolicy
from mmlspark_tpu_torch.runtime.faults import FaultPlan, inject_faults


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


class TestClients:
    def test_roundtrip(self):
        with MockService() as svc:
            resp = HTTPClient().send(
                HTTPRequestData.from_json(svc.url, {"x": 1})
            )
            assert resp.status_code == 200
            assert resp.json() == {"echo": {"x": 1}}

    def test_retry_on_429_with_retry_after(self):
        calls = {"n": 0}

        def behavior(path, body):
            calls["n"] += 1
            if calls["n"] == 1:
                return 429, {"error": "throttled"}, {"Retry-After": "0.05"}
            return 200, {"ok": True}, {}

        with MockService(behavior) as svc:
            resp = HTTPClient(retries=(0.01,)).send(
                HTTPRequestData.from_json(svc.url, {})
            )
            assert resp.status_code == 200 and calls["n"] == 2

    def test_gives_up_after_retries(self):
        with MockService(lambda p, b: (503, {}, {})) as svc:
            resp = HTTPClient(retries=(0.01, 0.01)).send(
                HTTPRequestData.from_json(svc.url, {})
            )
            assert resp.status_code == 503

    def test_async_order_and_nulls(self):
        with MockService(lambda p, b: (200, {"v": b["i"]}, {})) as svc:
            reqs = [
                None if i % 3 == 0 else HTTPRequestData.from_json(svc.url, {"i": i})
                for i in range(10)
            ]
            out = AsyncHTTPClient(concurrency=4).send_all(reqs)
            for i, r in enumerate(out):
                if i % 3 == 0:
                    assert r is None
                else:
                    assert r.json() == {"v": i}


class TestTransformers:
    def test_http_transformer(self):
        with MockService() as svc:
            t = Table({"req": np.array(
                [HTTPRequestData.from_json(svc.url, {"i": i}) for i in range(5)],
                dtype=object,
            )})
            out = HTTPTransformer(inputCol="req", outputCol="resp").transform(t)
            assert all(r.status_code == 200 for r in out["resp"])

    def test_simple_http_transformer(self):
        with MockService(lambda p, b: (200, {"sentiment": "pos"}, {})) as svc:
            t = Table({"text": np.array(["a", "b"], dtype=object)})
            out = SimpleHTTPTransformer(
                inputCol="text",
                outputCol="parsed",
                inputParser=JSONInputParser(url=svc.url),
                outputParser=JSONOutputParser(),
            ).transform(t)
            assert out["parsed"][0] == {"sentiment": "pos"}
            assert out["parsed_error"][0] is None

    def test_simple_http_error_column(self):
        def behavior(path, body):
            if body == "bad":
                return 400, {"error": "nope"}, {}
            return 200, {"ok": True}, {}

        with MockService(behavior) as svc:
            t = Table({"text": np.array(["good", "bad"], dtype=object)})
            out = SimpleHTTPTransformer(
                inputCol="text",
                outputCol="parsed",
                inputParser=JSONInputParser(url=svc.url),
                outputParser=JSONOutputParser(),
            ).transform(t)
            assert out["parsed"][0] == {"ok": True}
            assert out["parsed"][1] is None
            assert "400" in out["parsed_error"][1]

    def test_string_output_parser(self):
        with MockService(lambda p, b: (200, {"x": 1}, {})) as svc:
            t = Table({"text": np.array(["q"], dtype=object)})
            out = SimpleHTTPTransformer(
                inputCol="text",
                outputCol="raw",
                inputParser=JSONInputParser(url=svc.url),
                outputParser=StringOutputParser(),
            ).transform(t)
            assert out["raw"][0] == '{"x": 1}'

    def test_partition_consolidator_shares_client(self):
        with MockService() as svc:
            reqs = np.array(
                [HTTPRequestData.from_json(svc.url, {"i": i}) for i in range(4)],
                dtype=object,
            )
            t = Table({"req": reqs})
            c = PartitionConsolidator(inputCol="req", outputCol="resp", concurrency=2)
            out1 = c.transform(t)
            out2 = c.transform(t)
            assert all(r.status_code == 200 for r in out1["resp"])
            assert all(r.status_code == 200 for r in out2["resp"])


class TestSchema:
    def test_request_from_json_and_header_map(self):
        req = HTTPRequestData.from_json("http://h/x", {"a": 1}, headers={"X-A": "1"})
        assert req.method == "POST"
        assert json.loads(req.entity.content) == {"a": 1}
        assert req.header_map()["Content-Type"] == "application/json"
        assert req.header_map()["X-A"] == "1"

    def test_response_accessors(self):
        resp = HTTPResponseData(
            statusLine=StatusLineData("HTTP/1.1", 201, "Created"),
            headers=[HeaderData("Retry-After", "2")],
            entity=EntityData(content=b'{"ok": true}'),
        )
        assert resp.status_code == 201
        assert resp.header_map() == {"Retry-After": "2"}
        assert resp.json() == {"ok": True} and resp.text() == '{"ok": true}'


class TestClientResilience:
    def test_http_storm_answers_without_the_wire(self):
        with MockService() as svc:
            plan = FaultPlan(seed=0).http_storm(count=2, status=503, url_part=svc.url)
            with inject_faults(plan):
                client = HTTPClient(retries=(), breakers=BreakerRegistry(
                    failure_threshold=10, registry=MetricsRegistry()))
                codes = [client.send(HTTPRequestData.from_json(svc.url, {})).status_code
                         for _ in range(3)]
            assert codes == [503, 503, 200]
            assert len(svc.requests) == 1
            assert [f[0] for f in plan.fired] == ["http_status", "http_status"]

    def test_storm_retried_through_the_policy(self):
        with MockService() as svc:
            plan = FaultPlan(seed=0).http_storm(count=2, status=503)
            with inject_faults(plan):
                resp = HTTPClient(policy=RetryPolicy(delays=(0.0, 0.0, 0.0))).send(
                    HTTPRequestData.from_json(svc.url, {}))
            assert resp.status_code == 200 and len(svc.requests) == 1


class TestPortForwarding:
    def test_relay_round_trip(self):
        with MockService(lambda p, b: (200, {"via": "forwarder"}, {})) as svc:
            host, port = svc.url.replace("http://", "").rstrip("/").split(":")
            with PortForwarder(host, int(port)) as fwd:
                req = urllib.request.Request(
                    fwd.url, data=b"{}", method="POST",
                    headers={"Content-Type": "application/json"},
                )
                with urllib.request.urlopen(req, timeout=5) as r:
                    assert json.loads(r.read()) == {"via": "forwarder"}


class _RawServer:
    """A keep-alive HTTP server on raw sockets that counts the requests it
    reads, per connection. ``actions[i]`` says what it does with the i-th
    request it reads (default ``reply``): ``reply`` answers and keeps the
    connection; ``reply_close`` answers, then closes it; ``hangup`` closes
    it with no reply; ``stall`` holds it unanswered until the server
    stops."""

    def __init__(self, actions=()):
        self.actions = dict(enumerate(actions))
        self.requests = []  # (connection index, path)
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._sock = socket.create_server(("127.0.0.1", 0))
        self._sock.settimeout(0.05)
        self.url = f"http://127.0.0.1:{self._sock.getsockname()[1]}/score"
        self._threads = [threading.Thread(target=self._accept, daemon=True)]
        self._connections = 0

    def __enter__(self):
        self._threads[0].start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        for t in list(self._threads):
            t.join(timeout=5.0)
        self._sock.close()

    def _accept(self):
        while not self._stop.is_set():
            try:
                conn, _ = self._sock.accept()
            except socket.timeout:
                continue
            t = threading.Thread(target=self._serve, args=(conn, self._connections),
                                 daemon=True)
            self._connections += 1
            self._threads.append(t)
            t.start()

    def _serve(self, conn, index):
        reader = conn.makefile("rb")
        try:
            while True:
                line = reader.readline()
                if not line:
                    return
                path = line.split()[1].decode()
                length = 0
                while True:
                    header = reader.readline()
                    if header in (b"\r\n", b""):
                        break
                    name, _, value = header.decode().partition(":")
                    if name.strip().lower() == "content-length":
                        length = int(value)
                reader.read(length)
                with self._lock:
                    action = self.actions.get(len(self.requests), "reply")
                    self.requests.append((index, path))
                if action == "hangup":
                    return
                if action == "stall":
                    self._stop.wait()
                    return
                body = b'{"ok": true}'
                conn.sendall(b"HTTP/1.1 200 OK\r\nContent-Type: application/json\r\n"
                             b"Content-Length: %d\r\n\r\n%s" % (len(body), body))
                if action == "reply_close":
                    return
        finally:
            reader.close()
            conn.close()


class TestConnectionPool:
    """The keep-alive pool the fleet router's hops go through: it reuses a
    connection, sends a request once more only where the server closed the
    connection before reading it, and never waits past its timeout."""

    def _post(self, pool, url, timeout=5.0):
        return pool.request(url, "POST", b"{}", {"Content-Type": "application/json"}, timeout)

    def test_reuses_one_connection(self):
        with _RawServer() as srv:
            pool = ConnectionPool()
            try:
                for _ in range(3):
                    status, _, _, body = self._post(pool, srv.url)
                    assert status == 200 and json.loads(body) == {"ok": True}
            finally:
                pool.close()
            assert srv.requests == [(0, "/score")] * 3

    def test_a_connection_closed_while_idle_is_not_reused(self):
        with _RawServer(["reply_close"]) as srv:
            pool = ConnectionPool()
            try:
                assert self._post(pool, srv.url)[0] == 200
                time.sleep(0.1)  # the server's close reaches the idle connection
                assert self._post(pool, srv.url)[0] == 200
            finally:
                pool.close()
            # the closed connection was dropped when taken: nothing resent
            assert srv.requests == [(0, "/score"), (1, "/score")]

    def test_a_hangup_with_no_reply_is_resent_once(self):
        with _RawServer(["reply", "hangup"]) as srv:
            pool = ConnectionPool()
            try:
                assert self._post(pool, srv.url)[0] == 200
                status, _, _, body = self._post(pool, srv.url)
            finally:
                pool.close()
            assert status == 200 and json.loads(body) == {"ok": True}
            assert srv.requests == [(0, "/score"), (0, "/score"), (1, "/score")]

    def test_a_hangup_on_a_fresh_connection_is_not_resent(self):
        with _RawServer(["hangup"]) as srv:
            pool = ConnectionPool()
            try:
                with pytest.raises(http.client.RemoteDisconnected):
                    self._post(pool, srv.url)
            finally:
                pool.close()
            assert srv.requests == [(0, "/score")]

    def test_a_stalled_server_gets_one_post_and_the_timeout(self):
        timeout = 0.5
        with _RawServer(["reply", "stall"]) as srv:
            pool = ConnectionPool()
            try:
                assert self._post(pool, srv.url)[0] == 200
                t0 = time.monotonic()
                with pytest.raises(socket.timeout):
                    self._post(pool, srv.url, timeout=timeout)
                waited = time.monotonic() - t0
            finally:
                pool.close()
            assert srv.requests == [(0, "/score"), (0, "/score")]
            assert timeout <= waited < timeout + 0.3

    def test_do_request_through_the_pool_matches_urllib(self):
        with MockService(lambda p, b: (200, {"echo": b}, {})) as svc:
            req = HTTPRequestData.from_json(svc.url, {"x": 1})
            pool = ConnectionPool()
            try:
                pooled = _do_request(req, 5.0, pool=pool)
            finally:
                pool.close()
            plain = _do_request(req, 5.0)
        assert pooled.status_code == plain.status_code == 200
        assert pooled.json() == plain.json() == {"echo": {"x": 1}}
        assert pooled.entity.contentType == plain.entity.contentType


class TestParityWithTheReference:
    """Same mock service and seeded fault plan through both packages'
    clients: the same statuses, bodies, fired faults and wire requests."""

    @staticmethod
    def _drive(http, faults):
        def behavior(path, body):
            if body and body.get("i") == 3:
                return 400, {"error": "bad"}, {}
            return 200, {"v": (body or {}).get("i")}, {}

        with MockService(behavior) as svc:
            plan = (faults.FaultPlan(seed=5).http_storm(count=2, status=503, url_part="/s")
                    .http_reset(count=1, url_part="/r"))
            out = []
            with faults.inject_faults(plan):
                client = http.HTTPClient(retries=())
                for i, path in enumerate(["/s", "/s", "/s", "/x", "/x"]):
                    r = client.send(http.HTTPRequestData.from_json(svc.url + path, {"i": i}))
                    out.append((r.status_code, r.entity.content if r.entity else None))
                with pytest.raises(ConnectionResetError):
                    client.send(http.HTTPRequestData.from_json(svc.url + "/r", {}))
                async_out = http.AsyncHTTPClient(concurrency=3, retries=()).send_all(
                    [http.HTTPRequestData.from_json(svc.url + "/a", {"i": i}) for i in range(6)])
            paths = sorted(r["path"] for r in svc.requests)
        return (out, [(r.status_code, r.json()) for r in async_out], plan.fired, paths)

    def test_clients_match_the_reference(self):
        import mmlspark_tpu.io.http as jhttp
        import mmlspark_tpu.runtime.faults as jfaults

        import mmlspark_tpu_torch.io.http as thttp
        import mmlspark_tpu_torch.runtime.faults as tfaults

        assert self._drive(thttp, tfaults) == self._drive(jhttp, jfaults)
