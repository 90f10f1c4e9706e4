"""HTTP client stack: pooled sync client + bounded-concurrency async client
with status-aware retry/backoff behind the shared resilience layer.

Reference: ``io/http/Clients.scala`` (``BaseClient``/``AsyncClient`` with
bounded-concurrency futures, ``:63``), ``io/http/HTTPClients.scala``
(``HTTPClient`` pooled connections ``:26-62``; ``HandlingUtils.advanced``
retry handler honoring ``Retry-After``, ``:64-151``).

The retry loop itself now lives in
:class:`~mmlspark_tpu_torch.resilience.policy.RetryPolicy` (one loop for the
whole codebase); this module adds the wire specifics the policy can't
know:

- a **per-host circuit breaker** consulted before every attempt — under a
  down dependency the attempts stop locally (:class:`BreakerOpenError`)
  instead of storming it, and half-open probes re-detect recovery;
- **deadline propagation**: the ambient
  :class:`~mmlspark_tpu_torch.resilience.budget.Deadline` caps the socket
  timeout and rides outbound as ``X-Deadline-Ms``, so a downstream hop
  knows how much budget the caller has left;
- ``Retry-After`` honored on 503 as well as 429, including HTTP-date
  values, and retry exhaustion on a retryable status returns the last
  response **with a warning log** (the old silent ``return last``
  fall-through hid every terminal 5xx);
- seeded **HTTP fault injection** (``FaultPlan.http_storm`` et al.) is
  enacted here, before the socket, so chaos tests run with no server.

urllib-based (stdlib), a new connection per request; a caller that hits
the same hosts many times a second (the fleet router's hops) passes a
:class:`ConnectionPool` to reuse keep-alive connections instead. The
concurrency lever is the thread pool, mirroring the reference's future
pool per partition.
"""

from __future__ import annotations

import http.client
import logging
import select
import socket
import threading
import time
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterable, List, Optional, Sequence, Tuple
from urllib.parse import urlsplit

from mmlspark_tpu_torch.io.http.schema import (
    EntityData,
    HeaderData,
    HTTPRequestData,
    HTTPResponseData,
    StatusLineData,
)
from mmlspark_tpu_torch.resilience.breaker import (
    BreakerOpenError,
    BreakerRegistry,
    shared_breakers,
)
from mmlspark_tpu_torch.resilience.budget import (
    DEADLINE_HEADER,
    DeadlineExceededError,
    RetryBudget,
    current_deadline,
)
from mmlspark_tpu_torch.resilience.policy import RETRY_STATUSES, RetryPolicy

logger = logging.getLogger("mmlspark_tpu_torch.io.http")

#: statuses a breaker counts as dependency failure — 429 is the dependency
#: *protecting itself* (it is up), so throttles never trip a breaker
BREAKER_FAILURE_STATUSES = (408, 500, 502, 503, 504)


def _injected_fault(url: str):
    """Enact any ambient HTTP fault directive for this request. Returns a
    synthetic response (storm), None (no fault / after a delay), or raises
    (reset)."""
    from mmlspark_tpu_torch.runtime.faults import current_faults

    plan = current_faults()
    if plan is None:
        return None
    directive = plan.apply_on_http(url)
    if directive is None:
        return None
    kind = directive["kind"]
    if kind == "reset":
        raise ConnectionResetError(f"injected connection reset for {url}")
    if kind == "delay":
        import time

        time.sleep(directive["seconds"])
        return None
    headers = []
    if directive.get("retry_after") is not None:
        headers.append(HeaderData("Retry-After", str(directive["retry_after"])))
    return HTTPResponseData(
        statusLine=StatusLineData(
            "HTTP/1.1", directive["status"], "injected fault"
        ),
        headers=headers,
        entity=EntityData(content=b'{"error": "injected fault"}'),
    )


class ConnectionPool:
    """Idle keep-alive connections per (host, port), shared by threads: a
    request takes one (or opens one), and gives it back unless the server
    said it closes. An idle connection the server has closed is dropped
    when taken. A reused connection that still turns out closed before
    the server read the request (it fails while sending, or the server
    hangs up with no status line) is dropped, and the request sent once
    more on a fresh connection in the time left of ``timeout``. Any other
    failure, a timeout above all, is the caller's: the server may have
    the request, and a second send would double both it and the wait."""

    _CLOSED_ON_SEND = (BrokenPipeError, ConnectionResetError, ConnectionAbortedError)

    def __init__(self, max_idle_per_host: int = 64):
        self.max_idle_per_host = int(max_idle_per_host)
        self._idle: Dict[Tuple[str, int], List[http.client.HTTPConnection]] = {}
        self._lock = threading.Lock()

    def request(self, url: str, method: str, body: Optional[bytes],
                headers: Dict[str, str], timeout: float) -> Tuple[int, str, list, bytes]:
        """(status, reason, header pairs, body) of one request to ``url``,
        waiting no longer than ``timeout`` seconds in all."""
        parts = urlsplit(url)
        key = (parts.hostname, parts.port or 80)
        path = parts.path or "/"
        if parts.query:
            path += "?" + parts.query
        deadline = time.monotonic() + timeout
        conn = self._take(key)
        if conn is not None:
            out = self._exchange(key, conn, method, path, body, headers, timeout, reused=True)
            if out is not None:
                return out
            timeout = deadline - time.monotonic()
            if timeout <= 0:
                raise socket.timeout(f"no time left to resend to {url}")
        conn = http.client.HTTPConnection(key[0], key[1], timeout=timeout)
        return self._exchange(key, conn, method, path, body, headers, timeout, reused=False)

    def _exchange(self, key, conn, method, path, body, headers, timeout, reused):
        """One request on ``conn``; None where ``reused`` and the server
        had closed the connection before it read the request."""
        conn.timeout = timeout
        if conn.sock is not None:
            conn.sock.settimeout(timeout)
        sent = False
        try:
            conn.request(method, path, body=body, headers=headers)
            sent = True
            resp = conn.getresponse()
            data = resp.read()
        except (OSError, http.client.HTTPException) as e:
            conn.close()
            if reused and (isinstance(e, http.client.RemoteDisconnected) or (
                    not sent and isinstance(e, self._CLOSED_ON_SEND))):
                return None
            raise
        if resp.will_close:
            conn.close()
        else:
            self._give(key, conn)
        return resp.status, resp.reason, resp.getheaders(), data

    def _take(self, key) -> Optional[http.client.HTTPConnection]:
        while True:
            with self._lock:
                idle = self._idle.get(key)
                conn = idle.pop() if idle else None
            if conn is None:
                return None
            # an idle connection has nothing to read unless its server
            # closed it (end of file) or reset it
            if not select.select([conn.sock], [], [], 0)[0]:
                return conn
            conn.close()

    def _give(self, key, conn: http.client.HTTPConnection) -> None:
        with self._lock:
            idle = self._idle.setdefault(key, [])
            if len(idle) < self.max_idle_per_host:
                idle.append(conn)
                return
        conn.close()

    def close(self) -> None:
        with self._lock:
            idle, self._idle = self._idle, {}
        for conns in idle.values():
            for conn in conns:
                conn.close()


def _do_request(
    request: HTTPRequestData,
    timeout: float,
    extra_headers: Optional[Dict[str, str]] = None,
    pool: Optional[ConnectionPool] = None,
) -> HTTPResponseData:
    fault = _injected_fault(request.url)
    if fault is not None:
        return fault
    # net chaos sits BELOW the storm layer: storms answer without a
    # socket, net directives degrade the socket itself (unreachable,
    # stalled, timed out) or garble the bytes that come back
    from mmlspark_tpu_torch.runtime.faults import check_net

    net = check_net(request.url)
    headers = request.header_map()
    if extra_headers:
        headers.update(extra_headers)
    content = request.entity.content if request.entity else None
    if pool is not None:
        status, reason, pairs, body = pool.request(
            request.url, request.method, content, headers, timeout)
    else:
        req = urllib.request.Request(
            request.url, data=content, headers=headers, method=request.method)
        try:
            with urllib.request.urlopen(req, timeout=timeout) as resp:
                status, reason = resp.status, resp.reason
                pairs, body = list(resp.headers.items()), resp.read()
        except urllib.error.HTTPError as e:
            status, reason = e.code, str(e.reason)
            pairs = list((e.headers or {}).items())
            body = e.read() if hasattr(e, "read") else b""
    # an error status (urllib's HTTPError) keeps its body as sent and no
    # content type
    ok = status < 400
    if ok and net is not None and net.get("kind") == "corrupt":
        from mmlspark_tpu_torch.runtime.netchaos import corrupt_bytes

        body = corrupt_bytes(body)
    content_type = next((v for k, v in pairs if k.lower() == "content-type"), None)
    return HTTPResponseData(
        statusLine=StatusLineData("HTTP/1.1", status, reason or ""),
        headers=[HeaderData(k, v) for k, v in pairs],
        entity=EntityData(content=body, contentType=content_type if ok else None),
    )


class HTTPClient:
    """Synchronous client with ``HandlingUtils.advanced`` retry semantics
    behind the resilience layer: per-host breaker, retry budget, ambient
    deadline, ``Retry-After`` on 429/503 (delta-seconds or HTTP-date).

    ``retries`` keeps the legacy fixed-wait schedule; pass ``policy`` for
    seeded full-jitter backoff. ``breakers=None`` disables the breaker
    (unit tests of pure retry behavior); the default is the process-shared
    per-host registry."""

    def __init__(
        self,
        retries: Sequence[float] = (0.1, 0.5, 1.0),
        timeout: float = 60.0,
        policy: Optional[RetryPolicy] = None,
        budget: Optional[RetryBudget] = None,
        breakers: Optional[BreakerRegistry] = "shared",  # type: ignore[assignment]
    ):
        self.timeout = timeout
        self.policy = policy or RetryPolicy.from_legacy_waits(
            retries, retry_statuses=RETRY_STATUSES
        )
        if budget is not None:
            self.policy.budget = budget
        self.breakers: Optional[BreakerRegistry] = (
            shared_breakers() if breakers == "shared" else breakers
        )

    def send(self, request: HTTPRequestData) -> HTTPResponseData:
        policy = self.policy
        if policy.budget is not None:
            policy.budget.record_request()
        breaker = (
            self.breakers.for_url(request.url)
            if self.breakers is not None else None
        )
        last: Optional[HTTPResponseData] = None
        last_exc: Optional[Exception] = None
        attempt = 0
        while True:
            dl = current_deadline()
            if dl is not None and dl.expired:
                raise DeadlineExceededError(
                    f"deadline expired before attempt {attempt + 1} to "
                    f"{request.url}"
                )
            if breaker is not None and not breaker.allow():
                raise BreakerOpenError(
                    breaker.name, retry_after=breaker.retry_after()
                )
            extra = None
            timeout = self.timeout
            if dl is not None:
                # forward the remaining budget; cap the socket wait to it
                extra = {DEADLINE_HEADER: dl.to_header()}
                timeout = max(1e-3, min(self.timeout, dl.remaining()))
            resp: Optional[HTTPResponseData] = None
            try:
                resp = _do_request(request, timeout, extra_headers=extra)
            except Exception as e:  # transport error (conn refused/reset/timeout)
                last_exc = e
                logger.debug(
                    "transport error on %s (%s: %s)",
                    request.url, type(e).__name__, e,
                )
                if breaker is not None:
                    breaker.record_failure()
            else:
                last_exc = None
                if breaker is not None:
                    if resp.status_code in BREAKER_FAILURE_STATUSES:
                        breaker.record_failure()
                    else:
                        breaker.record_success()
                if not policy.retryable(resp.status_code):
                    return resp
                last = resp
            if not policy.allow_retry(attempt):
                break
            wait = policy.next_wait(
                attempt,
                status=resp.status_code if resp is not None else None,
                headers=resp.header_map() if resp is not None else None,
            )
            policy.sleep(wait)
            attempt += 1
        if last_exc is not None:
            raise last_exc
        assert last is not None
        # terminal retryable status: return it LOUDLY (the old code fell
        # through to a silent `return last`)
        logger.warning(
            "giving up on %s %s after %d attempts: terminal HTTP %d",
            request.method, request.url, attempt + 1, last.status_code,
        )
        return last


class AsyncHTTPClient:
    """Bounded-concurrency batch sender (``AsyncClient``,
    ``io/http/Clients.scala:63``): N in-flight requests, results in input
    order. ``None`` requests pass through as ``None`` (null rows). A call
    rejected by an open breaker degrades to a synthetic local 503 carrying
    ``Retry-After`` — error-column semantics, not a crashed batch."""

    def __init__(self, concurrency: int = 8,
                 retries: Sequence[float] = (0.1, 0.5, 1.0),
                 timeout: float = 60.0,
                 policy: Optional[RetryPolicy] = None,
                 budget: Optional[RetryBudget] = None,
                 breakers: Optional[BreakerRegistry] = "shared"):  # type: ignore[assignment]
        if concurrency < 1:
            raise ValueError("concurrency must be >= 1")
        self.concurrency = concurrency
        self._client = HTTPClient(
            retries=retries, timeout=timeout, policy=policy, budget=budget,
            breakers=breakers,
        )

    def _send_one(
        self, request: Optional[HTTPRequestData]
    ) -> Optional[HTTPResponseData]:
        if request is None:
            return None
        try:
            return self._client.send(request)
        except BreakerOpenError as e:
            return HTTPResponseData(
                statusLine=StatusLineData("HTTP/1.1", 503, "breaker open"),
                headers=[HeaderData("Retry-After", f"{e.retry_after:.3f}")],
                entity=EntityData(content=(
                    b'{"error": "circuit breaker open"}'
                )),
            )

    def send_all(
        self, requests: Iterable[Optional[HTTPRequestData]]
    ) -> List[Optional[HTTPResponseData]]:
        requests = list(requests)
        if not requests:
            return []
        with ThreadPoolExecutor(max_workers=self.concurrency) as pool:
            return list(pool.map(self._send_one, requests))
