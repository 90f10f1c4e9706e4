"""Front-end fleet router: one address for a fleet of serving replicas.

The reference's Spark Serving deployment puts a load balancer in front of
the per-worker HTTP servers it registers with the driver
(``HTTPSourceV2.scala:318-410`` ServiceInfo + ``DriverServiceUtils``);
:class:`FleetRouter` is that front end, built only on the public control
plane — it discovers live replicas from RegistrationService ``GET
/services`` and steers by the load metadata replicas heartbeat into their
leases (``inflight``/``shed_total``/``p99_ms``). No private handle into
any replica process exists: a replica that dies simply vanishes from
``/services`` at the next lease prune, and until then costs one failed
hop per request, never a user-visible error.

Per request the router:

- picks a replica by ``policy`` — ``"least_loaded"`` (ascending heartbeat
  ``inflight``, round-robin rotation breaking ties) or
  ``"consistent_hash"`` (a crc32 vnode ring over the ``X-Routing-Key``
  header or the request body, so one key sticks to one replica while the
  fleet resizes with minimal reshuffling);
- forwards the body with the *remaining* deadline re-computed into
  ``X-Deadline-Ms`` and the hop's socket timeout capped to it;
- on a transport error or retryable status, records the failure on that
  replica's :class:`~mmlspark_tpu_torch.resilience.breaker.CircuitBreaker` and
  retries on a *different* replica under the shared
  :class:`~mmlspark_tpu_torch.resilience.policy.RetryPolicy` — attempts bounded,
  sleeps jittered and clipped to the deadline, retries rationed by the
  :class:`~mmlspark_tpu_torch.resilience.budget.RetryBudget`;
- passes a replica's 429 shed through (with its ``Retry-After``) once
  retries are exhausted — a shed is the fleet protecting itself, not an
  error — and answers 503 only when every live replica was tried or
  breaker-skipped.

Hops go through :func:`mmlspark_tpu_torch.io.http.clients._do_request`, so the
ambient :class:`~mmlspark_tpu_torch.runtime.faults.FaultPlan` HTTP directives
(``http_storm``/``http_delay``/``http_reset``) inject at the router->replica
edge exactly as they do for any outbound client — the chaos campaign
trips real breakers with no cooperating server. Unlike the reference's
router, the port's keeps its hops' connections alive
(:class:`~mmlspark_tpu_torch.io.http.clients.ConnectionPool`).
"""

from __future__ import annotations

import json
import threading
import time
import urllib.request
import uuid
import zlib
from contextlib import nullcontext
from http.server import BaseHTTPRequestHandler
from typing import Any, Dict, List, Optional, Tuple

from mmlspark_tpu_torch.core.profiling import get_logger
from mmlspark_tpu_torch.io.http.clients import (
    BREAKER_FAILURE_STATUSES,
    ConnectionPool,
    _do_request,
)
from mmlspark_tpu_torch.io.http.schema import EntityData, HTTPRequestData
from mmlspark_tpu_torch.observability.events import (
    RegistryRecovered,
    RegistryUnavailable,
    RequestRouted,
    get_bus,
)
from mmlspark_tpu_torch.observability.registry import get_registry
from mmlspark_tpu_torch.observability.tracing import (
    TRACE_HEADER,
    Span,
    TraceContext,
    get_tracer,
)
from mmlspark_tpu_torch.resilience.breaker import BreakerRegistry
from mmlspark_tpu_torch.resilience.budget import (
    DEADLINE_HEADER,
    Deadline,
    RetryBudget,
    deadline_scope,
)
from mmlspark_tpu_torch.resilience.policy import RetryPolicy
from mmlspark_tpu_torch.serving.server import RegistrationService, ServiceInfo, _Server

logger = get_logger("mmlspark_tpu_torch.serving.router")

#: routing policies
LEAST_LOADED = "least_loaded"
CONSISTENT_HASH = "consistent_hash"

#: header carrying the affinity key for consistent-hash routing
ROUTING_KEY_HEADER = "X-Routing-Key"

#: vnodes per replica on the hash ring — enough that adding/removing one
#: replica moves ~1/N of the key space, small enough to rebuild per request
_VNODES = 64

_SERVICE_FIELDS = ("name", "host", "port", "model_version", "inflight",
                   "shed_total", "p99_ms")

#: a synthetic-502 hop that failed faster than this did no work anywhere
#: (connection refused/reset on a dead port — a socket timeout takes the
#: full hop timeout), so failing over is free and skips the retry budget
_FAST_FAIL_S = 0.1

#: fraction of the remaining deadline one hop may wait while other
#: replicas remain untried — a stalled replica costs a capped slice of
#: the budget, and the saved remainder pays for the failover hop
_HEDGE_FRACTION = 0.5


def _parse_services(raw: List[Dict[str, Any]]) -> List[ServiceInfo]:
    """``GET /services`` JSON -> ServiceInfo list, tolerant of extra keys
    (an older router must survive a newer registry's metadata)."""
    out = []
    for rec in raw:
        try:
            out.append(ServiceInfo(
                **{k: rec[k] for k in _SERVICE_FIELDS if k in rec}
            ))
        except (KeyError, TypeError):
            continue
    return out


class FleetRouter:
    """Deadline-aware, breaker-guarded HTTP front end over a replica fleet.

    Discovery is either in-process (``registry=`` a
    :class:`RegistrationService`) or over the wire (``registry_url=`` its
    base URL); a background thread re-reads ``/services`` every
    ``discovery_interval_s`` so retired/expired replicas drop out of
    rotation within one interval.
    """

    def __init__(
        self,
        registry: Optional[RegistrationService] = None,
        registry_url: Optional[str] = None,
        host: str = "127.0.0.1",
        port: int = 0,
        policy: str = LEAST_LOADED,
        retry_policy: Optional[RetryPolicy] = None,
        retry_budget: Optional[RetryBudget] = None,
        breakers: Optional[BreakerRegistry] = None,
        discovery_interval_s: float = 0.25,
        hop_timeout_s: float = 5.0,
        default_deadline_s: Optional[float] = None,
        name: str = "router",
    ):
        if registry is None and registry_url is None:
            raise ValueError("need registry= or registry_url=")
        if policy not in (LEAST_LOADED, CONSISTENT_HASH):
            raise ValueError(f"unknown routing policy {policy!r}")
        self._registry = registry
        self._registry_url = registry_url.rstrip("/") if registry_url else None
        self.policy = policy
        self.name = name
        self.hop_timeout_s = float(hop_timeout_s)
        self.default_deadline_s = default_deadline_s
        self.discovery_interval_s = float(discovery_interval_s)
        #: retries rationed fleet-wide: each first attempt deposits, each
        #: failover spends — a dead replica can't multiply traffic
        if retry_policy is None:
            retry_budget = retry_budget or RetryBudget(ratio=0.2)
            retry_policy = RetryPolicy(
                max_attempts=3, base=0.02, cap=0.25, seed=0,
                budget=retry_budget,
            )
        self.retry_policy = retry_policy
        #: tighter than the shared client defaults: a serving replica that
        #: fails 3 hops in 5 s is out of rotation for a second
        self.breakers = breakers or BreakerRegistry(
            failure_threshold=3, window_s=5.0, reset_timeout_s=1.0,
        )
        self._replicas: List[ServiceInfo] = []
        #: keep-alive connections to the replicas: a hop on a new
        #: connection costs both processes a connect and a thread
        self._pool = ConnectionPool()
        self._rr = 0  # least-loaded tiebreak rotation (benign races ok)
        self._started_at = time.monotonic()
        self._discover_stop = threading.Event()
        self._discover_thread: Optional[threading.Thread] = None

        reg = get_registry()
        self._m_requests = reg.counter(
            "router_requests_total", "Requests answered by the fleet router"
        )
        self._m_hops = reg.counter(
            "router_hops_total", "Replica attempts made by the router"
        )
        self._m_failovers = reg.counter(
            "router_failovers_total",
            "Requests that needed more than one replica attempt",
        )
        self._m_skipped = reg.counter(
            "router_breaker_skips_total",
            "Replica picks skipped because their breaker was open",
        )
        self._m_no_replica = reg.counter(
            "router_no_replica_total",
            "Requests failed because no live replica could be tried",
        )
        self._m_replicas = reg.gauge(
            "router_replicas", "Live replicas in the routing table"
        )
        self._m_stale = reg.gauge(
            "router_stale_table",
            "1 while the routing table is last-known-good because the "
            "registry is unreachable",
        )
        #: registry-outage latch: set on the first failed discovery so the
        #: RegistryUnavailable event fires once per outage, not per poll
        self._stale = False
        self._m_latency = reg.histogram(
            "router_latency_seconds", "Router end-to-end request latency"
        )
        self._httpd = _Server((host, port), self._make_handler())
        self.info = ServiceInfo(name, host, self._httpd.server_address[1])

    @property
    def url(self) -> str:
        return self.info.url

    # -- discovery -----------------------------------------------------------

    def refresh(self) -> List[ServiceInfo]:
        """Re-read ``/services`` into the routing table (also called by
        the background discovery thread). Returns the new table.

        Registry-outage tolerant: any discovery failure — connection
        refused, timeout, malformed or truncated ``/services`` JSON —
        keeps the last-known-good table and stamps it stale
        (``router_stale_table`` gauge, one
        :class:`~mmlspark_tpu_torch.observability.events.RegistryUnavailable`
        event per outage onset). The discovery thread never crashes; the
        router keeps answering from the stale table until the registry
        comes back."""
        try:
            if self._registry is not None:
                replicas = list(self._registry.services)
            else:
                url = self._registry_url + "/services"
                # net chaos on the discovery edge: partitions/drops raise
                # here (caught below -> stale table), corrupt garbles the
                # body so json.loads fails the same way a truncated read
                # off a dying registry would
                from mmlspark_tpu_torch.runtime.faults import check_net

                net = check_net(url)
                with urllib.request.urlopen(url, timeout=5) as resp:
                    raw = resp.read()
                if net is not None and net.get("kind") == "corrupt":
                    from mmlspark_tpu_torch.runtime.netchaos import corrupt_bytes

                    raw = corrupt_bytes(raw)
                replicas = _parse_services(json.loads(raw))
        except Exception as e:  # noqa: BLE001 - keep the last good table
            # warn once per outage onset; repeat polls log at DEBUG so a
            # long outage doesn't flood the log at discovery frequency
            log = logger.debug if self._stale else logger.warning
            if not self._stale:
                self._stale = True
                self._m_stale.set(1)
                bus = get_bus()
                if bus.active:
                    bus.publish(RegistryUnavailable(
                        source="router",
                        error=f"{type(e).__name__}: {e}",
                        stale_replicas=len(self._replicas),
                    ))
            log(
                "service discovery failed (%s); serving from stale table "
                "of %d replica(s)", e, len(self._replicas),
            )
            return self._replicas
        if self._stale:
            self._stale = False
            self._m_stale.set(0)
            bus = get_bus()
            if bus.active:
                bus.publish(RegistryRecovered(
                    source="router", replicas=len(replicas),
                ))
            logger.info("registry reachable again; routing table is fresh")
        # never route to ourselves (a router registered for visibility)
        replicas = [r for r in replicas if r.name != self.name]
        replicas.sort(key=lambda s: s.name)
        self._replicas = replicas  # atomic swap; readers snapshot
        self._m_replicas.set(len(replicas))
        return replicas

    def _discover_loop(self) -> None:
        while not self._discover_stop.wait(self.discovery_interval_s):
            try:
                self.refresh()
            except Exception:  # noqa: BLE001 - the poll thread must survive
                logger.warning("discovery poll failed", exc_info=True)

    # -- replica choice ------------------------------------------------------

    def _order(self, replicas: List[ServiceInfo],
               routing_key: bytes) -> List[ServiceInfo]:
        """Replica preference order for one request. The first entry is
        the pick; the rest are the failover sequence (always distinct
        replicas — a retry never re-hits the endpoint that just failed)."""
        if self.policy == CONSISTENT_HASH:
            ring: List[Tuple[int, ServiceInfo]] = []
            for svc in replicas:
                for v in range(_VNODES):
                    point = zlib.crc32(f"{svc.name}#{v}".encode())
                    ring.append((point, svc))
            ring.sort(key=lambda p: (p[0], p[1].name))
            key_point = zlib.crc32(routing_key)
            start = 0
            for i, (point, _) in enumerate(ring):
                if point >= key_point:
                    start = i
                    break
            ordered: List[ServiceInfo] = []
            seen = set()
            for i in range(len(ring)):
                svc = ring[(start + i) % len(ring)][1]
                if svc.name not in seen:
                    seen.add(svc.name)
                    ordered.append(svc)
            return ordered
        # least-loaded: ascending heartbeat inflight; rotation breaks ties
        # so equally idle replicas share first picks instead of the
        # alphabetically first one taking every request
        shift = self._rr % len(replicas)
        self._rr += 1
        rotated = replicas[shift:] + replicas[:shift]
        return sorted(rotated, key=lambda s: s.inflight or 0)

    # -- request path --------------------------------------------------------

    def _route(
        self, body: bytes, headers: Dict[str, str],
        span: Optional[Span] = None,
    ) -> Tuple[int, bytes, Dict[str, str], str, int]:
        """One client request through the fleet. Returns
        ``(status, body, extra_headers, final_replica, hops)``.
        ``span`` is the request's root span: each replica attempt opens a
        ``router.hop`` child whose :class:`TraceContext` rides the hop
        headers, so the replica's request->batch->apply spans parent
        under this hop in the merged fleet trace."""
        deadline = Deadline.from_header(headers.get(DEADLINE_HEADER))
        if deadline is None and self.default_deadline_s:
            deadline = Deadline.after(self.default_deadline_s)
        routing_key = (
            headers.get(ROUTING_KEY_HEADER, "").encode() or body
        )
        budget = self.retry_policy.budget
        if budget is not None:
            budget.record_request()

        replicas = self._replicas or self.refresh()
        if not replicas:
            self._m_no_replica.inc()
            return 503, b'{"error": "no live replicas"}', {}, "", 0

        scope = deadline_scope(deadline) if deadline else nullcontext()
        order = self._order(replicas, routing_key)
        tried: set = set()
        hops = 0
        attempt = 0  # retry index for the policy's backoff schedule
        last: Tuple[int, bytes, Dict[str, str], str] = (
            503, b'{"error": "all replicas unavailable"}', {}, "",
        )
        with scope:
            while True:
                candidate = None
                for svc in order:
                    if svc.name in tried:
                        continue
                    if not self.breakers.for_url(svc.url).allow():
                        self._m_skipped.inc()
                        continue
                    candidate = svc
                    break
                if candidate is None:
                    break  # every replica tried or breaker-skipped
                if deadline is not None and deadline.expired:
                    return (
                        504, b'{"error": "deadline exceeded"}', {},
                        last[3], hops,
                    )
                tried.add(candidate.name)
                hops += 1
                self._m_hops.inc()
                # hedge: while other replicas remain untried, one slow
                # hop may not burn the whole remaining deadline — reserve
                # headroom to fail over instead of timing out with
                # nothing left (one stalled replica != a dead request).
                # No breaker peek here: allow() claims half-open probes.
                more = any(s.name not in tried for s in order)
                hop_started = time.monotonic()
                tracer = get_tracer()
                hop_span = (
                    tracer.start_span(
                        "router.hop", parent=span, replica=candidate.name,
                    )
                    if span is not None else None
                )
                status, data, resp_headers = self._hop(
                    candidate, body, headers, deadline, hedge=more,
                    trace=(
                        TraceContext.from_span(hop_span)
                        if hop_span is not None else None
                    ),
                )
                if hop_span is not None:
                    tracer.finish(
                        hop_span,
                        status="ok" if status < 500 else f"http_{status}",
                        http_status=status,
                    )
                last = (status, data, resp_headers, candidate.name)
                if not self.retry_policy.retryable(status):
                    return status, data, resp_headers, candidate.name, hops
                if (
                    status == 502
                    and time.monotonic() - hop_started < _FAST_FAIL_S
                ):
                    # connection-level fast-fail (refused/reset before the
                    # replica did any work — a dead port, not a slow one):
                    # failing over costs the fleet nothing, so it is NOT
                    # rationed by the retry budget, which exists to cap
                    # load amplification on replicas that processed the
                    # attempt. Hops stay bounded by the tried-set and the
                    # deadline; no backoff — the next hop is a different
                    # replica. This is what makes a SIGKILL'd replica one
                    # failed hop instead of a user-visible 502 while its
                    # stale lease rides out the registry TTL.
                    continue
                if not self.retry_policy.allow_retry(attempt):
                    break
                time.sleep(self.retry_policy.next_wait(
                    attempt, status=status, headers=resp_headers,
                ))
                attempt += 1
        status, data, resp_headers, replica = last
        return status, data, resp_headers, replica, hops

    def _hop(
        self,
        svc: ServiceInfo,
        body: bytes,
        headers: Dict[str, str],
        deadline: Optional[Deadline],
        hedge: bool = False,
        trace: Optional[TraceContext] = None,
    ) -> Tuple[int, bytes, Dict[str, str]]:
        """One attempt against one replica, with breaker bookkeeping.
        Transport errors come back as a synthetic 502 so the retry loop
        has one shape to reason about. With ``hedge`` (other replicas
        remain untried) the socket wait is capped to a fraction of the
        remaining deadline so a timeout still leaves room to fail over.
        ``trace`` is the hop span's wire context — the replica adopts it
        so its spans land in the router's trace."""
        breaker = self.breakers.for_url(svc.url)
        timeout = self.hop_timeout_s
        extra: Dict[str, str] = {"Content-Type": "application/json"}
        if trace is not None:
            extra.update(trace.to_headers())
        elif headers.get(TRACE_HEADER):
            extra[TRACE_HEADER] = headers[TRACE_HEADER]
        # the per-client identity must survive the proxy hop: the replica's
        # malformed-rate breaker keys on X-Client-Id, and without it every
        # routed request would collapse onto the router's address — one
        # poison client would shed the whole fleet's healthy traffic
        for k, v in headers.items():
            if k.lower() == "x-client-id":
                extra["X-Client-Id"] = v
                break
        if deadline is not None:
            # forward the REMAINING budget; never wait on the socket
            # longer than the caller will wait for us
            extra[DEADLINE_HEADER] = deadline.to_header()
            budget_s = max(0.001, deadline.remaining())
            if hedge:
                budget_s = max(0.001, budget_s * _HEDGE_FRACTION)
            timeout = min(timeout, budget_s)
        request = HTTPRequestData(
            url=svc.url, method="POST",
            entity=EntityData(content=body, contentType="application/json"),
        )
        try:
            resp = _do_request(request, timeout, extra_headers=extra, pool=self._pool)
        except Exception as e:  # noqa: BLE001 - refused/reset/timeout
            breaker.record_failure()
            logger.debug("hop to %s failed: %s", svc.name, e)
            return 502, json.dumps(
                {"error": f"replica unreachable: {type(e).__name__}"}
            ).encode(), {}
        if resp.status_code in BREAKER_FAILURE_STATUSES:
            breaker.record_failure()
        else:
            # includes 429: a shedding replica is UP and protecting itself
            breaker.record_success()
        keep = {
            k: v for k, v in resp.header_map().items()
            if k.lower() == "retry-after"
        }
        return resp.status_code, (
            resp.entity.content if resp.entity else b""
        ), keep

    # -- HTTP edge -----------------------------------------------------------

    def health(self) -> Dict[str, Any]:
        return {
            "status": "ok",
            "name": self.name,
            "uptime_seconds": round(time.monotonic() - self._started_at, 3),
            "policy": self.policy,
            "replicas": len(self._replicas),
        }

    def _make_handler(self):
        router = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"
            disable_nagle_algorithm = True

            def _reply_bytes(
                self, status: int, data: bytes,
                content_type: str = "application/json",
                extra_headers: Optional[Dict[str, str]] = None,
            ) -> None:
                self.send_response(status)
                self.send_header("Content-Type", content_type)
                self.send_header("Content-Length", str(len(data)))
                for k, v in (extra_headers or {}).items():
                    self.send_header(k, v)
                self.end_headers()
                self.wfile.write(data)

            def do_GET(self):  # noqa: N802 (http.server API)
                if self.path == "/metrics":
                    body = get_registry().exposition().encode("utf-8")
                    self._reply_bytes(
                        200, body,
                        content_type="text/plain; version=0.0.4; charset=utf-8",
                    )
                elif self.path == "/healthz":
                    self._reply_bytes(200, json.dumps(router.health()).encode())
                else:
                    self._reply_bytes(404, b'{"error": "not found"}')

            def do_POST(self):  # noqa: N802 (http.server API)
                t0 = time.monotonic()
                rid = uuid.uuid4().hex
                length = int(self.headers.get("Content-Length", 0))
                body = self.rfile.read(length)
                headers = dict(self.headers.items())
                # root span for the fleet-wide trace; a client-supplied
                # X-Trace-Id is adopted so an upstream hop stays parent
                tracer = get_tracer()
                span = tracer.start_span(
                    "router.request", rid=rid,
                    context=TraceContext.from_headers(self.headers),
                )
                status, data, extra, replica, hops = router._route(
                    body, headers, span=span
                )
                router._m_requests.inc()
                if hops > 1:
                    router._m_failovers.inc()
                latency = time.monotonic() - t0
                router._m_latency.observe(latency)
                # the trace id rides EVERY reply — 429/503/504 included —
                # so a user-quoted incident id joins against the event log
                extra = dict(extra)
                extra[TRACE_HEADER] = span.trace_id
                try:
                    self._reply_bytes(status, data, extra_headers=extra)
                except OSError:
                    pass  # client hung up; the fold still sees the event
                tracer.finish(
                    span,
                    status="ok" if status < 500 else f"http_{status}",
                    http_status=status, hops=hops, replica=replica,
                )
                bus = get_bus()
                if bus.active:
                    bus.publish(RequestRouted(
                        rid=rid, replica=replica, hops=hops,
                        status=status, latency=latency,
                        trace_id=span.trace_id,
                    ))

            def log_message(self, *args):  # silence default stderr logging
                pass

        return Handler

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> "FleetRouter":
        self.refresh()
        threading.Thread(
            target=self._httpd.serve_forever, daemon=True,
            name=f"router-{self.name}",
        ).start()
        self._discover_stop.clear()
        self._discover_thread = threading.Thread(
            target=self._discover_loop, daemon=True,
            name=f"router-discovery-{self.name}",
        )
        self._discover_thread.start()
        return self

    def stop(self) -> None:
        self._discover_stop.set()
        if self._discover_thread is not None:
            self._discover_thread.join(timeout=2.0)
            self._discover_thread = None
        self._httpd.shutdown()
        self._httpd.server_close()
        self._pool.close()

    def __enter__(self) -> "FleetRouter":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()
