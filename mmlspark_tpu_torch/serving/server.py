"""Model serving — embedded HTTP servers answering with inference on the card.

Reference: Spark Serving (SURVEY.md §2.16;
``org/apache/spark/sql/execution/streaming/HTTPSourceV2.scala``): per-worker
HTTP servers with epoch-indexed request queues, reply-by-request-id, driver
registration service, commit-based GC, task-retry re-hydration.

The port's copy of ``mmlspark_tpu/serving/server.py``. The streaming-engine
indirection disappears — a :class:`ServingServer` owns an HTTP listener and
a micro-batching :class:`_BatchLoop` that hands each micro-batch to the
model's ``transform``. The reference pads requests into fixed batch shapes
so that its compiled program never recompiles; the port compiles nothing
(a LightGBM model's ``raw_margin`` is plain torch on its device), so it
pads nothing: each micro-batch goes to the model at its own row count. The
server never moves a model off its device, and a batch that fails on the
card is retried on the card (``max_retries``) and then answered 500, never
on the CPU. The reference machinery maps as:

- epoch-indexed queues + ``getNextRequest`` timeout-driven epoch advance
  (``HTTPSourceV2.scala:588-623``) → the micro-batch gather loop;
- ``replyTo(machineIp, requestId, response)`` (``HTTPSinkV2.scala:81-89``)
  → the rid-keyed reply registry: ANY listener's request can be answered
  by the shared loop (the cross-worker reply the reference left as
  ``NotImplementedError`` at ``HTTPSourceV2.scala:509-533``);
- ``registerPartition`` re-hydration + ``recoveredPartitions``
  (``HTTPSourceV2.scala:470-487``) → failed batches re-enqueue up to
  ``max_retries`` (task retry), and :meth:`_BatchLoop.recover` replays
  every uncommitted epoch after a worker death;
- commit-based GC (``:535-552``) → :meth:`_BatchLoop.commit`;
- the driver registration HTTP service (``DriverServiceUtils:113-173``,
  ``HTTPSourceStateHolder.serviceInfo``) → :class:`RegistrationService`.

Threads: listener threads parse, validate and wait; only the batch loop
(and, under :class:`DistributedServingServer`, the scheduler's executor
threads) calls the model, so only they launch work on the card. The
hot-swap watcher builds the next model off the loop's thread, on the
device its loader names, and swaps it in by one attribute store; a
LightGBM model keeps its booster on the host and uploads its tree tables
with each micro-batch, so the watcher launches nothing on the card.
"""

from __future__ import annotations

import json
import logging
import os
import queue
import random
import threading
import time
import uuid
import zlib
from dataclasses import dataclass, field
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from mmlspark_tpu_torch.core.pipeline import Transformer
from mmlspark_tpu_torch.data.table import Table
from mmlspark_tpu_torch.observability.events import (
    BatchFormed,
    LeaseRecovered,
    ModelSwapped,
    RequestServed,
    RequestShed,
    get_bus,
)
from mmlspark_tpu_torch.observability.profiler import get_profiler
from mmlspark_tpu_torch.observability.registry import get_registry
from mmlspark_tpu_torch.observability.tracing import (
    TRACE_HEADER,
    Span,
    TraceContext,
    get_tracer,
)
from mmlspark_tpu_torch.resilience.admission import AdmissionController
from mmlspark_tpu_torch.resilience.budget import DEADLINE_HEADER, Deadline

logger = logging.getLogger("mmlspark_tpu_torch.serving")

#: micro-batch sizes are small integers; latency-style buckets would put
#: every batch in the first bucket
_BATCH_SIZE_BUCKETS = (1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0, 128.0, 256.0)

_GET_QMONITOR = None


def _quality_monitor():
    # ambient quality gate, cached like core.pipeline._tracer: the batch
    # loop is the serving hot path, so an unconfigured process pays one
    # env lookup per batch and never imports the quality plane
    global _GET_QMONITOR
    if _GET_QMONITOR is None:
        from mmlspark_tpu_torch.observability.quality import get_monitor

        _GET_QMONITOR = get_monitor
    return _GET_QMONITOR()


class _Server(ThreadingHTTPServer):
    # many concurrent clients: deep accept backlog, daemon worker threads
    request_queue_size = 128
    daemon_threads = True


@dataclass
class _PendingRequest:
    rid: str
    payload: Any
    event: threading.Event = field(default_factory=threading.Event)
    response: Optional[bytes] = None
    status: int = 200
    epoch: int = -1
    retries: int = 0
    # observability: contextvars don't cross the listener->loop thread hop,
    # so the request's root span rides the request object itself
    t_submit: float = 0.0
    span: Optional[Span] = None
    trace_id: str = ""
    # resilience: the request's wall-clock budget (X-Deadline-Ms or the
    # server default) and the listener-gave-up flag — both checked by the
    # batch loop so timed-out work is purged BEFORE the model apply
    deadline: Optional[Deadline] = None
    cancelled: bool = False


@dataclass
class ServiceInfo:
    """One worker endpoint (``HTTPSourceV2.scala:318-410`` ServiceInfo).

    ``model_version`` is lease metadata: the ModelStore version this
    replica currently serves (None = untracked). Hot swaps and warm
    restarts refresh it, so ``GET /services`` shows which version each
    replica answers with.

    ``inflight``/``shed_total``/``p99_ms`` are *load* metadata, refreshed
    by heartbeats: the signals the fleet router (least-loaded balancing)
    and autoscaler (scale-up/down decisions) steer by without any private
    handle into the replica process — ``/services`` is the whole
    control-plane contract (docs/serving_fleet.md)."""

    name: str
    host: str
    port: int
    model_version: Optional[int] = None
    #: admitted-and-unanswered requests at last heartbeat (None = unreported)
    inflight: Optional[int] = None
    #: cumulative 429 sheds at last heartbeat
    shed_total: Optional[int] = None
    #: queue-wait p99 in milliseconds at last heartbeat
    p99_ms: Optional[float] = None

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}/"


#: ServiceInfo fields omitted from the ``/services`` wire format while
#: unreported (None) — a lease that never heartbeat load metadata keeps
#: the pre-fleet wire shape.
_LOAD_FIELDS = frozenset({"inflight", "shed_total", "p99_ms"})


class _BatchLoop:
    """Micro-batching evaluation loop shared by one or many listeners.

    Requests enter through :meth:`submit` (any listener thread) and are
    answered by rid through their own events — reply routing is therefore
    independent of which listener accepted the request. Uncommitted epochs
    are retained for re-hydration; a batch that fails evaluation re-enqueues
    its requests up to ``max_retries`` before failing them with 500."""

    def __init__(
        self,
        model: Transformer | Callable[[Table], Table],
        input_col: str,
        output_col: str,
        max_batch_size: int,
        max_latency_ms: float,
        max_retries: int = 1,
        scheduler=None,
        registry=None,
        admission: Optional[AdmissionController] = None,
    ):
        self.model = model
        self.input_col = input_col
        self.output_col = output_col
        #: ModelStore version of ``model`` (0 = untracked); hot swaps and
        #: warm restarts refresh it so drift sketches carry the version
        #: of the model that actually scored each batch
        self.model_version = 0
        self.max_batch_size = int(max_batch_size)
        self.max_latency_ms = float(max_latency_ms)
        self.max_retries = int(max_retries)
        #: shed-or-admit gate shared by every listener on this loop
        self.admission = admission
        #: optional mmlspark_tpu_torch.runtime.Scheduler — when set, each
        #: micro-batch is applied as partitioned tasks with retry /
        #: heartbeat re-dispatch (the Spark-executor dispatch analog)
        self.scheduler = scheduler
        self.queue: "queue.Queue[_PendingRequest]" = queue.Queue()
        self._epoch = 0
        self._history: Dict[int, List[_PendingRequest]] = {}  # uncommitted epochs
        #: rid -> request reply registry; entries leave on reply OR via
        #: :meth:`forget` when the listener gives up (504), so timed-out
        #: rids never accumulate
        self._pending: Dict[str, _PendingRequest] = {}
        self._lock = threading.Lock()
        self._stopping = threading.Event()
        self._thread: Optional[threading.Thread] = None
        #: monotonic time of the last processed batch (healthz freshness)
        self.last_batch_at: Optional[float] = None
        # metrics plane (docs/observability.md); pass a registry for isolation
        reg = registry if registry is not None else get_registry()
        self.registry = reg
        self._reg_requests = reg.counter(
            "serving_requests_total", "Requests answered by the batch loop"
        )
        self._reg_replies_failed = reg.counter(
            "serving_replies_failed_total",
            "Replies lost because the client disconnected before the write",
        )
        self._reg_batches = reg.counter(
            "serving_batches_total", "Micro-batches evaluated"
        )
        self._reg_queue_wait = reg.histogram(
            "serving_queue_wait_seconds",
            "Submit-to-batch wait per request",
        )
        self._reg_batch_size = reg.histogram(
            "serving_batch_size", "Requests per micro-batch",
            buckets=_BATCH_SIZE_BUCKETS,
        )
        self._reg_apply = reg.histogram(
            "serving_apply_latency_seconds",
            "Model apply time per micro-batch",
        )
        self._reg_expired = reg.counter(
            "serving_expired_total",
            "Requests dropped before model apply (deadline expired or "
            "listener gave up)",
        )

    # -- intake / reply ------------------------------------------------------

    def submit(self, req: _PendingRequest) -> None:
        if not req.t_submit:
            req.t_submit = time.monotonic()
        with self._lock:
            self._pending[req.rid] = req
        self.queue.put(req)

    def forget(self, rid: str) -> None:
        """The listener answered 504 and moved on: drop the rid from the
        reply registry and mark the request cancelled so the batch loop
        purges it instead of computing an answer nobody is waiting for."""
        with self._lock:
            req = self._pending.pop(rid, None)
        if req is not None:
            req.cancelled = True

    def _finish(self, req: _PendingRequest, data: bytes, status: int) -> None:
        """Resolve a request: deregister its rid, store the reply, wake
        the listener."""
        with self._lock:
            self._pending.pop(req.rid, None)
        req.response = data
        req.status = status
        req.event.set()

    def _reply(self, req: _PendingRequest, value: Any, status: int = 200) -> None:
        """replyTo(requestId) (``HTTPSinkV2.scala:81-89``)."""
        if isinstance(value, np.ndarray):
            value = value.tolist()
        elif isinstance(value, np.generic):
            value = value.item()
        self._finish(
            req, json.dumps({self.output_col: value}).encode("utf-8"), status
        )

    def note_reply_failure(self, rid: str, exc: BaseException) -> None:
        """The answer existed but the client hung up before the write — a
        visibility gap in the reference (a dropped keep-alive connection
        surfaced only as a stack trace). Status 499 follows nginx's
        'client closed request' convention."""
        self._reg_replies_failed.inc()
        bus = get_bus()
        if bus.active:
            bus.publish(RequestServed(rid=rid, status=499, latency=0.0))
        logger.debug(
            "reply to %s lost, client disconnected (%s: %s)",
            rid, type(exc).__name__, exc,
        )

    # -- batching ------------------------------------------------------------

    def effective_max_batch_size(self) -> int:
        """``max_batch_size`` after ambient memory pressure: half at
        WARN, a quarter (floor 1) at CRITICAL — smaller device batches
        under pressure, full size again the moment the level clears."""
        from mmlspark_tpu_torch.runtime.pressure import (
            PressureLevel, current_pressure_level,
        )

        level = current_pressure_level("memory")
        if level >= PressureLevel.CRITICAL:
            return max(1, self.max_batch_size // 4)
        if level >= PressureLevel.WARN:
            return max(1, self.max_batch_size // 2)
        return self.max_batch_size

    def _gather_batch(self) -> List[_PendingRequest]:
        """Collect up to the (pressure-adjusted) max batch size, waiting
        at most max_latency_ms past the first (``getNextRequest``
        epoch-advance timeout, ``HTTPSourceV2.scala:588-623``)."""
        batch: List[_PendingRequest] = []
        try:
            first = self.queue.get(timeout=0.05)
        except queue.Empty:
            return batch
        batch.append(first)
        bound = self.effective_max_batch_size()
        deadline = time.perf_counter() + self.max_latency_ms / 1000.0
        while len(batch) < bound:
            remaining = deadline - time.perf_counter()
            if remaining <= 0:
                break
            try:
                batch.append(self.queue.get(timeout=remaining))
            except queue.Empty:
                break
        return batch

    def _apply_model(self, table: Table) -> Table:
        apply = (
            self.model.transform if isinstance(self.model, Transformer)
            else self.model
        )
        if self.scheduler is None:
            return apply(table)
        # Scheduler-backed dispatch: split the micro-batch across executor
        # tasks; an executor dying mid-batch retries its partition, and
        # results reassemble in request order, so the caller sees one
        # ordinary (fault-absorbed) response set.
        col = table.column(self.input_col)
        k = max(1, min(self.scheduler.policy.max_workers, len(col)))
        bounds = np.linspace(0, len(col), k + 1).astype(int)
        shards = [
            Table({self.input_col: col[lo:hi]})
            for lo, hi in zip(bounds[:-1], bounds[1:])
            if hi > lo
        ]
        parts = self.scheduler.run(apply, shards)
        out = np.concatenate(
            [np.asarray(p.column(self.output_col)) for p in parts]
        )
        return Table({self.output_col: out})

    def _purge_expired(
        self, batch: List[_PendingRequest]
    ) -> List[_PendingRequest]:
        """Drop cancelled/deadline-expired requests BEFORE the model apply —
        computing an answer whose requester already got a 504 only adds
        latency for the live requests behind it (the load-shedding half of
        deadline propagation)."""
        live: List[_PendingRequest] = []
        for r in batch:
            if r.cancelled or (r.deadline is not None and r.deadline.expired):
                self._reg_expired.inc()
                if not r.event.is_set():
                    self._finish(
                        r, b'{"error": "deadline exceeded"}', status=504
                    )
                else:
                    with self._lock:
                        self._pending.pop(r.rid, None)
            else:
                live.append(r)
        return live

    def _process(self, batch: List[_PendingRequest]) -> None:
        batch = self._purge_expired(batch)
        if not batch:
            return
        epoch = self._epoch
        self._epoch += 1
        for r in batch:
            r.epoch = epoch
        with self._lock:
            self._history[epoch] = batch  # re-hydration bookkeeping
        now = time.monotonic()
        self.last_batch_at = now
        self._reg_batches.inc()
        self._reg_batch_size.observe(len(batch))
        for r in batch:
            if r.t_submit:
                self._reg_queue_wait.observe(now - r.t_submit)
        # The batch joins the FIRST request's trace (a batch has one parent;
        # the remaining requests keep their own root spans), so at least one
        # request's trace id threads request -> batch -> apply -> reply.
        tracer = get_tracer()
        parent = next((r.span for r in batch if r.span is not None), None)
        bus = get_bus()
        if bus.active:
            bus.publish(BatchFormed(
                epoch=epoch, size=len(batch),
                trace_id=parent.trace_id if parent else "",
            ))
        try:
            payloads = np.empty(len(batch), dtype=object)
            for i, r in enumerate(batch):
                p = r.payload
                payloads[i] = np.asarray(p) if isinstance(p, list) else p
            try:
                col = np.stack(payloads)  # rectangular -> fast path
            except (ValueError, TypeError):
                col = payloads  # ragged payloads stay an object column
            # drift sketching (quality plane): the loop observes the
            # batch itself — inputs before apply, scores after — and
            # suppresses the PipelineModel.transform hook underneath so
            # a request is never sketched twice
            monitor = _quality_monitor()
            t0 = time.perf_counter()
            with tracer.span(
                "serving.batch", parent=parent, epoch=epoch, size=len(batch)
            ):
                with tracer.span("serving.apply"):
                    if monitor is not None:
                        with monitor.suppress_transform():
                            out = self._apply_model(
                                Table({self.input_col: col})
                            )
                    else:
                        out = self._apply_model(Table({self.input_col: col}))
            apply_dt = time.perf_counter() - t0
            self._reg_apply.observe(apply_dt)
            values = out.column(self.output_col)
            if monitor is not None:
                monitor.observe_columns(
                    {self.input_col: col, self.output_col: values},
                    version=self.model_version,
                )
            prof = get_profiler()
            if prof.active:
                prof.note_execute("serving.apply", apply_dt)
                prof.note_transfer(
                    getattr(col, "nbytes", 0), "h2d", name="serving.apply"
                )
                prof.note_transfer(
                    getattr(np.asarray(values), "nbytes", 0),
                    "d2h", name="serving.apply",
                )
            for r, v in zip(batch, values):
                self._reply(r, v)
                self._reg_requests.inc()
            self.commit(epoch)
        except Exception as e:
            logger.warning(
                "batch epoch %d failed (%s: %s); re-enqueueing retryable "
                "requests", epoch, type(e).__name__, e,
            )
            self.commit(epoch)
            # Task-retry re-hydration: the failed batch goes back on the
            # queue (``registerPartition``/``recoveredPartitions``,
            # HTTPSourceV2.scala:470-487) until retries are exhausted.
            unanswered = [r for r in batch if not r.event.is_set()]
            retryable = [r for r in unanswered if r.retries < self.max_retries]
            failed = [r for r in unanswered if r.retries >= self.max_retries]
            for r in retryable:
                r.retries += 1
                self.queue.put(r)
            err = json.dumps({"error": str(e)[:500]}).encode("utf-8")
            for r in failed:
                self._finish(r, err, status=500)
                self._reg_requests.inc()

    def _serve_loop(self) -> None:
        while not self._stopping.is_set():
            batch = self._gather_batch()
            if batch:
                self._process(batch)

    # -- fault tolerance -----------------------------------------------------

    def commit(self, epoch: int) -> None:
        """Commit-based GC of answered epochs (``HTTPSourceV2.scala:535-552``)."""
        with self._lock:
            self._history.pop(epoch, None)

    @property
    def uncommitted_epochs(self) -> List[int]:
        with self._lock:
            return sorted(self._history)

    def recover(self) -> int:
        """Re-hydrate every uncommitted epoch after a worker death: its
        unanswered requests re-enter the queue for the next (restarted)
        loop. Returns how many requests were replayed."""
        with self._lock:
            pending = [
                r
                for reqs in self._history.values()
                for r in reqs
                if not r.event.is_set()
            ]
            self._history.clear()
        for r in pending:
            self.queue.put(r)
        return len(pending)

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> "_BatchLoop":
        self._stopping.clear()
        self._thread = threading.Thread(target=self._serve_loop, daemon=True)
        self._thread.start()
        return self

    def drain(self, timeout: float = 5.0) -> bool:
        """Graceful-shutdown helper: wait (bounded) for the already-queued
        requests to be answered by the still-running loop. Callers stop
        accepting first, drain second, stop the loop last — admitted
        requests get answers, not connection resets. Returns True when the
        queue fully drained."""
        if self._thread is None or not self._thread.is_alive():
            return self.queue.empty()
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if self.queue.empty() and not self.uncommitted_epochs:
                return True
            time.sleep(0.005)
        return self.queue.empty()

    def stop(self) -> None:
        self._stopping.set()


class _ListenerMixin:
    """HTTP edge shared by the serving classes: parse, submit, await."""

    def health(self) -> Dict[str, Any]:
        """Liveness snapshot served at ``GET /healthz``."""
        loop: _BatchLoop = self.loop  # type: ignore[attr-defined]
        last = loop.last_batch_at
        now = time.monotonic()
        return {
            "status": "ok",
            "name": getattr(self, "name", "serving"),
            "uptime_seconds": round(now - self._started_at, 3),
            "model_epoch": loop._epoch,
            "model_version": getattr(self, "model_version", None),
            "last_batch_age_seconds": (
                round(now - last, 3) if last is not None else None
            ),
            "uncommitted_epochs": len(loop.uncommitted_epochs),
            "inflight": (
                loop.admission.inflight if loop.admission is not None else None
            ),
        }

    def _make_handler(self, loop: _BatchLoop, input_col: str):
        server = self

        class Handler(BaseHTTPRequestHandler):
            # HTTP/1.1: connections persist across requests, so steady-state
            # clients skip TCP setup per call — the "sub-millisecond" serving
            # posture of the reference (mmlspark-serving.md) needs keep-alive.
            # Every response path MUST therefore carry Content-Length, or a
            # keep-alive client would block waiting for a close that never
            # comes. Nagle must be off: coalescing the status line with the
            # body write otherwise interacts with delayed ACKs into ~40 ms
            # stalls per keep-alive request.
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
                if extra_headers:
                    for k, v in extra_headers.items():
                        self.send_header(k, v)
                self.end_headers()
                self.wfile.write(data)

            def do_GET(self):  # noqa: N802 (http.server API)
                if self.path == "/metrics":
                    body = loop.registry.exposition().encode("utf-8")
                    self._reply_bytes(
                        200, body,
                        content_type="text/plain; version=0.0.4; charset=utf-8",
                    )
                elif self.path == "/healthz":
                    self._reply_bytes(200, json.dumps(server.health()).encode())
                else:
                    self._reply_bytes(404, b'{"error": "not found"}')

            def do_POST(self):  # noqa: N802 (http.server API)
                # admit-or-shed BEFORE reading the body: an overloaded
                # server answers 429 + Retry-After in microseconds instead
                # of queueing work it will time out on (docs/resilience.md)
                admission = loop.admission
                if admission is not None and not admission.try_acquire():
                    self._reply_bytes(
                        429, b'{"error": "server overloaded"}',
                        extra_headers={
                            "Retry-After": f"{admission.retry_after_s:g}"
                        },
                    )
                    return
                try:
                    self._handle_admitted()
                finally:
                    if admission is not None:
                        admission.release()

            def _reply_lost(self, span, rid: str, exc: BaseException) -> None:
                """A reply that could not be written. Its ``serving.request``
                span was recorded before the write with the status that was
                computed, so the loss is traced as a zero-length
                ``serving.reply`` child of it with status ``disconnect``,
                and counted as a failed reply."""
                tracer = get_tracer()
                tracer.finish(tracer.start_span("serving.reply", parent=span),
                              status="disconnect")
                loop.note_reply_failure(rid, exc)

            def _client_id(self) -> str:
                """Poison-breaker key: an explicit X-Client-Id beats the
                peer address (routers/proxies collapse many clients onto
                one address; the header keeps the breaker per-tenant)."""
                return (
                    self.headers.get("X-Client-Id")
                    or self.client_address[0]
                )

            def _reject(self, span, rid: str, client: str,
                        kind: str, detail: str) -> None:
                """Answer a malformed request with a structured 400 that
                still carries the trace id, book it against the client's
                malformed-rate budget, and keep it OUT of the batch loop
                (a bad payload must never poison co-batched requests)."""
                tracer = get_tracer()
                breaker = server.malformed_breaker
                if breaker is not None:
                    breaker.record_malformed(client, kind=kind)
                data = json.dumps({
                    "error": {"kind": kind, "detail": detail, "rid": rid},
                }).encode()
                # recorded before the reply, as on the served path
                tracer.finish(span, status="400")
                try:
                    self._reply_bytes(
                        400, data,
                        extra_headers={TRACE_HEADER: span.trace_id},
                    )
                except OSError as e:
                    self._reply_lost(span, rid, e)
                    return
                bus = get_bus()
                if bus.active:
                    bus.publish(RequestServed(
                        rid=rid, status=400, latency=0.0,
                        trace_id=span.trace_id,
                    ))

            def _handle_admitted(self) -> None:
                rid = uuid.uuid4().hex
                tracer = get_tracer()
                # the span opens BEFORE the body is parsed: every answer —
                # including a malformed-payload 400 — carries X-Trace-Id,
                # so a client can always hand support a correlatable id
                #
                # listener threads carry no ambient span; a wire-propagated
                # TraceContext (the router's hop) is adopted so this
                # request->batch->apply chain parents under the router's
                # span in the merged fleet trace — otherwise the request
                # mints the trace root itself
                span = tracer.start_span(
                    "serving.request", rid=rid,
                    context=TraceContext.from_headers(self.headers),
                )
                client = self._client_id()
                # body is ALWAYS read before any reply — a keep-alive
                # connection with an unconsumed body desyncs on the next
                # request — so even the poison-shed path drains it first
                length = int(self.headers.get("Content-Length", 0))
                body = self.rfile.read(length)
                breaker = server.malformed_breaker
                if breaker is not None and breaker.blocked(client):
                    breaker.note_shed(client)
                    retry_after = f"{breaker.reset_s:g}"
                    # the span is recorded BEFORE the reply: once the client
                    # holds its answer the span exists, even if this process
                    # dies on the next line
                    tracer.finish(span, status="429")
                    self._reply_bytes(
                        429, json.dumps({
                            "error": {"kind": "malformed-rate",
                                      "detail": "client shed by the poison "
                                                "breaker", "rid": rid},
                        }).encode(),
                        extra_headers={
                            "Retry-After": retry_after,
                            TRACE_HEADER: span.trace_id,
                        },
                    )
                    bus = get_bus()
                    if bus.active:
                        bus.publish(RequestShed(
                            reason="malformed_rate", queue_depth=0,
                            retry_after=breaker.reset_s, rid=rid,
                        ))
                    return
                try:
                    payload = json.loads(body) if body else None
                except json.JSONDecodeError as e:
                    self._reject(span, rid, client, "invalid-json", str(e))
                    return
                validator = server.request_validator
                if validator is not None:
                    rejection = validator.check_payload(payload)
                    if rejection is not None:
                        self._reject(span, rid, client, *rejection)
                        return
                if isinstance(payload, dict) and input_col in payload:
                    payload = payload[input_col]
                req = _PendingRequest(rid=rid, payload=payload)
                # deadline propagation: a caller-supplied X-Deadline-Ms wins;
                # otherwise the server's default request budget (if any)
                req.deadline = Deadline.from_header(
                    self.headers.get(DEADLINE_HEADER)
                )
                if req.deadline is None and server.request_deadline_s:
                    req.deadline = Deadline.after(server.request_deadline_s)
                req.span, req.trace_id = span, span.trace_id
                loop.submit(req)
                wait_s = server.reply_timeout_s
                if req.deadline is not None:
                    # never hold the connection past the caller's budget
                    wait_s = min(wait_s, max(0.0, req.deadline.remaining()))
                req.event.wait(timeout=wait_s)
                if req.response is None:
                    # the listener gives up: deregister the rid so the loop
                    # purges the request instead of computing into the void
                    loop.forget(req.rid)
                    status, data = 504, b'{"error": "timeout"}'
                else:
                    status, data = req.status, req.response
                # the span is recorded BEFORE the reply is written: a replica
                # killed or retired once the client holds its answer has
                # already recorded it (the fleet's trace continuity)
                tracer.finish(span, status=str(status))
                try:
                    self._reply_bytes(
                        status, data,
                        extra_headers={TRACE_HEADER: span.trace_id},
                    )
                except OSError as e:
                    # client disconnect on the reply path: answer computed
                    # but unwritable — count it, don't stack-trace (see
                    # docs/observability.md)
                    self._reply_lost(span, req.rid, e)
                    return
                bus = get_bus()
                if bus.active:
                    bus.publish(RequestServed(
                        rid=req.rid, status=status,
                        latency=time.monotonic() - req.t_submit,
                        trace_id=req.trace_id,
                    ))

            def log_message(self, *args):  # silence default stderr logging
                pass

        return Handler


class ServingServer(_ListenerMixin):
    """Serve a ``Transformer`` (or a raw table->table callable) over HTTP.

    POST body: JSON ``{"<inputCol>": value}`` or a bare value; reply is the
    JSON of the output column for that row. Requests are micro-batched up to
    ``maxBatchSize`` or ``maxLatencyMs`` — the ``DynamicMiniBatchTransformer``
    idea applied at the serving edge so single-row latency stays low while
    the chip still sees batches.
    """

    def __init__(
        self,
        model: Transformer | Callable[[Table], Table],
        input_col: str = "input",
        output_col: str = "prediction",
        host: str = "127.0.0.1",
        port: int = 0,
        max_batch_size: int = 64,
        max_latency_ms: float = 2.0,
        max_retries: int = 1,
        name: str = "serving",
        loop: Optional[_BatchLoop] = None,
        registry=None,
        reply_timeout_s: float = 30.0,
        max_pending: int = 1024,
        shed_retry_after_s: float = 1.0,
        request_deadline_s: Optional[float] = None,
        drain_timeout_s: float = 5.0,
        request_validator: Any = None,
        malformed_breaker: Any = None,
        malformed_threshold: int = 16,
        malformed_window_s: float = 5.0,
        malformed_reset_s: float = 2.0,
    ):
        from mmlspark_tpu_torch.dataguard.requestguard import (
            MalformedRateBreaker,
            RequestValidator,
        )

        self.input_col = input_col
        self.output_col = output_col
        self.name = name
        self._owns_loop = loop is None
        self._started_at = time.monotonic()
        #: how long a listener thread holds the connection waiting for the
        #: loop's reply (was a hardcoded 30 s)
        self.reply_timeout_s = float(reply_timeout_s)
        #: default per-request budget when the caller sends no X-Deadline-Ms
        self.request_deadline_s = request_deadline_s
        self.drain_timeout_s = float(drain_timeout_s)
        # pre-admission hardening (dataguard): payloads are validated
        # against the model's input contract before they can reach the
        # batch loop, and clients flooding malformed requests are shed
        # per-client — pass request_validator="off" to disable, or an
        # explicit RequestValidator to pin the contract
        if request_validator == "off":
            self.request_validator = None
        elif request_validator is None:
            self.request_validator = RequestValidator.for_model(
                model, input_col=input_col
            )
        else:
            self.request_validator = request_validator
        self.malformed_breaker = malformed_breaker or MalformedRateBreaker(
            threshold=malformed_threshold, window_s=malformed_window_s,
            reset_s=malformed_reset_s, registry=registry,
        )
        self.loop = loop or _BatchLoop(
            model, input_col, output_col, max_batch_size, max_latency_ms,
            max_retries, registry=registry,
            admission=AdmissionController(
                max_pending=max_pending, retry_after_s=shed_retry_after_s,
                registry=registry, name=name,
            ),
        )
        self._httpd = _Server((host, port), self._make_handler(self.loop, input_col))
        self.info = ServiceInfo(name, host, self._httpd.server_address[1])
        #: ModelStore version currently served (None = untracked); set by
        #: warm_restart_server and advanced by the hot-swap watcher
        self.model_version: Optional[int] = None
        self._swap_stop: Optional[threading.Event] = None
        self._swap_thread: Optional[threading.Thread] = None

    @property
    def model(self):
        return self.loop.model

    def heartbeat_stats(self) -> Dict[str, Any]:
        """The register/heartbeat payload this replica reports about
        itself: identity plus the live load metadata
        (``inflight``/``shed_total``/``p99_ms``) the fleet router and
        autoscaler steer by. Everything here is self-observed — the
        control plane never needs a handle into the replica process."""
        admission = self.loop.admission
        return {
            "name": self.info.name,
            "host": self.info.host,
            "port": self.info.port,
            "model_version": self.model_version,
            "inflight": admission.inflight if admission is not None else 0,
            "shed_total": (
                int(admission._shed.value) if admission is not None else 0
            ),
            "p99_ms": self.loop._reg_queue_wait.percentile(0.99) * 1e3,
        }

    # -- hot swap (live model replacement, zero downtime) --------------------

    def enable_hot_swap(
        self,
        loader: Callable[[str], Any],
        root: Optional[str] = None,
        name: str = "model",
        poll_s: float = 0.25,
    ) -> "ServingServer":
        """Watch the ModelStore ``CURRENT`` pointer under ``root`` and swap
        the live model the moment a new version commits — between requests,
        with no listener restart: the batch loop reads ``loop.model`` per
        micro-batch, so one attribute assignment is the whole cutover.
        Polling reads only the small CURRENT pointer
        (:meth:`~mmlspark_tpu_torch.runtime.journal.ModelStore.current_version`);
        the model text is loaded and CRC-verified only when the version
        actually moved. A version that fails to load is skipped (the old
        model keeps serving) and retried next poll."""
        import os as _os

        from mmlspark_tpu_torch.runtime.journal import ModelStore, default_checkpoint_dir

        root = root or default_checkpoint_dir()
        if root is None:
            raise ValueError(
                "hot swap needs a ModelStore root: pass root= or set "
                "MMLSPARK_TPU_CHECKPOINT_DIR"
            )
        store = ModelStore(_os.path.join(root, "models"))
        reg = self.loop.registry
        swaps = reg.counter(
            "serving_model_swaps_total", "Live model hot swaps"
        ).labels(server=self.name)
        version_g = reg.gauge(
            "serving_model_version", "ModelStore version currently served"
        ).labels(server=self.name)
        if self.model_version is not None:
            version_g.set(self.model_version)
        stop = threading.Event()

        def _watch() -> None:
            while not stop.wait(poll_s):
                try:
                    v = store.current_version(name)
                    if v is None or v == self.model_version:
                        continue
                    latest = store.latest(name)
                    if latest is None:
                        continue
                    version, text = latest
                    if version == self.model_version:
                        continue
                    model = loader(text)
                except Exception as e:  # noqa: BLE001 - keep serving old model
                    logger.warning(
                        "hot swap of %r failed (%s: %s); keeping v%s",
                        name, type(e).__name__, e, self.model_version,
                    )
                    continue
                # single attribute store = the atomic cutover: in-flight
                # batches finish on the old model, the next batch reads new
                self.loop.model = model
                self.model_version = version
                self.info.model_version = version
                self.loop.model_version = version
                monitor = _quality_monitor()
                if monitor is not None:
                    monitor.note_version(version)
                swaps.inc()
                version_g.set(version)
                logger.info(
                    "hot-swapped %r to v%06d on %s", name, version, self.name
                )
                bus = get_bus()
                if bus.active:
                    bus.publish(ModelSwapped(
                        name=name, version=version, server=self.name,
                    ))

        self._swap_stop = stop
        self._swap_thread = threading.Thread(
            target=_watch, daemon=True, name=f"hot-swap-{self.name}"
        )
        self._swap_thread.start()
        return self

    def start(self) -> "ServingServer":
        threading.Thread(target=self._httpd.serve_forever, daemon=True).start()
        if self._owns_loop:
            self.loop.start()
        return self

    def stop(self) -> None:
        if self._swap_stop is not None:
            self._swap_stop.set()
            if self._swap_thread is not None:
                self._swap_thread.join(timeout=5.0)
            self._swap_stop = self._swap_thread = None
        # graceful drain: stop accepting, answer what was admitted, THEN
        # stop the loop — reversing the old order, which could kill the
        # loop while listeners still held admitted-but-unanswered requests
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._owns_loop:
            self.loop.drain(timeout=self.drain_timeout_s)
            self.loop.stop()

    def __enter__(self) -> "ServingServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()


def _parse_load_metadata(info: Dict[str, Any]) -> Dict[str, Any]:
    """The optional load fields of a register/heartbeat payload, validated.
    Raises ``TypeError``/``ValueError`` on garbage (the caller answers 400)."""
    out: Dict[str, Any] = {}
    if info.get("inflight") is not None:
        out["inflight"] = int(info["inflight"])
    if info.get("shed_total") is not None:
        out["shed_total"] = int(info["shed_total"])
    if info.get("p99_ms") is not None:
        out["p99_ms"] = float(info["p99_ms"])
    return out


class RegistrationService:
    """Driver-side endpoint registry (``DriverServiceUtils:113-173``):
    workers POST their ServiceInfo to ``/register``; clients GET
    ``/services`` to discover every worker endpoint
    (``HTTPSourceStateHolder.serviceInfo``, ``HTTPSourceV2.scala:318-410``).

    With ``ttl_s`` set, every registration is a lease: replicas refresh it
    by POSTing ``/heartbeat`` (or calling :meth:`heartbeat` in-process),
    and a replica whose lease expires silently drops out of
    :attr:`services` — a crashed worker stops being discoverable without
    anyone deregistering it. ``ttl_s=None`` keeps the old everlasting
    registrations.

    With ``journal_dir`` set, the lease table is journaled to disk
    (tmp+rename with a CRC sidecar — the
    :class:`~mmlspark_tpu_torch.runtime.journal.ModelStore` idiom) on every
    register/deregister, and a restarted registry recovers the journaled
    leases on construction with a fresh grace period — replicas keep
    heartbeating as if nothing happened instead of re-registering from
    scratch. Each recovered lease publishes a
    :class:`~mmlspark_tpu_torch.observability.events.LeaseRecovered` event."""

    JOURNAL_NAME = "leases.json"

    def __init__(
        self,
        host: str = "127.0.0.1",
        port: int = 0,
        ttl_s: Optional[float] = None,
        clock: Callable[[], float] = time.monotonic,
        journal_dir: Optional[str] = None,
    ):
        self._services: Dict[str, ServiceInfo] = {}
        #: service name -> last register/heartbeat time (the lease stamp)
        self._last_seen: Dict[str, float] = {}
        self.ttl_s = ttl_s
        self._clock = clock
        self._journal_dir = journal_dir
        self._lock = threading.Lock()
        self._started_at = time.monotonic()
        if journal_dir is not None:
            self._recover_leases()
        registry = self

        class Handler(BaseHTTPRequestHandler):
            def do_POST(self):  # noqa: N802
                if self.path not in ("/register", "/heartbeat", "/deregister"):
                    self.send_response(404)
                    self.end_headers()
                    return
                length = int(self.headers.get("Content-Length", 0))
                try:
                    info = json.loads(self.rfile.read(length))
                    name = str(info["name"])
                except (KeyError, TypeError, ValueError) as e:
                    logger.debug("rejected malformed %s payload: %s", self.path, e)
                    self.send_response(400)
                    self.end_headers()
                    return
                if self.path == "/deregister":
                    # explicit retire: the lease is released NOW, not at
                    # TTL expiry — routers drop the replica on next poll
                    self.send_response(
                        200 if registry.deregister(name) else 404
                    )
                    self.end_headers()
                    return
                try:
                    raw_version = info.get("model_version")
                    model_version = (
                        int(raw_version) if raw_version is not None else None
                    )
                    load = _parse_load_metadata(info)
                except (TypeError, ValueError):
                    self.send_response(400)
                    self.end_headers()
                    return
                if self.path == "/heartbeat":
                    # lease refresh only: an unknown (expired/never-seen)
                    # name gets 404 so the replica knows to re-register
                    if not registry.heartbeat(name, model_version, **load):
                        self.send_response(404)
                        self.end_headers()
                        return
                    self.send_response(200)
                    self.end_headers()
                    return
                try:
                    svc = ServiceInfo(
                        name, info["host"], int(info["port"]),
                        model_version=model_version, **load,
                    )
                except (KeyError, TypeError, ValueError) as e:
                    logger.debug("rejected malformed /register payload: %s", e)
                    self.send_response(400)
                    self.end_headers()
                    return
                registry.register(svc)
                self.send_response(200)
                self.end_headers()

            def do_GET(self):  # noqa: N802
                ctype = "application/json"
                if self.path == "/services":
                    # load metadata is optional per lease: a replica that
                    # never heartbeat it gets the pre-fleet wire shape
                    body = json.dumps([
                        {k: v for k, v in vars(s).items()
                         if v is not None or k not in _LOAD_FIELDS}
                        for s in registry.services
                    ]).encode()
                elif self.path == "/metrics":
                    body = get_registry().exposition().encode("utf-8")
                    ctype = "text/plain; version=0.0.4; charset=utf-8"
                elif self.path == "/healthz":
                    n = len(registry.services)
                    body = json.dumps({
                        "status": "ok",
                        "uptime_seconds": round(
                            time.monotonic() - registry._started_at, 3
                        ),
                        "registered_services": n,
                    }).encode()
                else:
                    self.send_response(404)
                    self.end_headers()
                    return
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *args):
                pass

        self._httpd = _Server((host, port), Handler)
        self.info = ServiceInfo("registry", host, self._httpd.server_address[1])

    @property
    def services(self) -> List[ServiceInfo]:
        """Live endpoints: lease-expired replicas are pruned on read."""
        with self._lock:
            self._prune_expired()
            return list(self._services.values())

    def _prune_expired(self) -> None:
        """Drop services whose lease lapsed. Caller holds ``self._lock``."""
        if self.ttl_s is None:
            return
        now = self._clock()
        pruned = False
        for name, seen in list(self._last_seen.items()):
            if now - seen > self.ttl_s:
                self._services.pop(name, None)
                del self._last_seen[name]
                pruned = True
                logger.warning(
                    "service %r lease expired (no heartbeat for > %.1fs); "
                    "dropped from discovery", name, self.ttl_s,
                )
        if pruned:
            self._journal_leases()

    # -- lease journal (registry restart survival) ---------------------------

    @property
    def _journal_path(self) -> Optional[str]:
        if self._journal_dir is None:
            return None
        return os.path.join(self._journal_dir, self.JOURNAL_NAME)

    def _journal_leases(self) -> None:
        """Snapshot the lease table to disk. Caller holds ``self._lock``.
        Written on register/deregister (membership changes), not on every
        heartbeat: recovery re-stamps each lease with a fresh grace
        period anyway, so journaling the refresh times would buy nothing
        but an fsync per heartbeat."""
        path = self._journal_path
        if path is None:
            return
        from mmlspark_tpu_torch.runtime.journal import _atomic_write

        payload = json.dumps({
            "saved_at": time.time(),
            "leases": [vars(s) for s in self._services.values()],
        }).encode()
        try:
            os.makedirs(self._journal_dir, exist_ok=True)
            _atomic_write(path, payload)
            _atomic_write(path + ".crc", f"{zlib.crc32(payload):08x}".encode())
        except OSError:
            logger.warning("lease journal write failed", exc_info=True)

    def _recover_leases(self) -> None:
        """Reload journaled leases after a registry restart. Every
        recovered lease gets a fresh ``_last_seen`` stamp — the grace
        period restarts, giving live replicas one full TTL to land their
        next heartbeat before the lease can expire."""
        path = self._journal_path
        if path is None or not os.path.exists(path):
            return
        try:
            with open(path, "rb") as f:
                payload = f.read()
            with open(path + ".crc", "rb") as f:
                want = f.read().decode().strip()
            if f"{zlib.crc32(payload):08x}" != want:
                logger.warning(
                    "lease journal CRC mismatch; discarding %s", path
                )
                return
            doc = json.loads(payload)
        except (OSError, ValueError) as e:
            logger.warning("lease journal unreadable (%s); starting empty", e)
            return
        age_s = max(0.0, time.time() - float(doc.get("saved_at", 0.0)))
        bus = get_bus()
        for rec in doc.get("leases", []):
            try:
                svc = ServiceInfo(
                    str(rec["name"]), str(rec["host"]), int(rec["port"]),
                    model_version=rec.get("model_version"),
                    **{k: rec[k] for k in _LOAD_FIELDS if rec.get(k) is not None},
                )
            except (KeyError, TypeError, ValueError):
                continue
            self._services[svc.name] = svc
            self._last_seen[svc.name] = self._clock()
            if bus.active:
                bus.publish(LeaseRecovered(
                    name=svc.name, url=svc.url, age_s=age_s,
                ))
        if self._services:
            logger.info(
                "recovered %d journaled lease(s) (%.1fs old) from %s",
                len(self._services), age_s, path,
            )

    def register(self, svc: ServiceInfo) -> None:
        with self._lock:
            self._services[svc.name] = svc
            self._last_seen[svc.name] = self._clock()
            self._journal_leases()

    def heartbeat(
        self,
        name: str,
        model_version: Optional[int] = None,
        inflight: Optional[int] = None,
        shed_total: Optional[int] = None,
        p99_ms: Optional[float] = None,
    ) -> bool:
        """Refresh ``name``'s lease; False when the service is unknown
        (expired or never registered) — the replica must re-register.
        ``model_version`` updates the lease metadata so ``/services``
        tracks which model version the replica currently serves (a hot
        swap shows up on the next heartbeat without re-registration);
        ``inflight``/``shed_total``/``p99_ms`` refresh the load metadata
        the fleet router and autoscaler read off ``/services``."""
        with self._lock:
            self._prune_expired()
            if name not in self._services:
                return False
            self._last_seen[name] = self._clock()
            svc = self._services[name]
            if model_version is not None:
                svc.model_version = int(model_version)
            if inflight is not None:
                svc.inflight = int(inflight)
            if shed_total is not None:
                svc.shed_total = int(shed_total)
            if p99_ms is not None:
                svc.p99_ms = float(p99_ms)
            return True

    def deregister(self, name: str) -> bool:
        """Drop ``name`` immediately (the autoscaler's retire path): the
        next ``/services`` read no longer lists it, so no router sends it
        another request. False when the name was not registered."""
        with self._lock:
            self._last_seen.pop(name, None)
            dropped = self._services.pop(name, None) is not None
            if dropped:
                self._journal_leases()
            return dropped

    def start(self) -> "RegistrationService":
        threading.Thread(target=self._httpd.serve_forever, daemon=True).start()
        return self

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()

    def __enter__(self) -> "RegistrationService":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()


class DistributedServingServer:
    """N listeners sharing ONE micro-batch loop — the ``DistributedHTTPSource``
    shape: requests from every listener funnel into the shared queue, replies
    route back by request id regardless of the accepting listener (the
    cross-worker reply), and endpoints register with the driver's
    :class:`RegistrationService` the way worker servers report in
    (``reportServerToDriver``, ``HTTPSourceV2.scala:649-655``)."""

    def __init__(
        self,
        model,
        num_servers: int = 2,
        host: str = "127.0.0.1",
        name: str = "serving",
        registry: Optional[RegistrationService] = None,
        registry_url: Optional[str] = None,
        input_col: str = "input",
        output_col: str = "prediction",
        max_batch_size: int = 64,
        max_latency_ms: float = 2.0,
        max_retries: int = 1,
        base_port: int = 0,
        num_executors: int = 0,
        executor_policy=None,
        max_pending: int = 1024,
        shed_retry_after_s: float = 1.0,
        drain_timeout_s: float = 5.0,
        registry_heartbeat_s: Optional[float] = None,
        **kwargs,
    ):
        self.drain_timeout_s = float(drain_timeout_s)
        self._name = name
        #: lease-refresh cadence against a TTL'd RegistrationService;
        #: None disables the heartbeat thread
        self.registry_heartbeat_s = registry_heartbeat_s
        self._hb_stop = threading.Event()
        self._hb_thread: Optional[threading.Thread] = None
        # num_executors > 0 (or an ambient runtime.policy() / explicit
        # executor_policy) routes every micro-batch through the
        # fault-tolerant partition scheduler: the Spark-cluster posture
        # where batch evaluation runs on executors the driver can lose.
        self.scheduler = None
        from mmlspark_tpu_torch import runtime

        pol = executor_policy or runtime.current_policy()
        if num_executors > 0 or pol is not None:
            pol = pol or runtime.SchedulerPolicy(max_workers=num_executors)
            self.scheduler = runtime.Scheduler(policy=pol)
        # ONE admission gate across all listeners: the shared loop is the
        # shared bottleneck, so the pending bound must be global too
        self.loop = _BatchLoop(
            model, input_col, output_col, max_batch_size, max_latency_ms,
            max_retries, scheduler=self.scheduler,
            admission=AdmissionController(
                max_pending=max_pending, retry_after_s=shed_retry_after_s,
                name=name,
            ),
        )
        # ONE poison breaker too: a flooding client spraying its malformed
        # requests across listeners must still accumulate into one budget
        if "malformed_breaker" not in kwargs:
            from mmlspark_tpu_torch.dataguard.requestguard import MalformedRateBreaker

            kwargs["malformed_breaker"] = MalformedRateBreaker()
        # base_port > 0: listeners bind base_port, base_port+1, ... (the
        # deployable layout — k8s Services need declared ports); 0 keeps
        # OS-assigned ephemeral ports for tests.
        self.servers = [
            ServingServer(
                model, host=host, name=f"{name}-{i}", loop=self.loop,
                port=(base_port + i) if base_port else 0,
                input_col=input_col, output_col=output_col, **kwargs,
            )
            for i in range(num_servers)
        ]
        self._registry = registry
        self._registry_url = registry_url

    @property
    def service_info(self) -> List[ServiceInfo]:
        return [s.info for s in self.servers]

    def _register_endpoints(self) -> None:
        if self._registry is not None:
            for info in self.service_info:
                self._registry.register(info)
        if self._registry_url:
            import urllib.request

            for info in self.service_info:
                req = urllib.request.Request(
                    self._registry_url.rstrip("/") + "/register",
                    data=json.dumps(vars(info)).encode(),
                    method="POST",
                    headers={"Content-Type": "application/json"},
                )
                urllib.request.urlopen(req, timeout=5).read()

    # -- registry lease refresh ----------------------------------------------

    def _heartbeat_once(self) -> None:
        """Refresh every listener's lease; a rejected heartbeat (lease
        already expired) falls back to a full re-registration."""
        # all listeners share ONE loop/admission gate, so each lease
        # reports the same (global) load metadata — the router divides
        # traffic by replica, not by listener
        admission = self.loop.admission
        inflight = admission.inflight if admission is not None else None
        if self._registry is not None:
            for info in self.service_info:
                if not self._registry.heartbeat(
                    info.name, info.model_version, inflight=inflight
                ):
                    self._registry.register(info)
        if self._registry_url:
            import urllib.request

            base = self._registry_url.rstrip("/")
            for info in self.service_info:
                req = urllib.request.Request(
                    base + "/heartbeat",
                    data=json.dumps({
                        "name": info.name,
                        "model_version": info.model_version,
                        "inflight": inflight,
                    }).encode(),
                    method="POST",
                    headers={"Content-Type": "application/json"},
                )
                try:
                    urllib.request.urlopen(req, timeout=5).read()
                except Exception:
                    # expired or registry restarted: re-register from scratch
                    try:
                        self._register_endpoints()
                    except Exception:
                        logger.warning(
                            "registry heartbeat + re-register failed",
                            exc_info=True,
                        )
                    return

    def _heartbeat_loop(self) -> None:
        # seeded per-replica jitter (±20% of the period) de-synchronizes a
        # fleet's lease refreshes: after a registry restart every replica
        # would otherwise heartbeat in the same instant, and the recovered
        # registry would eat the whole fleet's refresh as one burst
        seed = int(os.environ.get("MMLSPARK_TPU_FAULT_SEED", "0") or 0)
        rng = random.Random(seed * 1_000_003 + zlib.crc32(self._name.encode()))
        while True:
            period = self.registry_heartbeat_s
            wait = period * (1.0 + 0.2 * (2.0 * rng.random() - 1.0))
            if self._hb_stop.wait(wait):
                return
            try:
                self._heartbeat_once()
            except Exception:
                logger.warning("registry heartbeat failed", exc_info=True)

    def start(self) -> "DistributedServingServer":
        self.loop.start()
        for s in self.servers:
            s.start()
        try:
            self._register_endpoints()
        except Exception:
            # a failed registration must not leak running listeners/ports
            logger.exception("endpoint registration failed; stopping servers")
            self.stop()
            raise
        if self.registry_heartbeat_s is not None:
            self._hb_stop.clear()
            self._hb_thread = threading.Thread(
                target=self._heartbeat_loop, daemon=True,
                name="registry-heartbeat",
            )
            self._hb_thread.start()
        return self

    def stop(self) -> None:
        self._hb_stop.set()
        if self._hb_thread is not None:
            self._hb_thread.join(timeout=1.0)
            self._hb_thread = None
        # listeners first (stop accepting), drain the shared queue, then
        # stop the loop — admitted requests get answered, not dropped
        for s in self.servers:
            s.stop()
        self.loop.drain(timeout=self.drain_timeout_s)
        self.loop.stop()
        if self.scheduler is not None:
            # graceful executor drain, then teardown (Spark's
            # decommission-before-stop)
            self.scheduler.pool.drain(timeout=5.0)
            self.scheduler.close()

    def __enter__(self) -> "DistributedServingServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()


# -- warm restart (durable model recovery) -----------------------------------


def recover_model(
    loader: Callable[[str], Any],
    root: Optional[str] = None,
    name: str = "model",
):
    """Warm-restart recovery scan: load the last atomically committed
    model from the :class:`~mmlspark_tpu_torch.runtime.journal.ModelStore`
    under ``root`` (default: the ambient ``MMLSPARK_TPU_CHECKPOINT_DIR``,
    where a durable ``fit`` commits) and rebuild it via ``loader(text)``
    — e.g. ``LightGBMClassificationModel.from_model_string``. Returns
    ``(version, model)`` or ``None`` when nothing was ever committed.
    A torn/corrupt CURRENT pointer falls back to the newest checksummed
    version, so a crash mid-commit can never resurrect a broken model."""
    import os

    from mmlspark_tpu_torch.runtime.journal import ModelStore, default_checkpoint_dir

    root = root or default_checkpoint_dir()
    if root is None:
        return None
    store = ModelStore(os.path.join(root, "models"))
    latest = store.latest(name)
    if latest is None:
        return None
    version, text = latest
    return version, loader(text)


def warm_restart_server(
    loader: Callable[[str], Any],
    root: Optional[str] = None,
    name: str = "model",
    watch: bool = False,
    poll_s: float = 0.25,
    **server_kwargs,
) -> ServingServer:
    """Build a :class:`ServingServer` from the last committed model —
    the process-kill recovery path: the server that died mid-serve comes
    back serving exactly the model version that was last atomically
    committed. The recovered version is stamped into the server's
    :class:`ServiceInfo` lease metadata, so registering/heartbeating it
    against a :class:`RegistrationService` reports which version this
    replica serves. ``watch=True`` additionally starts the CURRENT-pointer
    watcher (:meth:`ServingServer.enable_hot_swap`), so later commits
    hot-swap in with no further restarts. Raises ``FileNotFoundError``
    when no committed model exists (nothing safe to serve)."""
    recovered = recover_model(loader, root=root, name=name)
    if recovered is None:
        raise FileNotFoundError(
            f"no committed model {name!r} found under "
            f"{root or 'MMLSPARK_TPU_CHECKPOINT_DIR'}; cannot warm-restart"
        )
    version, model = recovered
    logger.info("warm restart: serving committed model %s v%06d", name, version)
    server = ServingServer(model, **server_kwargs)
    server.model_version = version
    server.info.model_version = version
    server.loop.model_version = version
    monitor = _quality_monitor()
    if monitor is not None:
        monitor.note_version(version)
    if watch:
        server.enable_hot_swap(loader, root=root, name=name, poll_s=poll_s)
    return server
