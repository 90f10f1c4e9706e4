"""Typed event bus — the port's copy of
``mmlspark_tpu/observability/events.py``.

Every subsystem posts typed events (:class:`StageStarted` ..
:class:`PoisonClientReleased`, the reference's classes with the same
fields, so a log written by either package replays in the other);
:class:`EventBus` publishes them synchronously to its listeners (a listener
that raises is logged, never propagated); :class:`EventLogSink` appends
each event as one JSON line, and ``MMLSPARK_TPU_EVENT_LOG=/path`` attaches
it to the process-global bus (``MMLSPARK_TPU_EVENT_LOG_PROCESS`` names a
child process's sibling log); :func:`replay` reads a log, rotated segments
first, back into events; :func:`collect`, :func:`merge` and
:func:`write_merged` fold a driver's log and its children's siblings into
one stream (byte for byte the reference's merge of the same segments), and
:func:`timeline` / :func:`format_timeline` summarize a stream as the
reference's history view does.

Publishing is near-free when nobody listens: call sites guard on
``bus.active``, so a quiet run does not even build the event.
"""

from __future__ import annotations

import dataclasses
import json
import threading
import time
from typing import Any, Callable, Dict, IO, Iterable, List, Optional, Type

from mmlspark_tpu_torch.core.profiling import get_logger

logger = get_logger("mmlspark_tpu_torch.observability")

_EVENT_TYPES: Dict[str, Type["Event"]] = {}


def _event(cls):
    """Register an event dataclass in the replay registry."""
    cls = dataclasses.dataclass(cls)
    _EVENT_TYPES[cls.__name__] = cls
    return cls


@dataclasses.dataclass
class Event:
    """Base event: ``t`` is ``time.monotonic()`` at publish (durations and
    ordering within one process; wall-clock does not survive NTP steps)."""

    t: float = dataclasses.field(default=0.0, kw_only=True)

    def __post_init__(self) -> None:
        if not self.t:
            self.t = time.monotonic()

    def to_record(self) -> Dict[str, Any]:
        rec: Dict[str, Any] = {"event": type(self).__name__}
        rec.update(dataclasses.asdict(self))
        return rec


# -- pipeline ----------------------------------------------------------------


@_event
class StageStarted(Event):
    """``Pipeline.fit``/``transform`` entered a stage (SparkListenerStageSubmitted)."""

    job_id: int
    stage_id: int
    name: str
    phase: str = "fit"  # "fit" | "transform"


@_event
class StageCompleted(Event):
    """A stage finished (SparkListenerStageCompleted); ``status`` is "ok" or
    the exception class name."""

    job_id: int
    stage_id: int
    name: str
    duration: float
    phase: str = "fit"
    status: str = "ok"


# -- runtime scheduler -------------------------------------------------------


@_event
class TaskDispatched(Event):
    """The scheduler handed an attempt to the executor pool."""

    job_id: int
    task_id: int
    attempt: int
    queue_depth: int


@_event
class TaskRetried(Event):
    """An attempt failed within the retry budget; the task was re-queued."""

    job_id: int
    task_id: int
    failures: int
    reason: str


@_event
class TaskFailed(Event):
    """An attempt failed; ``permanent`` marks retry-budget exhaustion.
    ``worker``/``duration``/``speculative`` carry the structured attempt
    record (worker -1 = the attempt never reached a worker)."""

    job_id: int
    task_id: int
    reason: str
    permanent: bool = False
    worker: int = -1
    duration: float = 0.0
    speculative: bool = False
    attempt: int = 0


@_event
class TaskSpeculated(Event):
    """The scheduler launched a speculative duplicate of a running task
    whose age exceeded ``speculation_multiplier`` x the median run time
    (the ``spark.speculation`` re-launch)."""

    job_id: int
    task_id: int
    original_worker: int
    age: float
    median: float


@_event
class TaskRecovered(Event):
    """A task's result was restored from a journal checkpoint at job
    start — no dispatch, zero re-execution (RDD checkpoint recovery)."""

    job_id: int
    task_id: int


@_event
class WorkerQuarantined(Event):
    """The health tracker took a worker out of the dispatch pool after
    its rolling failure/straggle score crossed the threshold (the
    BlacklistTracker exclusion)."""

    worker: int
    score: float
    parole_s: float


@_event
class WorkerParoled(Event):
    """A quarantined worker's parole elapsed; it rejoins the pool with a
    clean history."""

    worker: int


# -- process group -----------------------------------------------------------


@_event
class ProcessStarted(Event):
    """The process-group supervisor spawned (or respawned) a member
    process for gang ``epoch`` (executor registration in the driver's
    worker-list rendezvous)."""

    member: int
    pid: int
    epoch: int


@_event
class ProcessLost(Event):
    """A member process died or went silent mid-epoch; ``reason`` is
    ``"exit:<code>"``, ``"signal:<sig>"`` or ``"heartbeat"`` (executor
    lost, the SparkListenerExecutorRemoved analogue)."""

    member: int
    pid: int
    reason: str
    epoch: int


@_event
class GroupReformed(Event):
    """Gang recovery completed: the group re-rendezvoused for ``epoch``
    with ``members`` live processes after losing ``lost``."""

    epoch: int
    members: int
    lost: int


@_event
class NetworkPartitioned(Event):
    """An epoch revoked with every process alive — a partitioned, lossy,
    or silent link stalled the collective past its io deadline. The
    supervisor resolved the gang's blame votes to ``member`` (the peer
    it killed so recovery can use the normal loss path); ``reason``
    concatenates each reporter's revocation message. Every onset must be
    followed by a ``GroupReformed`` recovery record
    (``check_eventlog.py --partition``)."""

    member: int
    epoch: int
    reason: str = ""


@_event
class PeerSlow(Event):
    """The collective's soft straggler detector: a round that succeeded
    but made a member wait at least the slow-peer threshold for
    ``member``'s frame. Booked as a health straggle, so a chronically
    slow peer is quarantined out of the next re-formation."""

    member: int
    epoch: int
    wait_s: float


# -- serving -----------------------------------------------------------------


@_event
class BatchFormed(Event):
    """The micro-batch loop gathered one batch (epoch = batch id)."""

    epoch: int
    size: int
    trace_id: str = ""


@_event
class RequestServed(Event):
    """One HTTP request was answered (status 499 = client disconnected
    before the reply could be written)."""

    rid: str
    status: int
    latency: float
    trace_id: str = ""


@_event
class ModelCommitted(Event):
    """A fitted model became current (end of ``fit`` / model swap)."""

    model: str
    version: int = 0
    detail: str = ""


# -- many-models sweep plane -------------------------------------------------


@_event
class SweepStarted(Event):
    """A hyperparameter sweep began: ``candidates`` param maps partitioned
    into ``buckets`` shape-buckets (each bucket = one compiled program).
    ``mode`` is "inline" or "gang" (ProcessGroup-sharded buckets)."""

    candidates: int
    buckets: int
    estimator: str = ""
    mode: str = "inline"


@_event
class CandidateBatchFitted(Event):
    """One shape-bucket finished fitting: ``size`` candidates trained in
    one vmapped program when ``batched`` (a singleton / non-batchable
    bucket fell back to the sequential fit)."""

    bucket: int
    size: int
    kind: str = ""
    batched: bool = True
    seconds: float = 0.0


@_event
class SweepCompleted(Event):
    """The sweep selected its best candidate (``best_index`` into the
    candidate list) and, when a checkpoint dir is configured, committed
    the refit best model as ModelStore ``version``."""

    candidates: int
    best_index: int
    best_metric: float
    version: int = -1
    seconds: float = 0.0


# -- serving fleet -----------------------------------------------------------


@_event
class FleetScaled(Event):
    """The autoscaler changed the fleet size: ``direction`` is "up" or
    "down", ``replicas`` the fleet size AFTER the action, ``replica`` the
    spawned/retired index, ``reason`` the signal that drove the decision
    (e.g. ``"inflight 9.5 > 8.0"``)."""

    direction: str
    replicas: int
    replica: int = -1
    reason: str = ""


@_event
class RequestRouted(Event):
    """The front-end router answered one request: ``replica`` is the
    endpoint that produced the final answer, ``hops`` the number of
    replica attempts it took (1 = first try; >1 means failovers the
    client never saw). ``trace_id`` is the id the router returned in
    ``X-Trace-Id`` — a user-quoted incident id joins directly against
    the event log."""

    rid: str
    replica: str
    hops: int
    status: int
    latency: float
    trace_id: str = ""


@_event
class RegistryUnavailable(Event):
    """A registry consumer (``source`` = "router" / "controller" /
    "replica") could not reach ``/services`` or heartbeat the
    :class:`RegistrationService`. Routers and controllers keep serving
    from their last-known-good table (``stale_replicas`` entries,
    stamped stale); replicas fall back to jittered re-registration.
    Published once per outage onset, not per failed poll."""

    source: str
    error: str
    stale_replicas: int = 0


@_event
class RegistryRecovered(Event):
    """The paired recovery for :class:`RegistryUnavailable`: the same
    consumer (``source``) reached the registry again and its routing
    table / heartbeat / steering snapshot is fresh. Published once per
    outage end, so the event log carries both edges of every registry
    outage and duration can be audited offline."""

    source: str
    replicas: int = 0


@_event
class LeaseRecovered(Event):
    """A restarted :class:`RegistrationService` recovered one journaled
    replica lease from disk (CRC-verified, ``age_s`` since it was
    journaled) — the fleet re-appears without any replica re-registering
    from scratch."""

    name: str
    url: str
    age_s: float = 0.0


# -- streaming ---------------------------------------------------------------


@_event
class StreamEpochStarted(Event):
    """The micro-batch engine planned epoch ``epoch`` over source offsets
    ``[start, end)`` and durably logged the plan (the offset-WAL write —
    Spark's ``StreamingQueryListener.QueryProgressEvent`` start edge)."""

    query: str
    epoch: int
    start: int
    end: int


@_event
class StreamSourceAdvanced(Event):
    """A source exposed new offsets that epoch planning consumed;
    ``units`` is the manifest length (files / blocks in the batch)."""

    query: str
    start: int
    end: int
    units: int = 0


@_event
class StreamEpochCommitted(Event):
    """Epoch ``epoch`` ran the sink and wrote its commit-log entry —
    the exactly-once boundary; a restart never re-plans this epoch."""

    query: str
    epoch: int
    rows: int
    duration: float = 0.0


@_event
class ModelSwapped(Event):
    """A serving listener hot-swapped its live model to ModelStore
    version ``version`` between requests — zero downtime, no restart."""

    name: str
    version: int
    server: str = ""


# -- profiler ----------------------------------------------------------------


@_event
class ProfileCompiled(Event):
    """The :class:`~mmlspark_tpu_torch.observability.profiler.DeviceProfiler`
    saw a wrapped function called with an unseen shape/dtype signature
    (the reference's executable-cache miss; a kernel's first launch also
    builds or loads it). ``seconds`` is the host wall time of that call;
    ``flops``/``bytes_accessed`` are the caller-supplied cost of one call
    (the reference's XLA ``cost_analysis()``), 0.0 when none was given."""

    name: str
    seconds: float
    flops: float = 0.0
    bytes_accessed: float = 0.0
    signature: str = ""


@_event
class ProfileExecuted(Event):
    """One profiled execution window: call through ``block_until_ready``
    on every output, against a warm executable cache."""

    name: str
    seconds: float


# -- gbdt histogram engine ---------------------------------------------------


@_event
class HistogramChunked(Event):
    """A GBDT fit's precomputed-U one-hot exceeded ``MMLSPARK_TPU_U_BUDGET``
    and the histogram pass was row-chunked instead of abandoning the MXU
    path (``lightgbm/train.py``): each pass streams ``num_chunks`` chunks
    of ``chunk_rows`` rows, rebuilding the chunk's one-hot in-trace and
    accumulating partial histograms. ``acc_dtype`` is the scan carry's
    accumulator dtype (narrow int on the quantized path) and
    ``bytes_saved`` the carry bytes that narrowing saved vs f32 — both
    recorded so incident bundles can tell this PLANNED optimization apart
    from the ``runtime/pressure.py`` degradation ladder's emergency
    re-chunking (``HistogramDegraded``)."""

    rows: int
    k_packed: int
    chunk_rows: int
    num_chunks: int
    budget_bytes: int
    acc_dtype: str = "float32"
    bytes_saved: int = 0


@_event
class HistogramSubtracted(Event):
    """A GBDT fit selected sibling histogram subtraction
    (``lightgbm/train.py``): each split's histogram pass builds only the
    SMALLER child and derives the sibling as parent - smaller, in packed
    (pre-EFB-expansion) space. ``children_per_split`` is 1 (vs 2 without
    subtraction), ``acc_dtype`` the cache/pass accumulator dtype (narrow
    int on the quantized path, where subtraction is integer-exact),
    ``cache_bytes`` the resident per-class leaf-histogram cache, and
    ``bytes_saved_per_tree`` the histogram-build bytes one tree avoids —
    the planned-optimization counterpart of ``HistogramDegraded``."""

    rows: int
    num_leaves: int
    packed_columns: int
    packed_bins: int
    acc_dtype: str
    cache_bytes: int
    bytes_saved_per_tree: int
    children_per_split: int = 1


@_event
class HistogramDegraded(Event):
    """A GBDT histogram launch hit ``RESOURCE_EXHAUSTED`` and the train
    loop stepped down the degradation ladder (halve the U budget ->
    chunked-U -> smaller leaf batch) before retrying the SAME iteration
    (``lightgbm/train.py``). ``stage`` is the dispatch path ("scan" or
    "loop"), ``retries`` the OOM retry count at this iteration, and the
    model text stays byte-identical to an undisturbed run."""

    rows: int
    budget_bytes: int
    chunk_rows: int
    stage: str
    iteration: int = 0
    retries: int = 1
    detail: str = ""


@_event
class FeatureBundled(Event):
    """Exclusive Feature Bundling fitted at binning time
    (``lightgbm/bundling.py``): ``k_before``/``k_after`` are Σ per-feature
    bin widths before/after packing — the HBM re-stream every histogram
    pass pays — and ``conflicts`` counts sampled rows where two bundled
    members were simultaneously non-default (bounded by
    ``max_conflict_rate`` x sample)."""

    num_features: int
    num_columns: int
    k_before: int
    k_after: int
    conflicts: int
    sample_rows: int


# -- tracing -----------------------------------------------------------------


@_event
class SpanRecorded(Event):
    """One finished tracer span, mirrored onto the bus so the event log
    carries the span stream (the history server's cross-process trace
    waterfall is rebuilt from these). ``parent_id`` is either a bare
    span id (same process) or ``<process>:<span_id>`` for a parent that
    lives across a wire hop; ``wall_start`` is ``time.time()`` at span
    start, the only clock comparable across processes."""

    name: str
    trace_id: str
    span_id: str
    parent_id: str = ""
    start: float = 0.0
    duration: float = 0.0
    wall_start: float = 0.0
    status: str = "ok"
    tags: Dict[str, Any] = dataclasses.field(default_factory=dict)


# -- incidents ---------------------------------------------------------------


@_event
class IncidentRecorded(Event):
    """The flight recorder dumped an incident bundle: ``trigger`` names
    the tripwire (``breaker_tripped`` / ``gang_failed`` / ``slo_budget``
    / ``worker_quarantined``), ``path`` the bundle directory, ``events``
    how many ring-buffer events it captured, ``trace_id`` the offending
    trace when one was known."""

    incident_id: str
    trigger: str
    path: str
    events: int = 0
    trace_id: str = ""
    detail: str = ""


@_event
class IncidentSkipped(Event):
    """The flight recorder hit a failure (ENOSPC, permissions) while
    dumping a bundle and dropped it instead of raising mid-incident —
    the observability plane must never make an outage worse."""

    trigger: str
    reason: str
    incident_id: str = ""


# -- resource pressure -------------------------------------------------------


@_event
class MemoryPressure(Event):
    """The resource watchdog (or an in-loop OOM catch) observed memory
    pressure: ``source`` is "hbm:<device>", "host", or "device" (an
    in-loop RESOURCE_EXHAUSTED); ``level`` is "warn"/"critical" at onset
    and "ok" on recovery, so every onset pairs with either a degradation
    event or a later "ok" record (``check_eventlog.py --pressure``)."""

    source: str
    level: str
    used_bytes: float
    limit_bytes: float
    detail: str = ""


@_event
class DiskPressure(Event):
    """Free space on a durable volume (checkpoint dir, event-log dir)
    crossed a watchdog threshold; ``level`` is "warn"/"critical" at
    onset and "ok" on recovery."""

    path: str
    level: str
    free_bytes: float
    total_bytes: float


# -- model quality -----------------------------------------------------------


@_event
class DriftDetected(Event):
    """A live-traffic drift statistic for one feature (or the score
    column) crossed its threshold against the served version's reference
    profile. Every onset pairs with a later :class:`DriftCleared` for the
    same feature once the rolling window recovers
    (``check_eventlog.py --quality``)."""

    feature: str
    stat: str  # "psi" | "ks"
    value: float
    threshold: float
    model: str = ""
    version: int = 0


@_event
class DriftCleared(Event):
    """The drift statistic for ``feature`` fell back under threshold —
    the recovery edge of :class:`DriftDetected`."""

    feature: str
    stat: str
    value: float
    threshold: float
    model: str = ""
    version: int = 0


@_event
class AlertFired(Event):
    """The multi-window burn-rate evaluator fired: the SLO named by
    ``alert`` is burning its error budget faster than ``threshold``x in
    BOTH windows. Pairs with a later :class:`AlertResolved` once the
    short window recovers."""

    alert: str  # "availability" | "latency"
    slo: str  # the judged objective, e.g. "p99<=50ms"
    burn_short: float
    burn_long: float
    window_short_s: float
    window_long_s: float
    threshold: float = 1.0
    detail: str = ""


@_event
class AlertResolved(Event):
    """The short-window burn rate for ``alert`` dropped back under
    threshold — the recovery edge of :class:`AlertFired`."""

    alert: str
    slo: str
    burn_short: float
    burn_long: float
    window_short_s: float
    window_long_s: float
    threshold: float = 1.0
    detail: str = ""


# -- resilience --------------------------------------------------------------


@_event
class BreakerTripped(Event):
    """A circuit breaker transitioned closed -> open: ``failures``
    failures inside ``window_s`` seconds (docs/resilience.md)."""

    breaker: str
    failures: int
    window_s: float


@_event
class RequestShed(Event):
    """Admission control rejected a request with 429 + Retry-After
    instead of queueing it (``reason`` names the exceeded bound)."""

    reason: str
    queue_depth: int
    retry_after: float = 0.0
    rid: str = ""


# -- dataguard ---------------------------------------------------------------


@_event
class RecordsDeadLettered(Event):
    """A read under ``mode=permissive`` (or a ``drop``-policy fit guard)
    quarantined ``count`` corrupt records into the dead-letter store for
    ``source`` under ``epoch``. Exactly one event per committed epoch —
    a replayed streaming epoch finds its DLQ manifest already present
    and publishes nothing (``check_eventlog.py --dataguard`` enforces
    the no-duplicate invariant)."""

    source: str
    epoch: int
    count: int
    reasons: str = ""


@_event
class PoisonClientBlocked(Event):
    """The per-client malformed-rate breaker tripped: ``client`` sent
    ``malformed`` malformed requests inside ``window_s`` seconds and is
    now shed with 429s. Pairs with a later :class:`PoisonClientReleased`."""

    client: str
    malformed: int
    window_s: float


@_event
class PoisonClientReleased(Event):
    """The poison breaker released ``client`` after ``blocked_s`` seconds
    — the recovery edge of :class:`PoisonClientBlocked`."""

    client: str
    blocked_s: float


# -- bus ---------------------------------------------------------------------


class EventBus:
    """Synchronous typed event bus (the ListenerBus analogue).

    Listeners are plain callables ``listener(event)``. ``publish`` runs
    them in registration order on the publishing thread; a listener that
    raises is logged at DEBUG and skipped — observability must never fail
    the observed workload.
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._listeners: List[Callable[[Event], None]] = []

    @property
    def active(self) -> bool:
        """True when at least one listener is attached. Hot call sites
        guard event construction on this, so a quiet bus costs one
        attribute read."""
        return bool(self._listeners)

    def add_listener(self, listener: Callable[[Event], None]) -> None:
        with self._lock:
            if listener not in self._listeners:
                self._listeners = self._listeners + [listener]

    def remove_listener(self, listener: Callable[[Event], None]) -> None:
        # equality, not identity: a bound method (``obj.method``) is a new
        # object on every attribute access, but compares == to itself
        with self._lock:
            self._listeners = [l for l in self._listeners if l != listener]

    def publish(self, event: Event) -> None:
        for listener in self._listeners:  # snapshot semantics: list is replaced, not mutated
            try:
                listener(event)
            except Exception as e:  # noqa: BLE001 - listeners must not break the workload
                logger.debug("event listener %r failed: %s", listener, e)


#: process label pattern for per-process log suffixing; dots are excluded
#: so rotation suffixes (``.<seq>``) stay unambiguous
_PROCESS_SEP = "@"


def process_label() -> str:
    """This process's label in the federated event log: the value of
    ``MMLSPARK_TPU_EVENT_LOG_PROCESS`` (set by the spawner — replica
    supervisor, process group), or ``"driver"`` for the root process."""
    import os

    return os.environ.get("MMLSPARK_TPU_EVENT_LOG_PROCESS") or "driver"


def process_log_path(path: str, process: str) -> str:
    """The per-process event-log path for ``process`` under the shared
    base ``path``: ``<path>@<process>``. The base path itself belongs to
    the driver. Labels must not contain ``.``/``@``/path separators —
    rotation appends ``.<seq>`` and :func:`collect` parses it back off."""
    if any(c in process for c in (".", _PROCESS_SEP, "/", "\\")):
        raise ValueError(f"invalid process label {process!r}")
    return f"{path}{_PROCESS_SEP}{process}"


class EventLogSink:
    """JSON-lines event log: one ``{"event": <type>, ...}`` object per
    line, appended and flushed per event so a crash loses at most the
    in-flight record (the Spark event-log posture).

    The log is size-bounded (``spark.eventLog.rolling``): when a write
    would push the live file past ``max_bytes`` (default from
    ``MMLSPARK_TPU_EVENT_LOG_MAX_BYTES``; 0/unset = unbounded), the file
    rotates to ``<path>.<seq>`` with a monotonically increasing ``seq``
    and a fresh live file opens — a streaming/serving chaos run can no
    longer grow one file without limit. :func:`replay` reads the rotated
    segments oldest-first, then the live file, so the fold is unchanged.

    Every record is stamped with ``process`` (this process's federation
    label) and ``wt`` (``time.time()`` — the only clock comparable
    across processes); :func:`merge` orders the fleet stream by it.
    """

    def __init__(
        self,
        path: str,
        max_bytes: Optional[int] = None,
        process: Optional[str] = None,
    ):
        import os

        if max_bytes is None:
            max_bytes = int(
                os.environ.get("MMLSPARK_TPU_EVENT_LOG_MAX_BYTES", 0)
            ) or None
        self.path = path
        self.max_bytes = max_bytes
        self.process = process if process is not None else process_label()
        self._lock = threading.Lock()
        existing = [seq for seq, _ in _numbered_segments(path)]
        self._seq = max(existing) + 1 if existing else 1
        self._fh: Optional[IO[str]] = open(path, "a", encoding="utf-8")
        self._size = self._fh.tell()
        #: ENOSPC posture: failed writes are counted and dropped, never
        #: raised — losing event records must not fail the workload
        self.write_errors = 0
        self._warned_write_error = False

    def __call__(self, event: Event) -> None:
        rec = event.to_record()
        rec.setdefault("process", self.process)
        rec.setdefault("wt", time.time())
        line = json.dumps(rec) + "\n"
        with self._lock:
            if self._fh is None:
                return
            try:
                from mmlspark_tpu_torch.runtime.faults import check_write

                check_write(self.path)
                # rotate BEFORE the write so a segment never exceeds the
                # bound; an empty live file always accepts (one oversized
                # event must not rotate forever)
                if (
                    self.max_bytes
                    and self._size
                    and self._size + len(line) > self.max_bytes
                ):
                    self._rotate()
                self._fh.write(line)
                self._fh.flush()
                self._size += len(line)
            except OSError as e:
                self.write_errors += 1
                self._count_write_error()
                if not self._warned_write_error:
                    self._warned_write_error = True
                    logger.warning(
                        "event log %s write failed (%s); dropping records "
                        "(counted in eventlog_write_errors_total)",
                        self.path, e,
                    )

    def _count_write_error(self) -> None:
        try:
            from mmlspark_tpu_torch.observability.registry import get_registry

            get_registry().counter(
                "eventlog_write_errors_total",
                "Event-log records dropped because the write/rotation failed",
            ).inc()
        except Exception:  # noqa: BLE001 - metrics must not break the drop path
            pass

    def _rotate(self) -> None:
        """Close the live file and shelve it as the next numbered
        segment (caller holds ``_lock``)."""
        import os

        assert self._fh is not None
        self._fh.close()
        os.replace(self.path, f"{self.path}.{self._seq}")
        self._seq += 1
        self._fh = open(self.path, "a", encoding="utf-8")
        self._size = 0

    def close(self) -> None:
        with self._lock:
            if self._fh is not None:
                self._fh.close()
                self._fh = None


# -- process-global bus + env-driven sink ------------------------------------

_BUS = EventBus()
_ENV_SINK: Optional[EventLogSink] = None
_ENV_LOCK = threading.Lock()


def get_bus() -> EventBus:
    """The process-global bus. Each call re-syncs the env-driven sink:
    setting ``MMLSPARK_TPU_EVENT_LOG=/path`` before a component grabs the
    bus attaches the JSON-lines sink; unsetting it detaches. A child
    process additionally carrying ``MMLSPARK_TPU_EVENT_LOG_PROCESS=<label>``
    (set by its spawner) writes to the per-process sibling
    ``/path@<label>`` instead — two processes inheriting the same base
    path no longer clobber each other's live file and rotation sequence."""
    _sync_env_sink()
    return _BUS


def _sync_env_sink() -> None:
    global _ENV_SINK
    import os

    path = os.environ.get("MMLSPARK_TPU_EVENT_LOG")
    label = os.environ.get("MMLSPARK_TPU_EVENT_LOG_PROCESS") or "driver"
    if path and label != "driver":
        try:
            effective: Optional[str] = process_log_path(path, label)
        except ValueError:
            logger.warning(
                "MMLSPARK_TPU_EVENT_LOG_PROCESS=%s invalid; logging as driver",
                label,
            )
            effective, label = path, "driver"
    else:
        effective = path
    current = _ENV_SINK.path if _ENV_SINK is not None else None
    if effective == current:
        return
    with _ENV_LOCK:
        if _ENV_SINK is not None:
            _BUS.remove_listener(_ENV_SINK)
            _ENV_SINK.close()
            _ENV_SINK = None
        if effective:
            try:
                _ENV_SINK = EventLogSink(effective, process=label)
            except OSError as e:
                logger.warning("MMLSPARK_TPU_EVENT_LOG=%s unusable: %s", path, e)
                return
            _BUS.add_listener(_ENV_SINK)


# -- replay + timeline -------------------------------------------------------


def from_record(rec: Dict[str, Any]) -> Event:
    """Rebuild a typed event from one decoded JSON-lines record."""
    kind = rec.get("event")
    cls = _EVENT_TYPES.get(kind or "")
    if cls is None:
        raise ValueError(f"unknown event type {kind!r}")
    fields = {f.name for f in dataclasses.fields(cls)}
    return cls(**{k: v for k, v in rec.items() if k in fields})


def _numbered_segments(path: str) -> List[tuple]:
    """(seq, segment_path) pairs for the rotated segments of ``path``,
    unsorted; ``<path>.<digits>`` only, so unrelated siblings never
    count."""
    import glob
    import os

    out = []
    for p in glob.glob(glob.escape(path) + ".*"):
        suffix = p[len(path) + 1:]
        if suffix.isdigit() and os.path.isfile(p):
            out.append((int(suffix), p))
    return out


def log_segments(path: str) -> List[str]:
    """Every file of a (possibly rotated) event log in write order:
    numbered segments oldest-first, then the live file."""
    import os

    out = [p for _, p in sorted(_numbered_segments(path))]
    if os.path.exists(path) or not out:
        out.append(path)
    return out


def _stamp(ev: Event, rec: Dict[str, Any], process: str = "") -> Event:
    """Carry the sink-level federation stamps (``process``, ``wt``)
    through to the typed event as plain attributes — they are not
    dataclass fields, so single-process records and equality semantics
    are untouched."""
    ev.process = rec.get("process") or process  # type: ignore[attr-defined]
    ev.wt = float(rec.get("wt") or 0.0)  # type: ignore[attr-defined]
    return ev


def replay(path: str) -> List[Event]:
    """Read an event log back into typed events (skips blank lines).
    Rotated segments (``<path>.1``, ``<path>.2``, ...) are read in
    order before the live file, so a size-bounded log replays whole.
    Records carrying federation stamps (``process``/``wt``) surface them
    as event attributes, so replaying a merged fleet log keeps the
    process tags."""
    out: List[Event] = []
    for segment in log_segments(path):
        with open(segment, "r", encoding="utf-8") as fh:
            for line in fh:
                line = line.strip()
                if line:
                    rec = json.loads(line)
                    out.append(_stamp(from_record(rec), rec))
    return out


# -- fleet federation --------------------------------------------------------


def collect(path: str) -> Dict[str, List[str]]:
    """Discover every process's segments of a federated event log rooted
    at ``path``: the driver's own (possibly rotated) log plus every
    per-process sibling ``<path>@<label>`` written by child processes.
    Returns ``{label: [segment, ...]}`` in write order per process."""
    import glob
    import os

    out: Dict[str, List[str]] = {}
    if os.path.exists(path) or _numbered_segments(path):
        out["driver"] = log_segments(path)
    labels = set()
    for p in glob.glob(glob.escape(path) + _PROCESS_SEP + "*"):
        suffix = p[len(path) + 1:]
        # strip a rotation suffix (".<digits>") back off the live name
        stem, dot, tail = suffix.rpartition(".")
        if dot and tail.isdigit():
            suffix = stem
        if suffix:
            labels.add(suffix)
    for label in sorted(labels):
        out[label] = log_segments(process_log_path(path, label))
    return out


def _merged_records(path: str) -> List[Dict[str, Any]]:
    """Every process's records folded into one timestamp-ordered stream.
    Order is deterministic for a fixed set of files: sorted by the
    wall-clock stamp, ties broken by (process label, in-process order) —
    re-merging the same segments is byte-identical."""
    keyed: List[tuple] = []
    for process, segments in collect(path).items():
        idx = 0
        for segment in segments:
            with open(segment, "r", encoding="utf-8") as fh:
                for line in fh:
                    line = line.strip()
                    if not line:
                        continue
                    rec = json.loads(line)
                    rec.setdefault("process", process)
                    keyed.append(
                        (float(rec.get("wt") or 0.0), process, idx, rec)
                    )
                    idx += 1
    keyed.sort(key=lambda item: item[:3])
    return [rec for _, _, _, rec in keyed]


def merge(path: str) -> List[Event]:
    """The federated replay: fold every process's segments (see
    :func:`collect`) into one timestamp-ordered, process-tagged event
    stream. Each event carries ``.process`` and ``.wt`` attributes;
    :func:`timeline`, the reference's SLO report
    and history server consume the stream unchanged."""
    return [
        _stamp(from_record(rec), rec, process=rec.get("process", ""))
        for rec in _merged_records(path)
    ]


def write_merged(path: str, out_path: str) -> int:
    """Materialize the merged fleet stream as one JSON-lines file (the
    artifact CI validates and the history server renders); returns the
    record count. The write is atomic (tmp + ``os.replace``)."""
    import os

    records = _merged_records(path)
    tmp = f"{out_path}.tmp-{os.getpid()}"
    with open(tmp, "w", encoding="utf-8") as fh:
        for rec in records:
            fh.write(json.dumps(rec) + "\n")
    os.replace(tmp, out_path)
    return len(records)


def timeline(events: Iterable[Event]) -> Dict[str, Any]:
    """Fold an event stream into the summary the Spark UI would draw:
    per-stage wall times, task dispatch/retry/failure counts, serving
    batch/request stats, committed models."""
    stages: Dict[Any, Dict[str, Any]] = {}
    tasks = {
        "dispatched": 0, "retried": 0, "failed": 0, "failed_permanent": 0,
        "speculated": 0, "recovered": 0,
    }
    retry_reasons: Dict[str, int] = {}
    #: per-task structured attempt history folded from TaskFailed events
    attempts: Dict[int, List[Dict[str, Any]]] = {}
    quarantines: Dict[int, int] = {}
    paroles = 0
    processes = {"started": 0, "lost": 0, "reformed": 0}
    loss_reasons: Dict[str, int] = {}
    batches = {"count": 0, "rows": 0}
    latencies: List[float] = []
    statuses: Dict[int, int] = {}
    models: List[str] = []
    shed = 0
    breaker_trips: Dict[str, int] = {}
    streaming = {"epochs": 0, "rows": 0, "source_units": 0}
    stream_epochs: Dict[str, List[int]] = {}
    swaps: List[Dict[str, Any]] = []
    fleet: List[Dict[str, Any]] = []
    routing = {"count": 0, "hops": 0, "failovers": 0}
    routed_statuses: Dict[int, int] = {}
    routed_by_replica: Dict[str, int] = {}
    #: per-function compile/execute fold from Profile* events
    profiler: Dict[str, Dict[str, Any]] = {}
    incidents: List[Dict[str, Any]] = []
    incidents_skipped = 0
    pressure: List[Dict[str, Any]] = []
    degradations: List[Dict[str, Any]] = []
    #: PLANNED histogram-engine optimizations (subtraction / chunking) —
    #: kept separate from `degradations` so incident bundles distinguish
    #: a configured byte-saving path from an emergency pressure response
    hist_optimizations: List[Dict[str, Any]] = []
    #: drift onsets/clears per feature (the model-quality plane)
    quality = {"detected": 0, "cleared": 0}
    drift_features: Dict[str, Dict[str, int]] = {}
    #: burn-rate alert history, in stream order
    alerts = {"fired": 0, "resolved": 0}
    alert_history: List[Dict[str, Any]] = []
    #: events per federation process label ("" = untagged single-process log)
    by_process: Dict[str, int] = {}
    for ev in events:
        proc = getattr(ev, "process", "")
        if proc:
            by_process[proc] = by_process.get(proc, 0) + 1
        if isinstance(ev, StageStarted):
            stages.setdefault(
                (ev.job_id, ev.stage_id, ev.phase),
                {"name": ev.name, "phase": ev.phase, "start": ev.t},
            )
        elif isinstance(ev, StageCompleted):
            rec = stages.setdefault(
                (ev.job_id, ev.stage_id, ev.phase),
                {"name": ev.name, "phase": ev.phase, "start": ev.t - ev.duration},
            )
            rec["duration"] = ev.duration
            rec["status"] = ev.status
        elif isinstance(ev, TaskDispatched):
            tasks["dispatched"] += 1
        elif isinstance(ev, TaskRetried):
            tasks["retried"] += 1
            retry_reasons[ev.reason] = retry_reasons.get(ev.reason, 0) + 1
        elif isinstance(ev, TaskFailed):
            tasks["failed"] += 1
            if ev.permanent:
                tasks["failed_permanent"] += 1
            attempts.setdefault(ev.task_id, []).append({
                "attempt": ev.attempt, "worker": ev.worker,
                "reason": ev.reason, "duration": ev.duration,
                "speculative": ev.speculative, "permanent": ev.permanent,
            })
        elif isinstance(ev, TaskSpeculated):
            tasks["speculated"] += 1
        elif isinstance(ev, TaskRecovered):
            tasks["recovered"] += 1
        elif isinstance(ev, WorkerQuarantined):
            quarantines[ev.worker] = quarantines.get(ev.worker, 0) + 1
        elif isinstance(ev, WorkerParoled):
            paroles += 1
        elif isinstance(ev, ProcessStarted):
            processes["started"] += 1
        elif isinstance(ev, ProcessLost):
            processes["lost"] += 1
            loss_reasons[ev.reason] = loss_reasons.get(ev.reason, 0) + 1
        elif isinstance(ev, GroupReformed):
            processes["reformed"] += 1
        elif isinstance(ev, BatchFormed):
            batches["count"] += 1
            batches["rows"] += ev.size
        elif isinstance(ev, RequestServed):
            latencies.append(ev.latency)
            statuses[ev.status] = statuses.get(ev.status, 0) + 1
        elif isinstance(ev, ModelCommitted):
            models.append(ev.model)
        elif isinstance(ev, StreamSourceAdvanced):
            streaming["source_units"] += ev.units
        elif isinstance(ev, StreamEpochCommitted):
            streaming["epochs"] += 1
            streaming["rows"] += ev.rows
            stream_epochs.setdefault(ev.query, []).append(ev.epoch)
        elif isinstance(ev, ModelSwapped):
            swaps.append({"name": ev.name, "version": ev.version,
                          "server": ev.server})
        elif isinstance(ev, FleetScaled):
            fleet.append({"direction": ev.direction, "replicas": ev.replicas,
                          "replica": ev.replica, "reason": ev.reason,
                          "t": ev.t})
        elif isinstance(ev, RequestRouted):
            routing["count"] += 1
            routing["hops"] += ev.hops
            if ev.hops > 1:
                routing["failovers"] += 1
            routed_statuses[ev.status] = routed_statuses.get(ev.status, 0) + 1
            routed_by_replica[ev.replica] = (
                routed_by_replica.get(ev.replica, 0) + 1
            )
        elif isinstance(ev, RequestShed):
            shed += 1
        elif isinstance(ev, BreakerTripped):
            breaker_trips[ev.breaker] = breaker_trips.get(ev.breaker, 0) + 1
        elif isinstance(ev, IncidentRecorded):
            incidents.append({
                "incident_id": ev.incident_id, "trigger": ev.trigger,
                "path": ev.path, "trace_id": ev.trace_id,
            })
        elif isinstance(ev, IncidentSkipped):
            incidents_skipped += 1
        elif isinstance(ev, MemoryPressure):
            pressure.append({
                "kind": "memory", "source": ev.source, "level": ev.level,
                "t": ev.t,
            })
        elif isinstance(ev, DiskPressure):
            pressure.append({
                "kind": "disk", "source": ev.path, "level": ev.level,
                "t": ev.t,
            })
        elif isinstance(ev, HistogramDegraded):
            degradations.append({
                "iteration": ev.iteration, "stage": ev.stage,
                "budget_bytes": ev.budget_bytes, "chunk_rows": ev.chunk_rows,
                "retries": ev.retries,
            })
        elif isinstance(ev, HistogramSubtracted):
            hist_optimizations.append({
                "kind": "subtraction", "rows": ev.rows,
                "num_leaves": ev.num_leaves, "acc_dtype": ev.acc_dtype,
                "cache_bytes": ev.cache_bytes,
                "bytes_saved_per_tree": ev.bytes_saved_per_tree,
            })
        elif isinstance(ev, HistogramChunked):
            hist_optimizations.append({
                "kind": "chunked", "rows": ev.rows,
                "chunk_rows": ev.chunk_rows, "num_chunks": ev.num_chunks,
                "acc_dtype": ev.acc_dtype, "bytes_saved": ev.bytes_saved,
            })
        elif isinstance(ev, (DriftDetected, DriftCleared)):
            detected = isinstance(ev, DriftDetected)
            quality["detected" if detected else "cleared"] += 1
            rec = drift_features.setdefault(
                ev.feature, {"detected": 0, "cleared": 0}
            )
            rec["detected" if detected else "cleared"] += 1
        elif isinstance(ev, (AlertFired, AlertResolved)):
            fired = isinstance(ev, AlertFired)
            alerts["fired" if fired else "resolved"] += 1
            alert_history.append({
                "alert": ev.alert, "slo": ev.slo,
                "state": "fired" if fired else "resolved",
                "burn_short": ev.burn_short, "burn_long": ev.burn_long,
                "t": ev.t,
            })
        elif isinstance(ev, (ProfileCompiled, ProfileExecuted)):
            rec = profiler.setdefault(ev.name, {
                "compiles": 0, "compile_seconds": 0.0,
                "executions": 0, "device_seconds": 0.0,
                "flops": 0.0, "bytes_accessed": 0.0,
            })
            if isinstance(ev, ProfileCompiled):
                rec["compiles"] += 1
                rec["compile_seconds"] += ev.seconds
                if ev.flops:
                    rec["flops"] = ev.flops
                if ev.bytes_accessed:
                    rec["bytes_accessed"] = ev.bytes_accessed
            else:
                rec["executions"] += 1
                rec["device_seconds"] += ev.seconds
    requests: Dict[str, Any] = {
        "count": len(latencies), "statuses": statuses, "shed": shed,
    }
    if latencies:
        ordered = sorted(latencies)
        requests["latency_p50"] = ordered[len(ordered) // 2]
        requests["latency_max"] = ordered[-1]
    return {
        "stages": [stages[k] for k in sorted(stages)],
        "tasks": dict(tasks, retry_reasons=retry_reasons, attempts=attempts),
        "batches": batches,
        "requests": requests,
        "models": models,
        "streaming": dict(streaming, queries=stream_epochs),
        "swaps": swaps,
        "fleet": fleet,
        "routing": dict(
            routing, statuses=routed_statuses, by_replica=routed_by_replica,
        ),
        "breaker_trips": breaker_trips,
        "quarantines": quarantines,
        "paroles": paroles,
        "processes": dict(processes, loss_reasons=loss_reasons),
        "profiler": profiler,
        "incidents": incidents,
        "incidents_skipped": incidents_skipped,
        "pressure": pressure,
        "degradations": degradations,
        "hist_optimizations": hist_optimizations,
        "quality": dict(quality, features=drift_features),
        "alerts": dict(alerts, history=alert_history),
        "by_process": by_process,
    }


def format_timeline(summary: Dict[str, Any]) -> str:
    """Render a :func:`timeline` summary as the one-screen text report."""
    lines = ["== stages =="]
    for s in summary["stages"]:
        dur = s.get("duration")
        lines.append(
            f"  [{s['phase']}] {s['name']}: "
            + (f"{dur:.4f}s" if dur is not None else "unfinished")
            + (f" ({s['status']})" if s.get("status", "ok") != "ok" else "")
        )
    t = summary["tasks"]
    lines.append(
        f"== tasks == dispatched={t['dispatched']} retried={t['retried']} "
        f"failed={t['failed']} permanent={t['failed_permanent']}"
        + (f" speculated={t['speculated']}" if t.get("speculated") else "")
        + (f" recovered={t['recovered']}" if t.get("recovered") else "")
    )
    # structured per-task attempt history (worker / reason / duration /
    # speculative flag) — the JobFailedError post-mortem view
    for task_id in sorted(t.get("attempts") or {}):
        parts = []
        for a in t["attempts"][task_id]:
            parts.append(
                f"attempt {a['attempt']}"
                + (" (spec)" if a.get("speculative") else "")
                + f" on w{a['worker']} {a['reason']} {a['duration']:.3f}s"
                + (" PERMANENT" if a.get("permanent") else "")
            )
        lines.append(f"   task {task_id}: " + "; ".join(parts))
    procs = summary.get("processes") or {}
    if procs.get("started") or procs.get("lost"):
        line = (
            f"== processes == started={procs.get('started', 0)} "
            f"lost={procs.get('lost', 0)} reformed={procs.get('reformed', 0)}"
        )
        reasons = procs.get("loss_reasons") or {}
        if reasons:
            line += " (" + ", ".join(
                f"{reason} x{n}" for reason, n in sorted(reasons.items())
            ) + ")"
        lines.append(line)
    quarantines = summary.get("quarantines") or {}
    if quarantines:
        lines.append("== quarantine == " + ", ".join(
            f"w{wid} x{n}" for wid, n in sorted(quarantines.items())
        ) + f" paroled={summary.get('paroles', 0)}")
    streaming = summary.get("streaming") or {}
    if streaming.get("epochs"):
        line = (
            f"== streaming == epochs={streaming['epochs']} "
            f"rows={streaming['rows']} "
            f"source_units={streaming.get('source_units', 0)}"
        )
        queries = streaming.get("queries") or {}
        if queries:
            line += " (" + ", ".join(
                f"{q}: epochs {min(eps)}..{max(eps)}"
                for q, eps in sorted(queries.items())
            ) + ")"
        lines.append(line)
    b, r = summary["batches"], summary["requests"]
    lines.append(f"== serving == batches={b['count']} rows={b['rows']} "
                 f"requests={r['count']} shed={r.get('shed', 0)}")
    routing = summary.get("routing") or {}
    if routing.get("count"):
        avg_hops = routing["hops"] / routing["count"]
        lines.append(
            f"== routing == requests={routing['count']} "
            f"failovers={routing['failovers']} avg_hops={avg_hops:.2f}"
            + (" (" + ", ".join(
                f"{name} x{n}"
                for name, n in sorted((routing.get("by_replica") or {}).items())
            ) + ")" if routing.get("by_replica") else "")
        )
    fleet = summary.get("fleet") or []
    if fleet:
        lines.append("== fleet == " + ", ".join(
            f"{f['direction']}->{f['replicas']}"
            + (f" ({f['reason']})" if f.get("reason") else "")
            for f in fleet
        ))
    trips = summary.get("breaker_trips") or {}
    if trips:
        lines.append("== breakers == " + ", ".join(
            f"{name} tripped x{n}" for name, n in sorted(trips.items())
        ))
    incidents = summary.get("incidents") or []
    if incidents:
        lines.append("== incidents == " + ", ".join(
            f"{i['trigger']} ({i['incident_id']})" for i in incidents
        ) + (
            f" skipped={summary['incidents_skipped']}"
            if summary.get("incidents_skipped") else ""
        ))
    pressure = summary.get("pressure") or []
    degradations = summary.get("degradations") or []
    if pressure or degradations:
        onsets = [p for p in pressure if p["level"] != "ok"]
        recoveries = [p for p in pressure if p["level"] == "ok"]
        line = (
            f"== pressure == onsets={len(onsets)} "
            f"recoveries={len(recoveries)} degradations={len(degradations)}"
        )
        if onsets:
            line += " (" + ", ".join(
                f"{p['kind']}:{p['source']} {p['level']}" for p in onsets
            ) + ")"
        lines.append(line)
        for d in degradations:
            lines.append(
                f"   iter {d['iteration']} [{d['stage']}] -> "
                f"budget={d['budget_bytes']} chunk_rows={d['chunk_rows']} "
                f"retry {d['retries']}"
            )
    hist_opts = summary.get("hist_optimizations") or []
    if hist_opts:
        # planned byte-saving paths — NOT the pressure ladder above
        lines.append("== histogram optimizations ==")
        for o in hist_opts:
            if o["kind"] == "subtraction":
                lines.append(
                    f"   subtraction: leaves={o['num_leaves']} "
                    f"acc={o['acc_dtype']} cache={o['cache_bytes']}B "
                    f"saves={o['bytes_saved_per_tree']}B/tree"
                )
            else:
                lines.append(
                    f"   chunked: chunks={o['num_chunks']}x"
                    f"{o['chunk_rows']} acc={o['acc_dtype']} "
                    f"saves={o['bytes_saved']}B"
                )
    quality = summary.get("quality") or {}
    if quality.get("detected") or quality.get("cleared"):
        lines.append(
            f"== quality == drift detected={quality['detected']} "
            f"cleared={quality['cleared']}"
            + (" (" + ", ".join(
                f"{feat} x{c['detected']}"
                for feat, c in sorted((quality.get("features") or {}).items())
                if c["detected"]
            ) + ")" if quality.get("features") else "")
        )
    alerts = summary.get("alerts") or {}
    if alerts.get("fired") or alerts.get("resolved"):
        lines.append(
            f"== alerts == fired={alerts['fired']} "
            f"resolved={alerts['resolved']}"
        )
        for a in alerts.get("history") or []:
            lines.append(
                f"   {a['alert']} [{a['slo']}] {a['state']} "
                f"burn short={a['burn_short']:.2f} long={a['burn_long']:.2f}"
            )
    by_process = summary.get("by_process") or {}
    if by_process:
        lines.append("== fleet log == " + ", ".join(
            f"{proc} x{n}" for proc, n in sorted(by_process.items())
        ))
    if "latency_p50" in r:
        lines.append(
            f"   latency p50={r['latency_p50'] * 1e3:.2f}ms "
            f"max={r['latency_max'] * 1e3:.2f}ms"
        )
    profiler = summary.get("profiler") or {}
    if profiler:
        lines.append("== profiler ==")
        for name in sorted(profiler):
            p = profiler[name]
            parts = []
            if p["compiles"]:
                parts.append(
                    f"compiles={p['compiles']} ({p['compile_seconds']:.3f}s)"
                )
            if p["executions"]:
                avg = p["device_seconds"] / p["executions"]
                parts.append(
                    f"execs={p['executions']} device={p['device_seconds']:.3f}s "
                    f"avg={avg * 1e3:.2f}ms"
                )
            if p.get("flops"):
                parts.append(f"flops={p['flops']:.3g}")
            lines.append(f"   {name}: " + " ".join(parts))
    if summary["models"]:
        lines.append("== models == " + ", ".join(summary["models"]))
    swaps = summary.get("swaps") or []
    if swaps:
        lines.append("== swaps == " + ", ".join(
            f"{s['name']} -> v{s['version']}"
            + (f" @{s['server']}" if s.get("server") else "")
            for s in swaps
        ))
    return "\n".join(lines)
