"""Incident flight recorder — atomic post-mortem bundles on tripwires; the
port's copy of ``mmlspark_tpu/observability/incidents.py``. Its
``federator`` is the port's
:class:`~mmlspark_tpu_torch.observability.federation.MetricsFederator` (or
any object with a ``snapshot()``).

When the fleet misbehaves (a circuit breaker trips, a worker gang
exhausts its epoch budget, a worker is quarantined, the SLO error budget
is breached), the evidence is scattered: the last events live in
per-process log segments, the metrics in each replica's registry, the
trace in the tracer ring, the device profile in the profiler. By the
time someone looks, most of it has rotated away. The
:class:`FlightRecorder` is the black box: it rides the event bus keeping
a bounded ring of recent events, and on a tripwire dumps one **atomic**
bundle directory:

- ``manifest.json`` — incident id, trigger, wall time, trace id, detail;
- ``events.jsonl``  — the last N events **across processes** (the merged
  fleet tail when ``MMLSPARK_TPU_EVENT_LOG`` is set, the in-memory ring
  otherwise);
- ``metrics.json``  — the federated fleet snapshot when a federator is
  attached, else the local registry summary;
- ``trace.json``    — the offending trace's span tree (or the most
  recent finished spans when no trace id is known);
- ``profiler.json`` — the device profiler snapshot when profiling is on;
- ``quality.json``  — the drift table, when the quality plane left one.

Bundles are written to a temp directory and ``os.replace``d into place,
then booked as an :class:`~mmlspark_tpu_torch.observability.events.IncidentRecorded`
event so the history server lists them. A per-trigger cooldown stops an
event storm from writing a thousand identical bundles.

Like the event-log sink, the recorder is env-driven:
``MMLSPARK_TPU_INCIDENT_DIR=/path`` installs a process-global recorder
on first :func:`get_recorder` / :func:`maybe_record` call; subsystems
that raise (the process group's ``GangFailedError`` path) call
:func:`maybe_record` which is a no-op when no recorder is installed.
"""

from __future__ import annotations

import collections
import json
import os
import shutil
import threading
import time
from typing import Any, Dict, List, Optional

from mmlspark_tpu_torch.core.profiling import get_logger
from mmlspark_tpu_torch.observability import events as _events
from mmlspark_tpu_torch.observability.events import (
    BreakerTripped,
    Event,
    IncidentRecorded,
    IncidentSkipped,
    WorkerQuarantined,
)

logger = get_logger("mmlspark_tpu_torch.observability")

#: the tripwire names a bundle's manifest carries
TRIGGERS = (
    "alert_fired",
    "breaker_tripped",
    "drift_detected",
    "gang_failed",
    "slo_budget",
    "worker_quarantined",
)


class FlightRecorder:
    """Bounded event ring + atomic incident bundles (see module doc).

    ``install()`` attaches the recorder to the process-global bus so it
    both fills its ring and auto-records on :class:`BreakerTripped` /
    :class:`WorkerQuarantined`; :meth:`record` is the manual tripwire
    (``gang_failed``, ``slo_budget``). ``clock`` is injectable so tests
    can step the cooldown deterministically."""

    def __init__(
        self,
        directory: str,
        capacity: int = 512,
        cooldown_s: float = 30.0,
        event_log: Optional[str] = None,
        federator: Optional[Any] = None,
        registry: Optional[Any] = None,
        tracer: Optional[Any] = None,
        clock=time.time,
    ):
        self.directory = directory
        self.capacity = int(capacity)
        self.cooldown_s = float(cooldown_s)
        self.event_log = (
            event_log
            if event_log is not None
            else os.environ.get("MMLSPARK_TPU_EVENT_LOG")
        )
        #: optional MetricsFederator — when set, ``metrics.json`` is the
        #: fleet snapshot instead of the local registry summary
        self.federator = federator
        self.registry = registry
        self.tracer = tracer
        self._clock = clock
        self._ring: "collections.deque[Event]" = collections.deque(
            maxlen=self.capacity
        )
        self._lock = threading.Lock()
        self._seq = 0
        self._last_at: Dict[str, float] = {}
        self._asides: List[threading.Thread] = []
        self.recorded: List[str] = []

    # -- bus integration -----------------------------------------------------

    def install(self) -> "FlightRecorder":
        _events.get_bus().add_listener(self._on_event)
        return self

    def uninstall(self) -> None:
        _events.get_bus().remove_listener(self._on_event)

    def _on_event(self, event: Event) -> None:
        if isinstance(event, (IncidentRecorded, IncidentSkipped)):
            return  # our own bookkeeping must not re-trip the recorder
        with self._lock:
            self._ring.append(event)
        if isinstance(event, BreakerTripped):
            self._record_aside(
                "breaker_tripped",
                f"{event.breaker}: {event.failures} failures in {event.window_s}s",
            )
        elif isinstance(event, WorkerQuarantined):
            self._record_aside(
                "worker_quarantined",
                f"worker {event.worker} score {event.score:.2f}",
            )

    def _record_aside(self, trigger: str, detail: str) -> None:
        """Record from a thread of its own: a tripwire published on a
        serving thread (a breaker tripping inside a request) must not hold
        that request while the bundle is assembled; on a busy server the
        bundle took that request past its deadline. The thread is not a
        daemon, so the bundle is written before the process exits;
        :meth:`wait` joins the pending ones."""
        t = threading.Thread(target=self.record, args=(trigger,), kwargs={"detail": detail},
                             name=f"flight-recorder-{trigger}")
        with self._lock:
            self._asides = [a for a in self._asides if a.is_alive()] + [t]
        t.start()

    def wait(self, timeout: Optional[float] = None) -> None:
        """Join the bundles being written aside (tests, orderly shutdown)."""
        with self._lock:
            asides = list(self._asides)
        for t in asides:
            t.join(timeout)

    # -- the tripwire --------------------------------------------------------

    def record(
        self, trigger: str, trace_id: str = "", detail: str = ""
    ) -> Optional[str]:
        """Dump one bundle for ``trigger``; returns the bundle directory,
        or None when the trigger is inside its cooldown. Never raises —
        a flight recorder that crashes the plane is worse than none."""
        now = self._clock()
        with self._lock:
            last = self._last_at.get(trigger)
            if last is not None and now - last < self.cooldown_s:
                return None
            self._last_at[trigger] = now
            self._seq += 1
            seq = self._seq
        incident_id = f"{int(now)}-{trigger}-{seq:03d}"
        try:
            path = self._write_bundle(incident_id, trigger, trace_id, detail, now)
        except Exception as e:  # noqa: BLE001 - see docstring
            logger.warning("incident bundle %s failed: %s", incident_id, e)
            _events.get_bus().publish(IncidentSkipped(
                trigger=trigger,
                reason=str(e)[:200],
                incident_id=incident_id,
            ))
            return None
        self.recorded.append(path)
        _events.get_bus().publish(IncidentRecorded(
            incident_id=incident_id,
            trigger=trigger,
            path=path,
            events=len(self._ring),
            trace_id=trace_id,
            detail=detail,
        ))
        return path

    # -- bundle assembly -----------------------------------------------------

    def _recent_records(self) -> List[Dict[str, Any]]:
        """The last-N-events evidence: the merged fleet tail when an
        event log is federated on disk, the in-memory ring otherwise."""
        log = self.event_log or os.environ.get("MMLSPARK_TPU_EVENT_LOG")
        if log:
            try:
                merged = _events._merged_tail(log, self.capacity)
                if merged:
                    return merged
            except Exception as e:  # noqa: BLE001 - half-written segments
                logger.debug("incident merge failed, using ring: %s", e)
        with self._lock:
            ring = list(self._ring)
        out = []
        for ev in ring:
            rec = ev.to_record()
            rec.setdefault("process", _events.process_label())
            out.append(rec)
        return out

    def _metrics_snapshot(self) -> Dict[str, Any]:
        if self.federator is not None:
            try:
                return self.federator.snapshot()
            except Exception as e:  # noqa: BLE001
                logger.debug("incident fleet snapshot failed: %s", e)
        registry = self.registry
        if registry is None:
            from mmlspark_tpu_torch.observability.registry import get_registry

            registry = get_registry()
        return {"metrics": registry.summary()}

    def _trace_snapshot(self, trace_id: str) -> Dict[str, Any]:
        tracer = self.tracer
        if tracer is None:
            from mmlspark_tpu_torch.observability.tracing import get_tracer

            tracer = get_tracer()
        if trace_id:
            return tracer.span_tree(trace_id)
        return {"trace_id": "", "spans": tracer.export()[-64:]}

    def _write_bundle(
        self,
        incident_id: str,
        trigger: str,
        trace_id: str,
        detail: str,
        now: float,
    ) -> str:
        from mmlspark_tpu_torch.runtime.faults import check_write

        records = self._recent_records()
        final = os.path.join(self.directory, incident_id)
        # injected-ENOSPC gate: a full incident volume skips the bundle
        # (record() books IncidentSkipped) instead of crashing the caller
        check_write(final)
        tmp = os.path.join(self.directory, f".tmp-{incident_id}-{os.getpid()}")
        os.makedirs(tmp, exist_ok=True)
        try:
            with open(os.path.join(tmp, "events.jsonl"), "w",
                      encoding="utf-8") as fh:
                for rec in records:
                    fh.write(json.dumps(rec) + "\n")
            metrics = self._metrics_snapshot()
            with open(os.path.join(tmp, "metrics.json"), "w",
                      encoding="utf-8") as fh:
                json.dump(metrics, fh, indent=2,
                          sort_keys=True, default=str)
            with open(os.path.join(tmp, "trace.json"), "w",
                      encoding="utf-8") as fh:
                json.dump(self._trace_snapshot(trace_id), fh, indent=2,
                          default=str)
            profile = self._profiler_snapshot()
            if profile is not None:
                with open(os.path.join(tmp, "profiler.json"), "w",
                          encoding="utf-8") as fh:
                    json.dump(profile, fh, indent=2, default=str)
            quality = self._quality_snapshot(metrics)
            if quality is not None:
                with open(os.path.join(tmp, "quality.json"), "w",
                          encoding="utf-8") as fh:
                    json.dump(quality, fh, indent=2, sort_keys=True,
                              default=str)
            with open(os.path.join(tmp, "manifest.json"), "w",
                      encoding="utf-8") as fh:
                json.dump({
                    "incident_id": incident_id,
                    "trigger": trigger,
                    "trace_id": trace_id,
                    "detail": detail,
                    "wall_time": now,
                    "process": _events.process_label(),
                    "events": len(records),
                }, fh, indent=2, sort_keys=True)
            os.replace(tmp, final)
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise
        return final

    @staticmethod
    def _profiler_snapshot() -> Optional[Dict[str, Any]]:
        from mmlspark_tpu_torch.observability.profiler import get_profiler

        profiler = get_profiler()
        if not profiler.active:
            return None
        return profiler.snapshot()

    @staticmethod
    def _quality_snapshot(metrics: Dict[str, Any]) -> Optional[Dict[str, Any]]:
        """The drift-table evidence (``quality.json``): the live monitor's
        snapshot when one runs in this process, else the per-feature table
        rebuilt from the (possibly federated) ``metrics.json`` summary;
        None when the quality plane left no trace."""
        from mmlspark_tpu_torch.observability.quality import (
            drift_table_from_summary,
            get_monitor,
        )

        monitor = get_monitor()
        if monitor is not None:
            return monitor.snapshot()
        summary = metrics.get("metrics", {})
        rows = drift_table_from_summary(summary)
        if not rows:
            return None
        return {"drift": rows}


# -- process-global, env-driven recorder --------------------------------------

_RECORDER: Optional[FlightRecorder] = None
_RECORDER_LOCK = threading.Lock()


def get_recorder() -> Optional[FlightRecorder]:
    """The env-driven process-global recorder: setting
    ``MMLSPARK_TPU_INCIDENT_DIR=/path`` installs one (bus-attached) on
    first call; unsetting it uninstalls. Returns None when disabled."""
    global _RECORDER
    directory = os.environ.get("MMLSPARK_TPU_INCIDENT_DIR")
    current = _RECORDER.directory if _RECORDER is not None else None
    if directory == current:
        return _RECORDER
    with _RECORDER_LOCK:
        if _RECORDER is not None:
            _RECORDER.uninstall()
            _RECORDER = None
        if directory:
            try:
                os.makedirs(directory, exist_ok=True)
            except OSError as e:
                logger.warning(
                    "MMLSPARK_TPU_INCIDENT_DIR=%s unusable: %s", directory, e
                )
                return None
            _RECORDER = FlightRecorder(directory).install()
    return _RECORDER


def maybe_record(
    trigger: str, trace_id: str = "", detail: str = ""
) -> Optional[str]:
    """Record an incident iff a recorder is installed — the call
    subsystems make at their own tripwires (``gang_failed``,
    ``slo_budget``) without caring whether anyone is listening."""
    recorder = get_recorder()
    if recorder is None:
        return None
    return recorder.record(trigger, trace_id=trace_id, detail=detail)
