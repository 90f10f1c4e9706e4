"""Scheduler and executor metrics: per-task timings, retry counts, queue depth.

The port's copy of ``mmlspark_tpu/runtime/metrics.py``: an accumulating
object whose ``summary()`` returns a plain dict with the reference's keys
and whose ``log(logger, prefix)`` writes the reference's line. Queue-wait
and run times fold into named phase totals (``summary()["phases"]``), as
the reference's embedded ``StopWatch`` does. Every ``note_*`` also feeds
the process-global
:class:`~mmlspark_tpu_torch.observability.registry.MetricsRegistry`
(counters named ``scheduler_*``, queue-wait/run latency histograms), so a
scrape carries scheduler state; pass an explicit ``registry`` for an
isolated one (its counters equal :meth:`RuntimeMetrics.summary`).
"""

from __future__ import annotations

import collections
import logging
import threading
from typing import Dict, Optional

from mmlspark_tpu_torch.observability.registry import MetricsRegistry, get_registry

_log = logging.getLogger("mmlspark_tpu_torch.runtime")


class RuntimeMetrics:
    """Thread-safe counters and timings for one scheduler (they accumulate
    across jobs when the scheduler is reused)."""

    def __init__(self, registry: Optional[MetricsRegistry] = None) -> None:
        self._lock = threading.Lock()
        #: aggregate "queue_wait" / "run" seconds
        self.phases: Dict[str, float] = {}
        #: task index -> {"queue_wait": s, "run": s, "attempts": n}
        self.task_timings: Dict[int, Dict[str, float]] = {}
        self.retries: "collections.Counter[int]" = collections.Counter()
        self.counters: "collections.Counter[str]" = collections.Counter()
        self.max_queue_depth = 0
        # registry bridge: the same counts, scrapeable
        reg = registry if registry is not None else get_registry()
        self.registry = reg
        self._reg_tasks_done = reg.counter(
            "scheduler_tasks_done_total", "Tasks completed successfully"
        )
        self._reg_dispatches = reg.counter(
            "scheduler_dispatches_total", "Attempts handed to the executor pool"
        )
        self._reg_retries = reg.counter(
            "scheduler_retries_total", "Task re-dispatches after a failure"
        )
        self._reg_failures = reg.counter(
            "scheduler_failures_total",
            "Attempt failures by reason (error/executor_death/timeout/heartbeat)",
        )
        self._reg_recomputes = reg.counter(
            "scheduler_lineage_recomputes_total",
            "Lost partitions rebuilt from lineage",
        )
        self._reg_wasted = reg.counter(
            "scheduler_wasted_results_total",
            "Superseded attempts whose late result was discarded",
        )
        self._reg_queue_depth = reg.gauge(
            "scheduler_max_queue_depth", "High-water executor queue depth"
        )
        self._reg_spec_launched = reg.counter(
            "scheduler_speculative_launched_total",
            "Speculative duplicate attempts launched against stragglers",
        )
        self._reg_spec_wins = reg.counter(
            "scheduler_speculative_wins_total",
            "Tasks whose speculative copy finished first",
        )
        self._reg_recovered = reg.counter(
            "scheduler_tasks_recovered_total",
            "Tasks restored from journal checkpoints (zero re-execution)",
        )
        self._reg_quarantines = reg.counter(
            "scheduler_quarantines_total",
            "Workers quarantined by the health tracker",
        )
        self._reg_paroles = reg.counter(
            "scheduler_paroles_total",
            "Quarantined workers paroled back into the pool",
        )
        self._reg_quarantined_now = reg.gauge(
            "scheduler_quarantined_workers", "Workers currently quarantined"
        )
        self._reg_queue_wait = reg.histogram(
            "scheduler_task_queue_wait_seconds", "Dispatch-to-start wait per attempt"
        )
        self._reg_run = reg.histogram(
            "scheduler_task_run_seconds", "Run time of successful attempts"
        )

    # -- recording (called by the scheduler and executors) -------------------

    def note_dispatch(self, index: int, queue_depth: int) -> None:
        with self._lock:
            self.counters["dispatches"] += 1
            self.max_queue_depth = max(self.max_queue_depth, queue_depth)
        self._reg_dispatches.inc()
        self._reg_queue_depth.set_max(queue_depth)

    def note_start(self, index: int, queue_wait: float) -> None:
        with self._lock:
            t = self.task_timings.setdefault(index, {"queue_wait": 0.0, "run": 0.0, "attempts": 0})
            t["queue_wait"] += queue_wait
            t["attempts"] += 1
            self._add_phase("queue_wait", queue_wait)
        self._reg_queue_wait.observe(queue_wait)

    def note_done(self, index: int, run_seconds: float) -> None:
        with self._lock:
            t = self.task_timings.setdefault(index, {"queue_wait": 0.0, "run": 0.0, "attempts": 1})
            t["run"] += run_seconds
            self.counters["tasks_done"] += 1
            self._add_phase("run", run_seconds)
        self._reg_tasks_done.inc()
        self._reg_run.observe(run_seconds)

    def _add_phase(self, phase: str, seconds: float) -> None:
        self.phases[phase] = self.phases.get(phase, 0.0) + seconds

    def note_retry(self, index: int) -> None:
        with self._lock:
            self.retries[index] += 1
            self.counters["retries_total"] += 1
        self._reg_retries.inc()

    def note_failure(self, index: int, reason: str) -> None:
        """reason: 'error' | 'oom' | 'executor_death' | 'timeout' |
        'heartbeat' | 'corrupt' (the result failed the end-to-end CRC)."""
        with self._lock:
            self.counters["failures_total"] += 1
            self.counters[f"failures_{reason}"] += 1
        self._reg_failures.labels(reason=reason).inc()

    def note_recompute(self, index: int) -> None:
        with self._lock:
            self.counters["lineage_recomputes"] += 1
        self._reg_recomputes.inc()

    def note_wasted_result(self) -> None:
        """A superseded attempt reported late; its result was discarded."""
        with self._lock:
            self.counters["wasted_results"] += 1
        self._reg_wasted.inc()

    def note_speculative_launch(self, index: int) -> None:
        with self._lock:
            self.counters["speculative_launched"] += 1
        self._reg_spec_launched.inc()

    def note_speculative_win(self, index: int) -> None:
        """A speculative duplicate finished before the original attempt."""
        with self._lock:
            self.counters["speculative_wins"] += 1
        self._reg_spec_wins.inc()

    def note_recovered(self, index: int) -> None:
        """A task restored from a journal checkpoint without dispatch."""
        with self._lock:
            self.counters["tasks_recovered"] += 1
        self._reg_recovered.inc()

    def note_quarantine(self, worker_id: int) -> None:
        with self._lock:
            self.counters["quarantines"] += 1
            n = self.counters["quarantines"] - self.counters["paroles"]
        self._reg_quarantines.inc()
        self._reg_quarantined_now.set(max(0, n))

    def note_parole(self, worker_id: int) -> None:
        with self._lock:
            self.counters["paroles"] += 1
            n = self.counters["quarantines"] - self.counters["paroles"]
        self._reg_paroles.inc()
        self._reg_quarantined_now.set(max(0, n))

    # -- reporting -----------------------------------------------------------

    @property
    def retries_total(self) -> int:
        return self.counters["retries_total"]

    def summary(self) -> dict:
        with self._lock:
            c = self.counters
            return {
                "tasks_done": c["tasks_done"],
                "dispatches": c["dispatches"],
                "retries_total": c["retries_total"],
                "failures_total": c["failures_total"],
                "failures_error": c["failures_error"],
                "failures_heartbeat": c["failures_heartbeat"],
                "failures_timeout": c["failures_timeout"],
                "failures_executor_death": c["failures_executor_death"],
                "failures_corrupt": c["failures_corrupt"],
                "lineage_recomputes": c["lineage_recomputes"],
                "wasted_results": c["wasted_results"],
                "speculative_launched": c["speculative_launched"],
                "speculative_wins": c["speculative_wins"],
                "tasks_recovered": c["tasks_recovered"],
                "quarantines": c["quarantines"],
                "paroles": c["paroles"],
                "max_queue_depth": self.max_queue_depth,
                "phases": dict(self.phases),
                "per_task": {i: dict(t) for i, t in self.task_timings.items()},
                "retries_per_task": dict(self.retries),
            }

    def log(self, logger: Optional[logging.Logger] = None, prefix: str = "") -> None:
        logger = logger or _log
        s = self.summary()
        logger.info(
            "%stasks=%d dispatches=%d retries=%d failures=%d "
            "(heartbeat=%d timeout=%d death=%d) recomputes=%d "
            "speculative=%d/%d recovered=%d quarantines=%d "
            "max_queue_depth=%d",
            prefix, s["tasks_done"], s["dispatches"], s["retries_total"],
            s["failures_total"], s["failures_heartbeat"], s["failures_timeout"],
            s["failures_executor_death"], s["lineage_recomputes"],
            s["speculative_wins"], s["speculative_launched"],
            s["tasks_recovered"], s["quarantines"], s["max_queue_depth"],
        )
        total = sum(s["phases"].values()) or 1.0
        for phase, secs in sorted(s["phases"].items(), key=lambda kv: -kv[1]):
            logger.info("%s%s: %.3fs (%.0f%%)", prefix, phase, secs, 100 * secs / total)
