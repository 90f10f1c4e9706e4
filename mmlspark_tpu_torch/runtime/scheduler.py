"""Partitioned-job scheduler — the coordinating half of the runtime.

The port's copy of ``mmlspark_tpu/runtime/scheduler.py``, with its tracer
spans (``scheduler.job`` and one ``task-<i>`` span per attempt, finished
with the attempt's status) and bus events (``TaskDispatched``,
``TaskRetried``, ``TaskFailed``, ``TaskSpeculated``, ``TaskRecovered``,
``WorkerQuarantined``, ``WorkerParoled``).

Reproduces the slice of Spark's job scheduler that MMLSpark actually leaned on:
a partitioned job is N independent tasks, each walking
``PENDING -> RUNNING -> DONE | FAILED`` with bounded retries, exponential
backoff with *seeded* jitter (two runs with the same policy seed back off
identically — fault tests stay deterministic), per-task timeouts,
heartbeat-loss re-dispatch, and lineage-based recompute of lost
partitions. Results always come back in task-index order regardless of
completion order, so a partitioned computation is a drop-in replacement
for its inline loop — bit-identical output, which is what the
fault-injected ``fit`` parity tests assert.

The scheduling loop runs in the caller's thread: it dispatches due tasks,
then waits on the job condition with a heartbeat-interval timeout, and on
every wake scans RUNNING attempts for per-task timeout and stale
heartbeats. A lost attempt is *superseded* (its late result, if any, is
discarded), its worker is declared lost, and the task is re-queued.

Three further Spark behaviors ride the same loop:

- **speculative execution** (``spark.speculation``) — once
  ``speculation_quantile`` of tasks have finished, a running attempt
  older than ``speculation_multiplier`` x the median run time gets a
  duplicate attempt on a *different* worker; first result wins, the
  loser is superseded (its straggle is booked against its worker's
  health score);
- **executor quarantine** (BlacklistTracker) — a
  :class:`~mmlspark_tpu_torch.runtime.health.HealthTracker` scores failures
  and straggles per worker over a rolling window; workers over the
  threshold get no new dispatches until parole, and when *every* alive
  worker is quarantined the job fails fast with
  :class:`AllWorkersQuarantinedError` (opt out via
  ``quarantine_fail_fast=False`` to wait for parole);
- **durable checkpoint/recovery** — pass a
  :class:`~mmlspark_tpu_torch.runtime.journal.FitJournal` and completed task
  results are checkpointed (checksummed, atomic) as they land; a re-run
  after a crash restores them at startup with zero re-execution.
"""

from __future__ import annotations

import contextlib
import dataclasses
import enum
import itertools
import threading
import time
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence, Union

import numpy as np

from mmlspark_tpu_torch.core.profiling import get_logger
from mmlspark_tpu_torch.observability.events import (
    TaskDispatched,
    TaskFailed,
    TaskRecovered,
    TaskRetried,
    TaskSpeculated,
    WorkerParoled,
    WorkerQuarantined,
    get_bus,
)
from mmlspark_tpu_torch.observability.tracing import get_tracer
from mmlspark_tpu_torch.runtime.executor import ExecutorPool
from mmlspark_tpu_torch.runtime.faults import FaultPlan, current_faults, is_oom_error
from mmlspark_tpu_torch.runtime.health import HealthTracker
from mmlspark_tpu_torch.runtime.journal import FitJournal, result_crc as _result_crc
from mmlspark_tpu_torch.runtime.lineage import Lineage, PartitionLostError, ShardLineage
from mmlspark_tpu_torch.runtime.metrics import RuntimeMetrics
from mmlspark_tpu_torch.runtime.pressure import _footprint_hint

logger = get_logger("mmlspark_tpu_torch.runtime")

# job ids are process-global so event-log records from concurrent fits
# never collide (the SparkListenerJobStart jobId analogue)
_JOB_IDS = itertools.count()
_JOB_ID_LOCK = threading.Lock()


def _next_job_id() -> int:
    with _JOB_ID_LOCK:
        return next(_JOB_IDS)


class TaskState(enum.Enum):
    PENDING = "pending"
    RUNNING = "running"
    DONE = "done"
    FAILED = "failed"


class TaskLostError(RuntimeError):
    """Scheduler-side verdict on a running attempt: per-task timeout exceeded
    or the executor's heartbeat went stale. Counts against the retry
    budget like any task failure."""


class ResultCorruptedError(RuntimeError):
    """The scheduler's end-to-end integrity check rejected a reported result:
    the CRC the executor took after computing it no longer matches the
    value that arrived. Retryable — the re-run computes a clean copy."""


@dataclasses.dataclass
class AttemptInfo:
    """One line of a task's attempt history — what :class:`JobFailedError`
    carries per task and ``format_timeline`` renders."""

    attempt: int
    worker: int  # executor worker id; -1 = never reached a worker
    reason: str  # ok|error|oom|timeout|heartbeat|executor_death|corrupt|superseded
    duration: float
    speculative: bool = False


class JobFailedError(RuntimeError):
    """A task exhausted its retry budget; the whole job fails (Spark
    semantics: ``spark.task.maxFailures`` exceeded aborts the stage).

    ``history`` maps task index -> ordered :class:`AttemptInfo` list for
    every task that recorded at least one attempt, so the post-mortem
    (which worker, which failure mode, how long, speculative or not) is
    on the exception itself — no event-log round trip needed.
    """

    def __init__(self, message: str, history: Optional[Dict[int, List[AttemptInfo]]] = None):
        super().__init__(message)
        self.history: Dict[int, List[AttemptInfo]] = history or {}

    def describe(self) -> str:
        """The message plus per-task attempt lines, newest task last."""
        lines = [str(self)]
        for index in sorted(self.history):
            for a in self.history[index]:
                spec = " (spec)" if a.speculative else ""
                lines.append(
                    f"  task {index}: attempt {a.attempt}{spec} on "
                    f"w{a.worker} {a.reason} {a.duration:.3f}s"
                )
        return "\n".join(lines)


class AllWorkersQuarantinedError(JobFailedError):
    """Every alive worker is quarantined and ``quarantine_fail_fast`` is
    on — the job cannot make progress anywhere (Spark's "task cannot run
    anywhere due to node and executor blacklist" abort)."""


@dataclasses.dataclass
class SchedulerPolicy:
    """Retry/timeout/backoff knobs for one partitioned job (the analog of
    ``spark.task.maxFailures`` / ``spark.network.timeout`` et al.)."""

    max_workers: int = 4
    #: re-dispatches allowed per task beyond the first attempt
    max_retries: int = 2
    backoff_base: float = 0.05
    backoff_factor: float = 2.0
    #: jitter fraction; the jitter draw is seeded per (seed, task, failure)
    backoff_jitter: float = 0.25
    backoff_max: float = 5.0
    #: wall-clock limit per attempt; None disables
    task_timeout: Optional[float] = None
    heartbeat_interval: float = 0.05
    #: a worker whose last beat is older than this is declared lost
    heartbeat_timeout: float = 1.0
    seed: int = 0
    #: explicit fault plan; falls back to faults.current_faults()
    faults: Optional[FaultPlan] = None
    # -- speculative execution (spark.speculation[.multiplier|.quantile]) ----
    speculation: bool = False
    #: a running attempt older than multiplier x median run time straggles
    speculation_multiplier: float = 1.5
    #: fraction of tasks that must be DONE before speculation engages
    speculation_quantile: float = 0.75
    # -- executor quarantine (spark.excludeOnFailure.*) ----------------------
    #: rolling failure score at which a worker is quarantined; 0 disables
    quarantine_threshold: float = 0.0
    quarantine_window: float = 60.0
    parole_s: float = 30.0
    #: raise AllWorkersQuarantinedError instead of waiting for parole
    quarantine_fail_fast: bool = True
    # -- end-to-end result integrity -----------------------------------------
    #: checksum every result executor-side and verify scheduler-side
    result_integrity: bool = False

    def backoff(self, index: int, failures: int) -> float:
        """Delay before re-dispatching ``index`` after its ``failures``-th
        failure. Deterministic: jitter comes from an RNG seeded with
        ``(policy.seed, index, failures)``."""
        base = min(
            self.backoff_max,
            self.backoff_base * self.backoff_factor ** max(0, failures - 1),
        )
        jitter = np.random.default_rng((self.seed, index, failures)).random()
        return base * (1.0 + self.backoff_jitter * jitter)


@dataclasses.dataclass
class TaskRecord:
    index: int
    payload: Any
    state: TaskState = TaskState.PENDING
    attempt: int = -1  # id of the latest attempt
    failures: int = 0
    result: Any = None
    error: Optional[BaseException] = None
    not_before: float = 0.0  # monotonic time before which we won't re-dispatch
    needs_recompute: bool = False
    #: OOM failures so far — the retry's reduced-footprint hint
    oom_failures: int = 0
    #: ordered AttemptInfo per settled attempt (success, failure, supersede)
    history: List[AttemptInfo] = dataclasses.field(default_factory=list)


class _Attempt:
    """One dispatch of one task; the unit the executor pool runs."""

    def __init__(
        self,
        job: "_Job",
        task: TaskRecord,
        attempt_id: int,
        speculative: bool = False,
        excluded_workers: Sequence[int] = (),
    ):
        self.job = job
        self.task = task
        self.id = attempt_id
        #: 0-based per-task attempt number (what FaultPlan keys on)
        self.task_attempt = task.failures
        self.speculative = speculative
        #: worker ids that must NOT run this attempt (a speculative copy
        #: has to land on a different executor than the original)
        self.excluded_workers = tuple(excluded_workers)
        self.superseded = threading.Event()
        self.worker = None
        self.dispatched_at = time.monotonic()
        self.started_at: Optional[float] = None
        #: CRC32 the executor took over the pickled result, pre-transport
        self.result_crc: Optional[int] = None
        #: tracing span opened at dispatch; finished by whichever side
        #: settles the attempt (success, failure, or scheduler supersede)
        self.span = None

    # -- executor-side hooks -------------------------------------------------

    def mark_started(self, worker) -> None:
        self.worker = worker
        self.started_at = time.monotonic()
        self.job.metrics.note_start(
            self.task.index, self.started_at - self.dispatched_at
        )

    def execute(self, worker) -> Any:
        plan = self.job.policy.faults or current_faults()
        if plan is not None:
            plan.apply_on_start(
                self.task.index,
                self.task_attempt,
                worker=worker,
                superseded=self.superseded,
            )
        payload = self.task.payload
        if isinstance(payload, ShardLineage):
            payload = payload.materialize()
        # an OOM relaunch runs under a reduced-footprint hint (how many
        # times this task has OOMed); footprint-aware task bodies consult
        # pressure.reduced_footprint() to shrink their working set
        with _footprint_hint(self.task.oom_failures):
            result = self.job.fn(payload)
        if self.job.policy.result_integrity or (
            plan is not None
            and plan.will_corrupt(self.task.index, self.task_attempt)
        ):
            self.result_crc = _result_crc(result)
        if plan is not None:
            result = plan.apply_on_result(
                self.task.index, self.task_attempt, result
            )
        return result

    def report_success(self, result: Any) -> None:
        self.job._on_success(self, result)

    def report_failure(self, err: BaseException, executor_died: bool = False) -> None:
        self.job._on_failure(self, err, executor_died)

    def age(self, now: float) -> Optional[float]:
        return None if self.started_at is None else now - self.started_at


class _Job:
    """Scheduler-side state of one partitioned job."""

    def __init__(
        self,
        fn: Callable[[Any], Any],
        shards: Sequence[Any],
        policy: SchedulerPolicy,
        metrics: RuntimeMetrics,
        lineage: Optional[Lineage],
        journal: Optional[FitJournal] = None,
        health: Optional[HealthTracker] = None,
    ):
        self.fn = fn
        self.policy = policy
        self.metrics = metrics
        self.lineage = lineage
        self.journal = journal
        self.health = health
        self.id = _next_job_id()
        self.bus = get_bus()
        self.tasks = [TaskRecord(i, payload) for i, payload in enumerate(shards)]
        self.cond = threading.Condition()
        self.pending = set(range(len(self.tasks)))
        #: task index -> live attempts (>1 while a speculative copy races)
        self.running: Dict[int, List[_Attempt]] = {}
        self.done_count = 0
        self.failed: List[TaskRecord] = []
        #: run durations of successful attempts — the speculation median
        self.run_durations: List[float] = []
        self._attempt_ids = 0

    def finished(self) -> bool:
        return self.done_count + len(self.failed) == len(self.tasks)

    def next_attempt_id(self) -> int:
        aid = self._attempt_ids
        self._attempt_ids += 1
        return aid

    # -- completion callbacks (worker threads) -------------------------------

    def _is_current(self, att: _Attempt) -> bool:
        return (
            not att.superseded.is_set()
            and att in self.running.get(att.task.index, ())
        )

    def _on_success(self, att: _Attempt, result: Any) -> None:
        # end-to-end integrity: the executor checksummed the result before
        # it crossed the (simulated) wire; verify before taking the lock
        corrupt = (
            att.result_crc is not None and _result_crc(result) != att.result_crc
        )
        accepted = False
        t = att.task
        with self.cond:
            if not self._is_current(att):
                self.metrics.note_wasted_result()
                return
            now = time.monotonic()
            duration = now - (att.started_at or att.dispatched_at)
            siblings = self.running.get(t.index, [])
            siblings.remove(att)
            if corrupt:
                if not siblings:
                    self.running.pop(t.index, None)
                if att.span is not None:
                    get_tracer().finish(att.span, status="corrupt")
                self._register_failure(
                    t,
                    ResultCorruptedError(
                        f"task {t.index} attempt {att.id} result failed the "
                        f"end-to-end CRC check "
                        f"(expected {att.result_crc:#010x})"
                    ),
                    "corrupt",
                    att=att,
                )
                self.cond.notify_all()
                return
            # first result wins: supersede any racing sibling attempts
            self.running.pop(t.index, None)
            for other in siblings:
                other.superseded.set()
                if other.span is not None:
                    get_tracer().finish(other.span, status="superseded")
                t.history.append(AttemptInfo(
                    attempt=other.task_attempt,
                    worker=other.worker.wid if other.worker is not None else -1,
                    reason="superseded",
                    duration=(now - other.started_at) if other.started_at else 0.0,
                    speculative=other.speculative,
                ))
                if self.health is not None and other.worker is not None:
                    # being overtaken is a (discounted) health signal
                    self.health.note_straggle(other.worker.wid)
            t.state = TaskState.DONE
            t.result = result
            t.history.append(AttemptInfo(
                attempt=att.task_attempt,
                worker=att.worker.wid if att.worker is not None else -1,
                reason="ok",
                duration=duration,
                speculative=att.speculative,
            ))
            self.done_count += 1
            self.run_durations.append(duration)
            self.metrics.note_done(t.index, duration)
            if att.speculative:
                self.metrics.note_speculative_win(t.index)
                logger.info(
                    "task %d: speculative copy won in %.3fs", t.index, duration
                )
            if att.span is not None:
                get_tracer().finish(att.span)
            accepted = True
            self.cond.notify_all()
        if accepted and self.journal is not None:
            # durable record outside the job lock: checkpoint + journal
            # line on the worker's time, never blocking the scheduling loop. A
            # full checkpoint volume degrades durability, not the job —
            # the task's success already stands
            try:
                self.journal.record(t.index, result)
            except OSError as e:
                logger.warning(
                    "journal record for task %d failed (%s); result kept "
                    "in memory, recovery will recompute it", t.index, e,
                )

    def _on_failure(self, att: _Attempt, err: BaseException, executor_died: bool) -> None:
        with self.cond:
            if not self._is_current(att):
                self.metrics.note_wasted_result()
                return
            t = att.task
            siblings = self.running.get(t.index, [])
            if att in siblings:
                siblings.remove(att)
            if not siblings:
                self.running.pop(t.index, None)
            if executor_died:
                reason = "executor_death"
            elif is_oom_error(err):
                # memory exhaustion is its own retryable class: the
                # relaunch carries a reduced-footprint hint, and the
                # health tracker scores it heavier than a plain error
                reason = "oom"
                t.oom_failures += 1
            else:
                reason = "error"
            if att.span is not None:
                get_tracer().finish(att.span, status=reason, error=str(err)[:200])
            self._register_failure(t, err, reason, att=att)
            self.cond.notify_all()

    def _register_failure(
        self,
        t: TaskRecord,
        err: BaseException,
        reason: str,
        att: Optional[_Attempt] = None,
    ) -> None:
        """Book a failure against ``t`` and either re-queue or fail it.
        Caller holds ``self.cond``; ``att`` (when the failure settled a
        specific attempt) supplies worker/timing/speculative detail."""
        worker_id = -1
        duration = 0.0
        speculative = False
        attempt_no = t.failures
        if att is not None:
            attempt_no = att.task_attempt
            speculative = att.speculative
            if att.worker is not None:
                worker_id = att.worker.wid
            if att.started_at is not None:
                duration = time.monotonic() - att.started_at
        t.failures += 1
        self.metrics.note_failure(t.index, reason)
        if self.health is not None and worker_id >= 0:
            self.health.note_failure(worker_id, reason)
        t.history.append(AttemptInfo(
            attempt=attempt_no, worker=worker_id, reason=reason,
            duration=duration, speculative=speculative,
        ))
        others_running = bool(self.running.get(t.index))
        permanent = t.failures > self.policy.max_retries and not others_running
        if self.bus.active:
            self.bus.publish(TaskFailed(
                job_id=self.id, task_id=t.index, reason=reason,
                permanent=permanent, worker=worker_id, duration=duration,
                speculative=speculative, attempt=attempt_no,
            ))
        if (
            isinstance(err, PartitionLostError)
            and self.lineage is not None
            and self.lineage.has(t.index)
        ):
            t.needs_recompute = True
        if others_running:
            # a sibling attempt (the original, or a speculative copy) is
            # still live — it remains the task's hope; no re-queue, no
            # permanent verdict from this failure alone
            logger.info(
                "task %d attempt failed (%s); sibling attempt still running",
                t.index, reason,
            )
            return
        if permanent:
            t.state = TaskState.FAILED
            t.error = err
            self.failed.append(t)
            logger.warning(
                "task %d failed permanently after %d attempts (%s): %s",
                t.index, t.failures, reason, err,
            )
        else:
            self.metrics.note_retry(t.index)
            if self.bus.active:
                self.bus.publish(TaskRetried(
                    job_id=self.id, task_id=t.index, failures=t.failures,
                    reason=reason,
                ))
            t.state = TaskState.PENDING
            t.not_before = time.monotonic() + self.policy.backoff(t.index, t.failures)
            self.pending.add(t.index)
            logger.info(
                "task %d attempt failed (%s); retry %d/%d after backoff",
                t.index, reason, t.failures, self.policy.max_retries,
            )


class Scheduler:
    """Coordinator of partitioned jobs over an :class:`ExecutorPool`.

    Reusable across jobs (the serving dispatch loop keeps one alive);
    metrics accumulate across runs. If no pool is supplied the scheduler
    owns one sized by the policy and :meth:`close` shuts it down.

    ``health`` (a :class:`~mmlspark_tpu_torch.runtime.health.HealthTracker`)
    is built automatically when ``policy.quarantine_threshold > 0``;
    pass one explicitly to control its clock (fake-clock tests) or share
    it across schedulers. Either way it is wired to the pool's admission
    check, this scheduler's metrics, and the event bus.
    """

    def __init__(
        self,
        pool: Optional[ExecutorPool] = None,
        policy: Optional[SchedulerPolicy] = None,
        metrics: Optional[RuntimeMetrics] = None,
        health: Optional[HealthTracker] = None,
    ):
        self.policy = policy or current_policy() or SchedulerPolicy()
        self.metrics = metrics or RuntimeMetrics()
        self._owns_pool = pool is None
        self.pool = pool or ExecutorPool(
            self.policy.max_workers,
            heartbeat_interval=self.policy.heartbeat_interval,
        )
        if health is None and self.policy.quarantine_threshold > 0:
            health = HealthTracker(
                threshold=self.policy.quarantine_threshold,
                window_s=self.policy.quarantine_window,
                parole_s=self.policy.parole_s,
            )
        self.health = health
        if health is not None:
            if health.metrics is None:
                health.metrics = self.metrics
            if health.on_quarantine is None:
                health.on_quarantine = self._announce_quarantine
            if health.on_parole is None:
                health.on_parole = self._announce_parole
        self.pool.health = health

    # -- quarantine announcements (HealthTracker callbacks) ------------------

    def _announce_quarantine(self, worker_id: int, score: float) -> None:
        logger.warning(
            "worker %d quarantined (score %.2f >= %.2f); parole in %.1fs",
            worker_id, score, self.health.threshold, self.health.parole_s,
        )
        bus = get_bus()
        if bus.active:
            bus.publish(WorkerQuarantined(
                worker=worker_id, score=score, parole_s=self.health.parole_s,
            ))

    def _announce_parole(self, worker_id: int) -> None:
        logger.info("worker %d paroled; rejoining the pool", worker_id)
        bus = get_bus()
        if bus.active:
            bus.publish(WorkerParoled(worker=worker_id))

    # -- scheduling loop -------------------------------------------------------

    def run(
        self,
        fn: Callable[[Any], Any],
        shards: Sequence[Any],
        *,
        lineage: Optional[Lineage] = None,
        journal: Optional[FitJournal] = None,
        revalidate: Optional[Callable[[int, Any], bool]] = None,
    ) -> List[Any]:
        """Run ``fn`` over every shard; return results in shard order.

        ``journal`` makes the job durable: previously completed tasks are
        restored from its checkpoints at startup (zero re-execution) and
        every new completion is recorded before the job can finish.
        ``revalidate(index, result) -> bool`` vets each restored result
        (e.g. re-checksum side-effect files); a False sends the task back
        through normal execution.

        Raises :class:`JobFailedError` if any task exhausts its retry
        budget (partial results are discarded, Spark stage-abort style),
        carrying the per-task :class:`AttemptInfo` history.
        """
        shards = list(shards)
        if not shards:
            return []
        job = _Job(
            fn, shards, self.policy, self.metrics, lineage,
            journal=journal, health=self.health,
        )
        if journal is not None:
            self._restore_from_journal(job, journal, revalidate)
            if job.finished() and not job.failed:
                return [t.result for t in job.tasks]
        # the job span parents every attempt span (attempts are children,
        # retries siblings); under a pipeline-stage or serving-apply span
        # the whole tree hangs off one trace id
        with get_tracer().span(
            "scheduler.job", job_id=job.id, tasks=len(job.tasks)
        ):
            while True:
                with job.cond:
                    if job.finished():
                        break
                    now = time.monotonic()
                    self._check_all_quarantined(job)
                    self._dispatch_due(job, now)
                    self._monitor(job, now)
                    self._maybe_speculate(job, now)
                    timeout = self._wait_timeout(job, now)
                    job.cond.wait(timeout)
                # Replace any executor that died (ExecutorDeathError exit) or
                # was declared lost (stale heartbeat) — outside the job lock,
                # since spawning threads under it serves nothing.
                if self.pool.alive_count < self.pool.target_workers:
                    self.pool.ensure_capacity()
            if job.failed:
                first = job.failed[0]
                raise JobFailedError(
                    f"{len(job.failed)}/{len(job.tasks)} tasks failed permanently; "
                    f"first: task {first.index} after {first.failures} attempts",
                    history={
                        t.index: list(t.history) for t in job.tasks if t.history
                    },
                ) from first.error
        return [t.result for t in job.tasks]

    def _restore_from_journal(
        self,
        job: _Job,
        journal: FitJournal,
        revalidate: Optional[Callable[[int, Any], bool]],
    ) -> None:
        """Mark journaled tasks DONE before any dispatch happens (the
        checkpoint-recovery scan). Runs before the scheduling loop, so no
        locking is needed."""
        restored = journal.restore()
        recovered = 0
        for index in sorted(restored):
            if not 0 <= index < len(job.tasks):
                continue  # stale journal from a differently-sized run
            result = restored[index]
            if revalidate is not None and not revalidate(index, result):
                logger.warning(
                    "task %d: journal checkpoint failed revalidation; "
                    "recomputing", index,
                )
                continue
            t = job.tasks[index]
            t.state = TaskState.DONE
            t.result = result
            job.pending.discard(index)
            job.done_count += 1
            recovered += 1
            self.metrics.note_recovered(index)
            if job.bus.active:
                job.bus.publish(TaskRecovered(job_id=job.id, task_id=index))
        if recovered:
            logger.info(
                "restored %d/%d tasks from journal %s (zero re-execution)",
                recovered, len(job.tasks), journal.dir,
            )

    def _check_all_quarantined(self, job: _Job) -> None:
        """Fail fast when no alive worker may accept work. Caller holds
        ``job.cond``; raising releases it."""
        if self.health is None or not self.policy.quarantine_fail_fast:
            return
        if not (job.pending or job.running):
            return
        alive = [w.wid for w in self.pool.workers if not w.dead]
        if not alive or not self.health.all_quarantined(alive):
            return
        # abandon in-flight/queued attempts so workers skip them instead
        # of bouncing them through the inbox forever
        for atts in job.running.values():
            for att in atts:
                att.superseded.set()
        wait = self.health.next_parole_in()
        detail = f" (next parole in {wait:.1f}s)" if wait is not None else ""
        raise AllWorkersQuarantinedError(
            f"all {len(alive)} workers are quarantined; job {job.id} cannot "
            f"run anywhere{detail}",
            history={t.index: list(t.history) for t in job.tasks if t.history},
        )

    def _dispatch_due(self, job: _Job, now: float) -> None:
        """Submit every pending task whose backoff has elapsed. Caller
        holds ``job.cond``."""
        for index in sorted(job.pending):
            t = job.tasks[index]
            if t.not_before > now:
                continue
            if t.needs_recompute and job.lineage is not None:
                t.payload = job.lineage.recompute(index)
                t.needs_recompute = False
                self.metrics.note_recompute(index)
                logger.info("task %d: recomputed lost partition from lineage", index)
            job.pending.discard(index)
            att = _Attempt(job, t, job.next_attempt_id())
            t.attempt = att.id
            t.state = TaskState.RUNNING
            job.running[index] = [att]
            depth = self.pool.queue_depth() + 1
            self.metrics.note_dispatch(index, depth)
            # attempt spans: children of scheduler.job; a retry opens a
            # NEW span, so failed attempts read as siblings tagged with
            # their failure reason
            att.span = get_tracer().start_span(
                f"task-{index}", job_id=job.id, attempt=t.failures
            )
            if job.bus.active:
                job.bus.publish(TaskDispatched(
                    job_id=job.id, task_id=index, attempt=t.failures,
                    queue_depth=depth,
                ))
            self.pool.submit(att)

    def _monitor(self, job: _Job, now: float) -> bool:
        """Scan RUNNING attempts for per-task timeout and heartbeat loss;
        supersede and re-queue offenders. Caller holds ``job.cond``.
        Returns True if a worker was declared lost."""
        lost = False
        timeout = self.policy.task_timeout
        for index, atts in list(job.running.items()):
            for att in list(atts):
                t = att.task
                if (
                    timeout is not None
                    and att.started_at is not None
                    and now - att.started_at > timeout
                ):
                    att.superseded.set()
                    atts.remove(att)
                    if not atts:
                        job.running.pop(index, None)
                    if att.span is not None:
                        get_tracer().finish(att.span, status="timeout")
                    job._register_failure(
                        t,
                        TaskLostError(
                            f"task {index} attempt {att.id} exceeded "
                            f"task_timeout={timeout:g}s"
                        ),
                        "timeout",
                        att=att,
                    )
                elif (
                    att.worker is not None
                    and now - att.worker.last_beat > self.policy.heartbeat_timeout
                ):
                    att.superseded.set()
                    atts.remove(att)
                    if not atts:
                        job.running.pop(index, None)
                    if att.span is not None:
                        get_tracer().finish(att.span, status="heartbeat")
                    self.pool.declare_lost(att.worker)
                    lost = True
                    job._register_failure(
                        t,
                        TaskLostError(
                            f"executor running task {index} attempt {att.id} missed "
                            f"heartbeats for > {self.policy.heartbeat_timeout:g}s"
                        ),
                        "heartbeat",
                        att=att,
                    )
        return lost

    def _maybe_speculate(self, job: _Job, now: float) -> None:
        """Launch duplicate attempts against stragglers (the
        ``spark.speculation`` re-launch). Caller holds ``job.cond``.

        Engages only once ``speculation_quantile`` of the job's tasks are
        DONE and at least one run duration is known; a running attempt
        whose age exceeds ``speculation_multiplier`` x the median run
        time gets one speculative copy, pinned off its current worker."""
        pol = self.policy
        if not pol.speculation or not job.run_durations:
            return
        if job.done_count < pol.speculation_quantile * len(job.tasks):
            return
        workers = [w for w in self.pool.workers if not w.dead]
        if self.health is not None:
            workers = [w for w in workers if not self.health.is_quarantined(w.wid)]
        if len(workers) < 2:
            return  # nowhere different to run a copy
        median = float(np.median(job.run_durations))
        threshold = max(pol.speculation_multiplier * median, 1e-6)
        for index, atts in list(job.running.items()):
            if len(atts) != 1:
                continue  # a copy is already racing (or the list is settling)
            orig = atts[0]
            age = orig.age(now)
            if age is None or age <= threshold or orig.worker is None:
                continue
            spec = _Attempt(
                job, orig.task, job.next_attempt_id(),
                speculative=True, excluded_workers=(orig.worker.wid,),
            )
            atts.append(spec)
            depth = self.pool.queue_depth() + 1
            self.metrics.note_dispatch(index, depth)
            self.metrics.note_speculative_launch(index)
            spec.span = get_tracer().start_span(
                f"task-{index}", job_id=job.id, attempt=orig.task.failures,
                speculative=True,
            )
            if job.bus.active:
                job.bus.publish(TaskSpeculated(
                    job_id=job.id, task_id=index,
                    original_worker=orig.worker.wid, age=age, median=median,
                ))
                job.bus.publish(TaskDispatched(
                    job_id=job.id, task_id=index, attempt=orig.task.failures,
                    queue_depth=depth,
                ))
            logger.info(
                "task %d: speculative copy launched (attempt age %.3fs > "
                "%.2fx median %.3fs)",
                index, age, pol.speculation_multiplier, median,
            )
            self.pool.submit(spec)

    def _wait_timeout(self, job: _Job, now: float) -> float:
        """How long the scheduling loop may sleep: until the next backoff expiry,
        capped at a heartbeat interval so monitoring stays responsive."""
        timeout = self.policy.heartbeat_interval
        for index in job.pending:
            delta = job.tasks[index].not_before - now
            if 0 < delta < timeout:
                timeout = delta
        return max(timeout, 0.001)

    def close(self) -> None:
        if self._owns_pool:
            self.pool.shutdown()

    def __enter__(self) -> "Scheduler":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def run_partitioned(
    fn: Callable[[Any], Any],
    shards: Sequence[Any],
    policy: Optional[SchedulerPolicy] = None,
    *,
    lineage: Optional[Lineage] = None,
    pool: Optional[ExecutorPool] = None,
    metrics: Optional[RuntimeMetrics] = None,
    journal: Optional[FitJournal] = None,
    revalidate: Optional[Callable[[int, Any], bool]] = None,
) -> List[Any]:
    """Run ``fn`` over ``shards`` on a fault-tolerant scheduler; results
    come back in shard order. The one-call public entry point."""
    with Scheduler(pool=pool, policy=policy, metrics=metrics) as sched:
        return sched.run(
            fn, shards, lineage=lineage, journal=journal, revalidate=revalidate
        )


# -- ambient policy (reaches schedulers created inside fit/serve calls) ------

_POLICY_STACK: List[SchedulerPolicy] = []


@contextlib.contextmanager
def policy(
    policy_or_none: Optional[SchedulerPolicy] = None, **kwargs: Any
) -> Iterator[SchedulerPolicy]:
    """Make a :class:`SchedulerPolicy` ambient: estimators/servers that
    build their own scheduler pick it up without API threading.

    ``with runtime.policy(max_workers=8, max_retries=3): est.fit(...)``
    """
    p = policy_or_none if policy_or_none is not None else SchedulerPolicy(**kwargs)
    _POLICY_STACK.append(p)
    try:
        yield p
    finally:
        _POLICY_STACK.remove(p)


def current_policy() -> Optional[SchedulerPolicy]:
    return _POLICY_STACK[-1] if _POLICY_STACK else None
