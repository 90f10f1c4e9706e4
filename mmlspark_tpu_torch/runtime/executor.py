"""Executor pool — thread workers with heartbeats, drain, and replacement.

The port's copy of ``mmlspark_tpu/runtime/executor.py``.

The Spark analog is the executor fleet: each worker pulls task attempts
from a shared inbox, runs them, and reports back to the scheduler
(:mod:`~mmlspark_tpu_torch.runtime.scheduler`). Two Spark behaviors are
reproduced faithfully:

- **heartbeats** — every worker runs a pulse thread stamping
  ``last_beat``; the scheduler's loop declares a worker lost when
  its beat goes stale (the injected ``drop_heartbeat`` fault suppresses
  the pulse to trigger exactly this path);
- **executor death** — a task raising :class:`ExecutorDeathError` takes
  its whole worker down (the thread exits, like a crashed JVM executor);
  the scheduler re-dispatches the attempt and calls
  :meth:`ExecutorPool.ensure_capacity` to spawn a replacement.

The pool also enforces *admission*: before executing an attempt a worker
consults :meth:`ExecutorPool._admit` — a quarantined worker (see
:class:`~mmlspark_tpu_torch.runtime.health.HealthTracker`) gets no new work,
and an attempt that excludes this worker (a speculative copy must land
on a different executor than the original) is handed back to the inbox
for someone else. Attempts already superseded while queued are skipped
without burning a worker.

Workers are daemon threads so a held worker (fault-injected hang) never
blocks interpreter exit.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import List, Optional

from mmlspark_tpu_torch.runtime.faults import ExecutorDeathError

#: Sentinel that tells a worker to exit its pull loop.
POISON = object()


class _Worker(threading.Thread):
    _ids = 0

    def __init__(self, pool: "ExecutorPool", heartbeat_interval: float):
        _Worker._ids += 1
        self.wid = _Worker._ids
        super().__init__(name=f"{pool.name}-worker-{self.wid}", daemon=True)
        self.pool = pool
        self.heartbeat_interval = heartbeat_interval
        self.last_beat = time.monotonic()
        #: set by the drop_heartbeat fault; the pulse thread stops stamping
        self.beat_suppressed = False
        self.current = None  # the _Attempt being executed, if any
        self.dead = False
        self._halt = threading.Event()

    # -- heartbeat ----------------------------------------------------------

    def _pulse(self) -> None:
        while not self._halt.is_set():
            if not self.beat_suppressed:
                self.last_beat = time.monotonic()
            self._halt.wait(self.heartbeat_interval)

    # -- pull loop ----------------------------------------------------------

    def run(self) -> None:
        pulse = threading.Thread(
            target=self._pulse, name=f"{self.name}-pulse", daemon=True
        )
        pulse.start()
        try:
            while True:
                att = self.pool._inbox.get()
                if att is POISON:
                    return
                sup = getattr(att, "superseded", None)
                if sup is not None and sup.is_set():
                    continue  # scheduler gave up on this attempt while queued
                if not self.pool._admit(self, att):
                    # quarantined, or this attempt must run elsewhere:
                    # hand it back and pause so the bounce doesn't spin hot
                    self.pool._inbox.put(att)
                    time.sleep(self.pool.heartbeat_interval / 4)
                    continue
                self.current = att
                att.mark_started(self)
                try:
                    result = att.execute(self)
                except ExecutorDeathError as e:
                    att.report_failure(e, executor_died=True)
                    self.dead = True
                    return  # the executor dies with its task
                except BaseException as e:  # noqa: BLE001 — task errors retry
                    att.report_failure(e)
                else:
                    att.report_success(result)
                finally:
                    self.current = None
                    self.beat_suppressed = False
        finally:
            self._halt.set()
            self.pool._note_exit(self)


class ExecutorPool:
    """Fixed-size pool of pull-loop workers sharing one task inbox."""

    def __init__(
        self,
        num_workers: int,
        heartbeat_interval: float = 0.05,
        name: str = "runtime",
    ):
        if num_workers < 1:
            raise ValueError(f"num_workers must be >= 1, got {num_workers}")
        self.name = name
        #: fleet size the pool keeps replacing dead workers up to
        self.target_workers = num_workers
        self.heartbeat_interval = heartbeat_interval
        #: optional HealthTracker; quarantined workers are refused work
        self.health = None
        self._inbox: "queue.Queue" = queue.Queue()
        self._lock = threading.Lock()
        self._workers: List[_Worker] = []
        self._draining = False
        self._shutdown = False
        for _ in range(num_workers):
            self._spawn()

    def _spawn(self) -> None:
        w = _Worker(self, self.heartbeat_interval)
        self._workers.append(w)
        w.start()

    def _note_exit(self, worker: _Worker) -> None:
        with self._lock:
            worker.dead = True

    # -- submission ---------------------------------------------------------

    def submit(self, attempt) -> None:
        if self._draining or self._shutdown:
            raise RuntimeError(f"pool {self.name!r} is shut down")
        self._inbox.put(attempt)

    def _admit(self, worker: "_Worker", attempt) -> bool:
        """May ``worker`` execute ``attempt``? False when the attempt
        excludes this worker (speculative copies must land on a different
        executor than the original) or the health tracker has the worker
        quarantined — the worker re-queues the attempt for someone else."""
        if worker.wid in getattr(attempt, "excluded_workers", ()):
            return False
        health = self.health
        if health is not None and health.is_quarantined(worker.wid):
            return False
        return True

    def queue_depth(self) -> int:
        return self._inbox.qsize()

    # -- membership ---------------------------------------------------------

    @property
    def workers(self) -> List[_Worker]:
        with self._lock:
            return list(self._workers)

    @property
    def alive_count(self) -> int:
        with self._lock:
            return sum(1 for w in self._workers if not w.dead)

    def declare_lost(self, worker: _Worker) -> None:
        """Scheduler-side verdict: this executor is gone (stale heartbeat).
        Its thread may still be blocked; being a daemon it can't hurt."""
        with self._lock:
            worker.dead = True
            if worker in self._workers:
                self._workers.remove(worker)

    def ensure_capacity(self, target: Optional[int] = None) -> int:
        """Replace dead workers until ``target`` (default: the pool's own
        size) are alive; returns the number spawned."""
        spawned = 0
        if target is None:
            target = self.target_workers
        with self._lock:
            if self._draining or self._shutdown:
                return 0
            self._workers = [w for w in self._workers if not w.dead]
            while len(self._workers) < target:
                self._spawn()
                spawned += 1
        return spawned

    # -- teardown -----------------------------------------------------------

    def drain(self, timeout: float = 30.0) -> bool:
        """Stop accepting work and wait for in-flight tasks to finish.
        Returns True if the pool went quiet within ``timeout``."""
        self._draining = True
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            busy = any(w.current is not None for w in self.workers)
            if self._inbox.empty() and not busy:
                return True
            time.sleep(0.01)
        return False

    def shutdown(self, timeout: float = 5.0) -> None:
        with self._lock:
            if self._shutdown:
                return
            self._shutdown = True
            self._draining = True
            workers = list(self._workers)
        for _ in workers:
            self._inbox.put(POISON)
        deadline = time.monotonic() + timeout
        for w in workers:
            w.join(timeout=max(0.0, deadline - time.monotonic()))
