"""Executor health tracking and quarantine — the BlacklistTracker analogue.

The port's copy of ``mmlspark_tpu/runtime/health.py``.

Spark's ``BlacklistTracker`` (``spark.blacklist.*``, later
``spark.excludeOnFailure.*``) stops scheduling tasks on executors that
keep failing: failures are counted per executor over a rolling window,
an executor crossing the threshold is excluded from new task dispatch,
and a timeout paroles it back into the pool. This module is that policy
for the thread-based runtime:

- every attempt failure (error / timeout / heartbeat loss / corrupt
  result) books ``1.0`` against the worker that ran it; an OOM failure
  books ``oom_weight`` (default 2.0 — a worker that keeps exhausting
  memory poisons every task placed on it, the posture of Spark's
  OOM-aware ``excludeOnFailure``); being overtaken by a speculative
  copy books ``straggle_weight`` (chronic slowness is a health signal
  too, at a discount);
- scores are summed over a rolling ``window_s`` window; a worker at or
  above ``threshold`` is quarantined: the executor pool refuses to hand
  it new attempts (:meth:`ExecutorPool._admit`) until ``parole_s``
  elapses, when its history is wiped and it rejoins the fleet;
- if every alive worker is quarantined the scheduler fails fast with
  :class:`~mmlspark_tpu_torch.runtime.scheduler.AllWorkersQuarantinedError`
  (Spark's "cannot run anywhere due to node and executor blacklist")
  unless the policy opts into waiting for parole.

The clock is injectable so quarantine/parole tests run on a fake clock
with zero real sleeps. Thread-safe: workers consult it from their pull
loops while the scheduler books failures from completion callbacks.
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Callable, Deque, Dict, List, Optional, Set, Tuple


class HealthTracker:
    """Rolling-window per-worker failure scores with timed quarantine.

    ``metrics`` (a :class:`~mmlspark_tpu_torch.runtime.metrics.RuntimeMetrics`)
    and ``on_quarantine`` / ``on_parole`` callbacks are optional — the
    scheduler wires them to its metrics and its log.
    """

    def __init__(
        self,
        threshold: float = 3.0,
        window_s: float = 60.0,
        parole_s: float = 30.0,
        straggle_weight: float = 0.5,
        oom_weight: float = 2.0,
        partition_weight: float = 2.0,
        clock: Callable[[], float] = time.monotonic,
        metrics=None,
        on_quarantine: Optional[Callable[[int, float], None]] = None,
        on_parole: Optional[Callable[[int], None]] = None,
    ):
        if threshold <= 0:
            raise ValueError(f"threshold must be > 0, got {threshold}")
        self.threshold = float(threshold)
        self.window_s = float(window_s)
        self.parole_s = float(parole_s)
        self.straggle_weight = float(straggle_weight)
        self.oom_weight = float(oom_weight)
        self.partition_weight = float(partition_weight)
        self.clock = clock
        self.metrics = metrics
        self.on_quarantine = on_quarantine
        self.on_parole = on_parole
        self._lock = threading.Lock()
        #: worker id -> deque[(t, weight)] within the rolling window
        self._events: Dict[int, Deque[Tuple[float, float]]] = {}
        #: worker id -> parole time (quarantine ends)
        self._quarantined: Dict[int, float] = {}
        #: total quarantines/paroles (monotonic, for summaries)
        self.quarantines = 0
        self.paroles = 0

    # -- scoring -------------------------------------------------------------

    def note_failure(self, worker_id: Optional[int], reason: str = "error") -> None:
        """Book one attempt failure against ``worker_id`` (None = the
        attempt never reached a worker; nothing to book). OOM failures
        score ``oom_weight`` — memory exhaustion on a worker predicts
        exhaustion for whatever lands there next — and partition blame
        scores ``partition_weight``: a member the gang voted off for
        stalling the collective will stall the re-formed gang too."""
        if worker_id is not None:
            weight = 1.0
            if reason == "oom":
                weight = self.oom_weight
            elif reason == "partition":
                weight = self.partition_weight
            self._book(int(worker_id), weight)

    def note_straggle(self, worker_id: Optional[int]) -> None:
        """The worker's attempt was overtaken by a speculative copy."""
        if worker_id is not None:
            self._book(int(worker_id), self.straggle_weight)

    def _book(self, wid: int, weight: float) -> None:
        fire: Optional[Tuple[int, float]] = None
        with self._lock:
            now = self.clock()
            if wid in self._quarantined:
                return  # already out of the pool; don't extend the sentence
            q = self._events.setdefault(wid, collections.deque())
            q.append((now, weight))
            self._trim(q, now)
            score = sum(w for _, w in q)
            if score >= self.threshold:
                self._quarantined[wid] = now + self.parole_s
                q.clear()
                self.quarantines += 1
                fire = (wid, score)
        if fire is not None:
            if self.metrics is not None:
                self.metrics.note_quarantine(fire[0])
            if self.on_quarantine is not None:
                self.on_quarantine(fire[0], fire[1])

    def _trim(self, q: Deque[Tuple[float, float]], now: float) -> None:
        while q and now - q[0][0] > self.window_s:
            q.popleft()

    def score(self, worker_id: int) -> float:
        with self._lock:
            q = self._events.get(int(worker_id))
            if not q:
                return 0.0
            self._trim(q, self.clock())
            return sum(w for _, w in q)

    # -- quarantine state ----------------------------------------------------

    def is_quarantined(self, worker_id: int) -> bool:
        """True while the worker is serving its quarantine; checking after
        the parole time paroles it (history wiped, callbacks fired)."""
        wid = int(worker_id)
        paroled = False
        with self._lock:
            until = self._quarantined.get(wid)
            if until is None:
                return False
            if self.clock() < until:
                return True
            del self._quarantined[wid]
            self._events.pop(wid, None)
            self.paroles += 1
            paroled = True
        if paroled:
            if self.metrics is not None:
                self.metrics.note_parole(wid)
            if self.on_parole is not None:
                self.on_parole(wid)
        return False

    def quarantined_workers(self) -> Set[int]:
        """Worker ids currently quarantined (parole checks applied)."""
        with self._lock:
            wids = list(self._quarantined)
        return {w for w in wids if self.is_quarantined(w)}

    def all_quarantined(self, worker_ids: List[int]) -> bool:
        """True when ``worker_ids`` is non-empty and every one of them is
        quarantined — the fail-fast condition."""
        if not worker_ids:
            return False
        return all(self.is_quarantined(w) for w in worker_ids)

    def next_parole_in(self) -> Optional[float]:
        """Seconds until the earliest quarantined worker paroles (None
        when nobody is quarantined) — the scheduler's wait bound."""
        with self._lock:
            if not self._quarantined:
                return None
            return max(0.0, min(self._quarantined.values()) - self.clock())
