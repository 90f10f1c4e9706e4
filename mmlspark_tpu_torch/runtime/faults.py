"""Deterministic fault injection for the partition scheduler.

The port's copy of ``mmlspark_tpu/runtime/faults.py``: the same seeded,
(task, attempt)-keyed hooks, so a fault-path test asserts one recovery
sequence instead of racing a process killer.

The task plane, consulted by executor workers as each attempt starts:

- ``kill_task(n)``: the executor running task ``n`` dies mid-task
  (:class:`ExecutorDeathError`; the worker thread exits and the pool
  replaces it, like a lost JVM executor);
- ``delay_task(n, s)``: task ``n`` stalls ``s`` seconds before it runs;
- ``slow_task(n, s)``: task ``n`` straggles up to ``s`` seconds but wakes
  the moment the scheduler supersedes it, so speculation can overtake it;
- ``corrupt_result(n)``: the executor checksums task ``n``'s result, then
  flips bytes before reporting; the scheduler's CRC check must catch it;
- ``drop_heartbeat(n)``: the executor running task ``n`` stops
  heartbeating and hangs until the scheduler declares it lost.

The exhaustion plane:

- ``oom_task(n, kind)``: attempt 0 of task ``n`` runs out of memory at
  the task boundary, ``MemoryError`` for ``kind="host"`` and
  :class:`DeviceOomError` for ``kind="device"``. Device OOMs registered
  against a fit fire from the histogram dispatch keyed by iteration
  (:meth:`FaultPlan.apply_on_histogram`), so the fit's out-of-memory
  ladder takes them at the catch site of a real ``torch.cuda``
  out-of-memory error;
- ``disk_full(substr, n)``: the next ``n`` guarded writes whose path holds
  ``substr`` raise ``OSError(ENOSPC)`` before a byte is written
  (:func:`check_write`, called by every durable writer).

The data plane: ``truncate_shard(substr, n)``: the next ``n`` guarded shard
reads whose path holds ``substr`` raise :class:`CorruptShardError` at the
read gate (:func:`check_record`), so ``permissive`` quarantines the shard
and ``failfast`` raises, as for a torn file.

Each fault fires at most once; ``plan.fired`` records what fired.
``kill_random_task`` draws its victim from the plan's seeded RNG
(``np.random.default_rng(seed)``, the seed from ``MMLSPARK_TPU_FAULT_SEED``
when None), so the victim is the reference's for the same seed. The
process, stream, request (HTTP) and network planes, ``corrupt_record`` and
``malformed_request`` are not ported: their consumers (process groups,
streaming, serving) are not either.
"""

from __future__ import annotations

import contextlib
import errno
import os
import threading
import time
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch


class ExecutorDeathError(RuntimeError):
    """Simulated executor death: the worker thread running the task exits
    (the scheduler retries the task on a surviving or replacement worker)."""


class DeviceOomError(RuntimeError):
    """Simulated device out-of-memory. The message carries the reference's
    ``RESOURCE_EXHAUSTED`` marker, so :func:`is_oom_error` classifies it as
    it classifies ``torch.cuda.OutOfMemoryError``."""


class CorruptShardError(RuntimeError):
    """A shard file is corrupt (torn, bit-rotted or undecodable); the read
    gate (:func:`check_record`) raises it for an injected torn shard."""


class FaultPlan:
    """Seeded registry of (task, attempt)-keyed faults, consulted by
    executor workers as each attempt starts. Thread-safe; each fault pops
    when it fires so retries run clean."""

    def __init__(self, seed: Optional[int] = None):
        if seed is None:
            seed = int(os.environ.get("MMLSPARK_TPU_FAULT_SEED", "0"))
        self.seed = int(seed)
        self._rng = np.random.default_rng(seed)
        self._kill = {}
        self._delay = {}
        self._slow = {}
        self._corrupt = {}
        self._drop_beat = {}
        #: (index, attempt) -> "host"|"device" out-of-memory directives
        self._oom: Dict[Tuple[int, int], str] = {}
        #: ordered disk-full directives, consumed first-match per write
        self._disk_full: List[dict] = []
        self._write_seq = 0
        #: ordered torn-shard directives, consumed first-match per read
        self._truncate: List[dict] = []
        self._record_seq = 0
        self._lock = threading.Lock()
        #: [(kind, task_index, attempt)] in fire order
        self.fired: List[Tuple[str, int, int]] = []

    # -- registration (chainable) -------------------------------------------

    def kill_task(self, index: int, attempt: int = 0) -> "FaultPlan":
        self._kill[(int(index), int(attempt))] = True
        return self

    def delay_task(self, index: int, seconds: float, attempt: int = 0) -> "FaultPlan":
        self._delay[(int(index), int(attempt))] = float(seconds)
        return self

    def slow_task(self, index: int, seconds: float, attempt: int = 0) -> "FaultPlan":
        """Attempt ``attempt`` of task ``index`` blocks up to ``seconds`` but
        wakes when superseded (a speculative copy won, or the scheduler
        re-dispatched it), then runs the task body."""
        self._slow[(int(index), int(attempt))] = float(seconds)
        return self

    def corrupt_result(self, index: int, attempt: int = 0) -> "FaultPlan":
        """Attempt ``attempt`` of task ``index`` computes and checksums its
        result, then the reported value is corrupted; the scheduler's CRC
        check books a retryable ``corrupt`` failure."""
        self._corrupt[(int(index), int(attempt))] = True
        return self

    def drop_heartbeat(self, index: int, attempt: int = 0, hold: float = 30.0) -> "FaultPlan":
        """The executor running attempt ``attempt`` of task ``index`` stops
        heartbeating and blocks (up to ``hold`` seconds, or until the
        scheduler supersedes the attempt), then dies."""
        self._drop_beat[(int(index), int(attempt))] = float(hold)
        return self

    def kill_random_task(self, num_tasks: int, attempt: int = 0) -> "FaultPlan":
        """Seeded kill-one-executor: the victim index is drawn from the
        plan's RNG."""
        return self.kill_task(int(self._rng.integers(num_tasks)), attempt)

    def oom_task(self, index: int, kind: str = "host", attempt: int = 0) -> "FaultPlan":
        """Attempt ``attempt`` of task ``index`` runs out of memory at its
        boundary: ``MemoryError`` for ``kind="host"``, :class:`DeviceOomError`
        for ``kind="device"``. Device OOMs registered against a GBDT fit fire
        from the histogram dispatch instead (``index`` = fit iteration,
        ``attempt`` = the iteration's retry), so the fit's out-of-memory
        ladder absorbs them."""
        if kind not in ("host", "device"):
            raise ValueError(f"unknown OOM kind {kind!r} (expected 'host' or 'device')")
        self._oom[(int(index), int(attempt))] = str(kind)
        return self

    def disk_full(self, path_substr: str, count: int = 1) -> "FaultPlan":
        """The next ``count`` guarded writes whose target path holds
        ``path_substr`` raise ``OSError(ENOSPC)`` before any byte is written,
        so the fault leaves no torn file."""
        self._disk_full.append({"substr": str(path_substr), "n": int(count)})
        return self

    def truncate_shard(self, path_substr: str, count: int = 1) -> "FaultPlan":
        """The next ``count`` guarded shard reads whose path holds
        ``path_substr`` raise :class:`CorruptShardError` before any byte is
        decoded."""
        self._truncate.append({"substr": str(path_substr), "n": int(count)})
        return self

    def will_corrupt(self, index: int, attempt: int) -> bool:
        """True while a ``corrupt_result`` fault is registered for this
        (task, attempt): the executor then checksums the result even when
        ``policy.result_integrity`` is off."""
        with self._lock:
            return (int(index), int(attempt)) in self._corrupt

    # -- worker-side hooks ----------------------------------------------------

    def apply_on_start(self, index: int, attempt: int, worker=None,
                       superseded: Optional[threading.Event] = None) -> None:
        """Fire any faults registered for this (task, attempt). Called by
        the executor worker immediately before it runs the task body."""
        key = (int(index), int(attempt))
        with self._lock:
            delay = self._delay.pop(key, None)
            slow = self._slow.pop(key, None)
            drop = self._drop_beat.pop(key, None)
            kill = self._kill.pop(key, None)
            oom = self._oom.pop(key, None)
        if delay is not None:
            self.fired.append(("delay", index, attempt))
            time.sleep(delay)
        if slow is not None:
            self.fired.append(("slow_task", index, attempt))
            # straggle, but stay cancellable: a supersede wakes the attempt
            if superseded is not None:
                superseded.wait(timeout=slow)
            else:
                time.sleep(slow)
        if drop is not None:
            self.fired.append(("drop_heartbeat", index, attempt))
            if worker is not None:
                worker.beat_suppressed = True
            # hang without heartbeats until declared lost, then die like one
            if superseded is not None:
                superseded.wait(timeout=drop)
            else:
                time.sleep(drop)
            raise ExecutorDeathError(f"injected heartbeat loss on task {index} attempt {attempt}")
        if kill:
            self.fired.append(("kill", index, attempt))
            raise ExecutorDeathError(f"injected executor death on task {index} attempt {attempt}")
        if oom is not None:
            self.fired.append((f"oom_{oom}", index, attempt))
            if oom == "host":
                raise MemoryError(f"injected host OOM on task {index} attempt {attempt}")
            raise DeviceOomError(
                f"RESOURCE_EXHAUSTED: injected device OOM on task {index} attempt {attempt}")

    def apply_on_histogram(self, iteration: int, attempt: int) -> None:
        """Consulted by the GBDT loop before each iteration's step. Pops a
        registered *device* OOM keyed (iteration, retry) and raises it as
        :class:`DeviceOomError`; the loop's out-of-memory catch then walks
        the degradation ladder and retries the iteration. Host OOMs belong
        to the task boundary and never fire here."""
        key = (int(iteration), int(attempt))
        with self._lock:
            if self._oom.get(key) != "device":
                return
            self._oom.pop(key)
        self.fired.append(("oom_device", int(iteration), int(attempt)))
        raise DeviceOomError("RESOURCE_EXHAUSTED: injected device OOM at histogram "
                             f"iteration {iteration} attempt {attempt}")

    def apply_on_result(self, index: int, attempt: int, result):
        """Consulted after the task body returns and its checksum is taken:
        a corrupted copy of ``result`` under a ``corrupt_result`` fault,
        else ``result``."""
        with self._lock:
            corrupt = self._corrupt.pop((int(index), int(attempt)), None)
        if not corrupt:
            return result
        self.fired.append(("corrupt_result", index, attempt))
        return _corrupted_copy(result)

    def apply_on_write(self, path: str) -> None:
        """Pop the first ``disk_full`` directive matching ``path`` and raise
        ``OSError(ENOSPC)``, before the caller opens the file."""
        with self._lock:
            seq = self._take(self._disk_full, path, "_write_seq")
            if seq is None:
                return
            self._disk_full = [d for d in self._disk_full if d["n"] > 0]
        self.fired.append(("disk_full", seq, 0))
        raise OSError(errno.ENOSPC, "No space left on device (injected)", str(path))

    def apply_on_record(self, path: str) -> None:
        """Pop the first ``truncate_shard`` directive matching ``path`` and
        raise :class:`CorruptShardError`, before the reader decodes it."""
        with self._lock:
            seq = self._take(self._truncate, path, "_record_seq")
            if seq is None:
                return
            self._truncate = [d for d in self._truncate if d["n"] > 0]
        self.fired.append(("truncate_shard", seq, 0))
        raise CorruptShardError(f"truncated shard (injected): {path}")

    def _take(self, directives: List[dict], path: str, counter: str) -> Optional[int]:
        """Consume one use of the first directive whose substring is in
        ``path``; returns the plane's sequence number, or None. Caller
        holds the lock."""
        for d in directives:
            if d["n"] > 0 and d["substr"] in str(path):
                d["n"] -= 1
                seq = getattr(self, counter)
                setattr(self, counter, seq + 1)
                return seq
        return None


class _TaintedResult:
    """Stand-in for a result corrupted beyond byte-flipping (not a buffer
    type). Never equal to the clean value, and pickles to other bytes."""

    def __init__(self, original):
        self.original = original

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"_TaintedResult({self.original!r})"


def _corrupted_copy(result):
    """A deterministically corrupted copy of ``result``: its first byte
    flipped for arrays and bytes, a tainted wrapper otherwise."""
    if isinstance(result, np.ndarray) and result.size and result.dtype != object:
        bad = result.copy()
        bad.view(np.uint8).reshape(-1)[0] ^= 0xFF
        return bad
    if isinstance(result, (bytes, bytearray)) and len(result):
        bad = bytearray(result)
        bad[0] ^= 0xFF
        return bytes(bad)
    return _TaintedResult(result)


# -- ambient injection (reaches schedulers created inside fit calls) ---------

_ACTIVE: List[FaultPlan] = []


@contextlib.contextmanager
def inject_faults(plan: FaultPlan) -> Iterator[FaultPlan]:
    """Make ``plan`` visible to every scheduler whose policy carries no
    explicit plan, and to the fits and readers started inside the block."""
    _ACTIVE.append(plan)
    try:
        yield plan
    finally:
        _ACTIVE.remove(plan)


def current_faults() -> Optional[FaultPlan]:
    return _ACTIVE[-1] if _ACTIVE else None


def check_write(path: str) -> None:
    """Guarded-write gate: durable writers call it with their target path
    before touching the file system; raises ``OSError(ENOSPC)`` under a
    matching :meth:`FaultPlan.disk_full` directive."""
    plan = current_faults()
    if plan is not None:
        plan.apply_on_write(path)


def check_record(path: str) -> None:
    """Guarded-read gate: shard readers call it with the source path before
    decoding; raises :class:`CorruptShardError` under a matching
    :meth:`FaultPlan.truncate_shard` directive."""
    plan = current_faults()
    if plan is not None:
        plan.apply_on_record(path)


def is_oom_error(err: BaseException) -> bool:
    """Memory exhaustion: a host ``MemoryError``, a card's
    ``torch.cuda.OutOfMemoryError``, or an error whose message carries the
    ``RESOURCE_EXHAUSTED`` marker (the injected :class:`DeviceOomError`)."""
    return (isinstance(err, (MemoryError, torch.cuda.OutOfMemoryError))
            or "RESOURCE_EXHAUSTED" in str(err))
