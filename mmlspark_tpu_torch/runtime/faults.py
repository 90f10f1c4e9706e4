"""Deterministic fault injection for the partition scheduler and the
process group.

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

The process plane (``runtime/procgroup.py``): ``kill_process(m, i, e)``:
member ``m`` of a process group SIGKILLs itself at the start of fit
iteration ``i`` in gang epoch ``e``. The directives travel in the epoch
spec (:meth:`FaultPlan.process_kill_directives`), the worker checks them
with :meth:`FaultPlan.should_die`, and the supervisor books the death
(:meth:`FaultPlan.mark_process_killed`).

The request plane (``io/http``): the outbound clients consult the ambient
plan before every wire call:

- ``http_storm(n)``: the next ``n`` matching requests answer a synthetic
  503 (or any status) without touching the network;
- ``http_delay(n, s)``: the next ``n`` matching requests stall ``s``
  seconds first;
- ``http_reset(n)``: the next ``n`` matching requests raise
  ``ConnectionResetError``.

The network plane: ``net_partition(a, b)``, ``net_delay(m, ms)``,
``net_drop(m, p)`` and ``net_corrupt(m, n)``. With an int gang member they
act on the gang's collective (``runtime/netchaos.py``), per epoch; the
supervisor ships them (:meth:`FaultPlan.net_directives`) and books what it
observed (:meth:`FaultPlan.mark_net_fired`). With a string target (a URL
substring) they act on the next ``count`` matching outbound HTTP requests
through :func:`check_net`, below ``http_storm``: a partition raises an
unreachable ``OSError``, a delay sleeps, a drop times out and a corruption
garbles the response body.

The poison plane of the serving edge: ``malformed_request(n, kind)``:
a load generator pops these (:meth:`FaultPlan.take_malformed`) to send
seeded poison payloads (``"json"`` undecodable bytes, ``"schema"``
wrong-width vectors, ``"nan"`` non-finite features), which the edge must
answer with structured 400s while the poison breaker sheds the flood.

Each fault fires at most once; ``plan.fired`` records what fired.
``kill_random_task`` and ``kill_random_process`` draw their victims from
the plan's seeded RNG (``np.random.default_rng(seed)``, the seed from
``MMLSPARK_TPU_FAULT_SEED`` when None), so the victim is the reference's
for the same seed.

The stream plane (``mmlspark_tpu_torch/streaming``):

- ``kill_stream(epoch, point)``: the streaming query SIGKILLs its own
  process at ``point`` of epoch ``epoch``, ``"post_wal"`` (offsets logged,
  nothing processed) or ``"pre_commit"`` (sink done, commit log missing),
  when it asks :meth:`FaultPlan.should_kill_stream`;
- ``corrupt_record(substr, index, n)``: record ``index`` of the next ``n``
  matching jsonl/json sources is garbled after the file read
  (:func:`corrupt_record_bytes`, the reference's bytes), so that record
  alone fails to decode and quarantines.
"""

from __future__ import annotations

import contextlib
import errno
import os
import socket
import sys
import threading
import time
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np


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
        #: process-kill directives, shipped to the gang in its epoch spec
        self._kill_process: List[dict] = []
        #: [{epoch, point}] streaming-query kill points
        self._kill_stream: List[dict] = []
        #: ordered per-record corruption directives (jsonl/json sources)
        self._corrupt_record: List[dict] = []
        #: ordered network directives: gang-targeted entries (int members)
        #: ship in the epoch spec; HTTP-targeted entries (str URL parts) are
        #: consumed by :meth:`apply_on_socket`
        self._net: List[dict] = []
        self._net_seq = 0
        #: ordered HTTP fault directives, consumed first-match per request
        self._http: List[dict] = []
        self._http_seq = 0
        #: ordered malformed-request directives, popped by a load generator
        self._malformed: List[dict] = []
        self._malformed_seq = 0
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

    def kill_process(self, member: int, iteration: int = 0, epoch: int = 0) -> "FaultPlan":
        """Member ``member`` of a supervised process group SIGKILLs itself
        at the start of fit ``iteration`` during gang ``epoch``: a real
        OS-level death (no atexit, no socket shutdown). Enacted by the
        worker from the directive in its epoch spec
        (:meth:`process_kill_directives`); the supervisor marks it fired
        when it observes the death (:meth:`mark_process_killed`)."""
        self._kill_process.append({"member": int(member), "iteration": int(iteration),
                                   "epoch": int(epoch)})
        return self

    def kill_random_process(self, num_members: int, iteration: int = 0,
                            epoch: int = 0) -> "FaultPlan":
        """Seeded kill-one-process chaos: the victim is drawn from the
        plan's RNG."""
        return self.kill_process(int(self._rng.integers(num_members)), iteration, epoch)

    def process_kill_directives(self) -> List[dict]:
        """The process-kill directives, JSON-serializable, for the epoch
        spec."""
        with self._lock:
            return [dict(d) for d in self._kill_process]

    def mark_process_killed(self, member: int) -> bool:
        """The supervisor saw member ``member`` die for a registered
        directive: pops the first directive for that member and books it
        in ``fired`` as ``("kill_process", member, epoch)``."""
        with self._lock:
            for i, d in enumerate(self._kill_process):
                if d["member"] == int(member):
                    popped = self._kill_process.pop(i)
                    break
            else:
                return False
        self.fired.append(("kill_process", int(member), int(popped["epoch"])))
        return True

    @staticmethod
    def should_die(directives: List[dict], member: int, iteration: int, epoch: int) -> bool:
        """Worker side: True when (member, iteration, epoch) is a death point
        of the directives from the epoch spec (no live plan in the worker)."""
        for d in directives or []:
            if (int(d.get("member", -1)) == int(member)
                    and int(d.get("iteration", 0)) == int(iteration)
                    and int(d.get("epoch", 0)) == int(epoch)):
                return True
        return False

    def kill_stream(self, epoch: int, point: str = "pre_commit") -> "FaultPlan":
        """The streaming query SIGKILLs its own process at ``point`` of epoch
        ``epoch``: ``"post_wal"`` (plan logged, nothing processed) or
        ``"pre_commit"`` (sink ran, commit log not yet written: the restart
        re-delivers the epoch and only the sink's idempotence keeps it
        exactly-once)."""
        if point not in ("post_wal", "pre_commit"):
            raise ValueError(f"unknown stream kill point {point!r} "
                             "(expected 'post_wal' or 'pre_commit')")
        self._kill_stream.append({"epoch": int(epoch), "point": str(point)})
        return self

    def should_kill_stream(self, epoch: int, point: str) -> bool:
        """The query asks at each crash window: pops the first matching
        directive and books it in ``fired`` as ``("kill_stream", epoch,
        0)``; True tells the caller to SIGKILL itself."""
        with self._lock:
            for i, d in enumerate(self._kill_stream):
                if d["epoch"] == int(epoch) and d["point"] == str(point):
                    self._kill_stream.pop(i)
                    break
            else:
                return False
        self.fired.append(("kill_stream", int(epoch), 0))
        return True

    def corrupt_record(self, path_substr: str, index: int = 0, count: int = 1) -> "FaultPlan":
        """Record ``index`` of the next ``count`` matching record-oriented
        sources (jsonl/json) is garbled after the file read
        (:func:`corrupt_record_bytes`), so that record alone fails to
        decode: the per-record quarantine path."""
        self._corrupt_record.append({"substr": str(path_substr), "index": int(index),
                                     "n": int(count)})
        return self

    def http_storm(self, count: int = 1, status: int = 503, url_part: str = "",
                   retry_after: Optional[float] = None) -> "FaultPlan":
        """The next ``count`` requests whose URL holds ``url_part`` answer a
        synthetic ``status`` (default 503) without a wire call;
        ``retry_after`` adds a Retry-After header to the fake response."""
        self._http.append({"kind": "status", "n": int(count), "status": int(status),
                           "url_part": url_part, "retry_after": retry_after})
        return self

    def http_delay(self, count: int = 1, seconds: float = 0.05,
                   url_part: str = "") -> "FaultPlan":
        """The next ``count`` matching requests stall ``seconds`` before they
        go to the wire."""
        self._http.append({"kind": "delay", "n": int(count), "seconds": float(seconds),
                           "url_part": url_part})
        return self

    def http_reset(self, count: int = 1, url_part: str = "") -> "FaultPlan":
        """The next ``count`` matching requests die with
        ``ConnectionResetError``."""
        self._http.append({"kind": "reset", "n": int(count), "url_part": url_part})
        return self

    def net_partition(self, a, b: int = 0, epoch: int = 0, after_round: int = 0,
                      count: int = 1) -> "FaultPlan":
        """Partition the link between gang members ``a`` and ``b`` during
        gang ``epoch``: from allreduce round ``after_round`` on, frames
        between them are swallowed both ways, and each side's collective
        deadline (not a hang) ends the epoch. With a string ``a`` (a URL
        substring) the next ``count`` matching outbound HTTP connections
        raise an unreachable ``OSError`` instead."""
        if isinstance(a, str):
            self._net.append({"target": "http", "kind": "partition",
                              "url_part": str(a), "n": int(count)})
        else:
            self._net.append({"target": "gang", "kind": "partition", "a": int(a),
                              "b": int(b), "epoch": int(epoch),
                              "after_round": int(after_round)})
        return self

    def net_delay(self, member, ms: float, epoch: int = 0, count: int = 1) -> "FaultPlan":
        """Member ``member`` lags every outgoing frame of gang ``epoch`` by
        ``ms`` milliseconds (the slow peer of the soft detector and, past
        the io deadline, of the revoke path). String targets stall the next
        ``count`` matching HTTP requests."""
        if isinstance(member, str):
            self._net.append({"target": "http", "kind": "delay", "url_part": str(member),
                              "n": int(count), "ms": float(ms)})
        else:
            self._net.append({"target": "gang", "kind": "delay", "member": int(member),
                              "ms": float(ms), "epoch": int(epoch)})
        return self

    def net_drop(self, member, p: float, epoch: int = 0, count: int = 1) -> "FaultPlan":
        """Each outgoing frame of member ``member`` is dropped with
        probability ``p``, from the worker's seeded RNG. String targets make
        the next ``count`` matching HTTP requests time out."""
        if isinstance(member, str):
            self._net.append({"target": "http", "kind": "drop", "url_part": str(member),
                              "n": int(count), "p": float(p)})
        else:
            self._net.append({"target": "gang", "kind": "drop", "member": int(member),
                              "p": float(p), "epoch": int(epoch)})
        return self

    def net_corrupt(self, member, n: int = 1, epoch: int = 0) -> "FaultPlan":
        """The next ``n`` frames member ``member`` sends are bit-flipped
        after checksumming: the receiver's CRC check must reject them and
        the bounded retransmit absorb them (the fit stays byte-identical).
        String targets garble the next ``n`` matching HTTP response
        bodies."""
        if isinstance(member, str):
            self._net.append({"target": "http", "kind": "corrupt", "url_part": str(member),
                              "n": int(n)})
        else:
            self._net.append({"target": "gang", "kind": "corrupt", "member": int(member),
                              "n": int(n), "epoch": int(epoch)})
        return self

    def malformed_request(self, count: int = 1, kind: str = "json") -> "FaultPlan":
        """The next ``count`` poison requests a load generator sends
        (:meth:`take_malformed`) are of ``kind``: ``"json"`` (undecodable
        bytes), ``"schema"`` (wrong-width feature vector) or ``"nan"``
        (non-finite features)."""
        if kind not in ("json", "schema", "nan"):
            raise ValueError(f"unknown malformed-request kind {kind!r} "
                             "(expected 'json', 'schema' or 'nan')")
        self._malformed.append({"kind": str(kind), "n": int(count)})
        return self

    def net_directives(self, epoch: Optional[int] = None) -> List[dict]:
        """The gang's network directives (of ``epoch`` when given),
        JSON-serializable, for the epoch spec. Not consumed here: the
        driver pops them through :meth:`mark_net_fired`."""
        with self._lock:
            return [dict(d) for d in self._net
                    if d["target"] == "gang" and (epoch is None or d["epoch"] == int(epoch))]

    def mark_net_fired(self, kind: str, member: Optional[int] = None,
                       epoch: Optional[int] = None) -> bool:
        """The supervisor observed a network directive's effect (a
        partition's revocation, a corruption's retransmit): pops the first
        match and books it in ``fired`` as ``("net_<kind>", member,
        epoch)``."""

        def _involves(d: dict, m: int) -> bool:
            if "member" in d:
                return int(d["member"]) == m
            return m in (int(d.get("a", -1)), int(d.get("b", -1)))

        with self._lock:
            popped = None
            for i, d in enumerate(self._net):
                if d["target"] != "gang" or d["kind"] != str(kind):
                    continue
                if epoch is not None and d["epoch"] != int(epoch):
                    continue
                if member is not None and not _involves(d, int(member)):
                    continue
                popped = self._net.pop(i)
                break
        if popped is None:
            return False
        who = member if member is not None else popped.get("member", popped.get("a", -1))
        self.fired.append((f"net_{kind}", int(who), int(popped["epoch"])))
        return True

    def apply_on_socket(self, url: str) -> Optional[dict]:
        """Pop the first HTTP-targeted network directive matching ``url``, or
        None. The caller (:func:`check_net`) enacts it at the socket: raise
        the unreachable error, sleep the delay, time out, or garble the
        response body. Consumed in registration order, one per request."""
        with self._lock:
            directive = None
            for d in self._net:
                if d["target"] == "http" and d["n"] > 0 and d["url_part"] in url:
                    d["n"] -= 1
                    directive = dict(d)
                    break
            if directive is None:
                return None
            self._net = [d for d in self._net if d["target"] != "http" or d["n"] > 0]
            seq = self._net_seq
            self._net_seq += 1
        self.fired.append((f"net_{directive['kind']}", seq, 0))
        return directive

    def apply_on_http(self, url: str) -> Optional[dict]:
        """Pop the first HTTP fault matching ``url``, or None. The client
        enacts it: synthesize the status, sleep the delay, or raise the
        reset. Consumed in registration order, one per request."""
        with self._lock:
            directive = None
            for d in self._http:
                if d["n"] > 0 and d["url_part"] in url:
                    d["n"] -= 1
                    directive = dict(d)
                    break
            if directive is None:
                return None
            self._http = [d for d in self._http if d["n"] > 0]
            seq = self._http_seq
            self._http_seq += 1
        kind = directive["kind"]
        self.fired.append((f"http_{kind}", seq,
                           directive["status"] if kind == "status" else 0))
        return directive

    def take_malformed(self) -> Optional[str]:
        """Pop one malformed-request directive and return its kind
        (``"json"``/``"schema"``/``"nan"``), or None when the storm is over.
        Booked in ``fired`` as ``("malformed_request", seq, 0)``."""
        with self._lock:
            directive = None
            for d in self._malformed:
                if d["n"] > 0:
                    d["n"] -= 1
                    directive = d
                    break
            if directive is None:
                return None
            self._malformed = [d for d in self._malformed if d["n"] > 0]
            seq = self._malformed_seq
            self._malformed_seq += 1
        self.fired.append(("malformed_request", seq, 0))
        return directive["kind"]

    @property
    def pending(self) -> int:
        """Faults registered and not yet fired (a directive with a count
        counts each use)."""
        with self._lock:
            return (len(self._kill) + len(self._delay) + len(self._drop_beat)
                    + len(self._slow) + len(self._corrupt) + len(self._kill_process)
                    + len(self._kill_stream)
                    + sum(d["n"] for d in self._http) + len(self._oom)
                    + sum(d["n"] for d in self._disk_full)
                    + sum(d["n"] for d in self._truncate)
                    + sum(d["n"] for d in self._corrupt_record)
                    + sum(d["n"] for d in self._malformed)
                    + sum(d["n"] if d["target"] == "http" else 1 for d in self._net))

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

    def apply_on_record_bytes(self, path: str, index: int, data: bytes) -> bytes:
        """Pop the first ``corrupt_record`` directive matching (``path``,
        ``index``) and return a garbled copy of ``data``, the raw bytes of
        that one record (the reference's prefix, which no JSON decoder
        accepts, before the original bytes); other reads get ``data``
        back."""
        with self._lock:
            for d in self._corrupt_record:
                if d["n"] > 0 and d["substr"] in str(path) and d["index"] == int(index):
                    d["n"] -= 1
                    break
            else:
                return data
            self._corrupt_record = [d for d in self._corrupt_record if d["n"] > 0]
        self.fired.append(("corrupt_record", int(index), 0))
        return b"\xff\xfe<corrupt>" + bytes(data)

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


def corrupt_record_bytes(path: str, index: int, data: bytes) -> bytes:
    """Per-record corruption gate: record-oriented loaders (jsonl/json) pass
    each record's raw bytes through it after the file read; a matching
    :meth:`FaultPlan.corrupt_record` directive garbles them, otherwise
    ``data`` comes back untouched."""
    plan = current_faults()
    if plan is None:
        return data
    return plan.apply_on_record_bytes(path, index, data)


def check_net(url: str) -> Optional[dict]:
    """Network-chaos gate of outbound HTTP: registry and router clients call
    it with the target URL right before they open the socket, below
    ``http_storm``. Enacts a matching HTTP-targeted directive of the ambient
    plan and books it in ``netchaos_http_faults_total``: ``partition`` raises
    an unreachable ``OSError``, ``delay`` sleeps, ``drop`` raises
    ``socket.timeout``; a ``corrupt`` directive is returned for the caller
    to garble the received body with. No-op without a plan."""
    plan = current_faults()
    if plan is None:
        return None
    directive = plan.apply_on_socket(url)
    if directive is None:
        return None
    from mmlspark_tpu_torch.observability.registry import get_registry

    get_registry().counter(
        "netchaos_http_faults_total",
        "Injected network degradations enacted on the HTTP client path",
    ).inc()
    kind = directive["kind"]
    if kind == "partition":
        raise OSError(errno.EHOSTUNREACH, "Network partition (injected)", url)
    if kind == "delay":
        time.sleep(directive["ms"] / 1000.0)
        return None
    if kind == "drop":
        raise socket.timeout(f"injected frame drop for {url}")
    return directive  # "corrupt": the caller garbles the response body


def is_oom_error(err: BaseException) -> bool:
    """Memory exhaustion: a host ``MemoryError``, a card's
    ``torch.cuda.OutOfMemoryError``, or an error whose message carries the
    ``RESOURCE_EXHAUSTED`` marker (the injected :class:`DeviceOomError`).
    A process that never imported torch (a replica serving a host model)
    has no card error to classify, and does not import it for this."""
    torch = sys.modules.get("torch")
    return (isinstance(err, MemoryError)
            or (torch is not None and isinstance(err, torch.cuda.OutOfMemoryError))
            or "RESOURCE_EXHAUSTED" in str(err))
