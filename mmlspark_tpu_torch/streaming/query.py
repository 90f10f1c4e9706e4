"""The micro-batch engine: triggers, offset WAL, commit log, restart — the
port's copy of ``mmlspark_tpu/streaming/query.py``, with the same
checkpoint layout, so either package resumes the other's checkpoint.

This is the Structured Streaming ``StreamExecution`` analogue: a
:class:`StreamingQuery` repeatedly plans an epoch (a slice of new source
offsets), durably logs the plan, runs the sink, then durably logs the
commit. The two logs live under the checkpoint location:

    <checkpoint>/offsets/<epoch>.json   — written BEFORE processing (WAL):
                                          {"epoch", "start", "end", "manifest"}
    <checkpoint>/commits/<epoch>.json   — written AFTER the sink returns:
                                          {"epoch", "start", "end", "rows"}
    <checkpoint>/deadletter/            — epoch-keyed dead-letter store for
                                          records quarantined by a
                                          permissive/dropmalformed source
                                          (see mmlspark_tpu_torch.dataguard.dlq)

Restart contract (the ``checkpointLocation`` semantics):

- the last *committed* epoch fixes the resume offset — committed epochs
  are never re-planned and never re-processed;
- an epoch whose WAL exists but whose commit is missing (the process died
  mid-epoch) is *replayed from its recorded manifest* — the identical
  unit list, even if the source directory has since grown;
- the sink absorbs the replay idempotently (epoch-keyed dedup — see
  :mod:`mmlspark_tpu_torch.streaming.sink`), so delivery is exactly-once
  end to end under a SIGKILL at any point.

Triggers mirror Spark's: :class:`ProcessingTime` (tick every interval),
:class:`Once` (one epoch then terminate), :class:`AvailableNow` (drain
the backlog in rate-limited epochs, then terminate).

Chaos integration: at two designated points per epoch (``post_wal`` —
plan logged, nothing processed; ``pre_commit`` — sink done, commit log
missing: the nastiest window) the query consults the ambient
:class:`~mmlspark_tpu_torch.runtime.faults.FaultPlan` and honors a
registered ``kill_stream`` directive with a real ``SIGKILL`` of its own
process (``tools/torch_streaming_chaos_smoke.py`` drives both windows).
"""

from __future__ import annotations

import json
import os
import signal
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from mmlspark_tpu_torch.core.profiling import get_logger
from mmlspark_tpu_torch.observability.events import (
    StreamEpochCommitted,
    StreamEpochStarted,
    StreamSourceAdvanced,
    get_bus,
)
from mmlspark_tpu_torch.observability.registry import get_registry
from mmlspark_tpu_torch.runtime.journal import _atomic_write, default_checkpoint_dir
from mmlspark_tpu_torch.streaming.sink import Sink
from mmlspark_tpu_torch.streaming.source import StreamSource

logger = get_logger("mmlspark_tpu_torch.streaming")

#: epoch-batch sizes are small; latency buckets would bunch in one bucket
_EPOCH_SECONDS_BUCKETS = (
    0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 15.0, 60.0,
)


class Trigger:
    """When the query plans its next epoch."""


class ProcessingTime(Trigger):
    """Tick every ``interval_s`` seconds (Spark's default trigger shape)."""

    def __init__(self, interval_s: float = 1.0):
        self.interval_s = float(interval_s)


class Once(Trigger):
    """Process exactly one epoch (if data is available), then terminate."""


class AvailableNow(Trigger):
    """Drain everything currently available as rate-limited epochs
    (``max_per_trigger`` applies per epoch), then terminate."""


class StreamingQuery:
    """One continuous source → sink pipeline with durable epoch commits.

    With no checkpoint location (``checkpoint_dir=None`` and no ambient
    ``MMLSPARK_TPU_CHECKPOINT_DIR``) the query still runs — offsets live
    in memory and a restart starts over, exactly like an un-checkpointed
    Spark query.
    """

    def __init__(
        self,
        source: StreamSource,
        sink: Sink,
        trigger: Optional[Trigger] = None,
        name: str = "query",
        checkpoint_dir: Optional[str] = None,
        registry=None,
    ):
        self.source = source
        self.sink = sink
        self.trigger = trigger or Once()
        self.name = name
        if checkpoint_dir is None:
            root = default_checkpoint_dir()
            if root is not None:
                checkpoint_dir = os.path.join(root, "streaming", name)
        self.checkpoint_dir = checkpoint_dir
        self._offset = 0
        self._next_epoch = 0
        #: (epoch, start, end, manifest) of a WAL'd-but-uncommitted epoch
        self._replay: Optional[Tuple[int, int, int, List[Any]]] = None
        self._stop = threading.Event()
        self._terminated = threading.Event()
        self._terminated.set()
        self._thread: Optional[threading.Thread] = None
        #: the exception that terminated the query, if any
        self.exception: Optional[BaseException] = None
        self.last_progress: Dict[str, Any] = {}
        reg = registry if registry is not None else get_registry()
        labels = {"query": name}
        self._reg_epochs = reg.counter(
            "streaming_epochs_total", "Micro-batch epochs committed"
        ).labels(**labels)
        self._reg_rows = reg.counter(
            "streaming_rows_total", "Rows processed by committed epochs"
        ).labels(**labels)
        self._reg_epoch_s = reg.histogram(
            "streaming_epoch_seconds", "Plan-to-commit time per epoch",
            buckets=_EPOCH_SECONDS_BUCKETS,
        ).labels(**labels)
        self._reg_offset = reg.gauge(
            "streaming_offset", "Committed source offset"
        ).labels(**labels)
        #: dead-letter store for source quarantines (checkpointed only):
        #: epoch-keyed under the WAL epoch, so a replayed epoch that
        #: re-quarantines the same corrupt records letters them once
        self.dead_letters = None
        if self.checkpoint_dir is not None:
            os.makedirs(os.path.join(self.checkpoint_dir, "offsets"), exist_ok=True)
            os.makedirs(os.path.join(self.checkpoint_dir, "commits"), exist_ok=True)
            from mmlspark_tpu_torch.dataguard.dlq import DeadLetterStore

            self.dead_letters = DeadLetterStore(
                os.path.join(self.checkpoint_dir, "deadletter"),
                name=name, registry=reg,
            )
            self._restore()

    # -- checkpoint ----------------------------------------------------------

    def _log_path(self, kind: str, epoch: int) -> str:
        assert self.checkpoint_dir is not None
        return os.path.join(self.checkpoint_dir, kind, f"{epoch:06d}.json")

    @staticmethod
    def _read_log(path: str) -> Optional[Dict[str, Any]]:
        try:
            with open(path, "r", encoding="utf-8") as fh:
                return json.load(fh)
        except (OSError, ValueError):
            return None

    def _scan_epochs(self, kind: str) -> List[int]:
        try:
            names = os.listdir(os.path.join(self.checkpoint_dir, kind))
        except OSError:
            return []
        return sorted(
            int(n[:-5]) for n in names if n.endswith(".json") and n[:-5].isdigit()
        )

    def _restore(self) -> None:
        """Resume offsets from the commit log; arm replay for a planned
        epoch the last run never committed."""
        commits = self._scan_epochs("commits")
        if commits:
            last = commits[-1]
            rec = self._read_log(self._log_path("commits", last))
            if rec is not None:
                self._offset = int(rec.get("end", 0))
                self._next_epoch = last + 1
        wal = self._read_log(self._log_path("offsets", self._next_epoch))
        if wal is not None:
            self._replay = (
                self._next_epoch,
                int(wal.get("start", self._offset)),
                int(wal.get("end", self._offset)),
                list(wal.get("manifest", [])),
            )
            logger.info(
                "query %r: replaying uncommitted epoch %d (offsets [%d, %d))",
                self.name, self._next_epoch, self._replay[1], self._replay[2],
            )
        if commits or self._replay is not None:
            logger.info(
                "query %r restored: next epoch %d, offset %d",
                self.name, self._next_epoch, self._offset,
            )

    def _write_wal(
        self, epoch: int, start: int, end: int, manifest: List[Any]
    ) -> None:
        if self.checkpoint_dir is None:
            return
        _atomic_write(
            self._log_path("offsets", epoch),
            json.dumps({
                "epoch": epoch, "start": start, "end": end,
                "manifest": manifest,
            }).encode("utf-8"),
        )

    def _write_commit(self, epoch: int, start: int, end: int, rows: int) -> None:
        if self.checkpoint_dir is None:
            return
        _atomic_write(
            self._log_path("commits", epoch),
            json.dumps({
                "epoch": epoch, "start": start, "end": end, "rows": rows,
            }).encode("utf-8"),
        )

    @property
    def committed_epochs(self) -> List[int]:
        if self.checkpoint_dir is None:
            return list(range(self._next_epoch))
        return self._scan_epochs("commits")

    # -- chaos ---------------------------------------------------------------

    def _maybe_die(self, epoch: int, point: str) -> None:
        """Honor an ambient ``kill_stream`` directive with a REAL SIGKILL
        of this process — no Python cleanup, no atexit: the death the
        checkpoint contract exists for."""
        from mmlspark_tpu_torch.runtime.faults import current_faults

        plan = current_faults()
        if plan is not None and plan.should_kill_stream(epoch, point):
            logger.warning(
                "query %r: injected SIGKILL at epoch %d (%s)",
                self.name, epoch, point,
            )
            os.kill(os.getpid(), signal.SIGKILL)

    # -- the epoch loop ------------------------------------------------------

    def process_next(self) -> Optional[int]:
        """Plan + process + commit one epoch. Returns rows processed, or
        None when the source has nothing new."""
        t0 = time.perf_counter()
        if self._replay is not None:
            epoch, start, end, manifest = self._replay
        else:
            end = self.source.latest_offset()
            cap = self.source.max_per_trigger
            if cap is not None and cap > 0:
                end = min(end, self._offset + cap)
            if end <= self._offset:
                return None
            epoch, start = self._next_epoch, self._offset
            manifest = self.source.plan_batch(start, end)
            self._write_wal(epoch, start, end, manifest)
        bus = get_bus()
        if bus.active:
            bus.publish(StreamEpochStarted(
                query=self.name, epoch=epoch, start=start, end=end,
            ))
            bus.publish(StreamSourceAdvanced(
                query=self.name, start=start, end=end, units=len(manifest),
            ))
        self._maybe_die(epoch, "post_wal")
        table = self.source.load_batch(manifest)
        quarantined = list(getattr(self.source, "last_quarantined", ()))
        if quarantined and self.dead_letters is not None:
            # Before the sink, after the WAL: a pre_commit SIGKILL replays
            # the epoch, re-quarantines the same records, and commit_epoch
            # finds the manifest already present — exactly-once either way.
            self.dead_letters.commit_epoch(epoch, quarantined)
        self.sink.process_batch(epoch, table)
        self._maybe_die(epoch, "pre_commit")
        rows = table.num_rows
        self._write_commit(epoch, start, end, rows)
        self._replay = None
        self._offset = end
        self._next_epoch = epoch + 1
        duration = time.perf_counter() - t0
        self._reg_epochs.inc()
        self._reg_rows.inc(rows)
        self._reg_epoch_s.observe(duration)
        self._reg_offset.set(end)
        self.last_progress = {
            "epoch": epoch, "start": start, "end": end, "rows": rows,
            "duration_s": duration,
        }
        if bus.active:
            bus.publish(StreamEpochCommitted(
                query=self.name, epoch=epoch, rows=rows, duration=duration,
            ))
        return rows

    def process_all_available(self) -> int:
        """Drain the backlog synchronously; returns total rows processed."""
        total = 0
        while not self._stop.is_set():
            rows = self.process_next()
            if rows is None:
                break
            total += rows
        return total

    # -- lifecycle -----------------------------------------------------------

    def _run(self) -> None:
        try:
            if isinstance(self.trigger, Once):
                self.process_next()
            elif isinstance(self.trigger, AvailableNow):
                self.process_all_available()
            else:
                interval = self.trigger.interval_s  # type: ignore[attr-defined]
                while not self._stop.is_set():
                    t0 = time.monotonic()
                    self.process_all_available()
                    elapsed = time.monotonic() - t0
                    self._stop.wait(max(0.0, interval - elapsed))
        except Exception as e:  # noqa: BLE001 - terminates + surfaces the query
            self.exception = e
            logger.warning(
                "query %r terminated by %s: %s", self.name, type(e).__name__, e
            )
        finally:
            self._terminated.set()

    def start(self) -> "StreamingQuery":
        """Run the trigger loop on a background thread (``Once`` and
        ``AvailableNow`` terminate on their own; ``ProcessingTime`` runs
        until :meth:`stop`)."""
        if self._thread is not None and self._thread.is_alive():
            raise RuntimeError(f"query {self.name!r} is already running")
        self._stop.clear()
        self._terminated.clear()
        self.exception = None
        self._thread = threading.Thread(
            target=self._run, daemon=True, name=f"stream-{self.name}"
        )
        self._thread.start()
        return self

    @property
    def active(self) -> bool:
        return not self._terminated.is_set()

    def await_termination(self, timeout: Optional[float] = None) -> bool:
        """Block until the trigger loop terminates; True when it did."""
        return self._terminated.wait(timeout)

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=30.0)
            self._thread = None

    def __enter__(self) -> "StreamingQuery":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()
