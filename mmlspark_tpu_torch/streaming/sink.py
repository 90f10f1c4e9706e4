"""Streaming sinks — epoch-keyed, idempotent batch consumers; the port's
copy of ``mmlspark_tpu/streaming/sink.py``.

The exactly-once story of the micro-batch engine is split the way
Structured Streaming splits it: the query guarantees *at-least-once*
delivery of each planned epoch (offset WAL before processing, commit log
after), and the sink guarantees *idempotence per epoch id* — re-delivery
of an epoch the sink already processed must change nothing. Together
that is exactly-once end to end, surviving a SIGKILL at any point.

- :class:`MemorySink` — collects batches for tests (Spark's memory
  sink); duplicate epochs are dropped;
- :class:`ForeachBatchSink` — ``foreachBatch(fn)``: the user callable
  receives ``(table, epoch)``; duplicate epochs are dropped before the
  callable runs;
- :class:`ModelCommitSink` — each micro-batch runs an incremental
  warm-start LightGBM fit (``modelString`` chaining +
  :func:`~mmlspark_tpu_torch.lightgbm.base._merge_boosters`, the same
  machinery ``numBatches`` uses; the fit runs on the estimator's device,
  the card by default, through ``histogram.cu``) and commits the merged
  booster through :class:`~mmlspark_tpu_torch.runtime.journal.FitJournal`
  (epoch-keyed, CRC-checksummed) and the
  :class:`~mmlspark_tpu_torch.runtime.journal.ModelStore` atomic
  ``CURRENT`` swap a hot-swapping server watches. The journal record is
  the epoch's durability point; the store commit is text-deduplicated, so
  a crash in any window between the two re-runs at most one *uncommitted*
  fit and never double-applies an epoch's trees.
"""

from __future__ import annotations

import os
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from mmlspark_tpu_torch.core.profiling import get_logger
from mmlspark_tpu_torch.data.table import Table

logger = get_logger("mmlspark_tpu_torch.streaming")


class Sink:
    """Epoch-keyed batch consumer. ``process_batch`` MUST be idempotent in
    ``epoch``: the query re-delivers the last planned epoch after a crash
    (offset WAL replay), and the sink absorbs the duplicate."""

    def process_batch(self, epoch: int, table: Table) -> Any:
        raise NotImplementedError


class MemorySink(Sink):
    """Collects processed batches in memory (the ``memory`` sink)."""

    def __init__(self) -> None:
        self.batches: List[Tuple[int, Table]] = []
        self._seen: set = set()

    def process_batch(self, epoch: int, table: Table) -> None:
        if epoch in self._seen:
            logger.warning("memory sink dropped duplicate epoch %d", epoch)
            return
        self._seen.add(epoch)
        self.batches.append((epoch, table))

    @property
    def rows(self) -> int:
        return sum(t.num_rows for _, t in self.batches)

    def table(self) -> Table:
        """All processed rows as one table, in epoch order."""
        ordered = [t for _, t in sorted(self.batches) if t.num_rows]
        if not ordered:
            return Table({})
        return Table.concat(ordered)


class ForeachBatchSink(Sink):
    """``foreachBatch``: hand each micro-batch to ``fn(table, epoch)``.
    Duplicate epochs (WAL replay after a crash) are dropped before the
    callable runs, so ``fn`` sees each epoch at most once per process;
    cross-restart idempotence is the callable's contract, as in Spark."""

    def __init__(self, fn: Callable[[Table, int], Any]):
        self.fn = fn
        self._seen: set = set()

    def process_batch(self, epoch: int, table: Table) -> Any:
        if epoch in self._seen:
            logger.warning("foreachBatch dropped duplicate epoch %d", epoch)
            return None
        self._seen.add(epoch)
        return self.fn(table, epoch)


class ModelCommitSink(Sink):
    """Incremental warm-start fit per micro-batch + durable model commit.

    ``estimator_factory`` builds a fresh estimator per epoch (e.g.
    ``lambda: LightGBMClassifier(numIterations=10, seed=7)``); the sink
    chains epochs by setting ``modelString`` to the previous committed
    ensemble, fits the new chunk only, merges the delta booster onto the
    ensemble (:func:`~mmlspark_tpu_torch.lightgbm.base._merge_boosters` — the
    ``LGBM_BoosterMerge`` analogue ``numBatches`` already uses), and
    commits:

    1. ``FitJournal.record(epoch, merged_text)`` — the durability point:
       a journaled epoch is never refitted (zero re-execution);
    2. ``ModelStore.commit`` under ``name`` — skipped when the store's
       latest text already equals the merged text, so a crash between
       (1) and (2) repairs the store on replay instead of re-committing,
       and the version sequence matches an undisturbed run exactly.

    The serving plane watches the store's ``CURRENT`` pointer
    (:meth:`~mmlspark_tpu_torch.serving.ServingServer.enable_hot_swap`), which
    closes the loop: ingest → incremental fit → live commit → hot serve.
    """

    def __init__(
        self,
        estimator_factory: Callable[[], Any],
        name: str = "model",
        root: Optional[str] = None,
        registry=None,
    ):
        from mmlspark_tpu_torch.observability.registry import get_registry
        from mmlspark_tpu_torch.runtime.journal import (
            FitJournal,
            ModelStore,
            default_checkpoint_dir,
        )

        root = root or default_checkpoint_dir()
        if root is None:
            raise ValueError(
                "ModelCommitSink needs a durable root: pass root= or set "
                "MMLSPARK_TPU_CHECKPOINT_DIR"
            )
        self.name = name
        self.root = root
        self._factory = estimator_factory
        self.store = ModelStore(os.path.join(root, "models"))
        self._journal = FitJournal(
            os.path.join(root, "streaming-models"), key=name
        )
        #: epoch -> committed ensemble text, restored at startup so a
        #: journaled epoch is never refitted
        self._committed: Dict[int, str] = {
            int(k): str(v) for k, v in self._journal.restore().items()
        }
        #: store versions committed (or found already current) per epoch
        self.versions: Dict[int, int] = {}
        reg = registry if registry is not None else get_registry()
        self._reg_version = reg.gauge(
            "streaming_model_version",
            "Latest model version committed by the streaming fit sink",
        )
        self._reg_fit = reg.histogram(
            "streaming_fit_seconds", "Incremental fit time per micro-batch",
            buckets=(0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0),
        )

    # -- state ---------------------------------------------------------------

    @property
    def committed_epochs(self) -> List[int]:
        return sorted(self._committed)

    def latest_text(self) -> Optional[str]:
        """The committed ensemble text of the highest journaled epoch."""
        if not self._committed:
            return None
        return self._committed[max(self._committed)]

    # -- the epoch commit ----------------------------------------------------

    def process_batch(self, epoch: int, table: Table) -> int:
        epoch = int(epoch)
        if epoch in self._committed:
            # WAL replay of an already-journaled epoch: no refit; just make
            # sure the store commit (step 2) also happened before the crash
            logger.info(
                "streaming sink: epoch %d already journaled; skipping refit",
                epoch,
            )
            return self._ensure_store(epoch, self._committed[epoch])
        if table.num_rows == 0:
            # every record of the epoch quarantined (permissive source over
            # a fully-corrupt batch): fitting zero rows would either fail
            # or commit a spurious ensemble delta — skip, so the model
            # stays byte-identical to a fit over the clean complement
            logger.info(
                "streaming sink: epoch %d has no surviving rows; skipping fit",
                epoch,
            )
            latest = self.store.latest(self.name)
            return latest[0] if latest is not None else -1
        merged_text = self._fit_epoch(epoch, table)
        self._journal.record(epoch, merged_text)
        self._committed[epoch] = merged_text
        return self._ensure_store(epoch, merged_text)

    def _fit_epoch(self, epoch: int, table: Table) -> str:
        from mmlspark_tpu_torch.lightgbm.base import _merge_boosters
        from mmlspark_tpu_torch.lightgbm.booster import Booster

        base_text = self.latest_text()
        est = self._factory()
        if base_text:
            est.set("modelString", base_text)
        t0 = time.perf_counter()
        model = est.fit(table)
        self._reg_fit.observe(time.perf_counter() - t0)
        delta = model.booster
        if base_text:
            merged = _merge_boosters([Booster.from_string(base_text), delta])
        else:
            merged = delta
        return merged.model_to_string()

    def _ensure_store(self, epoch: int, text: str) -> int:
        """Idempotent store commit: a replay whose text is already CURRENT
        commits nothing, so version numbers track distinct ensembles."""
        latest = self.store.latest(self.name)
        if latest is not None and latest[1] == text:
            version = latest[0]
        else:
            version = self.store.commit(text, name=self.name)
            from mmlspark_tpu_torch.observability.events import ModelCommitted, get_bus

            bus = get_bus()
            if bus.active:
                bus.publish(ModelCommitted(
                    model=self.name, version=version,
                    detail=f"stream epoch {epoch}",
                ))
        self.versions[epoch] = version
        self._reg_version.set(version)
        return version

    def close(self) -> None:
        self._journal.close()
