"""Dead-letter store — the durable ``badRecordsPath`` analogue; the port's
copy of ``mmlspark_tpu/dataguard/dlq.py``, with the same files byte for
byte, so a store written by either package replays in the other.

Spark writes corrupt records as JSON under ``badRecordsPath`` with no
integrity or replay story; this store is the checkpoint-grade version:

    <root>/records/NNNNNN.jsonl         one JSON object per quarantined
                                        record (source, index, reason,
                                        detail), written tmp+rename
    <root>/records/NNNNNN.jsonl.crc32   CRC32 sidecar over the bytes
    <root>/manifest/NNNNNN.json         the epoch's commit point:
                                        {"epoch", "count", "crc32",
                                         "reasons"}

The manifest file is written LAST (atomically), so its existence is the
only commit signal — a SIGKILL between the records file and the manifest
leaves an uncommitted epoch that the replayed epoch simply rewrites.
:meth:`DeadLetterStore.commit_epoch` is epoch-keyed idempotent: a
replayed streaming epoch (WAL'd but SIGKILL'd before its commit log)
re-quarantines the identical records, finds the manifest already
present, and letters nothing twice — exactly-once under the streaming
WAL, the same contract the sinks keep.

Committing publishes :class:`~mmlspark_tpu_torch.observability.events.RecordsDeadLettered`
and feeds the ``dataguard_*`` metrics; :meth:`DeadLetterStore.replay`
CRC-verifies every records file before handing the rows back.
"""

from __future__ import annotations

import json
import os
import threading
import zlib
from typing import Any, Dict, List, Optional, Sequence

from mmlspark_tpu_torch.core.profiling import get_logger
from mmlspark_tpu_torch.dataguard.modes import (
    CorruptRecord,
    as_corrupt_records,
    summarize_reasons,
)
from mmlspark_tpu_torch.runtime.journal import _atomic_write

logger = get_logger("mmlspark_tpu_torch.dataguard")


class DeadLetterStore:
    """Epoch-keyed, CRC-sidecar'd quarantine under a durable root.

    ``name`` labels the owning dataset/query in events and metrics.
    Batch readers with no natural epoch use :meth:`letter`, which
    allocates the next free epoch index; streaming queries use
    :meth:`commit_epoch` keyed by their WAL epoch so replays dedup.
    """

    def __init__(self, root: str, name: str = "dataguard", registry=None):
        self.root = root
        self.name = name
        self._records_dir = os.path.join(root, "records")
        self._manifest_dir = os.path.join(root, "manifest")
        os.makedirs(self._records_dir, exist_ok=True)
        os.makedirs(self._manifest_dir, exist_ok=True)
        self._lock = threading.Lock()
        if registry is None:
            from mmlspark_tpu_torch.observability.registry import get_registry

            registry = get_registry()
        labels = {"source": name}
        self._reg_quarantined = registry.counter(
            "dataguard_quarantined_total",
            "Records quarantined to the dead-letter store",
        ).labels(**labels)
        self._reg_epochs = registry.counter(
            "dataguard_dlq_epochs_total",
            "Dead-letter epochs committed (manifest written)",
        ).labels(**labels)
        self._reg_replayed = registry.counter(
            "dataguard_replayed_total",
            "Dead-lettered records handed back by replay()",
        ).labels(**labels)

    # -- paths ---------------------------------------------------------------

    def _records_path(self, epoch: int) -> str:
        return os.path.join(self._records_dir, f"{epoch:06d}.jsonl")

    def _manifest_path(self, epoch: int) -> str:
        return os.path.join(self._manifest_dir, f"{epoch:06d}.json")

    # -- write side ----------------------------------------------------------

    def has_epoch(self, epoch: int) -> bool:
        """True when ``epoch`` is committed (its manifest exists)."""
        return os.path.exists(self._manifest_path(int(epoch)))

    def epochs(self) -> List[int]:
        """Committed epoch ids, ascending."""
        try:
            names = os.listdir(self._manifest_dir)
        except OSError:
            return []
        return sorted(
            int(n[:-5]) for n in names
            if n.endswith(".json") and n[:-5].isdigit()
        )

    def commit_epoch(self, epoch: int, records: Sequence[Any]) -> bool:
        """Durably letter ``records`` under ``epoch``. Returns True when
        this call committed the epoch, False when the epoch was already
        committed (a replayed epoch — nothing is written twice). Events
        and metrics are booked only on a fresh commit."""
        epoch = int(epoch)
        recs = as_corrupt_records(records)
        if not recs:
            return False
        with self._lock:
            if self.has_epoch(epoch):
                logger.info(
                    "dead-letter store %r: epoch %d already committed "
                    "(replay) — skipping %d record(s)",
                    self.name, epoch, len(recs),
                )
                return False
            data = "".join(
                json.dumps(r.to_record(), sort_keys=True) + "\n" for r in recs
            ).encode("utf-8")
            crc = zlib.crc32(data) & 0xFFFFFFFF
            _atomic_write(self._records_path(epoch), data)
            _atomic_write(
                self._records_path(epoch) + ".crc32", f"{crc:08x}".encode()
            )
            reasons = summarize_reasons(recs)
            _atomic_write(
                self._manifest_path(epoch),
                json.dumps({
                    "epoch": epoch, "count": len(recs), "crc32": f"{crc:08x}",
                    "reasons": reasons,
                }, sort_keys=True).encode("utf-8"),
            )
        self._reg_quarantined.inc(len(recs))
        self._reg_epochs.inc()
        from mmlspark_tpu_torch.observability.events import (
            RecordsDeadLettered, get_bus,
        )

        bus = get_bus()
        if bus.active:
            bus.publish(RecordsDeadLettered(
                source=self.name, epoch=epoch, count=len(recs),
                reasons=reasons,
            ))
        logger.warning(
            "dead-letter store %r: epoch %d quarantined %d record(s) (%s)",
            self.name, epoch, len(recs), reasons,
        )
        return True

    def letter(self, records: Sequence[Any]) -> Optional[int]:
        """Letter ``records`` under the next free epoch index (batch
        readers with no WAL epoch). Returns the epoch used, or None when
        there was nothing to letter."""
        recs = as_corrupt_records(records)
        if not recs:
            return None
        with self._lock:
            existing = self.epochs()
            epoch = (existing[-1] + 1) if existing else 0
        self.commit_epoch(epoch, recs)
        return epoch

    # -- read side -----------------------------------------------------------

    def manifest(self) -> Dict[int, Dict[str, Any]]:
        """Per-epoch manifest fold: epoch -> {count, crc32, reasons}."""
        out: Dict[int, Dict[str, Any]] = {}
        for epoch in self.epochs():
            try:
                with open(self._manifest_path(epoch), "r", encoding="utf-8") as fh:
                    out[epoch] = json.load(fh)
            except (OSError, ValueError) as e:
                logger.warning(
                    "dead-letter store %r: unreadable manifest for epoch "
                    "%d: %s", self.name, epoch, e,
                )
        return out

    def replay(self, epoch: Optional[int] = None) -> List[CorruptRecord]:
        """Hand back the quarantined records (one epoch, or all epochs in
        order), CRC-verifying every records file first — a torn or
        bit-rotted quarantine raises instead of replaying garbage."""
        epochs = [int(epoch)] if epoch is not None else self.epochs()
        out: List[CorruptRecord] = []
        for ep in epochs:
            path = self._records_path(ep)
            with open(path, "rb") as fh:
                data = fh.read()
            got = f"{zlib.crc32(data) & 0xFFFFFFFF:08x}"
            try:
                with open(path + ".crc32", "r", encoding="utf-8") as fh:
                    want = fh.read().strip()
            except OSError:
                want = got  # no sidecar: trust the manifest crc below
            manifest = self.manifest().get(ep, {})
            want = manifest.get("crc32", want)
            if got != want:
                raise ValueError(
                    f"dead-letter records for epoch {ep} failed CRC "
                    f"verification (want {want}, got {got})"
                )
            for line in data.decode("utf-8").splitlines():
                if not line.strip():
                    continue
                rec = json.loads(line)
                out.append(CorruptRecord(
                    source=rec["source"], index=int(rec["index"]),
                    reason=rec["reason"], detail=rec.get("detail", ""),
                ))
        self._reg_replayed.inc(len(out))
        return out

    def count(self) -> int:
        """Total records committed across all epochs (from manifests)."""
        return sum(int(m.get("count", 0)) for m in self.manifest().values())
