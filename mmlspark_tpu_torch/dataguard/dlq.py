"""Dead-letter store: the durable ``badRecordsPath`` analogue.

The write side of ``mmlspark_tpu/dataguard/dlq.py``'s ``DeadLetterStore``,
which a permissive :class:`~mmlspark_tpu_torch.data.sharded.ShardedDataset`
letters its quarantined shards to. The same files, byte for byte:

    <root>/records/NNNNNN.jsonl         one JSON object per quarantined
                                        record (source, index, reason,
                                        detail)
    <root>/records/NNNNNN.jsonl.crc32   CRC32 of those bytes
    <root>/manifest/NNNNNN.json         the epoch's commit point:
                                        {"count", "crc32", "epoch", "reasons"}

Every file is written to a temporary name and renamed, and the manifest
last, so its existence is the only commit signal. The metrics, events and
the replay side are not ported yet.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import zlib
from typing import List, Optional, Sequence

from mmlspark_tpu_torch.dataguard.modes import CorruptRecord, summarize_reasons

_log = logging.getLogger("mmlspark_tpu_torch.dataguard")


def _atomic_write(path: str, data: bytes) -> None:
    """tmp + fsync + rename: the file at ``path`` holds its old content or
    the whole new content, never a prefix."""
    tmp = path + ".tmp"
    with open(tmp, "wb") as fh:
        fh.write(data)
        fh.flush()
        os.fsync(fh.fileno())
    os.replace(tmp, path)


class DeadLetterStore:
    """Epoch-keyed quarantine with CRC sidecars under a durable root;
    ``name`` labels the owning dataset in the log."""

    def __init__(self, root: str, name: str = "dataguard"):
        self.root = root
        self.name = name
        self._records_dir = os.path.join(root, "records")
        self._manifest_dir = os.path.join(root, "manifest")
        os.makedirs(self._records_dir, exist_ok=True)
        os.makedirs(self._manifest_dir, exist_ok=True)
        self._lock = threading.Lock()

    def _records_path(self, epoch: int) -> str:
        return os.path.join(self._records_dir, f"{epoch:06d}.jsonl")

    def _manifest_path(self, epoch: int) -> str:
        return os.path.join(self._manifest_dir, f"{epoch:06d}.json")

    def epochs(self) -> List[int]:
        """Committed epoch ids, ascending."""
        try:
            names = os.listdir(self._manifest_dir)
        except OSError:
            return []
        return sorted(int(n[:-5]) for n in names if n.endswith(".json") and n[:-5].isdigit())

    def letter(self, records: Sequence[CorruptRecord]) -> Optional[int]:
        """Letter ``records`` under the next free epoch; returns the epoch,
        or None when there was nothing to letter."""
        recs = list(records)
        if not recs:
            return None
        data = "".join(json.dumps(r.to_record(), sort_keys=True) + "\n"
                       for r in recs).encode("utf-8")
        crc = zlib.crc32(data) & 0xFFFFFFFF
        reasons = summarize_reasons(recs)
        with self._lock:
            existing = self.epochs()
            epoch = (existing[-1] + 1) if existing else 0
            _atomic_write(self._records_path(epoch), data)
            _atomic_write(self._records_path(epoch) + ".crc32", f"{crc:08x}".encode())
            _atomic_write(self._manifest_path(epoch), json.dumps({
                "epoch": epoch, "count": len(recs), "crc32": f"{crc:08x}", "reasons": reasons,
            }, sort_keys=True).encode("utf-8"))
        _log.warning("dead-letter store %r: epoch %d quarantined %d record(s) (%s)",
                     self.name, epoch, len(recs), reasons)
        return epoch
