"""Partition lineage: recompute a lost shard instead of failing the job.

The port's copy of ``mmlspark_tpu/runtime/lineage.py``. A shard's lineage
is a ``source`` (a zero-argument closure returning the raw partition, such
as a row slice or a shard file's row range) and an ordered tuple of pure
``transforms``. When a task fails with :class:`PartitionLostError` and its
shard has lineage, the scheduler materializes the shard again from source
and retries on it. Sources and transforms are deterministic, so the
recomputed partition is the original bit for bit.
"""

from __future__ import annotations

import collections
import dataclasses
import threading
from typing import Any, Callable, Dict, Tuple


class PartitionLostError(RuntimeError):
    """A task's input partition is gone or corrupt (a shard that failed its
    CRC sidecar check). With recorded lineage the scheduler recomputes it
    and retries; otherwise it counts against the task's retry budget."""


@dataclasses.dataclass
class ShardLineage:
    """How to rebuild one partition payload from scratch."""

    source: Callable[[], Any]
    transforms: Tuple[Callable[[Any], Any], ...] = ()
    describe: str = ""

    def materialize(self) -> Any:
        payload = self.source()
        for fn in self.transforms:
            payload = fn(payload)
        return payload


class Lineage:
    """Registry of per-task-index shard lineage for one partitioned job."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._shards: Dict[int, ShardLineage] = {}
        self.recomputes: "collections.Counter[int]" = collections.Counter()

    def record(self, index: int, source: Callable[[], Any], *transforms: Callable[[Any], Any],
               describe: str = "") -> ShardLineage:
        shard = ShardLineage(source=source, transforms=transforms, describe=describe)
        with self._lock:
            self._shards[int(index)] = shard
        return shard

    def has(self, index: int) -> bool:
        with self._lock:
            return int(index) in self._shards

    def recompute(self, index: int) -> Any:
        with self._lock:
            shard = self._shards[int(index)]
            self.recomputes[int(index)] += 1
        return shard.materialize()
