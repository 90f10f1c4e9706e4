"""Streaming sources — the Structured Streaming ``Source`` analogue; the
port's copy of ``mmlspark_tpu/streaming/source.py``.

Spark's micro-batch engine (``sql/execution/streaming/``) talks to a source
through three ideas: a monotonically-growing *offset* (how much data
exists), a *planned batch* (the exact slice an epoch will process, durably
logged before processing so a restarted query replays the identical slice),
and the *batch load* itself. This module is that contract:

- :class:`StreamSource` — the three-method contract. Offsets are plain
  ints (units consumed so far); a plan is a JSON-serializable *manifest*
  naming the exact units, so the offset WAL pins a replayed epoch to the
  same bytes even if the directory grew in between;
- :class:`FileStreamSource` — the ``FileStreamSource`` analogue: a
  directory watcher consuming files in lexicographic name order
  (producers write ``part-00000.npz``, ``part-00001.npz``, ... — atomic
  rename into place; ``*.tmp`` and dotfiles are invisible). ``.npz``
  files load as named columns (CRC-checked against a ``.crc32`` sidecar
  when one exists), ``.json``/``.jsonl`` as row objects;
- :class:`MemoryStream` — the in-memory test source (Spark's
  ``MemoryStream``): each :meth:`MemoryStream.add` call appends one
  block; not durable across processes, by design.

``max_per_trigger`` is the ``maxFilesPerTrigger`` rate limit: the query
caps each epoch at that many new units so a backlog drains as several
bounded micro-batches instead of one giant one.

Corrupt-record read modes (``dataguard.modes``):
``FileStreamSource(..., mode="permissive")`` turns a torn npz, a stale
CRC sidecar, or an undecodable jsonl line into a quarantine instead of
an epoch-killing exception — whole-file failures quarantine the file
(``index`` -1), jsonl decode failures quarantine the single line and
keep the rest. The quarantines of the most recent ``load_batch`` are
exposed as ``last_quarantined``, which
:class:`~mmlspark_tpu_torch.streaming.query.StreamingQuery` commits to the
epoch-keyed dead-letter store under its WAL. ``dropmalformed`` drops
and counts; ``failfast`` (default) re-raises.
"""

from __future__ import annotations

import fnmatch
import json
import os
import zipfile
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np

from mmlspark_tpu_torch.core.profiling import get_logger
from mmlspark_tpu_torch.data.table import Table
from mmlspark_tpu_torch.dataguard.modes import (
    FAILFAST,
    CorruptRecord,
    normalize_mode,
)
from mmlspark_tpu_torch.runtime.faults import (
    CorruptShardError,
    check_record,
    corrupt_record_bytes,
)
from mmlspark_tpu_torch.runtime.lineage import PartitionLostError

logger = get_logger("mmlspark_tpu_torch.streaming")

#: error classes a corrupt stream file can surface as at decode time
_RECORD_ERRORS = (
    CorruptShardError,
    PartitionLostError,
    zipfile.BadZipFile,
    ValueError,  # includes json.JSONDecodeError and UnicodeDecodeError
    KeyError,
    OSError,
)


class StreamSource:
    """Offset-tracked input contract for the micro-batch engine.

    Offsets are integers counting units (files, blocks) available so
    far; they only grow. ``plan_batch`` turns an offset range into a
    JSON-serializable manifest; ``load_batch`` materializes a manifest
    into a :class:`~mmlspark_tpu_torch.data.table.Table`. The split exists so
    the query's offset WAL can pin a replayed epoch to the exact units
    the crashed run planned, not whatever the source sees now.
    """

    #: per-epoch unit cap (the ``maxFilesPerTrigger`` rate limit); None = all
    max_per_trigger: Optional[int] = None

    def latest_offset(self) -> int:
        raise NotImplementedError

    def plan_batch(self, start: int, end: int) -> List[Any]:
        raise NotImplementedError

    def load_batch(self, manifest: Sequence[Any]) -> Table:
        raise NotImplementedError


def _load_npz(path: str) -> Table:
    check_record(path)
    _verify_sidecar(path)
    with np.load(path, allow_pickle=False) as npz:
        return Table({name: npz[name] for name in npz.files})


def _verify_sidecar(path: str) -> None:
    """CRC-check ``path`` against a ``<path>.crc32`` sidecar when one
    exists (producers that write sidecars get end-to-end integrity on
    the streaming path too; a mismatch raises PartitionLostError)."""
    if os.path.exists(path + ".crc32"):
        from mmlspark_tpu_torch.data.sharded import _verify_shard

        _verify_shard(path)


def _load_json_rows(
    path: str,
    mode: str = FAILFAST,
    quarantined: Optional[List[CorruptRecord]] = None,
) -> Table:
    """Load a json/jsonl file as row objects. Under a non-failfast
    ``mode`` an undecodable jsonl *line* quarantines (appended to
    ``quarantined`` with its line index) and the rest of the file
    survives — the per-record path; array-form ``.json`` files decode
    all-or-nothing, so their failures quarantine the whole file."""
    check_record(path)
    rows: List[Dict[str, Any]] = []
    with open(path, "rb") as fh:
        raw = fh.read()
    text = raw.decode("utf-8").strip()
    if text.startswith("["):
        rows = json.loads(text)
        return Table.from_rows(rows)
    for i, line in enumerate(text.splitlines()):
        if not line.strip():
            continue
        data = corrupt_record_bytes(path, i, line.encode("utf-8"))
        try:
            rows.append(json.loads(data.decode("utf-8")))
        except ValueError as e:  # JSONDecodeError and UnicodeDecodeError
            if mode == FAILFAST or quarantined is None:
                raise
            quarantined.append(CorruptRecord.from_error(path, e, index=i))
    return Table.from_rows(rows)


_LOADERS: Dict[str, Callable[[str], Table]] = {
    ".npz": _load_npz,
    ".json": _load_json_rows,
    ".jsonl": _load_json_rows,
}


class FileStreamSource(StreamSource):
    """Directory watcher consuming files in lexicographic name order.

    The offset is "how many files (sorted by name) have been made
    available"; producers therefore name files monotonically
    (``part-00000.npz``, ``part-00001.npz``, ...) and publish them
    atomically (write ``name.tmp``, then rename) — ``*.tmp`` and
    dotfiles never enter the listing, so a half-written file is
    invisible exactly the way an uncommitted Spark output file is.
    """

    def __init__(
        self,
        path: str,
        pattern: str = "*",
        loader: Optional[Callable[[str], Table]] = None,
        max_per_trigger: Optional[int] = None,
        mode: str = FAILFAST,
    ):
        self.path = path
        self.pattern = pattern
        self._loader = loader
        self.max_per_trigger = max_per_trigger
        self.mode = normalize_mode(mode)
        #: quarantines from the most recent ``load_batch`` — the query
        #: dead-letters these under its WAL epoch
        self.last_quarantined: List[CorruptRecord] = []
        #: ordered names already exposed through ``latest_offset`` — a name
        #: never moves once listed, so offsets stay stable across rescans
        self._files: List[str] = []

    def _scan(self) -> List[str]:
        try:
            names = os.listdir(self.path)
        except OSError:
            return []
        return sorted(
            n for n in names
            if fnmatch.fnmatch(n, self.pattern)
            and not n.startswith(".")
            and not n.endswith(".tmp")
        )

    def latest_offset(self) -> int:
        seen = set(self._files)
        fresh = [n for n in self._scan() if n not in seen]
        if fresh:
            # append-only: files already listed keep their index even if a
            # late-arriving name would sort before them
            self._files.extend(sorted(fresh))
        return len(self._files)

    def plan_batch(self, start: int, end: int) -> List[str]:
        if end > len(self._files):
            self.latest_offset()
        if not 0 <= start <= end <= len(self._files):
            raise ValueError(
                f"offset range [{start}, {end}) outside the {len(self._files)} "
                f"files listed under {self.path}"
            )
        return list(self._files[start:end])

    def load_batch(self, manifest: Sequence[str]) -> Table:
        self.last_quarantined = []
        tables = []
        for name in manifest:
            try:
                tables.append(self._load_one(name))
            except _RECORD_ERRORS as e:
                if self.mode == FAILFAST:
                    raise
                full = os.path.join(self.path, name)
                self.last_quarantined.append(CorruptRecord.from_error(full, e))
                logger.warning(
                    "stream source %s: quarantined %s (%s: %s)",
                    self.path, name, type(e).__name__, e,
                )
        if not tables:
            return Table({})
        return Table.concat(tables)

    def _load_one(self, name: str) -> Table:
        full = os.path.join(self.path, name)
        if self._loader is not None:
            check_record(full)
            return self._loader(full)
        ext = os.path.splitext(name)[1].lower()
        if ext in (".json", ".jsonl"):
            # per-record tolerance: line failures land in last_quarantined,
            # whole-file failures propagate to load_batch's handler
            return _load_json_rows(
                full, mode=self.mode, quarantined=self.last_quarantined
            )
        loader = _LOADERS.get(ext)
        if loader is None:
            raise ValueError(
                f"no loader for {name!r} (supported: {sorted(_LOADERS)}; "
                "pass loader= for custom formats)"
            )
        return loader(full)


class MemoryStream(StreamSource):
    """In-memory block source for tests (Spark's ``MemoryStream``): each
    :meth:`add` appends one block of rows; offsets count blocks. State
    lives in this process only — checkpointed queries over a
    ``MemoryStream`` replay nothing after a restart, exactly like the
    Spark original."""

    def __init__(self, max_per_trigger: Optional[int] = None):
        self._blocks: List[Table] = []
        self.max_per_trigger = max_per_trigger

    def add(self, table: Table) -> int:
        """Append one block; returns the new latest offset."""
        self._blocks.append(table)
        return len(self._blocks)

    def latest_offset(self) -> int:
        return len(self._blocks)

    def plan_batch(self, start: int, end: int) -> List[int]:
        if not 0 <= start <= end <= len(self._blocks):
            raise ValueError(
                f"offset range [{start}, {end}) outside {len(self._blocks)} "
                "blocks"
            )
        return list(range(start, end))

    def load_batch(self, manifest: Sequence[int]) -> Table:
        missing = [i for i in manifest if not 0 <= i < len(self._blocks)]
        if missing:
            raise ValueError(
                f"blocks {missing} not present (MemoryStream state does not "
                "survive a restart; use FileStreamSource for durable replay)"
            )
        tables = [self._blocks[i] for i in manifest]
        if not tables:
            return Table({})
        return Table.concat(tables)
