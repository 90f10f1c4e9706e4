"""Corrupt-record read modes: Spark's ``mode`` option.

The port's copy of ``mmlspark_tpu/dataguard/modes.py``, for
:class:`~mmlspark_tpu_torch.data.sharded.ShardedDataset`:

- ``PERMISSIVE``: a torn or corrupt shard is quarantined (captured with its
  source, index and reason, and dead-lettered when a store is configured:
  the ``badRecordsPath`` analogue) and the read continues over the
  survivors;
- ``DROPMALFORMED``: corrupt shards are dropped and counted, not captured;
- ``FAILFAST``: the first corrupt shard raises (the default: tolerating
  corruption must be asked for).

Survivors are read in listing order and a quarantined unit gives no rows,
so a fit over a corrupted input equals the fit over its clean complement
byte for byte.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Sequence

#: the three Spark read modes, normalized lowercase
PERMISSIVE = "permissive"
DROPMALFORMED = "dropmalformed"
FAILFAST = "failfast"

_MODES = (PERMISSIVE, DROPMALFORMED, FAILFAST)


def normalize_mode(mode: str) -> str:
    """Case-insensitive mode (``"PERMISSIVE"`` and ``"permissive"`` are the
    same option, as in Spark)."""
    low = str(mode).strip().lower()
    if low not in _MODES:
        raise ValueError(
            f"unknown read mode {mode!r} (expected one of "
            f"{', '.join(m.upper() for m in _MODES)})"
        )
    return low


class BadRecordsError(ValueError):
    """A read hit corrupt records it cannot go on without (every shard
    corrupt). Carries the quarantine records, so callers can report which
    units were bad."""

    def __init__(self, message: str, records: Sequence["CorruptRecord"] = ()):
        super().__init__(message)
        self.records = list(records)


@dataclasses.dataclass
class CorruptRecord:
    """One quarantined unit: a whole shard (``index`` -1) or one record
    within it (``index`` >= 0); :meth:`to_record` is its JSON form for the
    dead-letter store."""

    source: str
    index: int
    reason: str
    detail: str = ""

    def to_record(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_error(cls, source: str, err: BaseException, index: int = -1) -> "CorruptRecord":
        return cls(source=str(source), index=int(index), reason=type(err).__name__,
                   detail=str(err)[:200])


def summarize_reasons(records: Sequence[CorruptRecord]) -> str:
    """``reason=count`` pairs, sorted by reason."""
    counts: Dict[str, int] = {}
    for rec in records:
        counts[rec.reason] = counts.get(rec.reason, 0) + 1
    return ",".join(f"{k}={v}" for k, v in sorted(counts.items()))


def as_corrupt_records(items: Sequence[Any]) -> List[CorruptRecord]:
    """Coerce a mixed list (CorruptRecord or plain dicts) into records."""
    out: List[CorruptRecord] = []
    for item in items:
        if isinstance(item, CorruptRecord):
            out.append(item)
        else:
            out.append(CorruptRecord(
                source=str(item.get("source", "?")),
                index=int(item.get("index", -1)),
                reason=str(item.get("reason", "unknown")),
                detail=str(item.get("detail", "")),
            ))
    return out
