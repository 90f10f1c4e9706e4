"""dataguard — the poison-tolerant data plane; the port's copy of
``mmlspark_tpu/dataguard/__init__.py`` for the modules it has:

- :mod:`mmlspark_tpu_torch.dataguard.modes` — Spark's corrupt-record read
  modes (``PERMISSIVE``/``DROPMALFORMED``/``FAILFAST``) consumed by
  :class:`~mmlspark_tpu_torch.data.sharded.ShardedDataset`;
- :mod:`mmlspark_tpu_torch.dataguard.dlq` — the epoch-keyed,
  CRC-sidecar'd dead-letter store, with replay;
- :mod:`mmlspark_tpu_torch.dataguard.guards` — NaN/Inf/label-domain fit
  guards with fail/drop/impute policies (``Pipeline.setInvalidDataPolicy``).

The serving-edge request guard comes with serving.
"""

from mmlspark_tpu_torch.dataguard.dlq import DeadLetterStore
from mmlspark_tpu_torch.dataguard.guards import (
    GuardReport,
    guard_arrays,
    guard_table,
    normalize_policy,
)
from mmlspark_tpu_torch.dataguard.modes import (
    DROPMALFORMED,
    FAILFAST,
    PERMISSIVE,
    BadRecordsError,
    CorruptRecord,
    normalize_mode,
    summarize_reasons,
)

__all__ = [
    "PERMISSIVE",
    "DROPMALFORMED",
    "FAILFAST",
    "normalize_mode",
    "BadRecordsError",
    "CorruptRecord",
    "summarize_reasons",
    "DeadLetterStore",
    "GuardReport",
    "guard_arrays",
    "guard_table",
    "normalize_policy",
]
