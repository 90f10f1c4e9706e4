"""Partition-loss error of the port's sharded reader.

The port's copy of the one class of ``mmlspark_tpu/runtime/lineage.py`` that
:mod:`mmlspark_tpu_torch.data.sharded` raises and catches: a shard whose
bytes fail their CRC check is lost. The lineage registry and the scheduler
that recompute a lost partition are not ported yet.
"""


class PartitionLostError(RuntimeError):
    """A task's input partition is gone or corrupt (a shard that failed its
    CRC sidecar check)."""
