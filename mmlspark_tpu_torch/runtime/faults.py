"""Shard-corruption error of the port's sharded reader.

The port's copy of the one class of ``mmlspark_tpu/runtime/faults.py`` that
:mod:`mmlspark_tpu_torch.data.sharded` catches as corruption. The fault
plan that injects it (``FaultPlan``, ``check_record``) is not ported yet:
the port's tests corrupt real bytes on disk instead.
"""


class CorruptShardError(RuntimeError):
    """A shard file is corrupt (torn, bit-rotted or undecodable)."""
