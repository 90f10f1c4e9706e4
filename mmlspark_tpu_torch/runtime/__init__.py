"""mmlspark_tpu_torch.runtime — a fault-tolerant partition scheduler.

The port's copy of the in-process part of ``mmlspark_tpu/runtime``: Spark's
scheduler and executor model as small thread-based Python, deterministic
enough to test fault recovery bit for bit.

- :mod:`~mmlspark_tpu_torch.runtime.scheduler`: the scheduler (per-task state
  machine, seeded backoff, results in task order, speculative execution);
- :mod:`~mmlspark_tpu_torch.runtime.executor`: heartbeating worker pool
  with dead-worker replacement and health-aware admission;
- :mod:`~mmlspark_tpu_torch.runtime.health`: per-worker failure scores,
  quarantine and parole;
- :mod:`~mmlspark_tpu_torch.runtime.journal`: the durable fit journal with
  checksummed partition checkpoints, and atomic model commits;
- :mod:`~mmlspark_tpu_torch.runtime.lineage`: recompute a lost partition
  from its recorded source;
- :mod:`~mmlspark_tpu_torch.runtime.faults`: seeded fault injection (task,
  exhaustion and shard-read planes);
- :mod:`~mmlspark_tpu_torch.runtime.pressure`: card, host and disk gauges
  and the process-wide pressure level;
- :mod:`~mmlspark_tpu_torch.runtime.metrics`: per-task timings, retries,
  queue depth.

Quick start::

    from mmlspark_tpu_torch import runtime

    results = runtime.run_partitioned(process, shards,
                                      runtime.SchedulerPolicy(max_workers=4))

    plan = runtime.FaultPlan(seed=7).kill_random_task(len(shards))
    with runtime.inject_faults(plan):
        same = runtime.run_partitioned(process, shards)
    assert same == results and plan.fired

The process groups of the reference (``procgroup``) are not ported.
"""

from mmlspark_tpu_torch.runtime.executor import ExecutorPool
from mmlspark_tpu_torch.runtime.faults import (
    CorruptShardError,
    DeviceOomError,
    ExecutorDeathError,
    FaultPlan,
    check_record,
    check_write,
    current_faults,
    inject_faults,
    is_oom_error,
)
from mmlspark_tpu_torch.runtime.health import HealthTracker
from mmlspark_tpu_torch.runtime.journal import (
    CHECKPOINT_DIR_ENV,
    FitJournal,
    ModelStore,
    default_checkpoint_dir,
    result_crc,
)
from mmlspark_tpu_torch.runtime.lineage import Lineage, PartitionLostError, ShardLineage
from mmlspark_tpu_torch.runtime.metrics import RuntimeMetrics
from mmlspark_tpu_torch.runtime.pressure import (
    PressureLevel,
    ResourceWatchdog,
    current_pressure_level,
    get_watchdog,
    reduced_footprint,
    sample_hbm,
    set_pressure_level,
)
from mmlspark_tpu_torch.runtime.scheduler import (
    AllWorkersQuarantinedError,
    AttemptInfo,
    JobFailedError,
    ResultCorruptedError,
    Scheduler,
    SchedulerPolicy,
    TaskLostError,
    TaskState,
    current_policy,
    policy,
    run_partitioned,
)

__all__ = [
    "AllWorkersQuarantinedError",
    "AttemptInfo",
    "CHECKPOINT_DIR_ENV",
    "CorruptShardError",
    "DeviceOomError",
    "ExecutorDeathError",
    "ExecutorPool",
    "FaultPlan",
    "FitJournal",
    "HealthTracker",
    "JobFailedError",
    "Lineage",
    "ModelStore",
    "PartitionLostError",
    "PressureLevel",
    "ResourceWatchdog",
    "ResultCorruptedError",
    "RuntimeMetrics",
    "Scheduler",
    "SchedulerPolicy",
    "ShardLineage",
    "TaskLostError",
    "TaskState",
    "check_record",
    "check_write",
    "current_faults",
    "current_policy",
    "current_pressure_level",
    "default_checkpoint_dir",
    "get_watchdog",
    "inject_faults",
    "is_oom_error",
    "policy",
    "reduced_footprint",
    "result_crc",
    "run_partitioned",
    "sample_hbm",
    "set_pressure_level",
]
