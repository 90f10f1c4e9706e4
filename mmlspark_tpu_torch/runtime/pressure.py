"""Resource-pressure watchdog and the process-wide pressure level.

The port's copy of ``mmlspark_tpu/runtime/pressure.py``.

Spark's memory plane is managed: UnifiedMemoryManager arbitrates
execution vs. storage inside a ``spark.memory.fraction`` budget, spills
to disk under pressure, and (with OOM-aware ``excludeOnFailure``) routes
work away from executors that keep dying. A card has no manager to hide
behind — an allocation either fits or raises ``OutOfMemoryError`` — so
this module supplies the *observed* analogue:

- :class:`ResourceWatchdog` samples card memory (``torch.cuda``'s
  allocator statistics via the profiler's ``sample_memory``), host RSS
  (``/proc/self/status``), and free disk on the checkpoint and event-log
  volumes; threshold crossings publish
  :class:`~mmlspark_tpu_torch.observability.events.MemoryPressure` /
  ``DiskPressure`` events, export ``pressure_*`` gauges, and set the
  process-wide :class:`PressureLevel`;
- :func:`current_pressure_level` is the cheap ambient read consumers
  poll: ``ShardedDataset`` splits bin tasks into smaller row ranges under
  host-memory pressure;
- :func:`reduced_footprint` is the scheduler's relaunch hint: a task
  that ran out of memory is retried under a footprint hint equal to its
  OOM failure count, so the task body (when it cares) can shrink its
  working set — the "retry smaller" half of graceful degradation.

Level transitions publish BOTH the onset (warn/critical) and the
recovery (level ``"ok"``), so every pressure onset in an event log pairs
with either a degradation event or a recovery record.
"""

from __future__ import annotations

import contextlib
import enum
import os
import shutil
import threading
from typing import Callable, Dict, List, Optional, Tuple

from mmlspark_tpu_torch.core.profiling import get_logger

logger = get_logger("mmlspark_tpu_torch.runtime")


class PressureLevel(enum.IntEnum):
    """Ordered severity of resource pressure; comparable with ``>=``."""

    OK = 0
    WARN = 1
    CRITICAL = 2


_LEVEL_LOCK = threading.Lock()
_LEVELS: Dict[str, PressureLevel] = {
    "memory": PressureLevel.OK,
    "disk": PressureLevel.OK,
}


def current_pressure_level(kind: str = "memory") -> PressureLevel:
    """The process-wide pressure level for ``kind`` ("memory"/"disk").
    One dict read — cheap enough for per-request consultation."""
    with _LEVEL_LOCK:
        return _LEVELS.get(kind, PressureLevel.OK)


def set_pressure_level(kind: str, level: PressureLevel) -> PressureLevel:
    """Set the ambient level (the watchdog's job; tests drive it
    directly to exercise consumers). Returns the previous level."""
    with _LEVEL_LOCK:
        prev = _LEVELS.get(kind, PressureLevel.OK)
        _LEVELS[kind] = PressureLevel(level)
    return prev


# -- reduced-footprint relaunch hint ------------------------------------------

_FOOTPRINT = threading.local()


def reduced_footprint() -> int:
    """How many times the current task attempt has OOMed before (0 = a
    clean first run). Task bodies that allocate proportionally consult
    this to shrink their working set on an OOM relaunch."""
    return int(getattr(_FOOTPRINT, "level", 0))


@contextlib.contextmanager
def _footprint_hint(level: int):
    """Scheduler-side: run a task attempt under a reduced-footprint
    hint (its OOM failure count)."""
    prev = getattr(_FOOTPRINT, "level", 0)
    _FOOTPRINT.level = int(level)
    try:
        yield
    finally:
        _FOOTPRINT.level = prev


# -- samplers (injectable for tests) ------------------------------------------


def sample_hbm() -> List[Tuple[str, float, float]]:
    """(device, bytes_in_use, bytes_limit) per card, from the profiler's
    ``sample_memory`` (which also sets its ``profiler_hbm_*`` gauges); []
    without a card — always safe."""
    try:
        from mmlspark_tpu_torch.observability.profiler import get_profiler

        stats = get_profiler().sample_memory()
    except Exception:  # noqa: BLE001 - no backend is a valid state
        return []
    out = []
    for device, rec in stats.items():
        used = rec.get("bytes_in_use")
        limit = rec.get("bytes_limit")
        if used is not None and limit:
            out.append((device, float(used), float(limit)))
    return out


def sample_host_rss() -> Optional[Tuple[float, float]]:
    """(rss_bytes, total_bytes) for this process vs. the host, or None
    when the platform doesn't expose either (non-Linux without
    ``resource``)."""
    rss = total = None
    try:
        with open("/proc/self/status", "r", encoding="ascii") as fh:
            for line in fh:
                if line.startswith("VmRSS:"):
                    rss = float(line.split()[1]) * 1024.0
                    break
        with open("/proc/meminfo", "r", encoding="ascii") as fh:
            for line in fh:
                if line.startswith("MemTotal:"):
                    total = float(line.split()[1]) * 1024.0
                    break
    except OSError:
        pass
    if rss is None:
        try:
            import resource

            # ru_maxrss is KiB on Linux
            rss = float(
                resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
            ) * 1024.0
        except Exception:  # noqa: BLE001
            return None
    if not total:
        return None
    return rss, total


def sample_disk(path: str) -> Optional[Tuple[float, float]]:
    """(free_bytes, total_bytes) for the volume holding ``path``."""
    try:
        usage = shutil.disk_usage(path)
    except OSError:
        return None
    return float(usage.free), float(usage.total)


class ResourceWatchdog:
    """Periodic sampler of HBM / host RSS / durable-volume free space.

    ``poll()`` takes one sample round: each source's utilisation is
    compared against ``warn_fraction`` / ``critical_fraction`` (for disk
    the *used* fraction of the volume), the worst source sets the
    process-wide level for its kind, and level *transitions* publish
    ``MemoryPressure``/``DiskPressure`` events — onset AND recovery, so
    the event log's pressure pairing always closes. ``start()`` runs
    ``poll`` on a daemon thread every ``interval_s``.
    """

    def __init__(
        self,
        checkpoint_dir: Optional[str] = None,
        eventlog_dir: Optional[str] = None,
        warn_fraction: float = 0.85,
        critical_fraction: float = 0.95,
        interval_s: float = 10.0,
        registry=None,
        hbm_sampler: Callable[[], List[Tuple[str, float, float]]] = sample_hbm,
        rss_sampler: Callable[[], Optional[Tuple[float, float]]] = sample_host_rss,
        disk_sampler: Callable[[str], Optional[Tuple[float, float]]] = sample_disk,
    ):
        from mmlspark_tpu_torch.observability.registry import get_registry
        from mmlspark_tpu_torch.runtime.journal import default_checkpoint_dir

        if checkpoint_dir is None:
            checkpoint_dir = default_checkpoint_dir()
        if eventlog_dir is None:
            log = os.environ.get("MMLSPARK_TPU_EVENT_LOG", "").strip()
            eventlog_dir = os.path.dirname(log) or "." if log else None
        self.checkpoint_dir = checkpoint_dir
        self.eventlog_dir = eventlog_dir
        self.warn_fraction = float(warn_fraction)
        self.critical_fraction = float(critical_fraction)
        self.interval_s = float(interval_s)
        self._hbm = hbm_sampler
        self._rss = rss_sampler
        self._disk = disk_sampler
        reg = registry if registry is not None else get_registry()
        self._g_mem_level = reg.gauge(
            "pressure_memory_level", "Process memory-pressure level (0/1/2)"
        )
        self._g_disk_level = reg.gauge(
            "pressure_disk_level", "Process disk-pressure level (0/1/2)"
        )
        self._g_hbm = reg.gauge(
            "pressure_hbm_fraction", "Worst-device HBM used fraction"
        )
        self._g_rss = reg.gauge(
            "pressure_host_rss_bytes", "Host RSS of this process"
        )
        self._g_free = reg.gauge(
            "pressure_disk_free_bytes", "Free bytes on a watched volume"
        )
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- one sample round ----------------------------------------------------

    def _level_for(self, fraction: float) -> PressureLevel:
        if fraction >= self.critical_fraction:
            return PressureLevel.CRITICAL
        if fraction >= self.warn_fraction:
            return PressureLevel.WARN
        return PressureLevel.OK

    def poll(self) -> Dict[str, PressureLevel]:
        """One sample round; returns the levels it settled on."""
        from mmlspark_tpu_torch.observability.events import (
            DiskPressure, MemoryPressure, get_bus,
        )

        bus = get_bus()
        # memory: worst of HBM devices and host RSS
        mem_level = PressureLevel.OK
        worst: Tuple[str, float, float] = ("", 0.0, 0.0)
        worst_frac = 0.0
        for device, used, limit in self._hbm():
            frac = used / limit
            if frac > worst_frac:
                worst_frac, worst = frac, (f"hbm:{device}", used, limit)
        if worst_frac:
            self._g_hbm.set(worst_frac)
        rss = self._rss()
        if rss is not None:
            rss_bytes, total = rss
            self._g_rss.set(rss_bytes)
            frac = rss_bytes / total
            if frac > worst_frac:
                worst_frac, worst = frac, ("host", rss_bytes, total)
        mem_level = self._level_for(worst_frac)
        prev = set_pressure_level("memory", mem_level)
        self._g_mem_level.set(int(mem_level))
        if mem_level != prev and bus.active:
            bus.publish(MemoryPressure(
                source=worst[0] or "host",
                level=(
                    "ok" if mem_level is PressureLevel.OK
                    else mem_level.name.lower()
                ),
                used_bytes=worst[1],
                limit_bytes=worst[2],
                detail=f"fraction={worst_frac:.3f}",
            ))
        if mem_level != prev:
            logger.warning(
                "memory pressure %s -> %s (%s at %.1f%%)",
                prev.name, mem_level.name, worst[0] or "host",
                worst_frac * 100.0,
            )
        # disk: worst of the watched volumes (used fraction)
        disk_level = PressureLevel.OK
        worst_disk: Tuple[str, float, float] = ("", 0.0, 0.0)
        worst_disk_frac = -1.0
        for path in {p for p in (self.checkpoint_dir, self.eventlog_dir) if p}:
            sampled = self._disk(path)
            if sampled is None:
                continue
            free, total = sampled
            self._g_free.labels(path=path).set(free)
            frac = 1.0 - free / total if total else 0.0
            if frac > worst_disk_frac:
                worst_disk_frac, worst_disk = frac, (path, free, total)
        if worst_disk_frac >= 0.0:
            disk_level = self._level_for(worst_disk_frac)
            prev_disk = set_pressure_level("disk", disk_level)
            self._g_disk_level.set(int(disk_level))
            if disk_level != prev_disk and bus.active:
                bus.publish(DiskPressure(
                    path=worst_disk[0],
                    level=(
                        "ok" if disk_level is PressureLevel.OK
                        else disk_level.name.lower()
                    ),
                    free_bytes=worst_disk[1],
                    total_bytes=worst_disk[2],
                ))
            if disk_level != prev_disk:
                logger.warning(
                    "disk pressure %s -> %s (%s, %.1f%% used)",
                    prev_disk.name, disk_level.name, worst_disk[0],
                    worst_disk_frac * 100.0,
                )
        return {"memory": mem_level, "disk": disk_level}

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> "ResourceWatchdog":
        if self._thread is not None and self._thread.is_alive():
            return self
        self._stop.clear()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()
        return self

    def _loop(self) -> None:
        while not self._stop.is_set():
            try:
                self.poll()
            except Exception as e:  # noqa: BLE001 - the watchdog must survive
                logger.debug("watchdog poll failed: %s", e)
            self._stop.wait(self.interval_s)

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None


# -- process-global watchdog --------------------------------------------------

_WATCHDOG: Optional[ResourceWatchdog] = None
_WATCHDOG_LOCK = threading.Lock()


def get_watchdog(**kwargs) -> ResourceWatchdog:
    """The process-global watchdog (created lazily, not auto-started;
    callers that want the background thread call ``.start()``)."""
    global _WATCHDOG
    with _WATCHDOG_LOCK:
        if _WATCHDOG is None:
            _WATCHDOG = ResourceWatchdog(**kwargs)
        return _WATCHDOG
