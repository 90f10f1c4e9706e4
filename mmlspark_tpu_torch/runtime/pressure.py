"""Resource-pressure watchdog and the process-wide pressure level.

The port's copy of ``mmlspark_tpu/runtime/pressure.py``:

- :class:`ResourceWatchdog` samples the card's memory
  (``torch.cuda.mem_get_info``), host RSS (``/proc/self/status``) and free
  disk on the checkpoint volume; the worst source sets the process-wide
  :class:`PressureLevel` of its kind;
- :func:`current_pressure_level` is the cheap ambient read consumers poll:
  ``ShardedDataset.bin_to_memmap`` splits its scheduled bin tasks into
  smaller row ranges under host-memory pressure;
- :func:`reduced_footprint` is the scheduler's relaunch hint: a task that
  ran out of memory is retried under a hint equal to its OOM failure count.

The reference also publishes ``MemoryPressure``/``DiskPressure`` events and
exports ``pressure_*`` gauges; the port has no event bus or metrics
registry yet, so level changes go to the log only.
"""

from __future__ import annotations

import contextlib
import enum
import logging
import shutil
import threading
from typing import Callable, Dict, List, Optional, Tuple

import torch

logger = logging.getLogger("mmlspark_tpu_torch.runtime")


class PressureLevel(enum.IntEnum):
    """Ordered severity of resource pressure; comparable with ``>=``."""

    OK = 0
    WARN = 1
    CRITICAL = 2


_LEVEL_LOCK = threading.Lock()
_LEVELS: Dict[str, PressureLevel] = {"memory": PressureLevel.OK, "disk": PressureLevel.OK}


def current_pressure_level(kind: str = "memory") -> PressureLevel:
    """The process-wide pressure level for ``kind`` ("memory"/"disk")."""
    with _LEVEL_LOCK:
        return _LEVELS.get(kind, PressureLevel.OK)


def set_pressure_level(kind: str, level: PressureLevel) -> PressureLevel:
    """Set the ambient level (the watchdog's job; tests set it directly to
    drive consumers). Returns the previous level."""
    with _LEVEL_LOCK:
        prev = _LEVELS.get(kind, PressureLevel.OK)
        _LEVELS[kind] = PressureLevel(level)
    return prev


# -- reduced-footprint relaunch hint ------------------------------------------

_FOOTPRINT = threading.local()


def reduced_footprint() -> int:
    """How many times the current task attempt has run out of memory before
    (0 = a clean first run)."""
    return int(getattr(_FOOTPRINT, "level", 0))


@contextlib.contextmanager
def _footprint_hint(level: int):
    """Scheduler side: run a task attempt under a reduced-footprint hint
    (its OOM failure count)."""
    prev = getattr(_FOOTPRINT, "level", 0)
    _FOOTPRINT.level = int(level)
    try:
        yield
    finally:
        _FOOTPRINT.level = prev


# -- samplers (injectable for tests) ------------------------------------------


def sample_hbm() -> List[Tuple[str, float, float]]:
    """(device, bytes_in_use, bytes_limit) per CUDA card, from
    ``torch.cuda.mem_get_info``'s free and total bytes; [] when there is no card."""
    if not torch.cuda.is_available():
        return []
    out = []
    for i in range(torch.cuda.device_count()):
        free, total = torch.cuda.mem_get_info(i)
        out.append((f"cuda:{i}", float(total - free), float(total)))
    return out


def sample_host_rss() -> Optional[Tuple[float, float]]:
    """(rss_bytes, total_bytes) for this process against the host, or None
    when the platform exposes neither."""
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
            rss = float(resource.getrusage(resource.RUSAGE_SELF).ru_maxrss) * 1024.0
        except (ImportError, OSError):
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
    """Periodic sampler of card memory, host RSS and durable-volume space.

    ``poll()`` takes one sample round: each source's used fraction is
    compared with ``warn_fraction`` and ``critical_fraction``, and the worst
    source sets the process-wide level of its kind. ``start()`` runs
    ``poll`` on a daemon thread every ``interval_s``.
    """

    def __init__(
        self,
        checkpoint_dir: Optional[str] = None,
        warn_fraction: float = 0.85,
        critical_fraction: float = 0.95,
        interval_s: float = 10.0,
        hbm_sampler: Callable[[], List[Tuple[str, float, float]]] = sample_hbm,
        rss_sampler: Callable[[], Optional[Tuple[float, float]]] = sample_host_rss,
        disk_sampler: Callable[[str], Optional[Tuple[float, float]]] = sample_disk,
    ):
        from mmlspark_tpu_torch.runtime.journal import default_checkpoint_dir

        if checkpoint_dir is None:
            checkpoint_dir = default_checkpoint_dir()
        self.checkpoint_dir = checkpoint_dir
        self.warn_fraction = float(warn_fraction)
        self.critical_fraction = float(critical_fraction)
        self.interval_s = float(interval_s)
        self._hbm = hbm_sampler
        self._rss = rss_sampler
        self._disk = disk_sampler
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def _level_for(self, fraction: float) -> PressureLevel:
        if fraction >= self.critical_fraction:
            return PressureLevel.CRITICAL
        if fraction >= self.warn_fraction:
            return PressureLevel.WARN
        return PressureLevel.OK

    def poll(self) -> Dict[str, PressureLevel]:
        """One sample round; returns the levels it settled on."""
        # memory: the worst of the cards and the host RSS
        worst, worst_frac = "", 0.0
        for device, used, limit in self._hbm():
            if used / limit > worst_frac:
                worst, worst_frac = f"hbm:{device}", used / limit
        rss = self._rss()
        if rss is not None and rss[0] / rss[1] > worst_frac:
            worst, worst_frac = "host", rss[0] / rss[1]
        mem_level = self._level_for(worst_frac)
        prev = set_pressure_level("memory", mem_level)
        if mem_level != prev:
            logger.warning("memory pressure %s -> %s (%s at %.1f%%)", prev.name, mem_level.name,
                           worst or "host", worst_frac * 100.0)
        # disk: the used fraction of the checkpoint volume
        disk_level = PressureLevel.OK
        sampled = self._disk(self.checkpoint_dir) if self.checkpoint_dir else None
        if sampled is not None:
            free, total = sampled
            frac = 1.0 - free / total if total else 0.0
            disk_level = self._level_for(frac)
            prev_disk = set_pressure_level("disk", disk_level)
            if disk_level != prev_disk:
                logger.warning("disk pressure %s -> %s (%s, %.1f%% used)", prev_disk.name,
                               disk_level.name, self.checkpoint_dir, frac * 100.0)
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

