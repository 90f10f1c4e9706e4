"""Device-performance profiler — the port's copy of
``mmlspark_tpu/observability/profiler.py``, over ``torch.cuda`` where the
reference has ``jax``.

:class:`DeviceProfiler` wraps the callables the framework dispatches:

- **first-call accounting**: a call with an unseen shape/dtype signature
  (the reference's executable-cache miss; the port has no jit cache, but
  a kernel's first launch builds or loads it) books a
  :class:`~mmlspark_tpu_torch.observability.events.ProfileCompiled` event
  with that call's wall time;
- **device timing**: every call runs in a window closed by
  ``torch.cuda.synchronize()`` when its result lies on a card, and books
  :class:`~mmlspark_tpu_torch.observability.events.ProfileExecuted` plus a
  ``profiler_device_seconds{fn=...}`` histogram observation;
- **roofline attribution**: ``wrap(fn, cost=...)`` takes a callable that
  returns ``{"flops", "bytes_accessed"}`` for one call (the compare-built
  histogram supplies ``ops.hopper_histogram.histogram_cost``), folded into
  achieved FLOP/s and bytes/s against the card's peaks
  (:func:`device_peaks`, NVIDIA's data sheets);
- **device-memory gauges**: :meth:`sample_memory` reads
  ``torch.cuda.memory_stats()`` into ``profiler_hbm_bytes_in_use`` /
  ``_peak`` / ``_limit`` (``{}`` on the CPU);
- **transfer counters**: :meth:`note_transfer` accumulates host<->device
  bytes into ``profiler_transfer_bytes_total{direction=...}``.

The process-global profiler (:func:`get_profiler`) is DISABLED by default:
instrumented sites guard on ``profiler.active``, so a quiet fit pays one
attribute read per site, until ``MMLSPARK_TPU_PROFILE=1`` is set or a
caller runs ``get_profiler().enable()``.
"""

from __future__ import annotations

import dataclasses
import os
import threading
import time
from contextlib import contextmanager
from typing import Any, Callable, Dict, List, Optional, Tuple

from mmlspark_tpu_torch.core.profiling import get_logger
from mmlspark_tpu_torch.observability.events import (
    ProfileCompiled,
    ProfileExecuted,
    get_bus,
)
from mmlspark_tpu_torch.observability.registry import (
    FIT_BUCKETS,
    MetricsRegistry,
    get_registry,
)

logger = get_logger("mmlspark_tpu_torch.observability")

#: card-name substring (lowercased) -> (float32 peak op/s outside the
#: tensor cores, memory bytes/s), from NVIDIA's data sheets at the full
#: power limit: the H100 data sheet (SXM, PCIe and NVL parts) and the
#: H200 data sheet. First match wins, so "h100" comes last.
_DEVICE_PEAKS: Tuple[Tuple[str, Tuple[float, float]], ...] = (
    ("h200", (67e12, 4.8e12)),
    ("h100 nvl", (60e12, 3.9e12)),
    ("h100 pcie", (51e12, 2.0e12)),
    ("h100", (67e12, 3.35e12)),
)

#: the platform label when no peak-table row (and no env override)
#: matched — the CPU lands here. Bound classification is skipped for it.
UNKNOWN_PLATFORM = "unknown-platform"


class DevicePeaks(tuple):
    """``(peak op/s, peak memory bytes/s)`` that unpacks like a 2-tuple,
    plus the ``platform`` label the peaks came from (``h100``,
    ``env-override``, or :data:`UNKNOWN_PLATFORM`)."""

    def __new__(
        cls, peak_flops: float, peak_bw: float, platform: str
    ) -> "DevicePeaks":
        self = super().__new__(cls, (float(peak_flops), float(peak_bw)))
        self.platform = str(platform)
        return self

    @property
    def known(self) -> bool:
        return self.platform != UNKNOWN_PLATFORM

    def bound_ms(self, bytes_: float, ops: float) -> Tuple[float, str]:
        """The least time the card could take for work that moves
        ``bytes_`` and does ``ops`` operations: the larger of bytes over the
        memory rate and operations over the peak rate, in ms, and which of
        the two (``"bytes"`` or ``"operations"``) bounds it."""
        flops, bw = self
        byte_ms, op_ms = bytes_ / bw * 1e3, ops / flops * 1e3
        return max(byte_ms, op_ms), "bytes" if byte_ms >= op_ms else "operations"


def device_peaks(device: Optional[str] = None) -> DevicePeaks:
    """:class:`DevicePeaks` for the card named ``device`` (default: the
    name of card 0, when there is one), overridable via
    ``MMLSPARK_TPU_PEAK_FLOPS`` / ``MMLSPARK_TPU_PEAK_HBM_BYTES``. A card
    with no table row and no override gets ``(0, 0)`` labelled
    :data:`UNKNOWN_PLATFORM`."""
    import torch

    env_f = os.environ.get("MMLSPARK_TPU_PEAK_FLOPS")
    env_b = os.environ.get("MMLSPARK_TPU_PEAK_HBM_BYTES")
    if env_f or env_b:
        return DevicePeaks(
            float(env_f or 0.0), float(env_b or 0.0), "env-override"
        )
    if device is None:
        if not torch.cuda.is_available():
            return DevicePeaks(0.0, 0.0, UNKNOWN_PLATFORM)
        device = torch.cuda.get_device_name(0)
    kind = str(device).lower()
    for needle, peaks in _DEVICE_PEAKS:
        if needle in kind:
            return DevicePeaks(peaks[0], peaks[1], needle)
    return DevicePeaks(0.0, 0.0, UNKNOWN_PLATFORM)


@dataclasses.dataclass
class FunctionProfile:
    """Accumulated per-function profile (one row of the roofline table)."""

    name: str
    compiles: int = 0
    compile_seconds: float = 0.0
    cache_hits: int = 0
    executions: int = 0
    device_seconds: float = 0.0
    #: the caller-supplied cost of ONE call
    flops: float = 0.0
    bytes_accessed: float = 0.0
    transfer_bytes: float = 0.0

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    def roofline(
        self,
        peak_flops: float = 0.0,
        peak_bw: float = 0.0,
        platform: Optional[str] = None,
    ) -> Dict[str, Any]:
        """Achieved vs peak attribution for this function: op/s and
        bytes/s over the mean execution window, the fraction of the peaks
        they represent, and which wall the function leans on (``bound``).
        The field names are the reference's: ``mxu_frac`` carries the
        share of the card's float32 peak, ``hbm_frac`` of its memory rate.
        On an :data:`UNKNOWN_PLATFORM` rig the bound stays ``"unknown"``."""
        row: Dict[str, Any] = {
            "name": self.name,
            "executions": self.executions,
            "mean_ms": (
                self.device_seconds / self.executions * 1e3
                if self.executions else 0.0
            ),
            "flops": self.flops,
            "bytes_accessed": self.bytes_accessed,
            "achieved_flops_per_s": 0.0,
            "achieved_bytes_per_s": 0.0,
            "mxu_frac": None,
            "hbm_frac": None,
            "bound": "unknown",
        }
        if platform is not None:
            row["platform"] = platform
        if self.executions and self.device_seconds > 0:
            mean = self.device_seconds / self.executions
            row["achieved_flops_per_s"] = self.flops / mean
            row["achieved_bytes_per_s"] = self.bytes_accessed / mean
        if peak_flops > 0 and row["achieved_flops_per_s"]:
            row["mxu_frac"] = row["achieved_flops_per_s"] / peak_flops
        if peak_bw > 0 and row["achieved_bytes_per_s"]:
            row["hbm_frac"] = row["achieved_bytes_per_s"] / peak_bw
        if row["mxu_frac"] is not None and row["hbm_frac"] is not None:
            row["bound"] = (
                "memory" if row["hbm_frac"] >= row["mxu_frac"] else "compute"
            )
        elif platform != UNKNOWN_PLATFORM and (
            self.flops or self.bytes_accessed
        ):
            # no peak table but a known platform: label by arithmetic
            # intensity against a ~10 op/byte machine-balance ridge
            intensity = self.flops / max(self.bytes_accessed, 1.0)
            row["bound"] = "compute" if intensity > 10.0 else "memory"
        return row


def _signature(args, kwargs) -> str:
    """Shape/dtype signature of a call: a new one counts as a first call
    (the reference's executable-cache miss)."""
    parts: List[str] = []
    for a in list(args) + sorted(kwargs.items()):
        if isinstance(a, tuple):
            a = a[1]
        shape = getattr(a, "shape", None)
        dtype = getattr(a, "dtype", None)
        if shape is not None:
            parts.append(f"{dtype}{tuple(shape)}")
        else:
            parts.append(type(a).__name__)
    return ",".join(parts)


def _first_tensor(out) -> Optional[torch.Tensor]:
    """The first tensor of a (nested) result, or None."""
    import torch

    if isinstance(out, torch.Tensor):
        return out
    if isinstance(out, dict):
        out = list(out.values())
    if isinstance(out, (tuple, list)):
        for item in out:
            t = _first_tensor(item)
            if t is not None:
                return t
    return None


def _sync(out) -> None:
    """Wait for the card when ``out`` holds a CUDA tensor (the reference's
    ``jax.block_until_ready``); a CPU result is ready already."""
    import torch

    t = _first_tensor(out)
    if t is not None and t.is_cuda:
        torch.cuda.synchronize(t.device)


class DeviceProfiler:
    """Wraps hot paths with first-call/execute/roofline accounting.

    Pass an isolated ``registry``/``bus`` for tests; the process-global
    instance (:func:`get_profiler`) feeds the shared metrics plane and
    event bus. ``enabled=False`` makes every entry point a cheap no-op
    and :meth:`wrap` the identity."""

    def __init__(
        self,
        registry: Optional[MetricsRegistry] = None,
        bus=None,
        enabled: bool = True,
    ):
        self.registry = registry if registry is not None else get_registry()
        self._bus = bus
        self.enabled = bool(enabled)
        self._lock = threading.Lock()
        self._profiles: Dict[str, FunctionProfile] = {}
        reg = self.registry
        self._reg_compiles = reg.counter(
            "profiler_compiles_total",
            "Executable compiles observed by the device profiler",
        )
        self._reg_cache_hits = reg.counter(
            "profiler_cache_hits_total",
            "Profiled calls answered from a warm executable cache",
        )
        self._reg_compile_s = reg.histogram(
            "profiler_compile_seconds",
            "Wall time of compiling calls (trace + XLA compile + first run)",
            buckets=FIT_BUCKETS,
        )
        self._reg_device_s = reg.histogram(
            "profiler_device_seconds",
            "Per-call device window (dispatch through block_until_ready)",
        )
        self._reg_transfer = reg.counter(
            "profiler_transfer_bytes_total",
            "Host<->device bytes moved through profiled call sites",
        )

    # -- plumbing ------------------------------------------------------------

    @property
    def bus(self):
        return self._bus if self._bus is not None else get_bus()

    @property
    def active(self) -> bool:
        return self.enabled

    def enable(self) -> "DeviceProfiler":
        self.enabled = True
        return self

    def disable(self) -> "DeviceProfiler":
        self.enabled = False
        return self

    def _profile(self, name: str) -> FunctionProfile:
        with self._lock:
            prof = self._profiles.get(name)
            if prof is None:
                prof = self._profiles[name] = FunctionProfile(name)
            return prof

    # -- recording -----------------------------------------------------------

    def note_compile(
        self,
        name: str,
        seconds: float,
        flops: float = 0.0,
        bytes_accessed: float = 0.0,
        signature: str = "",
    ) -> None:
        prof = self._profile(name)
        with self._lock:
            prof.compiles += 1
            prof.compile_seconds += seconds
            if flops:
                prof.flops = flops
            if bytes_accessed:
                prof.bytes_accessed = bytes_accessed
        self._reg_compiles.labels(fn=name).inc()
        self._reg_compile_s.observe(seconds)
        bus = self.bus
        if bus.active:
            bus.publish(ProfileCompiled(
                name=name, seconds=seconds, flops=flops,
                bytes_accessed=bytes_accessed, signature=signature,
            ))

    def note_execute(self, name: str, seconds: float) -> None:
        prof = self._profile(name)
        with self._lock:
            prof.executions += 1
            prof.device_seconds += seconds
        self._reg_device_s.labels(fn=name).observe(seconds)
        bus = self.bus
        if bus.active:
            bus.publish(ProfileExecuted(name=name, seconds=seconds))

    def note_cache_hit(self, name: str) -> None:
        prof = self._profile(name)
        with self._lock:
            prof.cache_hits += 1
        self._reg_cache_hits.labels(fn=name).inc()

    def note_transfer(
        self, nbytes: float, direction: str = "h2d", name: str = ""
    ) -> None:
        """Book host->device (``h2d``) or device->host (``d2h``) bytes."""
        if nbytes <= 0:
            return
        self._reg_transfer.labels(direction=direction).inc(float(nbytes))
        if name:
            prof = self._profile(name)
            with self._lock:
                prof.transfer_bytes += float(nbytes)

    def merge(
        self,
        name: str,
        executions: int = 0,
        device_seconds: float = 0.0,
        compiles: int = 0,
        compile_seconds: float = 0.0,
    ) -> None:
        """Fold externally measured totals into the profile table (a
        worker's summary folded by its driver). Only the profile table
        and the compile counter update; histograms and hit counters stay
        this process's own observations."""
        prof = self._profile(name)
        with self._lock:
            prof.executions += int(executions)
            prof.device_seconds += float(device_seconds)
            prof.compiles += int(compiles)
            prof.compile_seconds += float(compile_seconds)
        if compiles:
            self._reg_compiles.labels(fn=name).inc(int(compiles))

    def note_program_cache(self, hit: bool, size: int) -> None:
        """Accounting for callers that keep their own cache of built
        programs: hit/miss counters plus a live size gauge."""
        reg = self.registry
        if hit:
            reg.counter(
                "profiler_program_cache_hits_total",
                "Jitted-program cache hits (no retrace/lower)",
            ).inc()
        else:
            reg.counter(
                "profiler_program_cache_misses_total",
                "Jitted-program cache misses (program built + traced)",
            ).inc()
        reg.gauge(
            "profiler_program_cache_size",
            "Compiled programs resident in the fit program cache",
        ).set(size)

    @contextmanager
    def measure(self, name: str):
        """Time a host-side window as one execution of ``name`` (the
        caller is responsible for any device sync inside the block)."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.note_execute(name, time.perf_counter() - t0)

    # -- the wrapper ---------------------------------------------------------

    def wrap(
        self,
        fn: Callable[..., Any],
        name: Optional[str] = None,
        cost: Optional[Callable[..., Dict[str, float]]] = None,
    ) -> Callable[..., Any]:
        """Profile a callable. Each call runs in a window closed by a card
        sync; a call with an unseen shape/dtype signature books a first
        call (``note_compile``) with ``cost(*args, **kwargs)`` — the
        ``{"flops", "bytes_accessed"}`` of one call, which stands in for
        the reference's XLA ``cost_analysis()`` — and every call books an
        execution. Returns ``fn`` unchanged when the profiler is
        disabled."""
        if not self.enabled:
            return fn
        label = name or getattr(fn, "__name__", None) or repr(fn)
        seen: Dict[str, bool] = {}
        profiler = self

        def profiled(*args, **kwargs):
            if not profiler.enabled:
                return fn(*args, **kwargs)
            sig = _signature(args, kwargs)
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            _sync(out)
            dt = time.perf_counter() - t0
            if sig not in seen:
                seen[sig] = True
                spent = cost(*args, **kwargs) if cost is not None else {}
                profiler.note_compile(label, dt, signature=sig, **spent)
            else:
                profiler.note_cache_hit(label)
            profiler.note_execute(label, dt)
            return out

        profiled.__name__ = f"profiled_{label}"
        profiled.__wrapped__ = fn  # type: ignore[attr-defined]
        return profiled

    def wrap_host(
        self, fn: Callable[..., Any], name: str
    ) -> Callable[..., Any]:
        """Time a host-side callable as executions of ``name`` — no device
        sync, no first-call accounting. Returns ``fn`` unchanged when the
        profiler is disabled."""
        if not self.enabled:
            return fn
        profiler = self

        def timed(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                profiler.note_execute(name, time.perf_counter() - t0)

        timed.__name__ = f"profiled_{name}"
        timed.__wrapped__ = fn  # type: ignore[attr-defined]
        return timed

    # -- gauges + reports ----------------------------------------------------

    def sample_memory(self) -> Dict[str, Dict[str, float]]:
        """Read each card's ``torch.cuda.memory_stats()`` (bytes allocated
        now and at peak) and ``mem_get_info`` (its total) into per-device
        gauges. Without a card it returns {} and sets nothing — always
        safe to call."""
        import torch

        if not torch.cuda.is_available():
            return {}
        out: Dict[str, Dict[str, float]] = {}
        g_use = self.registry.gauge(
            "profiler_hbm_bytes_in_use", "Device memory in use (memory_stats)"
        )
        g_lim = self.registry.gauge(
            "profiler_hbm_bytes_limit", "Device memory limit (memory_stats)"
        )
        g_peak = self.registry.gauge(
            "profiler_hbm_bytes_peak", "Peak device memory (memory_stats)"
        )
        for i in range(torch.cuda.device_count()):
            stats = torch.cuda.memory_stats(i)
            key = f"cuda:{i}"
            in_use = float(stats.get("allocated_bytes.all.current", 0))
            peak = float(stats.get("allocated_bytes.all.peak", 0))
            limit = float(torch.cuda.mem_get_info(i)[1])
            g_use.labels(device=key).set(in_use)
            g_lim.labels(device=key).set(limit)
            g_peak.labels(device=key).set(peak)
            out[key] = {"bytes_in_use": in_use, "bytes_limit": limit,
                        "peak_bytes_in_use": peak}
        return out

    def roofline(self) -> List[Dict[str, Any]]:
        """One attribution row per profiled function, hottest first."""
        peaks = device_peaks()
        with self._lock:
            profiles = list(self._profiles.values())
        rows = [
            p.roofline(peaks[0], peaks[1], platform=peaks.platform)
            for p in profiles
        ]
        rows.sort(key=lambda r: -(r["mean_ms"] * r["executions"]))
        return rows

    def snapshot(self) -> Dict[str, Any]:
        """The JSON-safe profiler section: device identity + peaks,
        per-function totals, roofline rows, and the latest memory
        sample."""
        import torch

        if torch.cuda.is_available():
            dev = {"backend": "cuda", "kind": torch.cuda.get_device_name(0),
                   "count": torch.cuda.device_count()}
        else:
            dev = {"backend": "cpu", "kind": "", "count": 0}
        peaks = device_peaks()
        with self._lock:
            functions = {
                name: p.to_dict() for name, p in self._profiles.items()
            }
        return {
            "device": dev,
            "platform": peaks.platform,
            "peak_flops_per_s": peaks[0],
            "peak_hbm_bytes_per_s": peaks[1],
            "functions": functions,
            "roofline": self.roofline(),
            "memory": self.sample_memory(),
        }

    def clear(self) -> None:
        with self._lock:
            self._profiles.clear()


# -- process-global profiler --------------------------------------------------

_PROFILER: Optional[DeviceProfiler] = None
_PROFILER_LOCK = threading.Lock()


def _env_enabled() -> Optional[bool]:
    raw = os.environ.get("MMLSPARK_TPU_PROFILE")
    if raw is None:
        return None
    return raw.strip().lower() not in ("", "0", "false", "off", "no")


def get_profiler() -> DeviceProfiler:
    """The process-global profiler, DISABLED unless
    ``MMLSPARK_TPU_PROFILE=1`` (re-checked per call, like the event-log
    sink) or a caller ran ``enable()``. Instrumented hot paths guard on
    ``profiler.active`` so the quiet default costs one attribute read."""
    global _PROFILER
    with _PROFILER_LOCK:
        if _PROFILER is None:
            _PROFILER = DeviceProfiler(enabled=bool(_env_enabled()))
    env = _env_enabled()
    if env is not None:
        _PROFILER.enabled = env
    return _PROFILER
