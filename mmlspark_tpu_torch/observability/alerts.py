"""Multi-window, multi-burn-rate SLO alerting off the live registry — the
port's copy of ``mmlspark_tpu/observability/alerts.py``: the same samples
give the same burn rates, and alerts fire and resolve at the same ticks.

``SLOReport`` is a post-hoc fold: somebody runs it after the campaign and
discovers the budget was blown an hour ago. :class:`AlertEvaluator` is the
live edge: it samples cumulative counters and the apply-latency histogram
on a cadence, derives windowed **burn rates** against the
:class:`~mmlspark_tpu_torch.observability.slo.SLOTargets`, and applies the
classic multi-window rule — fire only when BOTH a short and a long window
burn faster than ``threshold``x budget (the short window gives fast onset,
the long window keeps a transient blip from paging), resolve as soon as the
short window recovers.

Burn definitions per sample-window delta:

- **availability**: ``(bad / requests) / (1 - target.availability)`` —
  1.0 means errors are consuming budget exactly as fast as the SLO
  allots, N means N-times too fast;
- **latency**: windowed mean apply latency / ``target.p99_ms`` — the
  mean exceeding the tail target is an unambiguous storm signal and
  needs only the histogram ``sum``/``count`` deltas, which federate
  exactly.

Transitions publish paired
:class:`~mmlspark_tpu_torch.observability.events.AlertFired` /
:class:`~mmlspark_tpu_torch.observability.events.AlertResolved` events,
trip the incident flight recorder (trigger ``alert_fired``), and maintain
an ``alerts_active`` gauge. :meth:`AlertEvaluator.active_alerts` is the
advisory hook ``FleetController(alert_advisor=...)`` reads (an
actively-burning SLO pins the fleet "busy", blocking scale-down
mid-incident). Pass ``source=`` a callable returning either a local
``registry.summary()`` or a federated ``fleet_summary(federator.scrape())``
for the fleet-wide verdict.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, List, Mapping, Optional, Tuple

from mmlspark_tpu_torch.core.profiling import get_logger
from mmlspark_tpu_torch.observability.events import (
    AlertFired,
    AlertResolved,
    get_bus,
)
from mmlspark_tpu_torch.observability.slo import SLOTargets

logger = get_logger("observability.alerts")

__all__ = ["AlertEvaluator"]


def _scalar(summary: Mapping[str, Any], name: str) -> float:
    v = summary.get(name)
    if v is None:
        return 0.0
    if isinstance(v, dict):
        return float(sum(v.values()))
    return float(v)


def _hist_sum_count(summary: Mapping[str, Any], name: str) -> Tuple[float, float]:
    v = summary.get(name)
    if isinstance(v, dict) and "count" in v:
        return float(v.get("sum", 0.0)), float(v.get("count", 0.0))
    return 0.0, 0.0


class _Sample:
    __slots__ = ("t", "requests", "bad", "apply_sum", "apply_count")

    def __init__(
        self, t: float, requests: float, bad: float,
        apply_sum: float, apply_count: float,
    ):
        self.t = t
        self.requests = requests
        self.bad = bad
        self.apply_sum = apply_sum
        self.apply_count = apply_count


class AlertEvaluator:
    """Samples a registry summary into a ring and evaluates multi-window
    burn rates on every :meth:`tick` (call it yourself with an injectable
    clock for determinism, or :meth:`start` the background cadence)."""

    def __init__(
        self,
        targets: Optional[SLOTargets] = None,
        source: Optional[Callable[[], Mapping[str, Any]]] = None,
        registry=None,
        windows: Tuple[float, float] = (300.0, 3600.0),
        threshold: float = 1.0,
        clock: Callable[[], float] = time.monotonic,
    ):
        if windows[0] >= windows[1]:
            raise ValueError("windows must be (short, long) with short < long")
        self.targets = targets or SLOTargets()
        self.windows = (float(windows[0]), float(windows[1]))
        self.threshold = float(threshold)
        self.clock = clock
        if registry is None:
            from mmlspark_tpu_torch.observability.registry import get_registry

            registry = get_registry()
        self.registry = registry
        self.source = source if source is not None else registry.summary
        self._samples: List[_Sample] = []
        self._active: Dict[str, Dict[str, float]] = {}
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._g_active = registry.gauge(
            "alerts_active", "Currently-firing burn-rate alerts"
        )

    # -- sampling ------------------------------------------------------------

    def _read(self) -> Optional[_Sample]:
        try:
            summary = self.source()
        except Exception as e:  # noqa: BLE001 - a failed scrape skips a tick
            logger.debug("alert source read failed: %s", e)
            return None
        apply_sum, apply_count = _hist_sum_count(
            summary, "serving_apply_latency_seconds"
        )
        return _Sample(
            t=self.clock(),
            requests=_scalar(summary, "serving_requests_total"),
            bad=(
                _scalar(summary, "serving_replies_failed_total")
                + _scalar(summary, "serving_expired_total")
            ),
            apply_sum=apply_sum,
            apply_count=apply_count,
        )

    def _baseline(self, now: float, window: float) -> Optional[_Sample]:
        """The newest sample at least ``window`` old (the delta baseline);
        None until the ring spans the window — a window that cannot be
        evaluated yet never fires."""
        base = None
        for s in self._samples:
            if now - s.t >= window:
                base = s
            else:
                break
        return base

    def _burns(self, now: float, latest: _Sample) -> Optional[Dict[str, Tuple[float, float]]]:
        """{alert: (burn_short, burn_long)}, or None while the ring is
        too young to span the long window."""
        out: Dict[str, List[float]] = {"availability": [], "latency": []}
        for window in self.windows:
            base = self._baseline(now, window)
            if base is None:
                return None
            req = latest.requests - base.requests
            bad = latest.bad - base.bad
            budget = 1.0 - self.targets.availability
            avail_burn = (bad / req / budget) if req > 0 and budget > 0 else 0.0
            n = latest.apply_count - base.apply_count
            mean_ms = (
                (latest.apply_sum - base.apply_sum) / n * 1e3 if n > 0 else 0.0
            )
            lat_burn = mean_ms / self.targets.p99_ms if self.targets.p99_ms else 0.0
            out["availability"].append(avail_burn)
            out["latency"].append(lat_burn)
        return {k: (v[0], v[1]) for k, v in out.items()}

    # -- evaluation ----------------------------------------------------------

    def tick(self) -> Dict[str, Tuple[float, float]]:
        """One sample + evaluation pass. Returns the current burn rates
        (empty until the ring spans the long window). Never raises."""
        latest = self._read()
        if latest is None:
            return {}
        slo_names = {
            "availability": f"availability>={self.targets.availability:g}",
            "latency": f"p99<={self.targets.p99_ms:g}ms",
        }
        fired: List[Tuple[str, float, float]] = []
        resolved: List[Tuple[str, float, float]] = []
        with self._lock:
            self._samples.append(latest)
            horizon = latest.t - 2.0 * self.windows[1]
            while len(self._samples) > 2 and self._samples[1].t <= horizon:
                self._samples.pop(0)
            burns = self._burns(latest.t, latest)
            if burns is None:
                return {}
            for alert, (short, long_) in sorted(burns.items()):
                active = alert in self._active
                if not active and short > self.threshold and long_ > self.threshold:
                    self._active[alert] = {"short": short, "long": long_}
                    fired.append((alert, short, long_))
                elif active and short <= self.threshold:
                    del self._active[alert]
                    resolved.append((alert, short, long_))
            active_count = len(self._active)
        self._g_active.set(float(active_count))
        bus = get_bus()
        for transitions, is_fire in ((fired, True), (resolved, False)):
            for alert, short, long_ in transitions:
                if bus.active:
                    ctor = AlertFired if is_fire else AlertResolved
                    bus.publish(ctor(
                        alert=alert, slo=slo_names[alert],
                        burn_short=short, burn_long=long_,
                        window_short_s=self.windows[0],
                        window_long_s=self.windows[1],
                        threshold=self.threshold,
                    ))
                if is_fire:
                    from mmlspark_tpu_torch.observability.incidents import maybe_record

                    maybe_record(
                        "alert_fired",
                        detail=(
                            f"{alert} burn {short:.2f}x/{long_:.2f}x over "
                            f"{self.windows[0]:g}s/{self.windows[1]:g}s"
                        ),
                    )
        return burns

    # -- advisory + lifecycle ------------------------------------------------

    def active_alerts(self) -> Tuple[str, ...]:
        """Currently-firing alert names — the FleetController's advisory
        hook (non-empty pins the fleet busy, deferring scale-down)."""
        with self._lock:
            return tuple(sorted(self._active))

    def alert_history(self) -> Dict[str, Dict[str, float]]:
        with self._lock:
            return {k: dict(v) for k, v in self._active.items()}

    def start(self, interval_s: float = 10.0) -> "AlertEvaluator":
        """Run :meth:`tick` on a daemon cadence until :meth:`stop`."""
        if self._thread is not None:
            return self
        self._stop.clear()

        def _loop() -> None:
            while not self._stop.wait(interval_s):
                try:
                    self.tick()
                except Exception as e:  # noqa: BLE001 - alerting must not die
                    logger.debug("alert tick failed: %s", e)

        self._thread = threading.Thread(
            target=_loop, name="alert-evaluator", daemon=True
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        thread, self._thread = self._thread, None
        if thread is not None:
            thread.join(timeout=5.0)
