"""Prometheus-style metrics registry: counters, gauges, latency histograms —
the port's copy of ``mmlspark_tpu/observability/registry.py``.

Spark exposes its task/scheduler/streaming metrics through a registry the
UI and sinks scrape; the analogue here is a process-global
:class:`MetricsRegistry` whose text *exposition* is the Prometheus format
(the reference's serving ``GET /metrics`` serves it directly):

    reg = get_registry()
    reg.counter("serving_requests_total", "Requests answered").inc()
    h = reg.histogram("serving_apply_latency_seconds", "Model apply time")
    h.observe(0.0021)
    print(reg.exposition())

Design constraints the implementation honors:

- **get-or-create**: registering the same (name, type) twice returns the
  same metric — many ``_BatchLoop``/``RuntimeMetrics`` instances feed the
  shared plane; a name collision across *types* is a hard error;
- **labels**: ``metric.labels(reason="timeout")`` binds label values to a
  child series (rendered ``name{reason="timeout"}``); the bare metric is
  the unlabeled series;
- **histograms** use fixed buckets (cumulative ``_bucket{le=...}`` series
  plus ``_sum``/``_count``) and answer ``p50/p95/p99`` by linear
  interpolation inside the owning bucket — the same estimate
  ``histogram_quantile`` computes server-side;
- every mutation is a few dict/float ops under a per-metric lock — safe
  from scheduler worker threads and HTTP handler threads alike, and cheap
  enough for the serving hot path.
"""

from __future__ import annotations

import math
import threading
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

#: default latency buckets (seconds): 100us .. 10s, roughly log-spaced
DEFAULT_BUCKETS: Tuple[float, ...] = (
    0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
)

#: fit/compile-scale buckets (seconds to half an hour). DEFAULT_BUCKETS
#: top out at 10 s, so fit-scale durations all land in +Inf and the
#: interpolated p99 clamps to 10.0 — meaningless for a multi-minute fit
#: or an XLA compile. Register fit and compile histograms with these;
#: keep DEFAULT_BUCKETS for serving-latency metrics.
FIT_BUCKETS: Tuple[float, ...] = (
    0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
    30.0, 60.0, 120.0, 300.0, 600.0, 1800.0,
)


def _format_value(v: float) -> str:
    if v == math.inf:
        return "+Inf"
    if float(v).is_integer():
        return str(int(v))
    return repr(float(v))


def _escape(value: str) -> str:
    return str(value).replace("\\", "\\\\").replace('"', '\\"')


def _render_labels(labels: Dict[str, str]) -> str:
    if not labels:
        return ""
    inner = ",".join(
        f'{k}="{_escape(v)}"' for k, v in sorted(labels.items())
    )
    return "{" + inner + "}"


class _Metric:
    """Shared base: name/help/type plus the labeled-children table."""

    kind = "untyped"

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._lock = threading.Lock()
        self._children: Dict[Tuple[Tuple[str, str], ...], "_Metric"] = {}

    def labels(self, **labels: str) -> "_Metric":
        """Child series bound to these label values (created on first use)."""
        key = tuple(sorted((k, str(v)) for k, v in labels.items()))
        with self._lock:
            child = self._children.get(key)
            if child is None:
                child = type(self)(self.name, self.help)
                if isinstance(child, Histogram):
                    child.buckets = self.buckets  # type: ignore[attr-defined]
                    child._counts = [0] * (len(child.buckets) + 1)
                child._label_values = dict(key)  # type: ignore[attr-defined]
                self._children[key] = child
            return child

    def _series(self) -> Iterable[Tuple[Dict[str, str], "_Metric"]]:
        """(labels, series) pairs: the bare series when touched, then every
        labeled child."""
        with self._lock:
            children = list(self._children.values())
        if self._touched():
            yield getattr(self, "_label_values", {}), self
        for child in children:
            yield child._label_values, child  # type: ignore[attr-defined]

    def _touched(self) -> bool:
        return True

    def render(self) -> List[str]:
        raise NotImplementedError


class Counter(_Metric):
    kind = "counter"

    def __init__(self, name: str, help: str = ""):
        super().__init__(name, help)
        self._value = 0.0
        self._used = False

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError("counters only go up")
        with self._lock:
            self._value += amount
            self._used = True

    @property
    def value(self) -> float:
        with self._lock:
            return self._value

    def _touched(self) -> bool:
        return self._used or not self._children

    def render(self) -> List[str]:
        return [
            f"{self.name}{_render_labels(labels)} {_format_value(series._value)}"
            for labels, series in self._series()
        ]


class Gauge(_Metric):
    kind = "gauge"

    def __init__(self, name: str, help: str = ""):
        super().__init__(name, help)
        self._value = 0.0
        self._used = False

    def set(self, value: float) -> None:
        with self._lock:
            self._value = float(value)
            self._used = True

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self._value += amount
            self._used = True

    def dec(self, amount: float = 1.0) -> None:
        self.inc(-amount)

    def set_max(self, value: float) -> None:
        """Monotonic high-water update (max queue depth et al.)."""
        with self._lock:
            if value > self._value:
                self._value = float(value)
            self._used = True

    @property
    def value(self) -> float:
        with self._lock:
            return self._value

    def _touched(self) -> bool:
        return self._used or not self._children

    def render(self) -> List[str]:
        return [
            f"{self.name}{_render_labels(labels)} {_format_value(series._value)}"
            for labels, series in self._series()
        ]


class Histogram(_Metric):
    """Fixed-bucket latency histogram with Prometheus exposition and
    bucket-interpolated quantiles (``p50/p95/p99`` via :meth:`percentile`)."""

    kind = "histogram"

    def __init__(
        self,
        name: str,
        help: str = "",
        buckets: Optional[Sequence[float]] = None,
    ):
        super().__init__(name, help)
        self.buckets: Tuple[float, ...] = tuple(buckets or DEFAULT_BUCKETS)
        if list(self.buckets) != sorted(self.buckets):
            raise ValueError("histogram buckets must be sorted ascending")
        # _counts[i] observations <= buckets[i]; last slot is +Inf overflow
        self._counts = [0] * (len(self.buckets) + 1)
        self._sum = 0.0
        self._count = 0

    def observe(self, value: float) -> None:
        with self._lock:
            self._sum += value
            self._count += 1
            for i, bound in enumerate(self.buckets):
                if value <= bound:
                    self._counts[i] += 1
                    return
            self._counts[-1] += 1

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    @property
    def sum(self) -> float:
        with self._lock:
            return self._sum

    def percentile(self, q: float) -> float:
        """Quantile estimate (q in [0, 1]) by linear interpolation within
        the owning bucket — ``histogram_quantile``'s estimate. Returns 0.0
        with no observations; observations beyond the last finite bucket
        clamp to its upper bound."""
        if not 0.0 <= q <= 1.0:
            raise ValueError("q must be in [0, 1]")
        with self._lock:
            total = self._count
            counts = list(self._counts)
        if total == 0:
            return 0.0
        rank = q * total
        cum = 0
        for i, bound in enumerate(self.buckets):
            prev_cum, cum = cum, cum + counts[i]
            if cum >= rank and counts[i] > 0:
                lo = self.buckets[i - 1] if i > 0 else 0.0
                frac = (rank - prev_cum) / counts[i]
                return lo + (bound - lo) * min(max(frac, 0.0), 1.0)
        return self.buckets[-1]

    def summary(self) -> Dict[str, float]:
        return {
            "count": self.count,
            "sum": self.sum,
            "p50": self.percentile(0.50),
            "p95": self.percentile(0.95),
            "p99": self.percentile(0.99),
        }

    def _touched(self) -> bool:
        return self._count > 0 or not self._children

    def render(self) -> List[str]:
        lines: List[str] = []
        for labels, series in self._series():
            with series._lock:
                counts = list(series._counts)  # type: ignore[attr-defined]
                total, ssum = series._count, series._sum  # type: ignore[attr-defined]
            cum = 0
            for bound, n in zip(series.buckets, counts):  # type: ignore[attr-defined]
                cum += n
                le = dict(labels, le=_format_value(bound))
                lines.append(f"{self.name}_bucket{_render_labels(le)} {cum}")
            le = dict(labels, le="+Inf")
            lines.append(f"{self.name}_bucket{_render_labels(le)} {total}")
            lines.append(
                f"{self.name}_sum{_render_labels(labels)} {repr(float(ssum))}"
            )
            lines.append(f"{self.name}_count{_render_labels(labels)} {total}")
        return lines


class MetricsRegistry:
    """Name -> metric table with get-or-create registration and Prometheus
    text exposition."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._metrics: Dict[str, _Metric] = {}

    def _get_or_create(self, cls, name: str, help: str, **kwargs) -> _Metric:
        with self._lock:
            existing = self._metrics.get(name)
            if existing is not None:
                if not isinstance(existing, cls):
                    raise ValueError(
                        f"metric {name!r} already registered as "
                        f"{existing.kind}, not {cls.kind}"
                    )
                return existing
            metric = cls(name, help, **kwargs)
            self._metrics[name] = metric
            return metric

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get_or_create(Counter, name, help)  # type: ignore[return-value]

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get_or_create(Gauge, name, help)  # type: ignore[return-value]

    def histogram(
        self,
        name: str,
        help: str = "",
        buckets: Optional[Sequence[float]] = None,
    ) -> Histogram:
        return self._get_or_create(  # type: ignore[return-value]
            Histogram, name, help, buckets=buckets
        )

    def get(self, name: str) -> Optional[_Metric]:
        with self._lock:
            return self._metrics.get(name)

    def exposition(self) -> str:
        """The Prometheus text format (version 0.0.4): ``# HELP``/``# TYPE``
        headers followed by every series, metrics in name order."""
        with self._lock:
            metrics = [self._metrics[k] for k in sorted(self._metrics)]
        lines: List[str] = []
        for m in metrics:
            if m.help:
                lines.append(f"# HELP {m.name} {m.help}")
            lines.append(f"# TYPE {m.name} {m.kind}")
            lines.extend(m.render())
        return "\n".join(lines) + "\n"

    def summary(self) -> Dict[str, object]:
        """Plain-dict snapshot: scalar for unlabeled counters/gauges, a
        ``{"k=v": value}`` dict for labeled ones, count/sum/p50/p95/p99
        for histograms."""
        with self._lock:
            metrics = dict(self._metrics)
        out: Dict[str, object] = {}
        for name, m in sorted(metrics.items()):
            if isinstance(m, Histogram):
                out[name] = m.summary()
            elif isinstance(m, (Counter, Gauge)):
                labeled: Dict[str, float] = {
                    ",".join(f"{k}={v}" for k, v in lbl.items()): series.value  # type: ignore[attr-defined]
                    for lbl, series in m._series()
                }
                out[name] = labeled if set(labeled) - {""} else m.value
        return out


_REGISTRY = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    """The process-global registry the serving ``/metrics`` endpoint
    exposes. Tests wanting isolation construct their own
    :class:`MetricsRegistry` and pass it to the instrumented component."""
    return _REGISTRY
