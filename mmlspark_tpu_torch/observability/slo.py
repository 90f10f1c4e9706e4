"""SLO reporting: fold the metrics registry + event log into one verdict —
the port's copy of ``mmlspark_tpu/observability/slo.py``, with the same
fold, field names and JSON, so a report over the same registry samples and
events is the reference's byte for byte.

:class:`SLOReport` is the Spark structured-streaming "progress report"
analogue for the serving plane:

    report = SLOReport.fold(get_registry(), events=replay(log_path))
    print(report.to_markdown())
    open("slo.json", "w").write(report.to_json())

Everything in the report is *derived*, never sampled twice: latency
quantiles come from the same ``serving_*`` histograms the Prometheus
endpoint exposes (so the report equals the registry fold exactly), request,
shed and error counts come from the counters, and the end-to-end quantiles
plus per-stage breakdown (queue -> batch -> apply -> reply) come from
replaying :class:`~mmlspark_tpu_torch.observability.events.RequestServed`
latencies against the stage histograms. Host code only: nothing here
touches the card.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, Iterable, List, Optional, Union

from mmlspark_tpu_torch.observability.events import (
    AlertFired,
    AlertResolved,
    DriftCleared,
    DriftDetected,
    Event,
    RequestServed,
    RequestShed,
)
from mmlspark_tpu_torch.observability.registry import MetricsRegistry


@dataclasses.dataclass(frozen=True)
class SLOTargets:
    """The serving objectives the report judges against (the reference's
    defaults: 5 ms median apply, 50 ms tail, three-nines availability)."""

    p50_ms: float = 5.0
    p99_ms: float = 50.0
    availability: float = 0.999

    def to_dict(self) -> Dict[str, float]:
        return dataclasses.asdict(self)


def _quantile(sorted_vals: List[float], q: float) -> float:
    """Linear-interpolated quantile of a sorted sample (0 when empty)."""
    if not sorted_vals:
        return 0.0
    if len(sorted_vals) == 1:
        return sorted_vals[0]
    pos = q * (len(sorted_vals) - 1)
    lo = int(pos)
    hi = min(lo + 1, len(sorted_vals) - 1)
    frac = pos - lo
    return sorted_vals[lo] + (sorted_vals[hi] - sorted_vals[lo]) * frac


def _scalar(summary: Dict[str, Any], name: str) -> float:
    """Counter/gauge value from a registry ``summary()`` dict; labeled
    series sum across children."""
    v = summary.get(name)
    if v is None:
        return 0.0
    if isinstance(v, dict):
        return float(sum(v.values()))
    return float(v)


def _hist(summary: Dict[str, Any], name: str) -> Dict[str, float]:
    v = summary.get(name)
    if isinstance(v, dict) and "count" in v:
        return {k: float(v[k]) for k in ("count", "sum", "p50", "p95", "p99")}
    return {"count": 0.0, "sum": 0.0, "p50": 0.0, "p95": 0.0, "p99": 0.0}


def fleet_summary(registry: MetricsRegistry) -> Dict[str, Any]:
    """Collapse a federated (``replica``-labeled) registry into the
    unlabeled summary shape :meth:`SLOReport.fold` reads. Counters and
    gauges already sum across children in the fold's ``_scalar``; the
    work here is histograms — a parent whose observations all live in
    labeled children reports ``count=0``, so merge the children
    bucket-for-bucket into one series before interpolating quantiles.
    Deterministic: the merge is pure addition over sorted metric names."""
    from mmlspark_tpu_torch.observability.registry import Histogram

    summary = registry.summary()
    with registry._lock:
        metrics = dict(registry._metrics)
    for name, metric in sorted(metrics.items()):
        if not isinstance(metric, Histogram) or not metric._children:
            continue
        merged = Histogram(name, buckets=metric.buckets)
        for _, series in metric._series():
            with series._lock:
                counts = list(series._counts)  # type: ignore[attr-defined]
                total = series._count  # type: ignore[attr-defined]
                ssum = series._sum  # type: ignore[attr-defined]
            if len(counts) != len(merged._counts):
                continue  # child scraped with mismatched buckets
            merged._counts = [a + b for a, b in zip(merged._counts, counts)]
            merged._count += total
            merged._sum += ssum
        summary[name] = merged.summary()
    return summary


@dataclasses.dataclass
class SLOReport:
    """One serving-SLO verdict, derived from the registry + event log."""

    targets: SLOTargets
    requests: float
    shed: float
    expired: float
    reply_failures: float
    errors: float
    #: end-to-end request latency quantiles (seconds), from RequestServed
    e2e: Dict[str, float]
    #: per-stage summaries (count/sum/p50/p95/p99, seconds)
    stages: Dict[str, Dict[str, float]]
    batches: float = 0.0
    #: model-quality section: the per-feature drift table
    #: rebuilt from the ``quality_*`` gauges, the live ``alerts_active``
    #: gauge, and the drift/alert transition history from the event log
    quality: Dict[str, Any] = dataclasses.field(default_factory=dict)

    # -- derived -------------------------------------------------------------

    @property
    def shed_pct(self) -> float:
        offered = self.requests + self.shed
        return 100.0 * self.shed / offered if offered else 0.0

    @property
    def error_rate(self) -> float:
        return self.errors / self.requests if self.requests else 0.0

    @property
    def error_budget_consumed(self) -> float:
        """Fraction of the availability error budget spent (>1 = blown)."""
        budget = 1.0 - self.targets.availability
        return self.error_rate / budget if budget > 0 else 0.0

    @property
    def apply_p50_ms(self) -> float:
        return self.stages.get("apply", {}).get("p50", 0.0) * 1e3

    @property
    def apply_p99_ms(self) -> float:
        return self.stages.get("apply", {}).get("p99", 0.0) * 1e3

    def ok(self) -> bool:
        return (
            self.apply_p50_ms <= self.targets.p50_ms
            and self.apply_p99_ms <= self.targets.p99_ms
            and self.error_budget_consumed <= 1.0
        )

    # -- construction --------------------------------------------------------

    @classmethod
    def fold(
        cls,
        registry: Union[MetricsRegistry, Dict[str, Any], None],
        events: Optional[Iterable[Event]] = None,
        targets: Optional[SLOTargets] = None,
    ) -> "SLOReport":
        """Fold a registry (or a ``registry.summary()`` dict — the history
        server feeds a JSON snapshot) and an optional event stream into a
        report. Counters and stage quantiles come straight from the
        registry; the event stream adds end-to-end quantiles, HTTP-error
        counts, and fills shed/served counts when no registry is given."""
        targets = targets or SLOTargets()
        if registry is None:
            summary: Dict[str, Any] = {}
        elif isinstance(registry, MetricsRegistry):
            summary = registry.summary()
        else:
            summary = dict(registry)

        stages = {
            "queue": _hist(summary, "serving_queue_wait_seconds"),
            "apply": _hist(summary, "serving_apply_latency_seconds"),
        }
        requests = _scalar(summary, "serving_requests_total")
        shed = _scalar(summary, "serving_shed_total")
        expired = _scalar(summary, "serving_expired_total")
        reply_failures = _scalar(summary, "serving_replies_failed_total")
        batches = _scalar(summary, "serving_batches_total")

        latencies: List[float] = []
        errors = 0.0
        ev_served = 0.0
        ev_shed = 0.0
        drift_events: List[Dict[str, Any]] = []
        alert_history: List[Dict[str, Any]] = []
        for ev in events or ():
            if isinstance(ev, RequestServed):
                ev_served += 1
                latencies.append(float(ev.latency))
                if ev.status >= 500:
                    errors += 1
            elif isinstance(ev, RequestShed):
                ev_shed += 1
            elif isinstance(ev, (DriftDetected, DriftCleared)):
                drift_events.append({
                    "event": type(ev).__name__,
                    "feature": ev.feature,
                    "stat": ev.stat,
                    "value": float(ev.value),
                    "threshold": float(ev.threshold),
                })
            elif isinstance(ev, (AlertFired, AlertResolved)):
                alert_history.append({
                    "event": type(ev).__name__,
                    "alert": ev.alert,
                    "slo": ev.slo,
                    "burn_short": float(ev.burn_short),
                    "burn_long": float(ev.burn_long),
                })
        if requests == 0.0:
            requests = ev_served
        if shed == 0.0:
            shed = ev_shed

        from mmlspark_tpu_torch.observability.quality import drift_table_from_summary

        quality = {
            "drift": drift_table_from_summary(summary),
            "alerts_active": _scalar(summary, "alerts_active"),
            "drift_events": drift_events,
            "alert_history": alert_history,
        }

        latencies.sort()
        e2e = {
            "count": float(len(latencies)),
            "p50": _quantile(latencies, 0.50),
            "p95": _quantile(latencies, 0.95),
            "p99": _quantile(latencies, 0.99),
        }
        # reply overhead: whatever end-to-end time queue+apply don't explain
        reply = max(
            0.0,
            e2e["p50"] - stages["queue"]["p50"] - stages["apply"]["p50"],
        )
        stages["reply"] = {
            "count": e2e["count"], "sum": 0.0,
            "p50": reply, "p95": 0.0, "p99": 0.0,
        }
        return cls(
            targets=targets,
            requests=requests,
            shed=shed,
            expired=expired,
            reply_failures=reply_failures,
            errors=errors,
            e2e=e2e,
            stages=stages,
            batches=batches,
            quality=quality,
        )

    @classmethod
    def fold_fleet(
        cls,
        registry: Union[MetricsRegistry, Dict[str, Any], None],
        events: Optional[Iterable[Event]] = None,
        targets: Optional[SLOTargets] = None,
    ) -> "SLOReport":
        """The fleet-wide verdict: fold a **federated** registry (every
        series ``replica``-labeled, from
        :meth:`~mmlspark_tpu_torch.observability.federation.MetricsFederator.scrape`)
        plus a **merged** multi-process event stream (from
        :func:`~mmlspark_tpu_torch.observability.events.merge`) into one report.
        Histogram children merge bucket-for-bucket first, so the fleet p99
        is interpolated over the union of observations, not the mean of
        per-replica quantiles."""
        if isinstance(registry, MetricsRegistry):
            registry = fleet_summary(registry)
        return cls.fold(registry, events=events, targets=targets)

    # -- renderers -----------------------------------------------------------

    def to_dict(self) -> Dict[str, Any]:
        return {
            "targets": self.targets.to_dict(),
            "requests": self.requests,
            "shed": self.shed,
            "shed_pct": self.shed_pct,
            "expired": self.expired,
            "reply_failures": self.reply_failures,
            "errors": self.errors,
            "error_rate": self.error_rate,
            "error_budget_consumed": self.error_budget_consumed,
            "batches": self.batches,
            "e2e": self.e2e,
            "stages": self.stages,
            "quality": self.quality,
            "ok": self.ok(),
        }

    def to_json(self, indent: int = 2) -> str:
        return json.dumps(self.to_dict(), indent=indent, sort_keys=True)

    def to_markdown(self) -> str:
        """The measured-SLO table as markdown (objectives, stages, drift and
        alert history)."""

        def _status(ok: bool) -> str:
            return "met" if ok else "**missed**"

        t = self.targets
        lines = [
            "| objective | target | measured | status |",
            "|---|---|---|---|",
            (
                f"| apply p50 | <= {t.p50_ms:g} ms | "
                f"{self.apply_p50_ms:.2f} ms | "
                f"{_status(self.apply_p50_ms <= t.p50_ms)} |"
            ),
            (
                f"| apply p99 | <= {t.p99_ms:g} ms | "
                f"{self.apply_p99_ms:.2f} ms | "
                f"{_status(self.apply_p99_ms <= t.p99_ms)} |"
            ),
            (
                f"| availability | >= {t.availability:.3%} | "
                f"{1.0 - self.error_rate:.3%} | "
                f"{_status(self.error_budget_consumed <= 1.0)} |"
            ),
            "",
            (
                f"Requests: {self.requests:.0f} served, {self.shed:.0f} shed "
                f"({self.shed_pct:.1f}%), {self.expired:.0f} expired, "
                f"{self.errors:.0f} server errors "
                f"(error budget consumed: "
                f"{self.error_budget_consumed:.1%})."
            ),
            "",
            "| stage | count | p50 | p95 | p99 |",
            "|---|---|---|---|---|",
        ]
        order = ["queue", "apply", "reply"]
        for stage in order + sorted(set(self.stages) - set(order)):
            s = self.stages.get(stage)
            if s is None:
                continue
            lines.append(
                f"| {stage} | {s['count']:.0f} | {s['p50'] * 1e3:.2f} ms "
                f"| {s['p95'] * 1e3:.2f} ms | {s['p99'] * 1e3:.2f} ms |"
            )
        if self.e2e["count"]:
            lines.append(
                f"| end-to-end | {self.e2e['count']:.0f} "
                f"| {self.e2e['p50'] * 1e3:.2f} ms "
                f"| {self.e2e['p95'] * 1e3:.2f} ms "
                f"| {self.e2e['p99'] * 1e3:.2f} ms |"
            )
        drift = self.quality.get("drift") or []
        if drift:
            lines += [
                "",
                "Model quality (vs reference profile):",
                "",
                "| feature | model | version | PSI | KS | drifted |",
                "|---|---|---|---|---|---|",
            ]
            for row in drift:
                lines.append(
                    f"| {row.get('feature', '')} | {row.get('model', '')} "
                    f"| {row.get('version', '')} | {row.get('psi', 0.0):.3f} "
                    f"| {row.get('ks', 0.0):.3f} "
                    f"| {'yes' if row.get('drifted') else 'no'} |"
                )
        history = self.quality.get("alert_history") or []
        if history:
            lines += [
                "",
                "| alert | slo | transition | burn short | burn long |",
                "|---|---|---|---|---|",
            ]
            for rec in history:
                lines.append(
                    f"| {rec.get('alert', '')} | {rec.get('slo', '')} "
                    f"| {rec.get('event', '')} "
                    f"| {rec.get('burn_short', 0.0):.2f}x "
                    f"| {rec.get('burn_long', 0.0):.2f}x |"
                )
        return "\n".join(lines)
