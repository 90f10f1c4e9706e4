"""mmlspark_tpu_torch.observability — the port's observability plane, with
the public names of ``mmlspark_tpu/observability/__init__.py`` for the
modules it has:

- :mod:`~mmlspark_tpu_torch.observability.events` — typed event bus with a
  JSON-lines event-log sink (``MMLSPARK_TPU_EVENT_LOG=/path``), replay,
  fleet federation (``collect``/``merge``) and the timeline summary;
- :mod:`~mmlspark_tpu_torch.observability.tracing` — Span/Tracer with
  ``contextvars`` propagation and deterministic span ids;
- :mod:`~mmlspark_tpu_torch.observability.registry` — Prometheus-style
  counters/gauges/histograms with text exposition;
- :mod:`~mmlspark_tpu_torch.observability.profiler` — device profiler
  (``MMLSPARK_TPU_PROFILE=1``): first-call accounting, card-synced
  execution windows, caller-supplied costs against the card's peaks,
  device-memory gauges, transfer counters;
- :mod:`~mmlspark_tpu_torch.observability.sketches` and
  :mod:`~mmlspark_tpu_torch.observability.quality` — exact mergeable
  sketches, reference profiles and drift monitoring
  (``MMLSPARK_TPU_QUALITY_STORE=/path``);
- :mod:`~mmlspark_tpu_torch.observability.incidents` — the incident flight
  recorder (``MMLSPARK_TPU_INCIDENT_DIR=/path``);
- :mod:`~mmlspark_tpu_torch.observability.federation` — fleet-wide
  ``/metrics`` federation (:class:`MetricsFederator`, ``parse_exposition``);
- :mod:`~mmlspark_tpu_torch.observability.slo` — the serving SLO fold
  (:class:`SLOReport`, :class:`SLOTargets`, ``fleet_summary`` for a
  federated registry);
- :mod:`~mmlspark_tpu_torch.observability.alerts` — multi-window burn-rate
  alerting (:class:`AlertEvaluator`, the fleet controller's advisory);
- :mod:`~mmlspark_tpu_torch.observability.history` — the history server:
  an event log rendered to one static HTML page
  (``python -m mmlspark_tpu_torch.observability.history``).

Importing this package loads neither ``jax`` nor ``mmlspark_tpu``.
"""

from mmlspark_tpu_torch.observability.alerts import AlertEvaluator
from mmlspark_tpu_torch.observability.events import (
    AlertFired,
    AlertResolved,
    BatchFormed,
    BreakerTripped,
    CandidateBatchFitted,
    DriftCleared,
    DriftDetected,
    Event,
    EventBus,
    EventLogSink,
    FeatureBundled,
    FleetScaled,
    GroupReformed,
    HistogramChunked,
    HistogramSubtracted,
    IncidentRecorded,
    LeaseRecovered,
    ModelCommitted,
    ModelSwapped,
    NetworkPartitioned,
    PeerSlow,
    ProcessLost,
    ProcessStarted,
    ProfileCompiled,
    ProfileExecuted,
    RegistryRecovered,
    RegistryUnavailable,
    RequestRouted,
    RequestServed,
    RequestShed,
    SpanRecorded,
    StageCompleted,
    StageStarted,
    StreamEpochCommitted,
    StreamEpochStarted,
    StreamSourceAdvanced,
    SweepCompleted,
    SweepStarted,
    TaskDispatched,
    TaskFailed,
    TaskRecovered,
    TaskRetried,
    TaskSpeculated,
    WorkerParoled,
    WorkerQuarantined,
    collect,
    format_timeline,
    from_record,
    get_bus,
    log_segments,
    merge,
    process_label,
    process_log_path,
    replay,
    timeline,
    write_merged,
)
from mmlspark_tpu_torch.observability.federation import (
    MetricsFederator,
    parse_exposition,
)
from mmlspark_tpu_torch.observability.incidents import (
    FlightRecorder,
    get_recorder,
    maybe_record,
)
from mmlspark_tpu_torch.observability.profiler import (
    DevicePeaks,
    DeviceProfiler,
    FunctionProfile,
    UNKNOWN_PLATFORM,
    device_peaks,
    get_profiler,
)
from mmlspark_tpu_torch.observability.quality import (
    QualityMonitor,
    ReferenceProfile,
    capture_pipeline_reference,
    drift_table_from_summary,
    get_monitor,
    install_monitor,
    load_profile,
)
from mmlspark_tpu_torch.observability.registry import (
    DEFAULT_BUCKETS,
    FIT_BUCKETS,
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    get_registry,
)
from mmlspark_tpu_torch.observability.sketches import (
    ColumnSketch,
    QuantileCompactor,
    ks_statistic,
    merge_all,
    psi,
)
from mmlspark_tpu_torch.observability.slo import SLOReport, SLOTargets, fleet_summary
from mmlspark_tpu_torch.observability.tracing import (
    PARENT_HEADER,
    TRACE_HEADER,
    Span,
    TraceContext,
    Tracer,
    get_tracer,
)


def __getattr__(name):
    # lazy: importing history here eagerly would trip runpy's double-import
    # warning under ``python -m mmlspark_tpu_torch.observability.history``
    if name == "render_report":
        from mmlspark_tpu_torch.observability.history import render_report

        return render_report
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "AlertEvaluator",
    "AlertFired",
    "AlertResolved",
    "BatchFormed",
    "BreakerTripped",
    "CandidateBatchFitted",
    "ColumnSketch",
    "Counter",
    "DEFAULT_BUCKETS",
    "DevicePeaks",
    "DeviceProfiler",
    "DriftCleared",
    "DriftDetected",
    "Event",
    "EventBus",
    "EventLogSink",
    "FIT_BUCKETS",
    "FeatureBundled",
    "FleetScaled",
    "FlightRecorder",
    "FunctionProfile",
    "Gauge",
    "GroupReformed",
    "Histogram",
    "HistogramChunked",
    "HistogramSubtracted",
    "IncidentRecorded",
    "LeaseRecovered",
    "MetricsFederator",
    "MetricsRegistry",
    "ModelCommitted",
    "ModelSwapped",
    "NetworkPartitioned",
    "PARENT_HEADER",
    "PeerSlow",
    "ProcessLost",
    "ProcessStarted",
    "ProfileCompiled",
    "ProfileExecuted",
    "QualityMonitor",
    "QuantileCompactor",
    "ReferenceProfile",
    "RegistryRecovered",
    "RegistryUnavailable",
    "RequestRouted",
    "RequestServed",
    "RequestShed",
    "SLOReport",
    "SLOTargets",
    "Span",
    "SpanRecorded",
    "StageCompleted",
    "StageStarted",
    "StreamEpochCommitted",
    "StreamEpochStarted",
    "StreamSourceAdvanced",
    "SweepCompleted",
    "SweepStarted",
    "TRACE_HEADER",
    "TaskDispatched",
    "TaskFailed",
    "TaskRecovered",
    "TaskRetried",
    "TaskSpeculated",
    "TraceContext",
    "Tracer",
    "UNKNOWN_PLATFORM",
    "WorkerParoled",
    "WorkerQuarantined",
    "capture_pipeline_reference",
    "collect",
    "device_peaks",
    "drift_table_from_summary",
    "fleet_summary",
    "format_timeline",
    "from_record",
    "get_bus",
    "get_monitor",
    "get_profiler",
    "get_recorder",
    "get_registry",
    "get_tracer",
    "install_monitor",
    "ks_statistic",
    "load_profile",
    "log_segments",
    "maybe_record",
    "merge",
    "merge_all",
    "parse_exposition",
    "process_label",
    "process_log_path",
    "psi",
    "render_report",
    "replay",
    "timeline",
    "write_merged",
]
