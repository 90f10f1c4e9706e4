"""Live model-quality plane: reference profiles + drift monitoring — the
port's copy of ``mmlspark_tpu/observability/quality.py``. Numeric numpy
columns are profiled and sketched column at a time (the sketches'
vectorized paths, and :meth:`_Window.push_many`), with the same profile,
windows, gauges and events as the value-by-value path.

The reference framework ships ``ComputeModelStatistics`` as a batch
evaluation transformer — quality is something you compute on a table you
already have. In production the table is the live request stream, and
the question is not "what is the AUC" (no labels yet) but "does today's
traffic still look like the data this model was fitted on". This module
is that production-time analogue:

- **Reference profiles**: fit time streams the training columns (and
  the fitted model's scores) through the deterministic
  :class:`~mmlspark_tpu_torch.observability.sketches.QuantileCompactor` to
  place near-equidepth bin edges, sketches each column over those fixed
  edges, and commits the result to the
  :class:`~mmlspark_tpu_torch.runtime.journal.ModelStore` as a CRC-sidecar'd
  JSON artifact riding next to the model version
  (``<name>-<version>.quality.json``).
- **Live sketching**: :class:`QualityMonitor` keeps a rolling window of
  bin counts per feature, fed by ``PipelineModel.transform`` and the
  serving ``_BatchLoop`` behind the same ambient-gate pattern as tracing
  — an unconfigured process pays one env lookup per call, keeping the
  bare transform inside the perf-report <5% overhead guard.
- **Drift scoring**: every ``eval_every`` observations the monitor
  scores each feature's window against the served version's reference
  profile (PSI + KS), publishes ``quality_*`` gauges the
  ``MetricsFederator`` scrapes like any other series, and on threshold
  crossings publishes paired :class:`DriftDetected`/:class:`DriftCleared`
  events and trips the incident flight recorder.

Env-driven like the event sink and the profiler:
``MMLSPARK_TPU_QUALITY_STORE=/path`` (the ModelStore root) installs the
process-global monitor on first :func:`get_monitor` call;
``MMLSPARK_TPU_QUALITY_MODEL`` names the model (default ``model``).
"""

from __future__ import annotations

import bisect
import collections
import concurrent.futures
import math
import os
import threading
from typing import Any, Deque, Dict, Iterable, List, Mapping, Optional, Tuple

import numpy as np

from mmlspark_tpu_torch.core.profiling import get_logger
from mmlspark_tpu_torch.observability.events import (
    DriftCleared,
    DriftDetected,
    get_bus,
)
from mmlspark_tpu_torch.observability.sketches import (
    DEFAULT_BINS,
    PSI_EPS,
    ColumnSketch,
    QuantileCompactor,
    _is_missing,
)

logger = get_logger("mmlspark_tpu_torch.observability.quality")

__all__ = [
    "QualityMonitor",
    "ReferenceProfile",
    "capture_pipeline_reference",
    "drift_table_from_summary",
    "get_monitor",
    "install_monitor",
    "load_profile",
]

#: artifact kind under which profiles ride next to the model version
PROFILE_KIND = "quality"

#: hysteresis: a drifted feature clears when its stats fall below this
#: fraction of the onset threshold, so a statistic hovering at the
#: threshold cannot flap detect/clear pairs
CLEAR_FRACTION = 0.8

#: hard cap on profiled features — quality must never explode the metric
#: cardinality a federated scrape carries
MAX_FEATURES = 64


def _iter_feature_values(
    column: str, values: Iterable[Any]
) -> Iterable[Tuple[str, Any]]:
    """Expand one column's rows into (feature, scalar) pairs: a vector
    row fans out to ``col[0]``, ``col[1]``, ...; scalar rows keep the
    bare column name."""
    for row in values:
        if isinstance(row, (list, tuple)) or (
            hasattr(row, "ndim") and getattr(row, "ndim", 0) >= 1
        ):
            for i, v in enumerate(row):
                yield f"{column}[{i}]", v
        else:
            yield column, row


def _feature_arrays(column: str, values: Any) -> Optional[List[Tuple[str, np.ndarray]]]:
    """A numeric numpy column as (feature, 1-D array) pairs in the order
    :func:`_iter_feature_values` names them (a 2-D column per index), or
    None for any other column (which takes the value-by-value path)."""
    if not isinstance(values, np.ndarray) or values.dtype.kind not in "fiub":
        return None
    if values.ndim == 1:
        return [(column, values)]
    if values.ndim == 2:
        return [(f"{column}[{i}]", values[:, i]) for i in range(values.shape[1])]
    return None


class ReferenceProfile:
    """Per-feature + score distribution profile captured at fit time.

    ``features`` maps feature name (``input[0]``, ``prediction``, ...) to
    the exact :class:`ColumnSketch` of the fit-time data over bin edges
    the :class:`QuantileCompactor` placed. Serialization is canonical
    JSON, so the committed artifact is byte-stable for identical fits.
    """

    def __init__(
        self,
        model: str,
        version: int,
        features: Dict[str, ColumnSketch],
        bins: int = DEFAULT_BINS,
    ):
        self.model = model
        self.version = int(version)
        self.features = dict(features)
        self.bins = int(bins)

    @classmethod
    def capture(
        cls,
        model: str,
        version: int,
        columns: Mapping[str, Iterable[Any]],
        bins: int = DEFAULT_BINS,
    ) -> "ReferenceProfile":
        """Profile the given columns: place near-equidepth edges per
        expanded feature, then sketch every value over them. Vector
        columns fan out per index; at most :data:`MAX_FEATURES` features
        are kept (name order, so the cap is deterministic)."""
        grouped: Dict[str, List[Any]] = {}
        for col, values in columns.items():
            arrays = _feature_arrays(col, values)
            if arrays is not None:
                for feature, arr in arrays:
                    grouped.setdefault(feature, []).append(arr)
                continue
            for feature, v in _iter_feature_values(col, values):
                parts = grouped.setdefault(feature, [])
                if not parts or isinstance(parts[-1], np.ndarray):
                    parts.append([])
                parts[-1].append(v)
        def sketch_of(feature: str) -> ColumnSketch:
            parts = grouped[feature]
            if all(isinstance(p, np.ndarray) for p in parts):
                values = parts[0] if len(parts) == 1 else np.concatenate(parts)
            else:
                values = [v for p in parts for v in p]
            compactor = QuantileCompactor()
            compactor.extend(values)
            sketch = ColumnSketch(compactor.edges(bins))
            sketch.observe_many(values)
            return sketch

        # features are independent, and numpy's sorts and ufuncs release
        # the interpreter lock: sketch them on a few threads
        names = sorted(grouped)[:MAX_FEATURES]
        workers = max(1, min(len(names), os.cpu_count() or 1, 8))
        with concurrent.futures.ThreadPoolExecutor(max_workers=workers) as pool:
            features = dict(zip(names, pool.map(sketch_of, names)))
        return cls(model, version, features, bins=bins)

    def to_dict(self) -> Dict[str, Any]:
        return {
            "model": self.model,
            "version": self.version,
            "bins": self.bins,
            "features": {
                name: sketch.to_dict()
                for name, sketch in sorted(self.features.items())
            },
        }

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "ReferenceProfile":
        return cls(
            model=str(d.get("model", "model")),
            version=int(d.get("version", 0)),
            features={
                name: ColumnSketch.from_dict(rec)
                for name, rec in dict(d.get("features", {})).items()
            },
            bins=int(d.get("bins", DEFAULT_BINS)),
        )

    def commit(self, store) -> str:
        """Commit this profile as the model version's quality artifact
        (CRC sidecar, tmp+rename — :meth:`ModelStore.commit_artifact`)."""
        return store.commit_artifact(
            self.model, self.version, PROFILE_KIND, self.to_dict()
        )


def load_profile(store, model: str, version: int) -> Optional[ReferenceProfile]:
    """The verified profile artifact for ``<model>-<version>``, or None
    when absent/corrupt."""
    payload = store.read_artifact(model, version, PROFILE_KIND)
    if payload is None:
        return None
    try:
        return ReferenceProfile.from_dict(payload)
    except (ValueError, TypeError, KeyError) as e:
        logger.warning("quality profile %s-%s unreadable: %s", model, version, e)
        return None


class _Window:
    """Rolling bin-count window of one live feature: integer counts over
    the reference edges plus a ring of bin indices (-1 = missing) so an
    old observation's count leaves when it scrolls out."""

    __slots__ = ("counts", "missing", "ring", "limit")

    def __init__(self, num_bins: int, limit: int):
        self.counts = [0] * num_bins
        self.missing = 0
        self.ring: Deque[int] = collections.deque()
        self.limit = limit

    def push(self, idx: int) -> None:
        self.ring.append(idx)
        if idx < 0:
            self.missing += 1
        else:
            self.counts[idx] += 1
        if len(self.ring) > self.limit:
            old = self.ring.popleft()
            if old < 0:
                self.missing -= 1
            else:
                self.counts[old] -= 1

    def push_many(self, idx: np.ndarray) -> None:
        """:meth:`push` of every index in order: the window ends as the
        last ``limit`` of the old ring and ``idx``."""
        if len(idx) < self.limit:
            for i in idx.tolist():
                self.push(i)
            return
        tail = idx[-self.limit:]
        self.ring = collections.deque(tail.tolist())
        self.missing = int((tail < 0).sum())
        self.counts = np.bincount(tail[tail >= 0], minlength=len(self.counts)).tolist()

    @property
    def n(self) -> int:
        return len(self.ring) - self.missing


def _bin_index(edges: Tuple[float, ...], value: Any) -> int:
    """Clamped bin index over reference edges; -1 for missing."""
    if _is_missing(value):
        return -1
    v = float(value)
    return bisect.bisect_right(edges, v, 1, len(edges) - 1) - 1


def _bin_indices(edges: Tuple[float, ...], values: np.ndarray) -> np.ndarray:
    """:func:`_bin_index` of every value of a numeric column."""
    x = values.astype(np.float64, copy=False)
    idx = np.searchsorted(np.asarray(edges[1:-1]), x, side="right")
    return np.where(np.isnan(x), -1, idx)


def _window_psi(ref: ColumnSketch, counts: List[int], n: int) -> float:
    p = ref.probabilities(eps=PSI_EPS)
    total = n + PSI_EPS * len(counts)
    q = [(c + PSI_EPS) / total for c in counts]
    return float(sum((qi - pi) * math.log(qi / pi) for pi, qi in zip(p, q)))


def _window_ks(ref: ColumnSketch, counts: List[int], n: int) -> float:
    if n == 0:
        return 0.0
    ref_cdf = ref.cdf()
    worst = 0.0
    cum = 0
    for c, r in zip(counts, ref_cdf):
        cum += c
        worst = max(worst, abs(cum / n - r))
    return worst


class QualityMonitor:
    """Rolling-window drift scorer of live traffic vs a reference profile.

    Observations enter through :meth:`observe_columns` (the serving batch
    loop and ``PipelineModel.transform`` both feed it; the loop suppresses
    the inner transform's observation so a request is never sketched
    twice). Every ``eval_every`` observations the windows are scored:
    ``quality_psi``/``quality_ks`` gauges per feature and model version,
    a 0/1 ``quality_drift_active`` gauge, and paired
    :class:`DriftDetected`/:class:`DriftCleared` events with a
    flight-recorder trip on detection. All state transitions are computed
    under the monitor lock; events publish after it releases.
    """

    def __init__(
        self,
        profile: Optional[ReferenceProfile] = None,
        store=None,
        model: str = "model",
        registry=None,
        window: int = 512,
        eval_every: int = 64,
        min_window: int = 32,
        psi_threshold: float = 0.2,
        ks_threshold: float = 0.25,
    ):
        self.store = store
        self.model = profile.model if profile is not None else model
        self.window = int(window)
        self.eval_every = int(eval_every)
        self.min_window = int(min_window)
        self.psi_threshold = float(psi_threshold)
        self.ks_threshold = float(ks_threshold)
        self._lock = threading.Lock()
        self._profile: Optional[ReferenceProfile] = None
        self._bases: set = set()
        self._windows: Dict[str, _Window] = {}
        self._drifted: Dict[str, bool] = {}
        self._last_stats: Dict[str, Dict[str, float]] = {}
        self._since_eval = 0
        self._suppress_depth = 0
        self.version = 0
        if registry is None:
            from mmlspark_tpu_torch.observability.registry import get_registry

            registry = get_registry()
        self.registry = registry
        self._g_psi = registry.gauge(
            "quality_psi",
            "Rolling-window PSI of live traffic vs the reference profile",
        )
        self._g_ks = registry.gauge(
            "quality_ks",
            "Rolling-window KS statistic vs the reference profile",
        )
        self._g_missing = registry.gauge(
            "quality_missing_rate", "Rolling-window missing-value rate"
        )
        self._g_drift = registry.gauge(
            "quality_drift_active", "1 while a feature is in drift"
        )
        self._c_obs = registry.counter(
            "quality_observations_total", "Values sketched by the quality plane"
        )
        if profile is not None:
            self._set_profile(profile)
        elif store is not None:
            current = store.current_version(self.model)
            if current:
                self._maybe_reload(int(current))

    # -- profile lifecycle ---------------------------------------------------

    @property
    def profile(self) -> Optional[ReferenceProfile]:
        return self._profile

    def _set_profile(self, profile: ReferenceProfile) -> None:
        self._profile = profile
        self.version = profile.version
        #: base column names the profile covers — unprofiled columns skip
        #: the per-row fan-out entirely
        self._bases = {name.partition("[")[0] for name in profile.features}
        self._windows = {
            name: _Window(len(sketch.counts), self.window)
            for name, sketch in profile.features.items()
        }
        self._drifted = {name: False for name in profile.features}
        self._last_stats = {}
        self._since_eval = 0

    def _maybe_reload(self, version: int) -> None:
        """Swap to ``version``'s profile when the store has one; fall back
        to the profile already loaded (the newest committed one) when the
        new version committed without a quality artifact. Version 0 means
        "untracked" (a loop that never hot-swapped) and never reloads."""
        if self.store is None or version <= 0 or version == self.version:
            return
        profile = load_profile(self.store, self.model, version)
        if profile is not None:
            with self._lock:
                self._set_profile(profile)
        else:
            # fallback: keep scoring against the previous reference, but
            # remember the served version so gauges/events carry it
            self.version = version

    def note_version(self, version: int) -> None:
        """The serving loop's hot-swap hook: the served model version
        changed, so drift must score against that version's profile."""
        try:
            self._maybe_reload(int(version))
        except Exception as e:  # noqa: BLE001 - quality must not fail serving
            logger.debug("quality profile reload failed: %s", e)

    # -- serving suppression -------------------------------------------------

    def suppress_transform(self) -> "_Suppress":
        """Context manager the serving batch loop wraps around its inner
        ``model.transform`` call: the loop observes the batch itself
        (inputs AND outputs), so the transform-level hook must not count
        the same rows again."""
        return _Suppress(self)

    @property
    def transform_suppressed(self) -> bool:
        with self._lock:
            return self._suppress_depth > 0

    # -- ingest --------------------------------------------------------------

    def observe_columns(
        self,
        columns: Mapping[str, Iterable[Any]],
        version: Optional[int] = None,
    ) -> None:
        """Sketch one batch of column values (vector rows fan out per
        index); only features present in the reference profile count.
        Never raises — quality must not fail the observed workload."""
        try:
            if version is not None:
                self.note_version(version)
            profile = self._profile
            if profile is None:
                return
            evaluate = False
            observed = 0
            with self._lock:
                for col, values in columns.items():
                    if col not in self._bases:
                        continue
                    arrays = _feature_arrays(col, values)
                    if arrays is not None:
                        for feature, arr in arrays:
                            win = self._windows.get(feature)
                            if win is None:
                                continue
                            ref = profile.features[feature]
                            # only the last `limit` values stay in the window
                            win.push_many(_bin_indices(ref.edges, arr[-win.limit:]))
                            self._since_eval += len(arr)
                            observed += len(arr)
                        continue
                    for feature, v in _iter_feature_values(col, values):
                        win = self._windows.get(feature)
                        if win is None:
                            continue
                        ref = profile.features[feature]
                        win.push(_bin_index(ref.edges, v))
                        self._since_eval += 1
                        observed += 1
                if self._since_eval >= self.eval_every:
                    self._since_eval = 0
                    evaluate = True
            if observed:
                self._c_obs.inc(observed)
            if evaluate:
                self.evaluate()
        except Exception as e:  # noqa: BLE001 - quality must not fail serving
            logger.debug("quality observation failed: %s", e)

    # -- scoring -------------------------------------------------------------

    def evaluate(self) -> List[Dict[str, Any]]:
        """Score every feature window against the reference, update the
        ``quality_*`` gauges, and publish drift transitions. Returns the
        drift table (one row per feature)."""
        profile = self._profile
        if profile is None:
            return []
        transitions: List[Tuple[str, str, float, float, bool]] = []
        table: List[Dict[str, Any]] = []
        with self._lock:
            version = self.version
            for feature in sorted(profile.features):
                ref = profile.features[feature]
                win = self._windows[feature]
                n = win.n
                if n < self.min_window:
                    continue
                psi_v = _window_psi(ref, win.counts, n)
                ks_v = _window_ks(ref, win.counts, n)
                total = len(win.ring)
                missing_rate = win.missing / total if total else 0.0
                was = self._drifted[feature]
                if not was and (
                    psi_v > self.psi_threshold or ks_v > self.ks_threshold
                ):
                    self._drifted[feature] = True
                    if psi_v > self.psi_threshold:
                        transitions.append(
                            (feature, "psi", psi_v, self.psi_threshold, True)
                        )
                    else:
                        transitions.append(
                            (feature, "ks", ks_v, self.ks_threshold, True)
                        )
                elif was and (
                    psi_v <= CLEAR_FRACTION * self.psi_threshold
                    and ks_v <= CLEAR_FRACTION * self.ks_threshold
                ):
                    self._drifted[feature] = False
                    transitions.append(
                        (feature, "psi", psi_v, self.psi_threshold, False)
                    )
                stats = {
                    "psi": psi_v, "ks": ks_v, "n": float(n),
                    "missing_rate": missing_rate,
                    "drifted": self._drifted[feature],
                }
                self._last_stats[feature] = stats
                table.append(dict(stats, feature=feature, version=version))
        for feature, stats in list(self._last_stats.items()):
            labels = {
                "feature": feature,
                "model": self.model,
                "version": str(version),
            }
            self._g_psi.labels(**labels).set(stats["psi"])
            self._g_ks.labels(**labels).set(stats["ks"])
            self._g_missing.labels(feature=feature).set(stats["missing_rate"])
            self._g_drift.labels(feature=feature).set(
                1.0 if stats["drifted"] else 0.0
            )
        self._publish(transitions, version)
        return table

    def _publish(
        self,
        transitions: List[Tuple[str, str, float, float, bool]],
        version: int,
    ) -> None:
        if not transitions:
            return
        bus = get_bus()
        for feature, stat, value, threshold, detected in transitions:
            if bus.active:
                ctor = DriftDetected if detected else DriftCleared
                bus.publish(ctor(
                    feature=feature, stat=stat, value=value,
                    threshold=threshold, model=self.model, version=version,
                ))
            if detected:
                from mmlspark_tpu_torch.observability.incidents import maybe_record

                maybe_record(
                    "drift_detected",
                    detail=f"{feature} {stat}={value:.3f} > {threshold:g}",
                )

    # -- export --------------------------------------------------------------

    def drifted_features(self) -> List[str]:
        with self._lock:
            return sorted(f for f, d in self._drifted.items() if d)

    def snapshot(self) -> Dict[str, Any]:
        """The drift table the flight recorder bundles as ``quality.json``
        and the SLO report folds into its quality section."""
        with self._lock:
            drift = [
                dict(self._last_stats[feature], feature=feature)
                for feature in sorted(self._last_stats)
            ]
            return {
                "model": self.model,
                "version": self.version,
                "psi_threshold": self.psi_threshold,
                "ks_threshold": self.ks_threshold,
                "window": self.window,
                "drift": drift,
            }


class _Suppress:
    __slots__ = ("_monitor",)

    def __init__(self, monitor: QualityMonitor):
        self._monitor = monitor

    def __enter__(self) -> "_Suppress":
        with self._monitor._lock:
            self._monitor._suppress_depth += 1
        return self

    def __exit__(self, *exc) -> None:
        with self._monitor._lock:
            self._monitor._suppress_depth -= 1


# -- process-global monitor (env-driven, like the sink and profiler) ---------

_MONITOR: Optional[QualityMonitor] = None
_MONITOR_LOCK = threading.Lock()


def install_monitor(monitor: Optional[QualityMonitor]) -> None:
    """Install (or clear, with None) the process-global monitor."""
    global _MONITOR
    with _MONITOR_LOCK:
        _MONITOR = monitor


def get_monitor() -> Optional[QualityMonitor]:
    """The process-global monitor, installing one from
    ``MMLSPARK_TPU_QUALITY_STORE``/``MMLSPARK_TPU_QUALITY_MODEL`` on
    first call; None when quality monitoring is unconfigured (the common
    case — call sites pay one env lookup)."""
    global _MONITOR
    if _MONITOR is not None:
        return _MONITOR
    root = os.environ.get("MMLSPARK_TPU_QUALITY_STORE", "")
    if not root:
        return None
    with _MONITOR_LOCK:
        if _MONITOR is None:
            try:
                from mmlspark_tpu_torch.runtime.journal import ModelStore

                window = int(
                    os.environ.get("MMLSPARK_TPU_QUALITY_WINDOW", "512")
                )
                # a short same-distribution window reads high on PSI by
                # construction (E[PSI] ~ (bins-1)/n), so the env-installed
                # monitor refuses to score before the window is half full
                min_window = int(
                    os.environ.get(
                        "MMLSPARK_TPU_QUALITY_MIN_WINDOW",
                        str(max(32, window // 2)),
                    )
                )
                _MONITOR = QualityMonitor(
                    store=ModelStore(root),
                    model=os.environ.get("MMLSPARK_TPU_QUALITY_MODEL", "model"),
                    window=window,
                    eval_every=int(
                        os.environ.get("MMLSPARK_TPU_QUALITY_EVAL_EVERY", "64")
                    ),
                    min_window=min_window,
                )
            except Exception as e:  # noqa: BLE001 - never fail the workload
                logger.warning("quality monitor install failed: %s", e)
                return None
    return _MONITOR


# -- fit-time capture hook ---------------------------------------------------


def capture_pipeline_reference(model, table, version_hint: int = 0) -> None:
    """``Pipeline.fit``'s capture hook (env-gated by the caller): profile
    the numeric training columns plus the fitted model's score columns
    and commit the artifact next to the store's CURRENT version. Never
    raises — fit must succeed whether or not the profile lands."""
    try:
        root = os.environ.get("MMLSPARK_TPU_QUALITY_STORE", "")
        if not root:
            return
        from mmlspark_tpu_torch.runtime.journal import ModelStore

        name = os.environ.get("MMLSPARK_TPU_QUALITY_MODEL", "model")
        store = ModelStore(root)
        columns: Dict[str, Any] = {}
        for col in table.columns:
            values = table.column(col)
            kind = getattr(getattr(values, "dtype", None), "kind", "")
            if kind in "fiub":
                columns[col] = values if kind else list(values)
        out = model.transform(table)
        for col in out.columns:
            if col in table.columns:
                continue
            values = out.column(col)
            kind = getattr(getattr(values, "dtype", None), "kind", "")
            if kind in "fiub":
                columns[col] = values if kind else list(values)
        version = store.current_version(name) or int(version_hint) or 1
        profile = ReferenceProfile.capture(name, version, columns)
        profile.commit(store)
        monitor = get_monitor()
        if monitor is not None and monitor.model == name:
            monitor.note_version(version)
    except Exception as e:  # noqa: BLE001 - fit must not fail on profiling
        logger.warning("reference-profile capture failed: %s", e)


# -- federated drift table ---------------------------------------------------


def drift_table_from_summary(summary: Mapping[str, Any]) -> List[Dict[str, Any]]:
    """Rebuild the per-feature drift table from a registry ``summary()``
    dict (local or federated — a ``replica`` label is carried through).
    This is what the SLO report and incident bundles use when the live
    monitor object is in another process."""
    psi_series = summary.get("quality_psi")
    if not isinstance(psi_series, dict):
        return []

    def _parse(key: str) -> Dict[str, str]:
        out: Dict[str, str] = {}
        for part in key.split(","):
            if "=" in part:
                k, _, v = part.partition("=")
                out[k] = v
        return out

    ks_by_key = (
        summary.get("quality_ks") if isinstance(summary.get("quality_ks"), dict)
        else {}
    )
    drift_series = (
        summary.get("quality_drift_active")
        if isinstance(summary.get("quality_drift_active"), dict)
        else {}
    )
    drift_by_feature: Dict[Tuple[str, str], float] = {}
    for key, value in drift_series.items():
        lbl = _parse(key)
        drift_by_feature[(lbl.get("feature", ""), lbl.get("replica", ""))] = value
    rows: List[Dict[str, Any]] = []
    for key in sorted(psi_series):
        lbl = _parse(key)
        feature = lbl.get("feature", "")
        replica = lbl.get("replica", "")
        row: Dict[str, Any] = {
            "feature": feature,
            "model": lbl.get("model", ""),
            "version": lbl.get("version", ""),
            "psi": float(psi_series[key]),
            "ks": float(ks_by_key.get(key, 0.0)),
            "drifted": bool(drift_by_feature.get((feature, replica), 0.0)),
        }
        if replica:
            row["replica"] = replica
        rows.append(row)
    return rows
