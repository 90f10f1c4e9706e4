"""Fit-time data validation — NaN/Inf and label-domain guards; the port's
copy of ``mmlspark_tpu/dataguard/guards.py``.

A single NaN label silently poisons a whole GBDT fit (every gradient it
touches goes NaN); an Inf feature does the same to quantile binning.
Before dataguard these reached the training loop unchecked. The guard
runs at ``Pipeline.fit`` (and is callable directly on any Table or array
set) under one of three policies, mirroring the read modes one level up:

- ``fail``   — raise :class:`~mmlspark_tpu_torch.dataguard.modes.BadRecordsError`
  naming the offending columns/counts (the default posture for training
  jobs where bad data means a broken producer);
- ``drop``   — rows with any non-finite feature or out-of-domain label
  are removed, in order, so the surviving fit equals a fit over the
  clean complement;
- ``impute`` — non-finite *feature* values are replaced by the column
  mean over its finite entries (0.0 for an all-bad column); rows with a
  bad *label* are still dropped — a label cannot be conjured.

Label-domain: labels must be finite always; ``label_domain="classifier"``
additionally requires non-negative integers (the LightGBM classifier
contract — a 0.5 label would silently train a broken multiclass model).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np

from mmlspark_tpu_torch.core.profiling import get_logger
from mmlspark_tpu_torch.dataguard.modes import BadRecordsError, CorruptRecord

logger = get_logger("mmlspark_tpu_torch.dataguard")

POLICIES = ("fail", "drop", "impute")


def normalize_policy(policy: str) -> str:
    low = str(policy).strip().lower()
    if low not in POLICIES:
        raise ValueError(
            f"unknown invalid-data policy {policy!r} "
            f"(expected one of {', '.join(POLICIES)})"
        )
    return low


@dataclasses.dataclass
class GuardReport:
    """What the guard did: rows seen/dropped, values imputed, and the
    per-column non-finite counts that drove it."""

    rows_in: int = 0
    rows_dropped: int = 0
    values_imputed: int = 0
    bad_label_rows: int = 0
    bad_columns: Dict[str, int] = dataclasses.field(default_factory=dict)

    @property
    def clean(self) -> bool:
        return not self.bad_columns

    def summary(self) -> str:
        cols = ",".join(f"{k}={v}" for k, v in sorted(self.bad_columns.items()))
        return (
            f"rows={self.rows_in} dropped={self.rows_dropped} "
            f"imputed={self.values_imputed} bad_labels={self.bad_label_rows}"
            + (f" [{cols}]" if cols else "")
        )


def _book_metrics(report: GuardReport) -> None:
    from mmlspark_tpu_torch.observability.registry import get_registry

    reg = get_registry()
    if report.rows_dropped:
        reg.counter(
            "dataguard_fit_rows_dropped_total",
            "Rows dropped by the fit guard (non-finite or out-of-domain)",
        ).inc(report.rows_dropped)
    if report.values_imputed:
        reg.counter(
            "dataguard_fit_values_imputed_total",
            "Non-finite feature values imputed by the fit guard",
        ).inc(report.values_imputed)


def _bad_label_mask(y: np.ndarray, label_domain: Optional[str]) -> np.ndarray:
    bad = ~np.isfinite(y)
    if label_domain == "classifier":
        finite = ~bad
        vals = y[finite]
        domain_bad = np.zeros_like(bad)
        domain_bad[finite] = (vals < 0) | (vals != np.floor(vals))
        bad = bad | domain_bad
    return bad


def guard_arrays(
    X: np.ndarray,
    y: Optional[np.ndarray] = None,
    w: Optional[np.ndarray] = None,
    policy: str = "fail",
    label_domain: Optional[str] = None,
    name: str = "fit",
) -> Tuple[np.ndarray, Optional[np.ndarray], Optional[np.ndarray], GuardReport]:
    """Apply the fit guard to a feature matrix / label / weight triple.
    Returns the (possibly filtered/imputed) arrays plus a report; under
    ``policy="fail"`` any invalid value raises :class:`BadRecordsError`."""
    policy = normalize_policy(policy)
    X = np.asarray(X)
    report = GuardReport(rows_in=len(X))
    bad_feat = ~np.isfinite(X) if np.issubdtype(X.dtype, np.floating) else \
        np.zeros(X.shape, dtype=bool)
    feat_rows = bad_feat.any(axis=tuple(range(1, X.ndim))) if X.ndim > 1 \
        else bad_feat
    for j in range(X.shape[1] if X.ndim > 1 else 0):
        n_bad = int(bad_feat[:, j].sum())
        if n_bad:
            report.bad_columns[f"f{j}"] = n_bad
    bad_label = np.zeros(len(X), dtype=bool)
    if y is not None:
        y = np.asarray(y, dtype=np.float64)
        bad_label = _bad_label_mask(y, label_domain)
        report.bad_label_rows = int(bad_label.sum())
        if report.bad_label_rows:
            report.bad_columns["label"] = report.bad_label_rows
    if w is not None:
        w = np.asarray(w, dtype=np.float64)
        bad_w = ~np.isfinite(w)
        if bad_w.any():
            report.bad_columns["weight"] = int(bad_w.sum())
            bad_label = bad_label | bad_w  # a bad weight drops the row too
    if report.clean:
        return X, y, w, report
    if policy == "fail":
        raise BadRecordsError(
            f"invalid values in fit input ({report.summary()}); set the "
            "invalid-data policy to 'drop' or 'impute' to tolerate them",
            records=[
                CorruptRecord(source=name, index=-1, reason="invalid-value",
                              detail=f"{col}: {n} non-finite/out-of-domain")
                for col, n in sorted(report.bad_columns.items())
            ],
        )
    if policy == "impute":
        X = np.array(X, dtype=np.float64, copy=True)
        for j in range(X.shape[1] if X.ndim > 1 else 0):
            col_bad = bad_feat[:, j]
            if not col_bad.any():
                continue
            finite = X[~col_bad, j]
            fill = float(finite.mean()) if len(finite) else 0.0
            X[col_bad, j] = fill
            report.values_imputed += int(col_bad.sum())
        keep = ~bad_label
    else:  # drop
        keep = ~(feat_rows | bad_label)
    report.rows_dropped = int((~keep).sum())
    if report.rows_dropped:
        X = X[keep]
        y = y[keep] if y is not None else None
        w = w[keep] if w is not None else None
    _book_metrics(report)
    logger.warning("fit guard (%s, policy=%s): %s", name, policy,
                   report.summary())
    return X, y, w, report


def guard_table(
    table,
    policy: str = "fail",
    label_col: Optional[str] = None,
    label_domain: Optional[str] = None,
    name: str = "fit",
):
    """Apply the fit guard to a Table: float columns are scanned for
    non-finite values (and ``label_col`` for domain violations); returns
    (guarded table, report). Non-float columns pass through untouched."""
    policy = normalize_policy(policy)
    report = GuardReport(rows_in=table.num_rows)
    n = table.num_rows
    bad_rows = np.zeros(n, dtype=bool)
    imputed: Dict[str, np.ndarray] = {}
    for col in table.columns:
        arr = table.column(col)
        if not isinstance(arr, np.ndarray) or \
                not np.issubdtype(arr.dtype, np.floating):
            continue
        if col == label_col:
            bad = _bad_label_mask(
                arr if arr.ndim == 1 else arr.reshape(n, -1)[:, 0],
                label_domain,
            )
            if bad.any():
                report.bad_columns[col] = int(bad.sum())
                report.bad_label_rows = int(bad.sum())
                bad_rows |= bad  # labels are never imputable
            continue
        bad = ~np.isfinite(arr)
        if not bad.any():
            continue
        report.bad_columns[col] = int(bad.sum())
        if policy == "impute":
            fixed = np.array(arr, dtype=np.float64, copy=True)
            finite = fixed[~bad] if arr.ndim == 1 else fixed[~bad]
            fill = float(finite.mean()) if finite.size else 0.0
            fixed[bad] = fill
            imputed[col] = fixed
            report.values_imputed += int(bad.sum())
        else:
            bad_rows |= bad.any(axis=tuple(range(1, arr.ndim))) \
                if arr.ndim > 1 else bad
    if report.clean:
        return table, report
    if policy == "fail":
        raise BadRecordsError(
            f"invalid values in fit input ({report.summary()}); set "
            "invalidDataPolicy='drop' or 'impute' to tolerate them",
            records=[
                CorruptRecord(source=name, index=-1, reason="invalid-value",
                              detail=f"{col}: {cnt} bad value(s)")
                for col, cnt in sorted(report.bad_columns.items())
            ],
        )
    out = table.with_columns(imputed) if imputed else table
    if bad_rows.any():
        report.rows_dropped = int(bad_rows.sum())
        out = out.filter(~bad_rows)
    _book_metrics(report)
    logger.warning("fit guard (%s, policy=%s): %s", name, policy,
                   report.summary())
    return out, report
