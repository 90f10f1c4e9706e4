"""Plot helpers: confusion matrix and ROC curve.

Parity target: the reference's hand-written Python plotting surface
(MMLSpark's ``src/main/python/mmlspark/plot/plot.py:17-59``), which
renders a row-normalized confusion-matrix heatmap with per-cell counts and
an accuracy banner, and a basic ROC curve.  This module re-derives both
from first principles on numpy (no sklearn dependency for the math — the
confusion matrix and the ROC sweep are computed here, matching the pinned
implementations in ``train/statistics.py``), and accepts either a
:class:`~mmlspark_tpu_torch.data.table.Table` or anything pandas-shaped.

Matplotlib is imported lazily so headless installs that never plot pay
nothing; callers in tests force the ``Agg`` backend.

The port's copy of ``mmlspark_tpu/plot.py`` (host numpy).
"""

from __future__ import annotations

import itertools
from typing import Any, Optional, Sequence

import numpy as np

__all__ = ["confusion_matrix", "confusionMatrix", "roc", "roc_points"]


def _columns(df: Any, y_col: str, y_hat_col: str):
    """Extract the two columns — Table, pandas frame, and plain mappings all
    support ``[]`` access."""
    return np.asarray(df[y_col]), np.asarray(df[y_hat_col])


def _confusion_counts(y: np.ndarray, y_hat: np.ndarray, labels: Sequence[Any]):
    """Count matrix with rows = true label, cols = predicted label. Rows
    whose true OR predicted value is outside ``labels`` are dropped, the
    sklearn ``confusion_matrix(..., labels=...)`` behavior. Vectorized via
    sorted-label searchsorted (the np.add.at pattern of
    ``train/statistics.py``), so million-row tables stay out of the
    interpreter loop."""
    labels_arr = np.asarray(labels)
    k = len(labels_arr)
    order = np.argsort(labels_arr, kind="stable")
    slabels = labels_arr[order]

    def to_index(vals):
        pos = np.searchsorted(slabels, vals)
        pos = np.clip(pos, 0, k - 1)
        ok = slabels[pos] == vals
        return order[pos], ok

    yi, ok_y = to_index(y)
    pi, ok_p = to_index(y_hat)
    keep = ok_y & ok_p
    cm = np.zeros((k, k), dtype=np.int64)
    np.add.at(cm, (yi[keep], pi[keep]), 1)
    return cm


def roc_points(y: np.ndarray, scores: np.ndarray):
    """ROC sweep: (fpr, tpr, thresholds), scores descending.

    Same convention as the reference's sklearn ``roc_curve`` call: one
    point per distinct score, prepended with (0, 0) at threshold +inf.
    """
    y = np.asarray(y, dtype=np.float64)
    scores = np.asarray(scores, dtype=np.float64)
    if y.size == 0:
        return np.zeros(1), np.zeros(1), np.array([np.inf])
    order = np.argsort(-scores, kind="stable")
    y, scores = y[order], scores[order]
    # Cut after the last occurrence of each distinct score value.
    distinct = np.where(np.diff(scores))[0]
    cuts = np.r_[distinct, y.size - 1]
    tps = np.cumsum(y)[cuts]
    fps = (cuts + 1) - tps
    pos = max(tps[-1], 1.0)
    neg = max(fps[-1], 1.0)
    tpr = np.r_[0.0, tps / pos]
    fpr = np.r_[0.0, fps / neg]
    thresholds = np.r_[np.inf, scores[cuts]]
    return fpr, tpr, thresholds


def confusion_matrix(
    df: Any,
    y_col: str,
    y_hat_col: str,
    labels: Optional[Sequence[Any]] = None,
    ax: Any = None,
):
    """Render the reference-style confusion-matrix heatmap.

    Row-normalized blue heatmap, raw counts in each cell, accuracy banner
    above the axes (``plot.py:25-43`` in the reference).  Returns the
    matplotlib Axes so callers can save or compose the figure.
    """
    import matplotlib.pyplot as plt

    y, y_hat = _columns(df, y_col, y_hat_col)
    if labels is None:
        labels = sorted(set(y.tolist()) | set(y_hat.tolist()))
    accuracy = float(np.mean(y == y_hat))
    cm = _confusion_counts(y, y_hat, labels)
    row_sums = np.maximum(cm.sum(axis=1, keepdims=True), 1)
    cmn = cm.astype(np.float64) / row_sums

    if ax is None:
        ax = plt.gca()
    ax.text(-0.3, -0.55, f"Accuracy = {round(accuracy * 100, 1)}%", fontsize=18)
    ticks = np.arange(len(labels))
    ax.set_xticks(ticks, labels=[str(l) for l in labels], rotation=0)
    ax.set_yticks(ticks, labels=[str(l) for l in labels], rotation=90)
    image = ax.imshow(cmn, interpolation="nearest", cmap=plt.cm.Blues, vmin=0, vmax=1)
    for i, j in itertools.product(range(cm.shape[0]), range(cm.shape[1])):
        ax.text(
            j,
            i,
            int(cm[i, j]),
            horizontalalignment="center",
            fontsize=18,
            color="white" if cmn[i, j] > 0.1 else "black",
        )
    ax.figure.colorbar(image, ax=ax)
    ax.set_xlabel("Predicted Label", fontsize=18)
    ax.set_ylabel("True Label", fontsize=18)
    return ax


# Reference-parity alias (plot.py:17 names it camelCase).
confusionMatrix = confusion_matrix


def roc(df: Any, y_col: str, y_hat_col: str, thresh: float = 0.5, ax: Any = None):
    """Render the ROC curve (reference ``plot.py:45-59``).

    ``y_col`` is binarized at ``thresh`` exactly as the reference does
    (labels above the threshold count as positive), then swept against the
    raw scores in ``y_hat_col``.  Returns the Axes.
    """
    import matplotlib.pyplot as plt

    y, y_hat = _columns(df, y_col, y_hat_col)
    y_bin = (np.asarray(y, dtype=np.float64) > thresh).astype(np.int64)
    fpr, tpr, _ = roc_points(y_bin, y_hat)
    if ax is None:
        ax = plt.gca()
    ax.plot(fpr, tpr)
    ax.set_xlabel("False Positive Rate", fontsize=20)
    ax.set_ylabel("True Positive Rate", fontsize=20)
    return ax
