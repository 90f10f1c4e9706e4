"""Model evaluation metrics as transformers: the port's copy of
``mmlspark_tpu/train/statistics.py`` (reference
``train/ComputeModelStatistics.scala:56``,
``ComputePerInstanceStatistics.scala:42``), numpy on the host, so the
same scored table gives the same numbers in both packages.

Classification: accuracy, per-class/micro precision & recall, AUC (rank
statistic), confusion matrix. Regression: mse, rmse, r², mae. All computed
as whole-column numpy reductions — one pass, no per-row UDFs.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from mmlspark_tpu_torch.core.params import HasLabelCol, Param, one_of, to_str
from mmlspark_tpu_torch.core.pipeline import Transformer
from mmlspark_tpu_torch.data.table import Table


def binary_auc(labels: np.ndarray, scores: np.ndarray) -> float:
    """AUC via the Mann-Whitney rank statistic, fully vectorized
    (tied scores get their group's average rank). Every row gets its tie
    group's rank whatever the order inside the group, so the reference's
    stable sort is not needed: the default sort gives the same bits in a
    third of the time."""
    labels = np.asarray(labels, dtype=np.float64)
    scores = np.asarray(scores, dtype=np.float64)
    n_pos = float((labels == 1).sum())
    n_neg = float((labels == 0).sum())
    if n_pos == 0 or n_neg == 0:
        return float("nan")
    order = np.argsort(scores)
    sorted_scores = scores[order]
    boundary = np.concatenate([[True], sorted_scores[1:] != sorted_scores[:-1]])
    group = np.cumsum(boundary) - 1
    counts = np.bincount(group)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    avg_rank = starts + (counts + 1) / 2.0  # 1-based average rank per group
    ranks = np.empty(len(scores), dtype=np.float64)
    ranks[order] = avg_rank[group]
    rank_sum = ranks[labels == 1].sum()
    return float((rank_sum - n_pos * (n_pos + 1) / 2) / (n_pos * n_neg))


def prob_class_index(values: np.ndarray) -> Optional[np.ndarray]:
    """Class-column indices into a probability matrix: the raw numeric values
    when they are non-negative integers (the learners' native class coding —
    column j of ``probability`` is P(class j)). Returns None for string or
    non-integral labels, where no alignment is derivable. This is distinct
    from :func:`remap_classes`, whose dense ids are ordered by *observed*
    distinct value and misalign with model class columns whenever the eval
    table sees only a subset of classes."""
    if values.dtype == object:
        return None
    v = values.astype(np.float64)
    if np.isnan(v).any() or not np.allclose(v, np.rint(v)) or v.min(initial=0) < 0:
        return None
    return np.rint(v).astype(np.int64)


def remap_classes(labels: np.ndarray, pred: np.ndarray):
    """Map label/prediction columns (numeric or string) onto dense class ids
    [0, k) ordered by sorted distinct value — the convention both metric
    stages share, so 1-D probability columns always mean P(highest class).
    The reference looks each row up in a dict; a binary search of the
    sorted classes gives the same ids in one vectorized pass (a sweep
    scores millions of rows per candidate)."""
    if labels.dtype == object or pred.dtype == object:
        both = np.array([str(v) for v in labels] + [str(v) for v in pred])
    else:
        both = np.concatenate([labels.astype(np.float64), pred.astype(np.float64)])
    classes = np.unique(both)
    ids = np.searchsorted(classes, both).astype(np.int64)
    return ids[: len(labels)], ids[len(labels):], classes


class ComputeModelStatistics(HasLabelCol, Transformer):
    """Scored table -> one-row metrics table."""

    scoresCol = Param("Prediction column", default="prediction", converter=to_str)
    scoredProbabilitiesCol = Param(
        "Probability column (binary AUC)", default="probability", converter=to_str
    )
    evaluationMetric = Param(
        "classification | regression | auto",
        default="auto",
        converter=to_str,
        validator=one_of("classification", "regression", "auto"),
    )

    def _kind(self, table: Table) -> str:
        metric = self.getEvaluationMetric()
        if metric != "auto":
            return metric
        labels = table.column(self.getLabelCol())
        if labels.dtype == object:
            return "classification"
        labels = labels.astype(np.float64)
        uniq = np.unique(labels[~np.isnan(labels)])
        if len(uniq) <= max(20, int(np.sqrt(len(labels)))) and np.allclose(
            uniq, np.rint(uniq)
        ):
            return "classification"
        return "regression"

    def transform(self, table: Table) -> Table:
        labels = table.column(self.getLabelCol())
        pred = table.column(self.getScoresCol())
        if self._kind(table) == "classification":
            li, pi, classes = remap_classes(labels, pred)
            k = len(classes)
            confusion = np.bincount(li * k + pi, minlength=k * k).reshape(k, k).astype(np.int64)
            accuracy = float((li == pi).mean())
            tp = np.diag(confusion).astype(np.float64)
            col_sums = confusion.sum(axis=0).astype(np.float64)
            row_sums = confusion.sum(axis=1).astype(np.float64)
            with np.errstate(invalid="ignore", divide="ignore"):
                precision = np.where(col_sums > 0, tp / col_sums, 0.0)
                recall = np.where(row_sums > 0, tp / row_sums, 0.0)
            weights = row_sums / row_sums.sum()
            metrics: Dict[str, float] = {
                "accuracy": accuracy,
                "precision": float((precision * weights).sum()),
                "recall": float((recall * weights).sum()),
            }
            if self.getScoredProbabilitiesCol() in table:
                probs = table.column(self.getScoredProbabilitiesCol())
                if probs.ndim == 1 and k == 2:
                    # 1-D probability = P(higher observed class): dense ids.
                    metrics["AUC"] = binary_auc(li, probs.astype(np.float64))
                elif probs.ndim == 2 and probs.shape[1] == 2:
                    # Columns are model class ids — use that coding when the
                    # labels fit it. A 2-column matrix cannot be a slice of a
                    # multiclass model, so otherwise (string labels, or
                    # reindexed codings like {1,2}) the sorted dense remap is
                    # the trainers' level indexing and is correct when two
                    # classes are observed.
                    li_raw = prob_class_index(labels)
                    if li_raw is not None and li_raw.max(initial=0) <= 1:
                        metrics["AUC"] = binary_auc(li_raw, probs[:, 1])
                    elif k == 2:
                        metrics["AUC"] = binary_auc(li, probs[:, 1])
            out = Table({name: np.array([value]) for name, value in metrics.items()})
            return out.with_column(
                "confusion_matrix", confusion.reshape(1, k * k).astype(np.float64)
            )
        labels = labels.astype(np.float64)
        pred = pred.astype(np.float64)
        err = pred - labels
        mse = float((err**2).mean())
        denom = float(((labels - labels.mean()) ** 2).sum())
        metrics = {
            "mean_squared_error": mse,
            "root_mean_squared_error": float(np.sqrt(mse)),
            "mean_absolute_error": float(np.abs(err).mean()),
            "R^2": float(1.0 - (err**2).sum() / denom) if denom > 0 else float("nan"),
        }
        return Table({name: np.array([value]) for name, value in metrics.items()})


class ComputePerInstanceStatistics(HasLabelCol, Transformer):
    """Appends per-row metrics (``ComputePerInstanceStatistics.scala:42``):
    regression -> L1/L2 loss; classification -> log-loss + correctness."""

    scoresCol = Param("Prediction column", default="prediction", converter=to_str)
    scoredProbabilitiesCol = Param(
        "Probability column", default="probability", converter=to_str
    )
    evaluationMetric = Param(
        "classification | regression | auto",
        default="auto",
        converter=to_str,
        validator=one_of("classification", "regression", "auto"),
    )

    _kind = ComputeModelStatistics._kind

    def transform(self, table: Table) -> Table:
        labels = table.column(self.getLabelCol())
        pred = table.column(self.getScoresCol())
        if self._kind(table) == "regression":
            err = pred.astype(np.float64) - labels.astype(np.float64)
            return table.with_columns(
                {"L1_loss": np.abs(err), "L2_loss": err**2}
            )
        # Same dense-id remap as ComputeModelStatistics: a 1-D probability
        # column means P(highest class) regardless of raw label coding.
        li, pi, _ = remap_classes(labels, pred)
        out = table.with_column("correct", (li == pi).astype(np.float64))
        if self.getScoredProbabilitiesCol() in table:
            probs = table.column(self.getScoredProbabilitiesCol())
            if probs.ndim == 2:
                # Index probability columns by the model's class coding (raw
                # integer labels) when the labels fit the column count; for
                # reindexed codings (e.g. {1,2} on a 2-column model) fall
                # back to the sorted dense remap the trainers index by.
                li_raw = prob_class_index(labels)
                if li_raw is not None and li_raw.max(initial=0) < probs.shape[1]:
                    li_prob = li_raw
                else:
                    li_prob = li
                idx = np.clip(li_prob, 0, probs.shape[1] - 1)
                p_true = probs[np.arange(len(li_prob)), idx]
            else:
                # 1-D probability = P(higher observed class): dense ids.
                p = probs.astype(np.float64)
                p_true = np.where(li == 1, p, 1.0 - p)
            out = out.with_column(
                "log_loss", -np.log(np.clip(p_true, 1e-15, 1.0))
            )
        return out
