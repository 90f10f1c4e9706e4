"""TuneHyperparameters / FindBestModel: the port's copy of
``mmlspark_tpu/automl/tune.py`` (reference
``automl/TuneHyperparameters.scala:37`` and ``automl/FindBestModel.scala:55``).

Randomized search with k-fold cross validation. ``sweepMode`` "batched"
(and "auto") fits each fold's candidates bucket by bucket through the
many-models plane (``mmlspark_tpu_torch.sweep``: one binning and one
upload of the bins for a bucket's K candidates); "threadpool" fits them
one at a time on a bounded thread pool (``getExecutionContext``/
future-per-paramMap, ``TuneHyperparameters.scala:95-187``). PyTorch
releases the GIL inside its ops, so pool threads overlap host binning with
the card's work. The launch counters of the kernel wrappers take a lock
(``ops/hopper_histogram.count_launch``); the profiler, the event bus and
the registry lock their own state, and each fit keeps its own
``FitStats``.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from mmlspark_tpu_torch.core.params import HasLabelCol, Param, gt, to_int, to_str
from mmlspark_tpu_torch.core.pipeline import Estimator, Model, Transformer
from mmlspark_tpu_torch.data.table import Table
from mmlspark_tpu_torch.train.statistics import ComputeModelStatistics

# metric name -> (output column of ComputeModelStatistics, higher is better, kind)
_METRICS: Dict[str, Tuple[str, bool, str]] = {
    "accuracy": ("accuracy", True, "classification"),
    "precision": ("precision", True, "classification"),
    "recall": ("recall", True, "classification"),
    "AUC": ("AUC", True, "classification"),
    "mse": ("mean_squared_error", False, "regression"),
    "rmse": ("root_mean_squared_error", False, "regression"),
    "mae": ("mean_absolute_error", False, "regression"),
    "r2": ("R^2", True, "regression"),
}


def _evaluate(scored: Table, label_col: str, metric: str) -> float:
    # The metric name fixes the task kind: 'auto' detection misclassifies
    # integer-valued regression targets (counts, ratings) as classification.
    col, _, kind = _METRICS[metric]
    stats = ComputeModelStatistics(
        labelCol=label_col, evaluationMetric=kind
    ).transform(scored)
    if col not in stats:
        raise ValueError(
            f"metric {metric!r} not produced — got columns {stats.columns}"
        )
    return float(stats.column(col)[0])


def _is_larger_better(metric: str) -> bool:
    return _METRICS[metric][1]


class TuneHyperparameters(HasLabelCol, Estimator):
    """Randomized hyperparameter search over one or more estimators with
    k-fold CV; best (estimator, param map) refitted on the full data."""

    models = Param("Estimators to sweep", is_complex=True)
    paramSpace = Param("Per-estimator dict of param Dists, or one shared dict",
                       is_complex=True, default=None)
    evaluationMetric = Param("Metric name", default="accuracy", converter=to_str,
                             validator=lambda v: v in _METRICS)
    numFolds = Param("CV folds", default=3, converter=to_int, validator=gt(1))
    numRuns = Param("Sampled param maps per estimator", default=10,
                    converter=to_int, validator=gt(0))
    parallelism = Param("Concurrent candidate fits", default=1, converter=to_int,
                        validator=gt(0))
    seed = Param("RNG seed (sampling + fold split)", default=0, converter=to_int)
    sweepMode = Param(
        "Candidate execution plane: 'auto' routes batchable candidates "
        "through the many-models sweep (shape-bucketed fits, "
        "mmlspark_tpu_torch.sweep) and falls back to the thread pool on any "
        "error; 'batched' requires the sweep plane; 'threadpool' forces "
        "the sequential candidate-at-a-time baseline",
        default="auto", converter=to_str,
        validator=lambda v: v in ("auto", "batched", "threadpool"),
    )

    def _folds(self, n: int) -> List[np.ndarray]:
        rng = np.random.default_rng(self.getSeed())
        perm = rng.permutation(n)
        return np.array_split(perm, self.getNumFolds())

    def _cv_metric(self, est: Estimator, params: Dict[str, Any],
                   table: Table, folds: List[np.ndarray]) -> float:
        label_col = self.getLabelCol()
        metric = self.getEvaluationMetric()
        n = table.num_rows
        scores = []
        for fold in folds:
            mask = np.zeros(n, dtype=bool)
            mask[fold] = True
            train, valid = table.filter(~mask), table.filter(mask)
            model = est.copy(params).fit(train)
            scores.append(_evaluate(model.transform(valid), label_col, metric))
        return float(np.mean(scores))

    def _fit(self, table: Table) -> "TuneHyperparametersModel":
        estimators = self.getModels()
        if isinstance(estimators, Estimator):
            estimators = [estimators]
        if not estimators:
            raise ValueError("no estimators to tune")
        space = self.getParamSpace() or {}
        rng = np.random.default_rng(self.getSeed())
        folds = self._folds(table.num_rows)

        candidates: List[Tuple[Estimator, Dict[str, Any]]] = []
        for est in estimators:
            dists = space.get(est.uid, space) if space else {}
            # tolerate {param: Dist} directly or per-estimator nesting
            if dists and all(hasattr(d, "get_next") for d in dists.values()):
                for _ in range(self.getNumRuns()):
                    candidates.append(
                        (est, {k: d.get_next(rng) for k, d in dists.items()})
                    )
            else:
                candidates.append((est, {}))

        def run(cand: Tuple[Estimator, Dict[str, Any]]) -> float:
            est, params = cand
            return self._cv_metric(est, params, table, folds)

        metrics: Optional[List[float]] = None
        mode = self.getSweepMode()
        if mode in ("auto", "batched"):
            # many-models plane: per fold, the candidates of a shape-
            # bucket fit K at once from one binning and one upload instead
            # of candidate-at-a-time (singleton buckets degrade to the same
            # per-candidate fit the thread pool would run)
            try:
                from mmlspark_tpu_torch.sweep.batched import cv_metrics_batched

                metrics = cv_metrics_batched(
                    candidates, table, folds, self.getLabelCol(),
                    self.getEvaluationMetric(),
                )
            except Exception:
                if mode == "batched":
                    raise
                metrics = None  # auto: the thread-pool baseline still works
        if metrics is None:
            if self.getParallelism() > 1:
                with ThreadPoolExecutor(max_workers=self.getParallelism()) as pool:
                    metrics = list(pool.map(run, candidates))
            else:
                metrics = [run(c) for c in candidates]

        higher = _is_larger_better(self.getEvaluationMetric())
        # NaN metrics (single-class CV fold, constant labels) rank as worst,
        # never best; an all-NaN sweep is an error, not a silent winner.
        metrics_arr = np.asarray(metrics, dtype=np.float64)
        if np.isnan(metrics_arr).all():
            raise ValueError(
                "all candidate metrics are NaN — check folds/label distribution"
            )
        ranked = np.where(np.isnan(metrics_arr), -np.inf if higher else np.inf, metrics_arr)
        best_i = int(np.argmax(ranked) if higher else np.argmin(ranked))
        best_est, best_params = candidates[best_i]
        best_model = best_est.copy(best_params).fit(table)
        model = TuneHyperparametersModel(
            bestModel=best_model,
            bestMetric=float(metrics[best_i]),
            allMetrics=[float(m) for m in metrics],
            bestParams=best_params,
        )
        model.parent = self
        return model


class TuneHyperparametersModel(Model):
    bestModel = Param("Winning fitted model", is_complex=True, default=None)
    bestMetric = Param("Winning CV metric", default=float("nan"))
    allMetrics = Param("CV metric per candidate", default=None)
    bestParams = Param("Winning param map", default=None)

    def transform(self, table: Table) -> Table:
        return self.getBestModel().transform(table)


class FindBestModel(HasLabelCol, Estimator):
    """Evaluates already-fitted models on a dataset, keeps the best
    (``FindBestModel.scala:55-130``)."""

    models = Param("Fitted models (Transformers) to evaluate", is_complex=True)
    evaluationMetric = Param("Metric name", default="accuracy", converter=to_str,
                             validator=lambda v: v in _METRICS)

    def _fit(self, table: Table) -> "BestModel":
        models = self.getModels()
        if not models:
            raise ValueError("no trained models to evaluate")
        metric = self.getEvaluationMetric()
        label_col = self.getLabelCol()
        higher = _is_larger_better(metric)
        rows = []
        best_val, best_model, best_scored = None, None, None
        for m in models:
            scored = m.transform(table)
            val = _evaluate(scored, label_col, metric)
            rows.append((m.uid, val))
            if best_val is None or ((val > best_val) == higher and val != best_val):
                best_val, best_model, best_scored = val, m, scored
        model = BestModel(
            bestModel=best_model,
            bestModelMetrics=best_val,
            allModelMetrics=rows,
        )
        model.parent = self
        return model


class BestModel(Model):
    bestModel = Param("Winning transformer", is_complex=True, default=None)
    bestModelMetrics = Param("Winning metric value", default=float("nan"))
    allModelMetrics = Param("(uid, metric) per candidate", default=None)

    def transform(self, table: Table) -> Table:
        return self.getBestModel().transform(table)

    def get_evaluated_models(self) -> Table:
        rows = self.getAllModelMetrics() or []
        return Table({
            "model": np.array([r[0] for r in rows], dtype=object),
            "metric": np.array([r[1] for r in rows], dtype=np.float64),
        })
