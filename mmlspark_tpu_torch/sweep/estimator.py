"""TrainValidSweep: the many-models plane's estimator surface.

The port's copy of ``mmlspark_tpu/sweep/estimator.py``. A
train/validation-split hyperparameter sweep: candidates come from the
:mod:`mmlspark_tpu_torch.automl.hyperparam` spaces (``GridSpace`` /
``RandomSpace`` / raw ``Dist`` dicts), partition into shape-buckets
(:mod:`mmlspark_tpu_torch.sweep.bucketing`), and each bucket fits K at
once (:mod:`mmlspark_tpu_torch.sweep.batched`: one binning, one upload,
``histogram.cu`` on the estimator's device). The best candidate by
validation metric is refit on the FULL table, so the committed model is
byte-identical to a standalone fit with the winning params, and committed
through :class:`~mmlspark_tpu_torch.runtime.journal.ModelStore`
(versioned, CRC) when a checkpoint root is set.

With ``numProcesses`` > 1 the buckets shard across a supervised
:class:`~mmlspark_tpu_torch.runtime.procgroup.ProcessGroup` gang
(:mod:`mmlspark_tpu_torch.sweep.distributed`): task-per-bucket,
per-bucket journal resume, and a SIGKILL'd worker cannot change the
selected model.

Observability: ``SweepStarted`` / ``CandidateBatchFitted`` /
``SweepCompleted`` events plus ``sweep_*`` registry metrics.
"""

from __future__ import annotations

import os
import time
from typing import Any, Dict, List, Tuple

import numpy as np

from mmlspark_tpu_torch.automl.tune import _METRICS
from mmlspark_tpu_torch.core.params import HasLabelCol, Param, gt, to_bool, to_float, to_int, to_str
from mmlspark_tpu_torch.core.pipeline import Estimator, Model
from mmlspark_tpu_torch.data.table import Table


def _model_text(model) -> str:
    """Serialized form committed to the ModelStore: the booster's text."""
    if hasattr(model, "get_model_string"):
        return model.get_model_string()
    raise TypeError(f"cannot serialize {type(model).__name__} for commit")


class TrainValidSweep(HasLabelCol, Estimator):
    """Batched train/validation hyperparameter sweep with best-model
    commit. The batch-of-models analogue of ``TuneHyperparameters``:
    one split instead of k folds, shape-bucketed fits instead of a
    candidate-at-a-time thread pool. ``_group_options`` (an attribute,
    not a param) goes to the gang's ``ProcessGroup``; the gang's epochs,
    the seconds of writing its spec, the worker results (each member's
    buckets, launches and seconds) and the exit statuses land on
    ``_process_sweep``."""

    estimator = Param("Estimator to sweep", is_complex=True)
    paramSpace = Param(
        "GridSpace / RandomSpace / {param: Dist} candidate source",
        is_complex=True, default=None,
    )
    paramMaps = Param(
        "Explicit candidate param maps (overrides paramSpace)",
        is_complex=True, default=None,
    )
    evaluationMetric = Param(
        "Metric name", default="accuracy", converter=to_str,
        validator=lambda v: v in _METRICS,
    )
    trainRatio = Param(
        "Fraction of rows in the training split", default=0.75,
        converter=to_float, validator=lambda v: 0.0 < v < 1.0,
    )
    numRuns = Param("Sampled param maps (random spaces)", default=10,
                    converter=to_int, validator=gt(0))
    seed = Param("RNG seed (sampling + split)", default=0, converter=to_int)
    numProcesses = Param(
        "Shard buckets across a worker gang when > 1", default=0,
        converter=to_int,
    )
    commitModel = Param(
        "Commit the refit best model to the ModelStore", default=True,
        converter=to_bool,
    )

    def _candidates(self) -> List[Tuple[Estimator, Dict[str, Any]]]:
        est = self.getEstimator()
        if est is None:
            raise ValueError("no estimator to sweep")
        maps: List[Dict[str, Any]]
        explicit = self.getParamMaps()
        space = self.getParamSpace()
        if explicit:
            maps = [dict(m) for m in explicit]
        elif space is None:
            maps = [{}]
        elif hasattr(space, "param_maps"):
            from mmlspark_tpu_torch.automl.hyperparam import GridSpace

            if isinstance(space, GridSpace):
                maps = list(space.param_maps())
            else:
                maps = list(space.param_maps(self.getNumRuns()))
        elif isinstance(space, dict) and space and all(
            hasattr(d, "get_next") for d in space.values()
        ):
            rng = np.random.default_rng(self.getSeed())
            maps = [
                {k: d.get_next(rng) for k, d in space.items()}
                for _ in range(self.getNumRuns())
            ]
        else:
            raise ValueError(
                "paramSpace must be a GridSpace/RandomSpace or a dict of "
                f"Dists, got {type(space).__name__}"
            )
        if not maps:
            raise ValueError("candidate space is empty")
        return [(est, m) for m in maps]

    def _split(self, n: int) -> np.ndarray:
        """Seeded boolean train mask (row order preserved; the complement
        is the validation split). Always leaves >=1 row on each side."""
        if n < 2:
            raise ValueError(f"{n} rows cannot split train/valid")
        rng = np.random.default_rng(self.getSeed())
        perm = rng.permutation(n)
        n_train = min(max(int(round(n * self.getTrainRatio())), 1), n - 1)
        mask = np.zeros(n, dtype=bool)
        mask[perm[:n_train]] = True
        return mask

    def _fit(self, table: Table) -> "TrainValidSweepModel":
        from mmlspark_tpu_torch.automl.tune import _is_larger_better
        from mmlspark_tpu_torch.observability import (
            SweepCompleted,
            SweepStarted,
            get_bus,
            get_registry,
        )
        from mmlspark_tpu_torch.sweep.batched import fit_bucket
        from mmlspark_tpu_torch.sweep.bucketing import bucket_candidates

        t0 = time.perf_counter()
        label_col = self.getLabelCol()
        metric = self.getEvaluationMetric()
        candidates = self._candidates()
        buckets = bucket_candidates(candidates)
        num_processes = self.getNumProcesses()
        mode = "gang" if num_processes > 1 else "inline"

        bus = get_bus()
        if bus.active:
            bus.publish(SweepStarted(
                candidates=len(candidates), buckets=len(buckets),
                estimator=type(self.getEstimator()).__name__, mode=mode,
            ))
        reg = get_registry()
        reg.counter(
            "sweep_candidates_total", "Candidates entering sweeps"
        ).inc(len(candidates))
        reg.gauge(
            "sweep_buckets", "Shape-buckets in the last sweep"
        ).set(len(buckets))

        mask = self._split(table.num_rows)
        metrics: List[float] = [float("nan")] * len(candidates)
        if mode == "gang":
            from mmlspark_tpu_torch.sweep.distributed import run_sweep_process_group

            metrics = run_sweep_process_group(
                self.getEstimator(), buckets, table, mask, label_col,
                metric, num_processes,
                num_candidates=len(candidates),
                seed=self.getSeed(),
                group_options=getattr(self, "_group_options", None),
                owner=self,
            )
        else:
            # the gang's workers cut the split themselves
            train, valid = table.filter(mask), table.filter(~mask)
            for bi, bucket in enumerate(buckets):
                scored = fit_bucket(
                    bucket, train, valid, label_col, metric, bucket_index=bi,
                )
                for pos, idx in enumerate(bucket.indices):
                    metrics[idx] = scored[pos][0]

        higher = _is_larger_better(metric)
        metrics_arr = np.asarray(metrics, dtype=np.float64)
        if np.isnan(metrics_arr).all():
            raise ValueError(
                "all candidate metrics are NaN — check split/label distribution"
            )
        ranked = np.where(
            np.isnan(metrics_arr), -np.inf if higher else np.inf, metrics_arr
        )
        best_i = int(np.argmax(ranked) if higher else np.argmin(ranked))
        best_est, best_params = candidates[best_i]

        # refit on the FULL table: the committed model is what a standalone
        # fit with the winning params would produce, byte for byte
        best_model = best_est.copy(best_params).fit(table)

        version = -1
        if self.getCommitModel():
            from mmlspark_tpu_torch.runtime.journal import ModelStore, default_checkpoint_dir

            ckpt_root = default_checkpoint_dir()
            if ckpt_root is not None:
                store = ModelStore(os.path.join(ckpt_root, "models"))
                version = store.commit(
                    _model_text(best_model),
                    name=f"sweep-{type(best_model).__name__.lower()}",
                )

        elapsed = time.perf_counter() - t0
        reg.gauge(
            "sweep_best_metric", "Winning validation metric of the last sweep"
        ).set(float(metrics[best_i]))
        reg.counter("sweep_runs_total", "Completed sweeps").inc()
        if bus.active:
            bus.publish(SweepCompleted(
                candidates=len(candidates), best_index=best_i,
                best_metric=float(metrics[best_i]), version=version,
                seconds=elapsed,
            ))

        model = TrainValidSweepModel(
            bestModel=best_model,
            bestParams=dict(best_params),
            bestMetric=float(metrics[best_i]),
            allMetrics=[float(m) for m in metrics],
            modelVersion=version,
        )
        model.parent = self
        return model


class TrainValidSweepModel(Model):
    bestModel = Param("Winning refit model", is_complex=True, default=None)
    bestParams = Param("Winning param map", default=None)
    bestMetric = Param("Winning validation metric", default=float("nan"))
    allMetrics = Param("Validation metric per candidate", default=None)
    modelVersion = Param("ModelStore version of the committed best model "
                         "(-1 = not committed)", default=-1, converter=to_int)

    def transform(self, table: Table) -> Table:
        return self.getBestModel().transform(table)

    def leaderboard(self) -> Table:
        """Candidates ranked best-first: (rank, candidate index, metric)."""
        from mmlspark_tpu_torch.automl.tune import _is_larger_better

        metrics = np.asarray(self.getAllMetrics() or [], dtype=np.float64)
        higher = (
            _is_larger_better(self.parent.getEvaluationMetric())
            if self.parent is not None else True
        )
        ranked = np.where(np.isnan(metrics), -np.inf if higher else np.inf,
                          metrics)
        order = np.argsort(-ranked if higher else ranked, kind="stable")
        return Table({
            "rank": np.arange(len(order), dtype=np.int64),
            "candidate": order.astype(np.int64),
            "metric": metrics[order],
        })
