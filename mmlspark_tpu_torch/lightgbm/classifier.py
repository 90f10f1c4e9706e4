"""LightGBMClassifier — binary and multiclass GBDT classification.

The port's counterpart of ``mmlspark_tpu/lightgbm/classifier.py``: the same
params and output columns (rawPrediction, probability, prediction); labels above
1 infer the multiclass objective with one class per label value.
"""

from __future__ import annotations

import numpy as np

from mmlspark_tpu_torch.core.params import Param, to_bool, to_int, to_str
from mmlspark_tpu_torch.data.table import Table
from mmlspark_tpu_torch.lightgbm.base import (
    LightGBMBase,
    LightGBMModelBase,
    extract_features,
)
from mmlspark_tpu_torch.lightgbm.train import TrainResult


class LightGBMClassifier(LightGBMBase):
    objective = Param("binary or multiclass ('' = infer from label arity)",
                      default="", converter=to_str)
    rawPredictionCol = Param("Raw margin output column", default="rawPrediction", converter=to_str)
    probabilityCol = Param("Probability output column", default="probability", converter=to_str)
    isUnbalance = Param(
        "Binary class weighting for unbalanced data: positive rows get weight n_neg/n_pos",
        default=False, converter=to_bool,
    )

    _inferred_classes: int = 2

    def _adjust_weights(self, y: np.ndarray, w):
        if not self.getIsUnbalance():
            return w
        labels = set(np.unique(y).tolist())
        if not labels <= {0.0, 1.0}:
            raise ValueError(f"isUnbalance requires binary 0/1 labels (got {sorted(labels)[:5]})")
        n_pos = max(1, int((y > 0.5).sum()))
        n_neg = max(1, int((y <= 0.5).sum()))
        base = np.ones(len(y), dtype=np.float64) if w is None else np.asarray(w, np.float64)
        return np.where(y > 0.5, base * (n_neg / n_pos), base)

    def _num_classes(self, y: np.ndarray) -> int:
        n = int(np.max(y)) + 1 if len(y) else 2
        self._inferred_classes = max(2, n)
        return self._inferred_classes

    def _objective_name(self) -> str:
        obj = self.getObjective()
        if obj:
            return obj
        return "binary" if self._inferred_classes <= 2 else "multiclass"

    def _make_model(self, result: TrainResult) -> "LightGBMClassificationModel":
        return LightGBMClassificationModel(
            featuresCol=self.getFeaturesCol(),
            predictionCol=self.getPredictionCol(),
            rawPredictionCol=self.getRawPredictionCol(),
            probabilityCol=self.getProbabilityCol(),
            leafPredictionCol=self.getLeafPredictionCol(),
            featuresShapCol=self.getFeaturesShapCol(),
            numClasses=self._inferred_classes,
            boosterData=result.booster.to_dict(),
            device=self.getDevice(),
        )


class LightGBMClassificationModel(LightGBMModelBase):
    rawPredictionCol = Param("Raw margin output column", default="rawPrediction", converter=to_str)
    probabilityCol = Param("Probability output column", default="probability", converter=to_str)
    numClasses = Param("Number of classes", default=2, converter=to_int)

    def transform(self, table: Table) -> Table:
        booster = self.booster
        X = extract_features(table, self.getFeaturesCol(), booster.num_features)
        margins = booster.raw_margin(X, device=self.getDevice())  # (N, C)
        if booster.num_classes == 1:
            p1 = 1.0 / (1.0 + np.exp(-margins[:, 0]))
            probs = np.stack([1.0 - p1, p1], axis=1)
            raw = np.stack([-margins[:, 0], margins[:, 0]], axis=1)
        else:
            m = margins - margins.max(axis=1, keepdims=True)
            e = np.exp(m)
            probs = e / e.sum(axis=1, keepdims=True)
            raw = margins
        pred = probs.argmax(axis=1).astype(np.float64)
        out = (
            table.with_column(self.getRawPredictionCol(), raw)
            .with_column(self.getProbabilityCol(), probs)
            .with_column(self.getPredictionCol(), pred)
        )
        return self._with_leaf_col(out, X, booster)
