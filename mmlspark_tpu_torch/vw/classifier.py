"""VowpalWabbitClassifier — logistic-loss online linear classification.

Parity with ``vw/VowpalWabbitClassifier.scala`` (labels mapped to {-1, +1},
probability via sigmoid of the raw margin).

The port's copy of ``mmlspark_tpu/vw/classifier.py``; the model computes its
margins on its ``device``.
"""

from __future__ import annotations

import numpy as np

from mmlspark_tpu_torch.core.params import Param, to_str
from mmlspark_tpu_torch.data.table import Table
from mmlspark_tpu_torch.vw.base import (
    VowpalWabbitBase,
    VowpalWabbitModelBase,
    VWTrainResult,
)


class VowpalWabbitClassifier(VowpalWabbitBase):
    _default_loss = "logistic"

    rawPredictionCol = Param("Raw margin output column", default="rawPrediction", converter=to_str)
    probabilityCol = Param("Probability output column", default="probability", converter=to_str)

    def _label_transform(self, y: np.ndarray) -> np.ndarray:
        # 0/1 -> -1/+1 (VW binary label convention)
        return np.where(y > 0.5, 1.0, -1.0).astype(np.float32)

    def _make_model(self, result: VWTrainResult, dim: int, const_idx: int):
        return VowpalWabbitClassificationModel(
            featuresCol=self.getFeaturesCol(),
            predictionCol=self.getPredictionCol(),
            rawPredictionCol=self.getRawPredictionCol(),
            probabilityCol=self.getProbabilityCol(),
            modelWeights=result.weights,
            sparseDim=dim,
            constantIndex=const_idx,
            trainingStats=result.stats,
            device=self.getDevice(),
        )


class VowpalWabbitClassificationModel(VowpalWabbitModelBase):
    rawPredictionCol = Param("Raw margin output column", default="rawPrediction", converter=to_str)
    probabilityCol = Param("Probability output column", default="probability", converter=to_str)

    def transform(self, table: Table) -> Table:
        m = self._margins(table)
        p1 = 1.0 / (1.0 + np.exp(-m))
        probs = np.stack([1 - p1, p1], axis=1)
        raw = np.stack([-m, m], axis=1)
        return (
            table.with_column(self.getRawPredictionCol(), raw)
            .with_column(self.getProbabilityCol(), probs)
            .with_column(self.getPredictionCol(), (m > 0).astype(np.float64))
        )
