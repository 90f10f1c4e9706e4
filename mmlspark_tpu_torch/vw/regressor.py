"""VowpalWabbitRegressor — squared/quantile-loss online linear regression.

Parity with ``vw/VowpalWabbitRegressor.scala``.

The port's copy of ``mmlspark_tpu/vw/regressor.py``; the model computes its
margins on its ``device``.
"""

from __future__ import annotations

import numpy as np

from mmlspark_tpu_torch.data.table import Table
from mmlspark_tpu_torch.vw.base import (
    VowpalWabbitBase,
    VowpalWabbitModelBase,
    VWTrainResult,
)


class VowpalWabbitRegressor(VowpalWabbitBase):
    _default_loss = "squared"

    def _make_model(self, result: VWTrainResult, dim: int, const_idx: int):
        return VowpalWabbitRegressionModel(
            featuresCol=self.getFeaturesCol(),
            predictionCol=self.getPredictionCol(),
            modelWeights=result.weights,
            sparseDim=dim,
            constantIndex=const_idx,
            trainingStats=result.stats,
            device=self.getDevice(),
        )


class VowpalWabbitRegressionModel(VowpalWabbitModelBase):
    def transform(self, table: Table) -> Table:
        return table.with_column(
            self.getPredictionCol(),
            self._apply_link(self._margins(table)).astype(np.float64),
        )
