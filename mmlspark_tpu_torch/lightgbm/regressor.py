"""LightGBMRegressor: the regression objectives (l2, l1, huber, quantile,
poisson, tweedie).

The port's counterpart of ``mmlspark_tpu/lightgbm/regressor.py``: the same
params (objective, alpha, tweedieVariancePower) and output column; poisson
and tweedie models predict on the response scale (``exp`` of the margin).
"""

from __future__ import annotations

import numpy as np

from mmlspark_tpu_torch.core.params import Param, one_of, to_float, to_str
from mmlspark_tpu_torch.data.table import Table
from mmlspark_tpu_torch.lightgbm.base import (
    LightGBMBase,
    LightGBMModelBase,
    extract_features,
)
from mmlspark_tpu_torch.lightgbm.train import TrainResult


class LightGBMRegressor(LightGBMBase):
    objective = Param(
        "regression objective", default="regression", converter=to_str,
        validator=one_of("regression", "regression_l1", "l2", "l1", "huber", "quantile",
                         "poisson", "tweedie", "mae", "mse"),
    )
    alpha = Param("Quantile/huber alpha", default=0.9, converter=to_float)
    tweedieVariancePower = Param("Tweedie variance power in (1, 2)", default=1.5,
                                 converter=to_float)

    def _objective_name(self) -> str:
        return self.getObjective()

    def _extra_train_options(self) -> dict:
        return {"alpha": self.getAlpha(),
                "tweedie_variance_power": self.getTweedieVariancePower()}

    def _make_model(self, result: TrainResult) -> "LightGBMRegressionModel":
        return LightGBMRegressionModel(
            featuresCol=self.getFeaturesCol(),
            predictionCol=self.getPredictionCol(),
            leafPredictionCol=self.getLeafPredictionCol(),
            featuresShapCol=self.getFeaturesShapCol(),
            objective=self.getObjective(),
            boosterData=result.booster.to_dict(),
            device=self.getDevice(),
        )


class LightGBMRegressionModel(LightGBMModelBase):
    objective = Param("Objective the booster was trained with", default="regression",
                      converter=to_str)

    def transform(self, table: Table) -> Table:
        booster = self.booster
        X = extract_features(table, self.getFeaturesCol(), booster.num_features)
        margins = booster.raw_margin(X, device=self.getDevice())[:, 0]
        if self.getObjective() in ("poisson", "tweedie"):
            margins = np.exp(margins)
        out = table.with_column(self.getPredictionCol(), margins.astype(np.float64))
        return self._with_leaf_col(out, X, booster)
