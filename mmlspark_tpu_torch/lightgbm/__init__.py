"""GBDT: binning, training, booster, and the classifier, regressor and
ranker estimators."""

from mmlspark_tpu_torch.lightgbm.classifier import (
    LightGBMClassificationModel,
    LightGBMClassifier,
)
from mmlspark_tpu_torch.lightgbm.ranker import LightGBMRanker, LightGBMRankerModel
from mmlspark_tpu_torch.lightgbm.regressor import LightGBMRegressionModel, LightGBMRegressor

__all__ = ["LightGBMClassificationModel", "LightGBMClassifier", "LightGBMRanker",
           "LightGBMRankerModel", "LightGBMRegressionModel", "LightGBMRegressor"]
