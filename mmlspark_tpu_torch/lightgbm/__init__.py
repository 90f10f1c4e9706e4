"""Leafwise GBDT: binning, training, booster and the classifier estimator."""

from mmlspark_tpu_torch.lightgbm.classifier import (
    LightGBMClassificationModel,
    LightGBMClassifier,
)

__all__ = ["LightGBMClassificationModel", "LightGBMClassifier"]
