"""The simplified train and evaluate API (the reference's ``train/``,
SURVEY.md section 2.12): ``TrainClassifier`` and ``TrainRegressor``, which
featurize a raw table and fit a learner, and the statistics stages the tuner
and the sweep score with.
"""

from mmlspark_tpu_torch.train.statistics import (
    ComputeModelStatistics,
    ComputePerInstanceStatistics,
    binary_auc,
    prob_class_index,
    remap_classes,
)
from mmlspark_tpu_torch.train.trainers import (
    TrainClassifier,
    TrainedClassifierModel,
    TrainedRegressorModel,
    TrainRegressor,
)

__all__ = [
    "ComputeModelStatistics",
    "ComputePerInstanceStatistics",
    "TrainClassifier",
    "TrainRegressor",
    "TrainedClassifierModel",
    "TrainedRegressorModel",
    "binary_auc",
    "prob_class_index",
    "remap_classes",
]
