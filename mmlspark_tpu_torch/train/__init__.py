"""Model statistics (the reference's ``train/``, SURVEY.md section 2.12).

The port's ``train`` package holds the statistics stages the tuner and the
sweep score with. ``TrainClassifier`` and ``TrainRegressor`` come with the
featurizers they build on.
"""

from mmlspark_tpu_torch.train.statistics import (
    ComputeModelStatistics,
    ComputePerInstanceStatistics,
    binary_auc,
    prob_class_index,
    remap_classes,
)

__all__ = [
    "ComputeModelStatistics",
    "ComputePerInstanceStatistics",
    "binary_auc",
    "prob_class_index",
    "remap_classes",
]
