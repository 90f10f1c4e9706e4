"""mmlspark_tpu_torch.sweep: the many-models training plane.

The port's counterpart of ``mmlspark_tpu/sweep``. Where Spark parallelizes
model search across executors, the port fits many small models from one
binning and one upload of the bins: candidates that share static options
form a shape-bucket, heterogeneous grids partition into buckets, and each
bucket runs its candidates in lockstep through ``histogram.cu``
(``lightgbm.train.train_many``). The bucketing rules are the reference's
(``docs/automl_sweep.md``); :class:`TrainValidSweep` is the estimator
surface, inline or on a worker gang.
"""

from mmlspark_tpu_torch.sweep.batched import cv_metrics_batched, fit_bucket
from mmlspark_tpu_torch.sweep.bucketing import (
    GBDT_VMAPPED,
    VW_VMAPPED,
    CandidateBucket,
    bucket_candidates,
)
from mmlspark_tpu_torch.sweep.estimator import TrainValidSweep, TrainValidSweepModel

__all__ = [
    "CandidateBucket",
    "GBDT_VMAPPED",
    "TrainValidSweep",
    "TrainValidSweepModel",
    "VW_VMAPPED",
    "bucket_candidates",
    "cv_metrics_batched",
    "fit_bucket",
]
