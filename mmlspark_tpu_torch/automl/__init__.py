"""AutoML (reference ``automl/``, SURVEY.md section 2.13): the port's
hyperparameter spaces, ``TuneHyperparameters`` and ``FindBestModel``."""

from mmlspark_tpu_torch.automl.hyperparam import (
    DefaultHyperparams,
    DiscreteHyperParam,
    Dist,
    DoubleRangeHyperParam,
    GridSpace,
    HyperparamBuilder,
    IntRangeHyperParam,
    RandomSpace,
)
from mmlspark_tpu_torch.automl.tune import (
    BestModel,
    FindBestModel,
    TuneHyperparameters,
    TuneHyperparametersModel,
)

__all__ = [
    "BestModel",
    "DefaultHyperparams",
    "DiscreteHyperParam",
    "Dist",
    "DoubleRangeHyperParam",
    "FindBestModel",
    "GridSpace",
    "HyperparamBuilder",
    "IntRangeHyperParam",
    "RandomSpace",
    "TuneHyperparameters",
    "TuneHyperparametersModel",
]
