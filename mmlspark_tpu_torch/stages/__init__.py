"""Generic pipeline stages, the port's copy of the reference's ``stages/`` (SURVEY.md
section 2.11)."""

from mmlspark_tpu_torch.stages.basic import (
    Cacher,
    ClassBalancer,
    ClassBalancerModel,
    DropColumns,
    EnsembleByKey,
    Explode,
    Lambda,
    MultiColumnAdapter,
    RenameColumn,
    Repartition,
    SelectColumns,
    StratifiedRepartition,
    SummarizeData,
    TextPreprocessor,
    Timer,
    TimerModel,
    UDFTransformer,
    UnicodeNormalize,
)
from mmlspark_tpu_torch.stages.batching import (
    DynamicMiniBatchTransformer,
    FixedMiniBatchTransformer,
    FlattenBatch,
    TimeIntervalMiniBatchTransformer,
)
from mmlspark_tpu_torch.stages.udfs import get_value_at, to_vector

__all__ = [
    "Cacher",
    "ClassBalancer",
    "ClassBalancerModel",
    "DropColumns",
    "DynamicMiniBatchTransformer",
    "EnsembleByKey",
    "Explode",
    "FixedMiniBatchTransformer",
    "FlattenBatch",
    "Lambda",
    "MultiColumnAdapter",
    "RenameColumn",
    "Repartition",
    "SelectColumns",
    "StratifiedRepartition",
    "SummarizeData",
    "TextPreprocessor",
    "TimeIntervalMiniBatchTransformer",
    "Timer",
    "TimerModel",
    "UDFTransformer",
    "UnicodeNormalize",
    "get_value_at",
    "to_vector",
]
