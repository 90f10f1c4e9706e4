"""Automatic featurization (the reference's ``featurize/``, SURVEY.md
section 2.10): the port's copies of the indexers, imputation, type
conversion, text hashing and ``Featurize``, all host numpy."""

from mmlspark_tpu_torch.featurize.clean import CleanMissingData, CleanMissingDataModel
from mmlspark_tpu_torch.featurize.conversion import DataConversion
from mmlspark_tpu_torch.featurize.featurize import AssembleFeatures, Featurize, FeaturizeModel
from mmlspark_tpu_torch.featurize.indexers import (
    IndexToValue,
    ValueIndexer,
    ValueIndexerModel,
    decode_levels,
)
from mmlspark_tpu_torch.featurize.text import (
    MultiNGram,
    PageSplitter,
    TextFeaturizer,
    TextFeaturizerModel,
    hashing_tf,
)

__all__ = [
    "AssembleFeatures",
    "CleanMissingData",
    "CleanMissingDataModel",
    "DataConversion",
    "Featurize",
    "FeaturizeModel",
    "IndexToValue",
    "MultiNGram",
    "PageSplitter",
    "TextFeaturizer",
    "TextFeaturizerModel",
    "ValueIndexer",
    "ValueIndexerModel",
    "decode_levels",
    "hashing_tf",
]
