"""Recommendation (reference ``recommendation/``, SURVEY.md §2.9); the port's
copy of ``mmlspark_tpu/recommendation/``."""

from mmlspark_tpu_torch.recommendation.ranking import (
    AdvancedRankingMetrics,
    RankingAdapter,
    RankingAdapterModel,
    RankingEvaluator,
    RankingTrainValidationSplit,
    RankingTrainValidationSplitModel,
    RecommendationIndexer,
    RecommendationIndexerModel,
)
from mmlspark_tpu_torch.recommendation.sar import SAR, SARModel

__all__ = [
    "AdvancedRankingMetrics",
    "RankingAdapter",
    "RankingAdapterModel",
    "RankingEvaluator",
    "RankingTrainValidationSplit",
    "RankingTrainValidationSplitModel",
    "RecommendationIndexer",
    "RecommendationIndexerModel",
    "SAR",
    "SARModel",
]
