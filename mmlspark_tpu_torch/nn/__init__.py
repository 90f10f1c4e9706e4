"""Nearest neighbors (reference ``nn/``, SURVEY.md §2.6); the port's copy of
``mmlspark_tpu/nn/``."""

from mmlspark_tpu_torch.nn.ball_tree import BallTree, BestMatch, ConditionalBallTree
from mmlspark_tpu_torch.nn.knn import KNN, ConditionalKNN, ConditionalKNNModel, KNNModel

__all__ = [
    "BallTree",
    "BestMatch",
    "ConditionalBallTree",
    "ConditionalKNN",
    "ConditionalKNNModel",
    "KNN",
    "KNNModel",
]
