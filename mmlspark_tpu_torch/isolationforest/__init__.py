"""Isolation Forest (reference ``isolationforest/IsolationForest.scala:9-58``,
a thin re-export of LinkedIn's ``isolation-forest`` Spark estimator); the
port's copy of ``mmlspark_tpu/isolationforest/``."""

from mmlspark_tpu_torch.isolationforest.forest import IsolationForest, IsolationForestModel

__all__ = ["IsolationForest", "IsolationForestModel"]
