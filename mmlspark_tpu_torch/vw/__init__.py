"""Online linear learning (VowpalWabbit-on-Spark equivalent), the port's
copy of ``mmlspark_tpu/vw/``.

The same surface: a hashing featurizer with namespaces and interactions
(host numpy), and online linear learners with adaptive updates (adagrad SGD
or FTRL) whose minibatch loop runs as torch ops on the estimator's
``device``; a mesh fit averages its shards' state at each pass end (VW's
``endPass`` allreduce).
"""

from mmlspark_tpu_torch.vw.featurizer import VowpalWabbitFeaturizer
from mmlspark_tpu_torch.vw.interactions import VowpalWabbitInteractions
from mmlspark_tpu_torch.vw.classifier import VowpalWabbitClassifier, VowpalWabbitClassificationModel
from mmlspark_tpu_torch.vw.regressor import VowpalWabbitRegressor, VowpalWabbitRegressionModel

__all__ = [
    "VowpalWabbitFeaturizer",
    "VowpalWabbitInteractions",
    "VowpalWabbitClassifier",
    "VowpalWabbitClassificationModel",
    "VowpalWabbitRegressor",
    "VowpalWabbitRegressionModel",
]
