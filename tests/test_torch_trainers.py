"""The port's TrainClassifier and TrainRegressor (mmlspark_tpu_torch.train)
against the JAX package's, over each package's LightGBM on the CPU, on a
mixed table (strings with None, NaN and numpy scalars, numerics with NaN,
text, a label with noise) and row weights: the featurized matrix is equal,
the model texts hold ``model_texts_close`` and the decoded predictions are
equal. Trained models move between the packages; no new module imports
jax or the JAX package; chip_smoke's phase 32 runs on the CPU.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

from mmlspark_tpu_torch.data.table import Table
from mmlspark_tpu_torch.lightgbm import LightGBMClassifier
from mmlspark_tpu_torch.train import TrainClassifier

from _torch_trainers_cases import PARAMS, REPO
from _torch_trainers_cases import ref  # noqa: F401  (fixtures)


def test_a_vector_column_is_not_featurized(ref):
    rng = np.random.default_rng(4)
    X = rng.normal(size=(600, 5))
    cols = {"features": X, "label": np.where(X[:, 0] + rng.logistic(size=600) > 0, "a", "b")
            .astype(object)}
    port = TrainClassifier(model=LightGBMClassifier(device="cpu", **PARAMS),
                           labelCol="label").fit(Table(cols))
    want = ref.train.TrainClassifier(model=ref.Classifier(parallelism="serial", **PARAMS),
                                     labelCol="label").fit(ref.Table(cols))
    assert port.getFeaturizerModel() is None and port.getFeaturesCol() == "features"
    assert ref.close(port.getFittedModel().get_model_string(),
                     want.getFittedModel().get_model_string())
    assert list(port.transform(Table({"features": X}))["prediction"]) == \
        list(want.transform(ref.Table({"features": X}))["prediction"])


@pytest.mark.parametrize("module", ["ops.hashing", "featurize", "stages", "train",
                                    "data.table", "data.sharded"])
def test_new_module_loads_neither_jax_nor_the_jax_package(module):
    code = (f"import sys, mmlspark_tpu_torch.{module}\n"
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'mmlspark_tpu.'))"
            " or m == 'mmlspark_tpu']\n"
            "assert not bad, bad\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    subprocess.run([sys.executable, "-c", code], check=True, env=env, cwd=str(REPO),
                   timeout=120)
