"""Imports, the reference's import shim, fixtures and helpers shared by
the test files of one subject:
``test_torch_trainers.py``, ``test_torch_chip_smoke_trainers.py``,
``test_torch_trainer_parity.py``.

Not a test module: pytest collects nothing here. Each test file imports
by name what it uses, the fixtures included.
"""

import os
import pathlib
import subprocess
import sys
import time
import types

import numpy as np
import pytest


def _import_reference():
    """Import the JAX package's fit path through the u_histogram shim (see
    ``tests/test_torch_gbdt.py``). The JAX package itself is not changed."""
    from jax._src.lax import lax as lax_internal
    from jax.interpreters import batching

    saved = batching.primitive_batchers
    batching.primitive_batchers = {lax_internal.optimization_barrier_p: None}
    try:
        import mmlspark_tpu.ops.u_histogram  # noqa: F401
    finally:
        batching.primitive_batchers = saved


# At import, so that every pytest worker has the module before it collects
# the JAX package's own test files.
try:
    _import_reference()
except ModuleNotFoundError as err:
    if err.name != "jax":
        raise

import torch

from mmlspark_tpu_torch.core.pipeline import PipelineStage
from mmlspark_tpu_torch.data.table import Table
from mmlspark_tpu_torch.lightgbm import LightGBMClassifier, LightGBMRegressor
from mmlspark_tpu_torch.train import (
    TrainClassifier,
    TrainedClassifierModel,
    TrainedRegressorModel,
    TrainRegressor,
)

REPO = pathlib.Path(__file__).resolve().parents[1]
PARAMS = dict(numIterations=4, numLeaves=7, minGainToSplit=1e-3, minDataInLeaf=10)


@pytest.fixture(scope="module")
def ref():
    import mmlspark_tpu.core.pipeline as jpipeline
    import mmlspark_tpu.train as jtrain
    from mmlspark_tpu.data.table import Table as JTable
    from mmlspark_tpu.lightgbm import LightGBMClassifier as JClassifier
    from mmlspark_tpu.lightgbm import LightGBMRegressor as JRegressor
    from mmlspark_tpu.lightgbm.procfit import model_texts_close

    return types.SimpleNamespace(train=jtrain, Table=JTable, Classifier=JClassifier,
                                 Regressor=JRegressor, close=model_texts_close,
                                 pipeline=jpipeline)


def _raw(n=1200, seed=0):
    """A raw table: a categorical string column with None, NaN and numpy
    scalars, a near-unique text column, numerics with NaN, row weights,
    and a latent with label noise."""
    rng = np.random.default_rng(seed)
    pool = ["red", "green", "blue", None, float("nan"), np.float64(2.5), np.int64(3)]
    cat = np.empty(n, dtype=object)
    cat[:] = [pool[i] for i in rng.integers(0, len(pool), n)]
    code = np.array([f"AP{i:03d}" for i in rng.integers(0, 140, n)], dtype=object)
    num = rng.normal(size=n)
    num[rng.random(n) < 0.1] = np.nan
    ints = rng.integers(0, 50, n)
    effect = rng.normal(0, 0.8, 140)[np.array([int(c[2:]) for c in code])]
    latent = np.nan_to_num(num) + 0.7 * (cat == "red") + effect + 0.02 * ints
    noisy = latent + rng.logistic(size=n)
    return {"cat": cat, "code": code, "num": num, "ints": ints,
            "w": rng.uniform(0.5, 2.0, n)}, latent, noisy


def _fit_both(ref, trainer, learner, label, cols, **kw):
    port_learner = {"clf": LightGBMClassifier, "reg": LightGBMRegressor}[learner]
    ref_learner = {"clf": ref.Classifier, "reg": ref.Regressor}[learner]
    port_trainer = {"clf": TrainClassifier, "reg": TrainRegressor}[trainer]
    ref_trainer = {"clf": ref.train.TrainClassifier, "reg": ref.train.TrainRegressor}[trainer]
    port = port_trainer(model=port_learner(device="cpu", weightCol="w", **PARAMS),
                        labelCol=label, **kw).fit(Table(cols))
    want = ref_trainer(model=ref_learner(parallelism="serial", weightCol="w", **PARAMS),
                       labelCol=label, **kw).fit(ref.Table(cols))
    return port, want


def _check(ref, port, want, cols, label, pred_equal=True):
    test = {k: v for k, v in cols.items() if k != label}
    feats = port.getFeaturizerModel().transform(Table(cols))[port.getFeaturesCol()]
    np.testing.assert_array_equal(
        feats, want.getFeaturizerModel().transform(ref.Table(cols))[want.getFeaturesCol()])
    assert port.getFeaturesCol() == want.getFeaturesCol()
    assert ref.close(port.getFittedModel().get_model_string(),
                     want.getFittedModel().get_model_string())
    got, exp = port.transform(Table(test)), want.transform(ref.Table(test))
    assert got.columns == exp.columns
    if pred_equal:
        assert [repr(v) for v in got["prediction"]] == [repr(v) for v in exp["prediction"]]
    return got, exp


class _CudaStub:
    """``torch.cuda`` for a CPU dry run: syncs and memory calls do nothing,
    events read the host clock."""

    class Event:
        def __init__(self, enable_timing=False):
            self.t = 0.0

        def record(self):
            self.t = time.perf_counter()

        def elapsed_time(self, end):
            return (end.t - self.t) * 1e3

    def synchronize(self, *a):
        pass

    def empty_cache(self):
        pass


class _TorchProxy:
    """``torch`` with every device the CPU and ``cuda`` a stub."""

    cuda = _CudaStub()

    def __getattr__(self, name):
        return getattr(torch, name)

    @staticmethod
    def device(*a, **kw):
        return torch.device("cpu")
