"""Imports, the reference's import shim, fixtures and helpers shared by
the test files of one subject:
``test_torch_boosting.py``, ``test_torch_boosting_estimator.py``,
``test_torch_boosting_multiclass_depthwise.py``,
``test_torch_boosting_u.py``.

Not a test module: pytest collects nothing here. Each test file imports
by name what it uses, the fixtures included.
"""

import dataclasses
import signal

import numpy as np
import pytest
import torch

from mmlspark_tpu_torch.data.table import Table
from mmlspark_tpu_torch.lightgbm import LightGBMClassifier
from mmlspark_tpu_torch.lightgbm import binning as tbinning
from mmlspark_tpu_torch.lightgbm import objectives as tobj
from mmlspark_tpu_torch.lightgbm import train as ttrain
from mmlspark_tpu_torch.lightgbm.booster import Booster
from mmlspark_tpu_torch.lightgbm.convert import booster_from_jax
from mmlspark_tpu_torch.ops import hopper_histogram as hh
from mmlspark_tpu_torch.runtime.faults import FaultPlan, inject_faults


def _import_reference():
    """Import the JAX package's fit path through the u_histogram shim (see
    ``tests/test_torch_gbdt.py``): a dict holding the barrier rule stands
    in for jax 0.9's ``batching.primitive_batchers`` while the module
    imports. The JAX package itself is not changed."""
    from jax._src.lax import lax as lax_internal
    from jax.interpreters import batching

    saved = batching.primitive_batchers
    batching.primitive_batchers = {lax_internal.optimization_barrier_p: None}
    try:
        import mmlspark_tpu.ops.u_histogram  # noqa: F401
    finally:
        batching.primitive_batchers = saved


try:
    _import_reference()
except ModuleNotFoundError as err:
    if err.name != "jax":
        raise

TIME_LIMIT_S = 180
STRUCTURE = ("split_feature", "split_bin", "left_child", "right_child", "is_leaf")
BASE = dict(num_iterations=5, num_leaves=15, max_bin=31, learning_rate=0.2,
            min_gain_to_split=1e-3)
PATHS = {
    "compare": {},
    "u_bf16": dict(histogram_method="u"),
    "u_quant": dict(histogram_method="u", use_quantized_grad=True),
}


@pytest.fixture(autouse=True)
def _time_limit():
    """Each test of this file fails after TIME_LIMIT_S seconds."""

    def expire(signum, frame):
        raise TimeoutError(f"test ran past its {TIME_LIMIT_S} s limit")

    saved = signal.signal(signal.SIGALRM, expire)
    signal.alarm(TIME_LIMIT_S)
    try:
        yield
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, saved)


@pytest.fixture(scope="module")
def ref():
    import jax
    import mmlspark_tpu.lightgbm.binning as jbinning
    import mmlspark_tpu.lightgbm.objectives as jobj
    import mmlspark_tpu.lightgbm.train as jtrain
    from mmlspark_tpu.data.table import Table as JTable
    from mmlspark_tpu.lightgbm import LightGBMClassifier as JClassifier
    from mmlspark_tpu.lightgbm.procfit import model_texts_close

    return dict(jax=jax, binning=jbinning, obj=jobj, train=jtrain, Table=JTable,
                Classifier=JClassifier, texts_close=model_texts_close)


def _case(seed, num_class=2, n=2000, f=8):
    """Gaussian features; per-class scores with noise; the label is the
    argmax (multiclass) or the sign of a difference (binary); row weights."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, f))
    s = np.stack([X[:, 0] + X[:, 1] * X[:, 2], np.sin(X[:, 3]) * 2 - X[:, 0],
                  X[:, 4] + 0.5 * X[:, 5], X[:, 6] - X[:, 7], X[:, 2] * X[:, 5]], 1)
    s = s[:, :max(num_class, 2)] + rng.normal(size=(n, max(num_class, 2)))
    y = s.argmax(1) if num_class > 2 else (s[:, 0] > s[:, 1])
    return X, y.astype(np.float64), rng.uniform(0.5, 2.0, n)


def _opts(num_class, **kw):
    if num_class > 2:
        kw = {"objective": "multiclass", "num_class": num_class, **kw}
    else:
        kw = {"objective": "binary", **kw}
    return {**BASE, **kw}


def _fit_both(ref, X, y, w=None, valid=None, **opts):
    """The same fit through both packages: (port result, reference result,
    port bins, port mapper)."""
    max_bin = opts["max_bin"]
    bt, mt = tbinning.bin_dataset(X, max_bin=max_bin)
    bj, mj = ref["binning"].bin_dataset(X, max_bin=max_bin)
    tvalid = jvalid = None
    if valid is not None:
        Xv, yv = valid
        tvalid = [("v", tbinning.bin_dataset(Xv, mapper=mt)[0], yv, None)]
        jvalid = [("v", ref["binning"].bin_dataset(Xv, mapper=mj)[0], yv, None)]
    rt = ttrain.train(bt, y, ttrain.TrainOptions(**opts), w=w, mapper=mt, valid_sets=tvalid,
                      device="cpu")
    rj = ref["train"].train(bj, y, ref["train"].TrainOptions(**opts), w=w, mapper=mj,
                            valid_sets=jvalid)
    return rt, rj, bt, mt


def _same_trees(tb, jb, atol=1e-5):
    assert tb.num_trees == np.asarray(jb.split_feature).shape[0]
    assert tb.num_classes == jb.num_classes
    for field in STRUCTURE:
        assert np.array_equal(getattr(tb, field), np.asarray(getattr(jb, field))), field
    np.testing.assert_allclose(tb.leaf_values, np.asarray(jb.leaf_values), atol=atol)


def _same_margins(tb, jb, X, atol=1e-5):
    np.testing.assert_allclose(tb.raw_margin(X, device="cpu"), np.asarray(jb.raw_margin(X)),
                               atol=atol)


# -- the estimator and carried boosters -------------------------------------------


def _estimators(ref, **params):
    common = {**dict(numIterations=4, numLeaves=15, maxBin=31, learningRate=0.2,
                     minGainToSplit=1e-3), **params}
    return (LightGBMClassifier(device="cpu", **common),
            ref["Classifier"](parallelism="serial", **common))
