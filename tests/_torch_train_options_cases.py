"""Imports, the reference's import shim, fixtures and helpers shared by
the test files of one subject:
``test_torch_train_options.py``, ``test_torch_bagging.py``,
``test_torch_binary_quantized_text.py``,
``test_torch_binary_quantized_text_mid.py``,
``test_torch_eval_history.py``, ``test_torch_fit_options_checks.py``,
``test_torch_schedules_and_warm_start.py``.

Not a test module: pytest collects nothing here. Each test file imports
by name what it uses, the fixtures included.
"""

import dataclasses
import signal

import numpy as np
import pytest

from mmlspark_tpu_torch.data.table import Table
from mmlspark_tpu_torch.lightgbm import LightGBMClassifier
from mmlspark_tpu_torch.lightgbm import binning as tbinning
from mmlspark_tpu_torch.lightgbm import callbacks as tcb
from mmlspark_tpu_torch.lightgbm import objectives as tobj
from mmlspark_tpu_torch.lightgbm import train as ttrain
from mmlspark_tpu_torch.lightgbm.booster import Booster
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
BASE = dict(num_iterations=6, num_leaves=15, max_bin=31, learning_rate=0.2)


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
    import mmlspark_tpu.lightgbm.binning as jbinning
    import mmlspark_tpu.lightgbm.callbacks as jcb
    import mmlspark_tpu.lightgbm.objectives as jobj
    import mmlspark_tpu.lightgbm.train as jtrain
    from mmlspark_tpu.data.table import Table as JTable
    from mmlspark_tpu.lightgbm import LightGBMClassifier as JClassifier

    return dict(binning=jbinning, cb=jcb, obj=jobj, train=jtrain, Table=JTable,
                Classifier=JClassifier)


def _case(seed, n=1500, f=6, objective="binary"):
    """Gaussian features; a noisy label (binary) or target (regression)."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, f))
    s = X[:, 0] + X[:, 1] * X[:, 2] + 0.5 * np.sin(X[:, 3])
    if objective == "binary":
        return X, (s + 0.8 * rng.normal(size=n) > 0).astype(np.float64)
    return X, 2.0 * s + 0.5 * rng.normal(size=n)


def _bins(ref, X, Xv=None, **kw):
    """Both packages' bins of X (and Xv through X's mapper)."""
    bt, mt = tbinning.bin_dataset(X, max_bin=31, **kw)
    bj, mj = ref["binning"].bin_dataset(X, max_bin=31, **kw)
    out = dict(bt=bt, mt=mt, bj=bj, mj=mj)
    if Xv is not None:
        out["bvt"] = tbinning.bin_dataset(Xv, mapper=mt)[0]
        out["bvj"] = ref["binning"].bin_dataset(Xv, mapper=mj)[0]
    return out


def _fit_both(ref, X, y, Xv=None, yv=None, callbacks=(), bin_kw=None, **kw):
    b = _bins(ref, X, Xv, **(bin_kw or {}))
    opts = {**BASE, "objective": "binary", **kw}
    tvalid = [("v", b["bvt"], yv, None)] if Xv is not None else None
    jvalid = [("v", b["bvj"], yv, None)] if Xv is not None else None
    rt = ttrain.train(b["bt"], y, ttrain.TrainOptions(**opts), mapper=b["mt"], valid_sets=tvalid,
                      callbacks=[c() for c in callbacks] if callbacks else None, device="cpu")
    rj = ref["train"].train(b["bj"], y, ref["train"].TrainOptions(**opts), mapper=b["mj"],
                            valid_sets=jvalid,
                            callbacks=[c(ref) for c in callbacks] if callbacks else None)
    return rt, rj


def _same_trees(tb, jb, atol=1e-5):
    assert tb.num_trees == jb.num_trees
    for field in STRUCTURE:
        assert np.array_equal(getattr(tb, field), getattr(jb, field)), field
    np.testing.assert_allclose(tb.leaf_values, jb.leaf_values, atol=atol)


def _same_evals(te, je):
    assert te.keys() == je.keys()
    for name in te:
        assert te[name].keys() == je[name].keys()
        for metric, scores in te[name].items():
            want = je[name][metric]
            assert len(scores) == len(want), (name, metric)
            if metric == "auc":
                np.testing.assert_allclose(scores, want, rtol=0, atol=1e-6)
            else:
                np.testing.assert_allclose(scores, want, rtol=1e-5, atol=1e-7)


# -- the mask schedule, metrics and callbacks -----------------------------------

SCHEDULES = {
    "plain": dict(bagging_fraction=0.6, bagging_freq=2),
    "stratified": dict(pos_bagging_fraction=0.8, neg_bagging_fraction=0.4, bagging_freq=1),
    "feature_fraction": dict(feature_fraction=0.5),
    "all": dict(bagging_fraction=0.7, bagging_freq=3, feature_fraction=0.7),
}


METRIC_NAMES = ["auc", "binary_logloss", "binary_error", "l2", "mse", "rmse", "l1", "mae",
                "quantile"]


# -- bagged and feature-fraction fits --------------------------------------------


# -- validation sets, metrics and early stopping ---------------------------------


def _stopper(at):
    def make(ref=None):
        base = ref["cb"].TrainingCallback if ref else tcb.TrainingCallback

        class Stop(base):
            seen = []

            def before_iteration(self, env):
                self.seen.append(("before", env.iteration, env.learning_rate))

            def after_iteration(self, env):
                self.seen.append(("after", env.iteration,
                                  len(env.evals["v"][next(iter(env.evals["v"]))])))
                return env.iteration == at

        return Stop()
    return make


def _schedule(kind):
    values = [0.3, 0.05, 0.2, 0.1, 0.25, 0.15]

    def make(ref=None):
        cls = ref["cb"].LearningRateSchedule if ref else tcb.LearningRateSchedule
        return cls(values if kind == "list" else (lambda i: 0.3 * 0.7 ** i))
    return make


# -- warm start ------------------------------------------------------------------


def _estimators(ref, **params):
    common = {**dict(numIterations=4, numLeaves=15, maxBin=31, learningRate=0.2), **params}
    return (LightGBMClassifier(device="cpu", **common),
            ref["Classifier"](parallelism="serial", **common))


# -- the out-of-memory ladder, categoricals and bundles --------------------------


def _cat_case(seed, n=1600):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, 4))
    X[:, 0] = rng.integers(0, 12, n)
    X[:, 1] = rng.integers(0, 3, n)
    effect = rng.normal(size=12)
    logit = effect[X[:, 0].astype(int)] + 0.8 * (X[:, 1] == 2) + X[:, 2]
    return X, (logit + rng.logistic(size=n) > 0).astype(np.float64)


def _one_hot_case(seed, n=1600):
    rng = np.random.default_rng(seed)
    X = np.zeros((n, 12))
    for blk in range(3):
        X[np.arange(n), blk * 4 + rng.integers(0, 4, n)] = rng.uniform(0.5, 2.0, n)
    X = np.hstack([X, rng.normal(size=(n, 2))])
    logit = X[:, 0] + 2 * X[:, 6] + X[:, -1] - 1.0
    return X, (logit + rng.logistic(size=n) > 0).astype(np.float64)


SEEDS = [
    (0, 1400, {}), (1, 1400, dict(bagging_fraction=0.7, bagging_freq=2, feature_fraction=0.8)),
    (3, 6000, {}), (5, 6000, dict(bagging_fraction=0.7, bagging_freq=2, feature_fraction=0.8)),
]


def quantized_text_case(ref, seed, n, extra, max_bin):
    """The quantized U path writes the reference's model text byte for
    byte: the same noise, integer histograms, the reference's compiled
    arithmetic in the quantization (a fused multiply-add, the reciprocal of
    127) and its prefix sums in XLA's CPU order (bin order at 64 and 256
    bins, two interleaved chains at 32, four at 16)."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, 8))
    y = ((X[:, 0] + X[:, 1] * X[:, 2] + 0.5 * rng.normal(size=n)) > 0).astype(np.float64)
    kw = dict(objective="binary", num_iterations=10, num_leaves=15, max_bin=max_bin,
              histogram_method="u", use_quantized_grad=True, **extra)
    bt, mt = tbinning.bin_dataset(X, max_bin=max_bin)
    bj, mj = ref["binning"].bin_dataset(X, max_bin=max_bin)
    port = ttrain.train(bt, y, ttrain.TrainOptions(**kw), mapper=mt, device="cpu")
    want = ref["train"].train(bj, y, ref["train"].TrainOptions(**kw), mapper=mj)
    assert port.stats.quantized
    assert port.booster.model_to_string() == want.booster.model_to_string()
