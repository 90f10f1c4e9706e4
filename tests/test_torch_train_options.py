"""The port's train() options against the JAX package: bagging (plain and
pos/neg-stratified), feature_fraction, validation sets and eval metrics,
early stopping, callbacks (LR schedules, iteration hooks, the stop channel),
warm start (init_margins, initScoreCol, modelString) and
validationIndicatorCol, on the default and the quantized U paths.

Inputs come from numpy seeds and go through both packages on the CPU.
Tolerances: identical tree structure, leaf values and margins within 1e-5,
AUC histories within 1e-6 and loss histories within 1e-5 relative, the same
best iteration. The data carry label noise, so no split is chosen on a
gain at float32 noise level.
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


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_mask_schedule_is_the_references(ref, name):
    opts = dict(num_iterations=7, **SCHEDULES[name])
    n, f = 997, 9
    y = (np.random.default_rng(5).uniform(size=n) < 0.3).astype(np.float32)
    to, jo = ttrain.TrainOptions(**opts), ref["train"].TrainOptions(**opts)
    num_bag = max(1, int(round(n * to.bagging_fraction)))
    num_feat = max(1, int(round(f * to.feature_fraction)))
    port = list(ttrain._mask_schedule(to, np.random.default_rng(11), n, num_bag, num_feat, f,
                                      y=y))
    want = list(ref["train"]._mask_schedule(jo, np.random.default_rng(11), n, 0, num_bag,
                                            num_feat, f, np.ones(n, np.float32), y=y))
    assert len(port) == len(want) == 7
    for (bag, changed, fm), (jbag, jchanged, jfm) in zip(port, want):
        assert changed == jchanged
        np.testing.assert_array_equal(np.ones(n) if bag is None else bag, jbag)
        if jfm is None:
            assert fm is None
        else:
            np.testing.assert_array_equal(fm, jfm)


METRIC_NAMES = ["auc", "binary_logloss", "binary_error", "l2", "mse", "rmse", "l1", "mae",
                "quantile"]


@pytest.mark.parametrize("metric", METRIC_NAMES)
def test_metric_matches_reference(ref, metric):
    rng = np.random.default_rng(len(metric))
    n = 3001
    y = (rng.uniform(size=n) < 0.4).astype(np.float64)
    margins = np.round(rng.normal(size=(n, 1)), 2).astype(np.float32)  # ties for auc
    w = rng.uniform(0.5, 2.0, size=n)
    got = ttrain._evaluate(metric, "binary", y, margins, w, 0.7)
    want = ref["train"]._evaluate(metric, "binary", y, margins, w, 0.7)
    assert got == pytest.approx(want, rel=1e-12, abs=1e-12)
    assert tobj.metric_higher_is_better(metric) == ref["obj"].metric_higher_is_better(metric)


def test_lr_schedule_and_hooks_are_the_references(ref):
    class Hook(tcb.TrainingCallback):
        def after_iteration(self, env):
            return False

    sched = [tcb.LearningRateSchedule(lambda i: 0.3 / (i + 1)),
             tcb.LearningRateSchedule([0.1, None, 0.05, 0.2] * 2)]
    jsched = [ref["cb"].LearningRateSchedule(lambda i: 0.3 / (i + 1)),
              ref["cb"].LearningRateSchedule([0.1, None, 0.05, 0.2] * 2)]
    got = tcb._lr_schedule(sched[:1], 0.1, 8)
    np.testing.assert_array_equal(got, ref["cb"]._lr_schedule(jsched[:1], 0.1, 8))
    assert got.dtype == np.float32
    assert tcb._lr_schedule([tcb.TrainingCallback()], 0.1, 8) is None
    assert not tcb._has_iteration_hooks(sched) and tcb._has_iteration_hooks([Hook()])


def test_table_filter_keeps_rows_in_order():
    t = Table({"a": np.arange(6), "v": np.arange(12).reshape(6, 2)})
    out = t.filter(np.array([1, 0, 1, 0, 0, 1], bool))
    assert out.num_rows == 3 and out["a"].tolist() == [0, 2, 5]
    assert out["v"].tolist() == [[0, 1], [4, 5], [10, 11]]


# -- bagged and feature-fraction fits --------------------------------------------


@pytest.mark.parametrize("path", ["compare", "u_quant"])
@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_bagged_fit_matches_jax(ref, name, path):
    X, y = _case(seed=3 + len(name))
    kw = dict(SCHEDULES[name])
    if path == "u_quant":
        kw.update(histogram_method="u", use_quantized_grad=True)
    rt, rj = _fit_both(ref, X, y, **kw)
    assert rt.stats.histogram_path == ("u" if path == "u_quant" else "compare")
    _same_trees(rt.booster, rj.booster)
    np.testing.assert_allclose(rt.booster.raw_margin(X, device="cpu"), rj.booster.raw_margin(X),
                               atol=1e-5)


# -- validation sets, metrics and early stopping ---------------------------------


@pytest.mark.parametrize("objective,metric", [
    ("binary", None), ("binary", "binary_logloss"), ("binary", "binary_error"),
    ("regression", None), ("regression", "rmse"), ("regression", "l1"),
    ("regression", "quantile"),
])
def test_eval_history_matches_jax(ref, objective, metric):
    X, y = _case(seed=21, n=1800, objective=objective)
    Xt, yt, Xv, yv = X[:1300], y[:1300], X[1300:], y[1300:]
    rt, rj = _fit_both(ref, Xt, yt, Xv, yv, objective=objective, metric=metric,
                       provide_training_metric=True, bagging_fraction=0.8, bagging_freq=1)
    _same_trees(rt.booster, rj.booster)
    _same_evals(rt.evals, rj.evals)
    name = metric or ("auc" if objective == "binary" else "l2")
    assert len(rt.evals["v"][name]) == len(rt.evals["training"][name]) == BASE["num_iterations"]
    assert rt.best_iteration == rj.best_iteration
    assert rt.booster.best_iteration == -1  # no early stopping: every tree counts


@pytest.mark.parametrize("tolerance", [0.0, 2e-3])
def test_early_stopping_matches_jax(ref, tolerance):
    X, y = _case(seed=31, n=1600)
    y = np.where(np.random.default_rng(1).uniform(size=len(y)) < 0.25, 1 - y, y)
    Xt, yt, Xv, yv = X[:1100], y[:1100], X[1100:], y[1100:]
    kw = dict(num_iterations=30, learning_rate=0.5, early_stopping_round=2,
              improvement_tolerance=tolerance, feature_fraction=0.8)
    rt, rj = _fit_both(ref, Xt, yt, Xv, yv, **kw)
    tb, jb = rt.booster, rj.booster
    assert tb.num_iterations < kw["num_iterations"], "the fit did not stop early"
    assert rt.best_iteration == rj.best_iteration == tb.best_iteration == jb.best_iteration
    assert 0 < tb.best_iteration < tb.num_iterations
    _same_trees(tb, jb)
    _same_evals(rt.evals, rj.evals)
    # predict honours best_iteration as the reference does
    np.testing.assert_allclose(tb.raw_margin(Xv, device="cpu"), jb.raw_margin(Xv), atol=1e-5)
    full = tb.raw_margin(Xv, num_iteration=tb.num_iterations, device="cpu")
    assert not np.allclose(full, tb.raw_margin(Xv, device="cpu"))


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


def test_callback_stop_matches_jax(ref):
    X, y = _case(seed=41, n=1500)
    Xt, yt, Xv, yv = X[:1100], y[:1100], X[1100:], y[1100:]
    rt, rj = _fit_both(ref, Xt, yt, Xv, yv, callbacks=[_stopper(3)], early_stopping_round=4)
    assert rt.booster.num_iterations == rj.booster.num_iterations == 4
    assert rt.best_iteration == rj.best_iteration
    assert rt.booster.best_iteration == rj.booster.best_iteration
    _same_trees(rt.booster, rj.booster)
    _same_evals(rt.evals, rj.evals)


def test_callback_hooks_see_what_the_reference_shows(ref):
    X, y = _case(seed=43, n=1200)
    port_cb, ref_cb = _stopper(2)(), _stopper(2)(ref)
    b = _bins(ref, X[:900], X[900:])
    ttrain.train(b["bt"], y[:900], ttrain.TrainOptions(**BASE), mapper=b["mt"],
                 valid_sets=[("v", b["bvt"], y[900:], None)], callbacks=[port_cb], device="cpu")
    ref["train"].train(b["bj"], y[:900], ref["train"].TrainOptions(**BASE), mapper=b["mj"],
                       valid_sets=[("v", b["bvj"], y[900:], None)], callbacks=[ref_cb])
    assert port_cb.seen == ref_cb.seen and len(port_cb.seen) == 6


def _schedule(kind):
    values = [0.3, 0.05, 0.2, 0.1, 0.25, 0.15]

    def make(ref=None):
        cls = ref["cb"].LearningRateSchedule if ref else tcb.LearningRateSchedule
        return cls(values if kind == "list" else (lambda i: 0.3 * 0.7 ** i))
    return make


@pytest.mark.parametrize("kind", ["list", "callable"])
@pytest.mark.parametrize("path", ["compare", "u_quant"])
def test_lr_schedule_matches_jax(ref, kind, path):
    X, y = _case(seed=51)
    kw = dict(histogram_method="u", use_quantized_grad=True) if path == "u_quant" else {}
    rt, rj = _fit_both(ref, X, y, callbacks=[_schedule(kind)], **kw)
    _same_trees(rt.booster, rj.booster)
    plain, _ = _fit_both(ref, X, y, **kw)
    assert not np.allclose(plain.booster.leaf_values, rt.booster.leaf_values)


# -- warm start ------------------------------------------------------------------


@pytest.mark.parametrize("path", ["compare", "u_quant"])
def test_init_margins_warm_start_matches_jax(ref, path):
    X, y = _case(seed=61)
    kw = dict(histogram_method="u", use_quantized_grad=True) if path == "u_quant" else {}
    first, jfirst = _fit_both(ref, X, y, **kw)
    init = first.booster.raw_margin(X, device="cpu")
    b = _bins(ref, X)
    opts = {**BASE, "objective": "binary", "num_iterations": 4, **kw}
    rt = ttrain.train(b["bt"], y, ttrain.TrainOptions(**opts), mapper=b["mt"],
                      init_margins=init, device="cpu")
    rj = ref["train"].train(b["bj"], y, ref["train"].TrainOptions(**opts), mapper=b["mj"],
                            init_margins=jfirst.booster.raw_margin(X))
    assert rt.booster.init_score.tolist() == [0.0]  # a delta model
    _same_trees(rt.booster, rj.booster)


def _estimators(ref, **params):
    common = {**dict(numIterations=4, numLeaves=15, maxBin=31, learningRate=0.2), **params}
    return (LightGBMClassifier(device="cpu", **common),
            ref["Classifier"](parallelism="serial", **common))


def test_estimator_warm_starts_match_jax(ref):
    """modelString and initScoreCol continue a fit as the reference does,
    and the two ways give the port the same model text."""
    X, y = _case(seed=71)
    first_t, first_j = _estimators(ref)
    m_t = first_t.fit(Table({"features": X, "label": y}))
    m_j = first_j.fit(ref["Table"]({"features": X, "label": y}))
    text = m_t.get_model_string()
    by_text_t, by_text_j = _estimators(ref, modelString=text)
    dt = by_text_t.fit(Table({"features": X, "label": y})).booster
    dj = by_text_j.fit(ref["Table"]({"features": X, "label": y})).booster
    _same_trees(dt, dj)
    # the raw margins of the model that the text holds (its init score is
    # folded into the first tree's leaves, so they may differ from the
    # in-memory booster's in the last ulp)
    init = Booster.from_string(text).raw_margin(X, device="cpu")[:, 0]
    jinit = type(m_j.booster).from_string(m_j.get_model_string()).raw_margin(X)[:, 0]
    by_col, by_col_j = _estimators(ref, initScoreCol="init")
    ct = by_col.fit(Table({"features": X, "label": y, "init": init})).booster
    cj = by_col_j.fit(ref["Table"]({"features": X, "label": y, "init": jinit})).booster
    _same_trees(ct, cj)
    assert ct.model_to_string() == dt.model_to_string()


def test_validation_indicator_col_matches_jax(ref):
    X, y = _case(seed=81, n=1800)
    flag = np.random.default_rng(2).uniform(size=len(y)) < 0.3
    params = dict(validationIndicatorCol="is_valid", metric="binary_logloss",
                  earlyStoppingRound=2, numIterations=12, baggingFraction=0.8, baggingFreq=2,
                  featureFraction=0.8, isProvideTrainingMetric=True)
    est_t, est_j = _estimators(ref, **params)
    mt = est_t.fit(Table({"features": X, "label": y, "is_valid": flag}))
    mj = est_j.fit(ref["Table"]({"features": X, "label": y, "is_valid": flag}))
    _same_trees(mt.booster, mj.booster)
    _same_evals(mt._train_evals, mj._train_evals)
    assert set(mt._train_evals) == {"valid_0", "training"}
    assert mt.booster.best_iteration == mj.booster.best_iteration
    assert len(mt._train_evals["valid_0"]["binary_logloss"]) == mt.booster.num_iterations
    # the flagged rows are held out; the root covers the first bag only
    assert mt.booster.cover[0][0] == round(int((~flag).sum()) * 0.8)
    assert len(mt.fit_stats.per_iteration) == mt.booster.num_iterations


def test_estimator_delegates_reach_the_fit():
    X, y = _case(seed=83, n=800)
    seen = []

    class Record(tcb.TrainingCallback):
        def after_iteration(self, env):
            seen.append((env.iteration, env.learning_rate))

    est = LightGBMClassifier(device="cpu", numIterations=3, numLeaves=7, maxBin=31)
    est.set_delegate(Record(), tcb.LearningRateSchedule([0.3, 0.2, 0.1]))
    est.fit(Table({"features": X, "label": y}))
    assert [it for it, _ in seen] == [0, 1, 2]
    np.testing.assert_allclose([lr for _, lr in seen], [0.3, 0.2, 0.1], rtol=1e-7)


# -- the out-of-memory ladder, categoricals and bundles --------------------------


def test_oom_retry_reuses_the_iterations_bag_and_mask(ref):
    """A retried iteration runs with the bag, feature mask and learning rate
    of its first attempt: the degraded fit writes the clean fit's model
    text, and that text is the reference's tree for tree."""
    X, y = _case(seed=91)
    b = _bins(ref, X)
    opts = ttrain.TrainOptions(**{**BASE, "objective": "binary", "histogram_method": "u",
                                  "use_quantized_grad": True, "bagging_fraction": 0.6,
                                  "bagging_freq": 1, "feature_fraction": 0.6})
    clean = ttrain.train(b["bt"], y, opts, mapper=b["mt"], device="cpu")
    fault = FaultPlan()
    for it, attempt in ((2, 0), (2, 1), (4, 0)):
        fault.oom_task(it, kind="device", attempt=attempt)
    with inject_faults(fault):
        degraded = ttrain.train(b["bt"], y, opts, mapper=b["mt"], device="cpu")
    assert fault.fired == [("oom_device", 2, 0), ("oom_device", 2, 1), ("oom_device", 4, 0)]
    assert degraded.stats.oom_retries == 3
    assert degraded.stats.histogram_path == "u_chunked"
    assert degraded.booster.model_to_string() == clean.booster.model_to_string()
    jb = ref["train"].train(b["bj"], y, ref["train"].TrainOptions(**dataclasses.asdict(opts)),
                            mapper=b["mj"]).booster
    _same_trees(degraded.booster, jb)


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


@pytest.mark.parametrize("kind", ["categorical", "bundled"])
@pytest.mark.parametrize("path", ["compare", "u_quant"])
def test_valid_routing_on_categorical_and_bundled_fits(ref, kind, path):
    kw = dict(histogram_method="u", use_quantized_grad=True) if path == "u_quant" else {}
    if kind == "categorical":
        # min_data_per_group at its default leaves some categories out of the
        # sorted-set search, so no mirrored pair of candidates ties (see
        # test_mirrored_categorical_split_is_a_float_tie)
        X, y = _cat_case(seed=101)
        bin_kw = dict(categorical_features=[0, 1])
        kw["min_data_per_group"] = 100
    else:
        X, y = _one_hot_case(seed=103)
        bin_kw = dict(feature_bundling=True)
    Xt, yt, Xv, yv = X[:1200], y[:1200], X[1200:], y[1200:]
    rt, rj = _fit_both(ref, Xt, yt, Xv, yv, bin_kw=bin_kw, metric="binary_logloss",
                       cat_smooth=5.0, feature_fraction=0.8, **kw)
    if kind == "categorical":
        assert rt.booster.has_categorical
    else:
        assert tbinning.bin_dataset(Xt, max_bin=31, **bin_kw)[1].bundles is not None
    _same_trees(rt.booster, rj.booster)
    _same_evals(rt.evals, rj.evals)
    # the routed valid margins are the booster's own predictions
    want = tobj.binary_logloss(yv, rt.booster.raw_margin(Xv, device="cpu")[:, 0],
                               np.ones(len(yv)))
    assert rt.evals["v"]["binary_logloss"][-1] == pytest.approx(want, rel=1e-6)


def test_mirrored_categorical_split_is_a_float_tie(ref):
    """A known departure, pinned. Where every category of a node passes
    min_data_per_group, the sorted-set search scores a left set in
    ascending order and its complement in descending order: the same
    partition, mirrored, with the same gain in exact arithmetic. Which
    direction wins is float32 rounding of the two prefix sums, and the
    packages sum in different orders. Here (12 categories of about 100
    rows, min_data_per_group 20) they pick mirrored sets at the first
    categorical split: same partition, children in swapped slots."""
    X, y = _cat_case(seed=102)
    rt, rj = _fit_both(ref, X[:1200], y[:1200], bin_kw=dict(categorical_features=[0, 1]),
                       min_data_per_group=20, cat_smooth=5.0)
    tb, jb = rt.booster, rj.booster
    t, node = 0, 1
    assert tb.cat_nodes[t][node] and jb.cat_nodes[t][node]
    left_t = set(np.nonzero(tb.cat_masks[t][node])[0].tolist())
    left_j = set(np.nonzero(np.asarray(jb.cat_masks[t][node]))[0].tolist())
    assert left_t.isdisjoint(left_j) and left_t | left_j == set(range(1, 13))
    assert tb.split_gain[t][node] == pytest.approx(jb.split_gain[t][node], rel=1e-6)
    lt, rt_ = tb.left_child[t][node], tb.right_child[t][node]
    lj, rj_ = jb.left_child[t][node], jb.right_child[t][node]
    assert tb.cover[t][lt] == jb.cover[t][rj_] and tb.cover[t][rt_] == jb.cover[t][lj]


# -- byte-identical quantized model text ----------------------------------------


@pytest.mark.parametrize("max_bin", [15, 31, 63, 255])
@pytest.mark.parametrize("seed,n,extra", [
    (0, 1400, {}), (1, 1400, dict(bagging_fraction=0.7, bagging_freq=2, feature_fraction=0.8)),
    (3, 6000, {}), (5, 6000, dict(bagging_fraction=0.7, bagging_freq=2, feature_fraction=0.8)),
])
def test_quantized_model_text_is_the_references(ref, seed, n, extra, max_bin):
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


# -- what check_supported and train refuse ---------------------------------------


def test_new_options_are_accepted():
    ttrain.check_supported(ttrain.TrainOptions(
        bagging_fraction=0.5, bagging_freq=1, pos_bagging_fraction=0.5,
        neg_bagging_fraction=0.5, feature_fraction=0.5, early_stopping_round=3,
        provide_training_metric=True))


@pytest.mark.parametrize("name,value", [("tree_learner", "feature_parallel"),
                                        ("histogram_method", "onehot"),
                                        ("tree_learner", "voting_parallel")])
def test_unported_options_still_raise(name, value):
    """histogram_method 'onehot' is taken now (the compare-built pass: the
    default's text) and an unknown method raises the reference's
    ValueError; the tree learners are taken, and voting still refuses
    bundling with the reference's error."""
    opts = ttrain.TrainOptions(**{name: value})
    if name != "tree_learner":
        ttrain.check_supported(opts)
        with pytest.raises(ValueError, match="unknown histogram method"):
            ttrain.check_supported(ttrain.TrainOptions(**{name: "bogus"}))
        X, y = _case(seed=5, n=300)
        bins, mapper = tbinning.bin_dataset(X, max_bin=31)
        texts = [ttrain.train(bins, y, dataclasses.replace(o, num_iterations=2), mapper=mapper,
                              device="cpu").booster.model_to_string()
                 for o in (opts, ttrain.TrainOptions())]
        assert texts[0] == texts[1]
        return
    ttrain.check_supported(opts)
    X, y = _case(seed=5, n=300)
    X[:, 4:] = np.where(np.arange(300)[:, None] % 2 == np.arange(2)[None, :], 0.0, 1.0)
    bins, mapper = tbinning.bin_dataset(X, max_bin=31, feature_bundling=True)
    if value == "voting_parallel":
        with pytest.raises(ValueError, match="voting"):
            ttrain.train(bins, y, dataclasses.replace(opts, num_iterations=1), mapper=mapper,
                         device="cpu")
    else:
        res = ttrain.train(bins, y, dataclasses.replace(opts, num_iterations=1),
                           mapper=mapper, device="cpu")
        assert res.booster.num_trees == 1


@pytest.mark.parametrize("method", ["segment", "onehot", "panel"])
def test_reference_histogram_methods_take_the_compare_built_pass(ref, method):
    """The reference's other ``histogram_method`` values: the port's text
    is the default's byte for byte, and within ``model_texts_close`` of
    the reference's fit with the same value."""
    from mmlspark_tpu.lightgbm.procfit import model_texts_close

    X, y = _case(seed=21, n=1200)
    w = np.random.default_rng(21).uniform(0.5, 2.0, len(y))
    b = _bins(ref, X)
    kw = {**BASE, "objective": "binary"}
    port = ttrain.train(b["bt"], y, ttrain.TrainOptions(**kw, histogram_method=method), w=w,
                        mapper=b["mt"], device="cpu").booster.model_to_string()
    default = ttrain.train(b["bt"], y, ttrain.TrainOptions(**kw), w=w, mapper=b["mt"],
                           device="cpu").booster.model_to_string()
    want = ref["train"].train(b["bj"], y, ref["train"].TrainOptions(**kw, histogram_method=method),
                              w=w, mapper=b["mj"]).booster.model_to_string()
    assert port == default
    assert model_texts_close(port, want)


def test_pos_neg_bagging_needs_the_binary_objective():
    X, y = _case(seed=7, n=200, objective="regression")
    bins, mapper = tbinning.bin_dataset(X, max_bin=31)
    with pytest.raises(ValueError, match="binary"):
        ttrain.train(bins, y, ttrain.TrainOptions(objective="regression", bagging_freq=1,
                                                  pos_bagging_fraction=0.5),
                     mapper=mapper, device="cpu")


def test_unported_metric_is_refused_with_a_valid_set():
    X, y = _case(seed=9, n=300)
    bins, mapper = tbinning.bin_dataset(X, max_bin=31)
    with pytest.raises(NotImplementedError, match="ndcg"):
        ttrain.train(bins, y, ttrain.TrainOptions(num_iterations=1, metric="ndcg"),
                     mapper=mapper, valid_sets=[("v", bins, y, None)], device="cpu")
