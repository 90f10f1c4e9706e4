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

import numpy as np
import pytest

from mmlspark_tpu_torch.data.table import Table
from mmlspark_tpu_torch.lightgbm import LightGBMClassifier
from mmlspark_tpu_torch.lightgbm import callbacks as tcb
from mmlspark_tpu_torch.lightgbm import objectives as tobj
from mmlspark_tpu_torch.lightgbm import train as ttrain
from mmlspark_tpu_torch.lightgbm.booster import Booster

from _torch_train_options_cases import (
    BASE, METRIC_NAMES, SCHEDULES, _bins, _case, _estimators, _fit_both, _same_evals,
    _same_trees, _stopper,
)
from _torch_train_options_cases import _time_limit, ref  # noqa: F401  (fixtures)


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
