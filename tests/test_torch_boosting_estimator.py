"""Carried boosters, multiclass early stopping and the multiclass estimator
against the JAX package, split off ``tests/test_torch_boosting.py`` so the
test workers can run the files side by side. Tolerances as in that file.
"""

import numpy as np
import pytest

from mmlspark_tpu_torch.data.table import Table
from mmlspark_tpu_torch.lightgbm.booster import Booster
from mmlspark_tpu_torch.lightgbm.convert import booster_from_jax

from _torch_boosting_cases import _case, _estimators, _fit_both, _opts, _same_trees
from _torch_boosting_cases import _time_limit, ref  # noqa: F401  (fixtures)


def test_multiclass_early_stopping_matches_jax(ref):
    X, y, w = _case(seed=40, num_class=3, n=2400)
    kw = _opts(3, num_iterations=30, learning_rate=0.5, metric="multi_logloss",
               early_stopping_round=2)
    rt, rj, _, _ = _fit_both(ref, X[:1600], y[:1600], w[:1600], valid=(X[1600:], y[1600:]),
                             **kw)
    hist_t, hist_j = rt.evals["v"]["multi_logloss"], rj.evals["v"]["multi_logloss"]
    assert len(hist_t) == len(hist_j) < 30  # stopped early
    np.testing.assert_allclose(hist_t, hist_j, rtol=1e-6)
    assert rt.best_iteration == rj.best_iteration < len(hist_t)
    assert rt.booster.best_iteration == rj.booster.best_iteration
    _same_trees(rt.booster, rj.booster)


def test_estimator_multiclass_validation_and_init_scores_match_jax(ref):
    """validationIndicatorCol with multi_logloss, then a warm start from an
    initScoreCol of C columns."""
    X, y, _ = _case(seed=130, num_class=3, n=2400)
    flag = np.random.default_rng(3).uniform(size=len(y)) < 0.3
    params = dict(validationIndicatorCol="is_valid", metric="multi_logloss",
                  earlyStoppingRound=2, numIterations=8)
    est_t, est_j = _estimators(ref, **params)
    mt = est_t.fit(Table({"features": X, "label": y, "is_valid": flag}))
    mj = est_j.fit(ref["Table"]({"features": X, "label": y, "is_valid": flag}))
    _same_trees(mt.booster, mj.booster)
    np.testing.assert_allclose(mt._train_evals["valid_0"]["multi_logloss"],
                               mj._train_evals["valid_0"]["multi_logloss"], rtol=1e-6)
    init = mt.booster.raw_margin(X, device="cpu")
    assert init.shape == (len(y), 3)
    warm_t, warm_j = _estimators(ref, initScoreCol="init")
    dt = warm_t.fit(Table({"features": X, "label": y, "init": init})).booster
    dj = warm_j.fit(ref["Table"]({"features": X, "label": y, "init": init})).booster
    np.testing.assert_array_equal(dt.init_score, np.zeros(3, np.float32))
    _same_trees(dt, dj)


@pytest.mark.parametrize("kind", ["multiclass", "rf", "dart", "depthwise"])
def test_carried_booster_predicts_as_jax(ref, kind):
    num_class = 3 if kind in ("multiclass", "dart") else 2
    kw = dict(multiclass={}, rf=dict(boosting_type="rf", bagging_fraction=0.7, bagging_freq=1),
              dart=dict(boosting_type="dart", drop_rate=0.3),
              depthwise=dict(growth="depthwise", max_depth=5))[kind]
    X, y, w = _case(seed=140, num_class=num_class, n=1500)
    bj, mj = ref["binning"].bin_dataset(X, max_bin=31)
    jb = ref["train"].train(bj, y, ref["train"].TrainOptions(**_opts(num_class, **kw)), w=w,
                            mapper=mj).booster
    tb = booster_from_jax(jb.to_dict())
    np.testing.assert_allclose(tb.raw_margin(X, device="cpu"), np.asarray(jb.raw_margin(X)),
                               atol=1e-6)
    assert tb.model_to_string() == jb.model_to_string()
    back = Booster.from_string(tb.model_to_string())
    np.testing.assert_allclose(back.raw_margin(X, device="cpu"), tb.raw_margin(X, device="cpu"),
                               atol=1e-5)
