"""Validation-set evaluation histories against the JAX package, split off
``tests/test_torch_train_options.py`` so the test workers can run the files
side by side. Tolerances as in that file.
"""

import pytest

from _torch_train_options_cases import BASE, _case, _fit_both, _same_evals, _same_trees
from _torch_train_options_cases import _time_limit, ref  # noqa: F401  (fixtures)


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
