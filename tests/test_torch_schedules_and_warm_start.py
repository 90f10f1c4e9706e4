"""Learning-rate schedules, warm starts from init margins and early stopping
against the JAX package, split off ``tests/test_torch_train_options.py`` so
the test workers can run the files side by side. Tolerances as in that
file.
"""

import numpy as np
import pytest

from mmlspark_tpu_torch.lightgbm import train as ttrain

from _torch_train_options_cases import (
    BASE, _bins, _case, _fit_both, _same_evals, _same_trees, _schedule,
)
from _torch_train_options_cases import _time_limit, ref  # noqa: F401  (fixtures)


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


@pytest.mark.parametrize("kind", ["list", "callable"])
@pytest.mark.parametrize("path", ["compare", "u_quant"])
def test_lr_schedule_matches_jax(ref, kind, path):
    X, y = _case(seed=51)
    kw = dict(histogram_method="u", use_quantized_grad=True) if path == "u_quant" else {}
    rt, rj = _fit_both(ref, X, y, callbacks=[_schedule(kind)], **kw)
    _same_trees(rt.booster, rj.booster)
    plain, _ = _fit_both(ref, X, y, **kw)
    assert not np.allclose(plain.booster.leaf_values, rt.booster.leaf_values)


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
