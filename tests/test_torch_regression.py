"""The port's regression objectives, percentile leaf renewal,
LightGBMRegressor and maxBinByFeature against the JAX package.

Inputs come from numpy seeds and go through both packages on the CPU: the
port with ``device='cpu'`` (its kernels' plain versions), the JAX package as
its own CPU tests run it. Tolerances: gradients and hessians of every
objective bit for bit against the compiled reference (XLA's CPU ``exp`` and
its fused multiply-adds are copied), renewal's leaves bit for bit against
the reference's step, quantized model text byte for byte (l2, l1, huber,
quantile, poisson and tweedie alike), default-path leaves and predictions
within 1e-5 relative (the two packages sum float histograms in other
orders). Fit data carry row weights and heavy-tailed noise; fits set
``min_gain_to_split`` 1e-3 (see ``tests/test_torch_boosting.py``).
"""

import numpy as np
import pytest
import torch

from mmlspark_tpu_torch.data.table import Table
from mmlspark_tpu_torch.lightgbm import LightGBMRegressor
from mmlspark_tpu_torch.lightgbm import binning as tbinning
from mmlspark_tpu_torch.lightgbm import objectives as tobj
from mmlspark_tpu_torch.lightgbm import train as ttrain
from mmlspark_tpu_torch.ops import hopper_histogram as hh

from _torch_regression_cases import OBJECTIVES, QUANT, _case, _fit_both, _margins, _same_trees
from _torch_regression_cases import ref, reference_renewal  # noqa: F401  (fixtures)


@pytest.mark.parametrize("objective,kw", [
    ("regression", {}), ("regression_l1", {}), ("huber", {}), ("huber", dict(alpha=2.5)),
    ("quantile", {}), ("quantile", dict(alpha=0.1)), ("poisson", {}), ("tweedie", {}),
    ("tweedie", dict(tweedie_variance_power=1.1)), ("tweedie", dict(tweedie_variance_power=1.9)),
])
def test_gradients_are_the_references_bit_for_bit(ref, objective, kw):
    """poisson and tweedie take XLA's CPU exp on arguments of either sign;
    tweedie's g and h are the fused multiply-adds XLA compiles."""
    jax = ref["jax"]
    n = 20_000
    m = _margins(n, 1)
    rng = np.random.default_rng(2)
    y = np.where(rng.random(n) < 0.3, 0.0, rng.gamma(2.0, 3.0, n)).astype(np.float32)
    y[:1000] = m[:1000, 0]  # d = 0 exactly: sign 0, quantile's d >= 0 branch
    w = rng.uniform(0.5, 2.0, n).astype(np.float32)
    jo, to = ref["obj"].get_objective(objective), tobj.get_objective(objective)
    jg, jh = jax.jit(lambda a, b, c: jo.grad_hess(a, b, c, **kw))(m, y, w)
    tg, th = to.grad_hess(torch.from_numpy(m), torch.from_numpy(y), torch.from_numpy(w), **kw)
    # tweedie's e^((1-rho) m) overflows at the largest |m|: NaN where both give NaN
    assert np.array_equal(tg.numpy(), np.asarray(jg), equal_nan=True)
    assert np.array_equal(th.numpy(), np.asarray(jh), equal_nan=True)
    np.testing.assert_array_equal(to.init_score(y, 1, w), jo.init_score(y, 1, w))
    assert to.default_metric == jo.default_metric


def test_xla_exp_is_the_references_exp_on_the_full_range(ref):
    jax = ref["jax"]
    x = np.concatenate([np.linspace(-100.0, 100.0, 400_001),
                        np.random.default_rng(3).normal(size=100_000) * 30]).astype(np.float32)
    want = np.asarray(jax.jit(ref["jnp"].exp)(x))
    got = tobj.xla_exp(torch.from_numpy(x)).numpy()
    assert np.array_equal(got, want)
    assert np.isinf(got[x > 88.8]).all() and np.isfinite(got[x < 88.7]).all()


@pytest.mark.parametrize("alias,name", [("l1", "regression_l1"), ("mae", "regression_l1"),
                                        ("l2", "regression"), ("mse", "regression")])
def test_aliases(ref, alias, name):
    assert tobj.get_objective(alias).name == name == ref["obj"].get_objective(alias).name


def test_unknown_objective_names_the_ported_ones():
    with pytest.raises(ValueError, match="tweedie") as err:
        tobj.get_objective("xentropy")
    assert "quantile" in str(err.value) and "lambdarank" in str(err.value)
    with pytest.raises(ValueError, match="huber"):
        ttrain.check_supported(ttrain.TrainOptions(objective="lambdarank"))


@pytest.mark.parametrize("metric", ["poisson", "tweedie"])
def test_poisson_and_tweedie_metrics(ref, metric):
    rng = np.random.default_rng(5)
    y, m, w = rng.poisson(2.0, 500).astype(float), rng.normal(size=(500, 1)), np.ones(500)
    for name in (metric, "l2", "rmse", "l1"):
        got = ttrain._evaluate(name, metric, y, m, w, 0.9)
        assert got == ref["train"]._evaluate(name, metric, y, m, w, 0.9)
    assert np.array_equal(ttrain._margin_to_score(m, "l2", metric), np.exp(m[:, 0]))
    assert tobj.metric_higher_is_better(metric) is False


@pytest.mark.parametrize("n", [1, 16, 17, 300, 4097, 70_000])
@pytest.mark.parametrize("pct", [0.5, 0.9, 0.1])
def test_renewal_is_the_references_bit_for_bit(reference_renewal, n, pct):
    """Fractional weights (some zero, as bagged-out rows), tied residuals and
    empty leaf slots; the global prefix sum adds in XLA's CPU order."""
    rng = np.random.default_rng(n)
    leaf = (rng.integers(0, 16, n) * 2).astype(np.int32)  # odd slots stay empty
    resid = np.round(rng.normal(size=n) * 3, 1).astype(np.float32)
    w = (rng.uniform(0.5, 2.0, n) * (rng.random(n) < 0.8)).astype(np.float32)
    lv = rng.normal(size=31).astype(np.float32)
    want = np.asarray(reference_renewal(lv, leaf, resid, w, np.float32(pct), np.float32(0.1)))
    got = ttrain.renew_leaves(*map(torch.from_numpy, (lv, leaf, resid, w)), pct, 0.1)
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("n", [5, 16, 255, 256, 257, 4096, 100_003])
def test_xla_cumsum_adds_in_the_references_order(ref, n):
    x = np.random.default_rng(n).uniform(0.5, 2.0, n).astype(np.float32)
    want = np.asarray(ref["jax"].jit(ref["jnp"].cumsum)(x))
    assert np.array_equal(ttrain.xla_cumsum(torch.from_numpy(x)).numpy(), want)


# -- fits -----------------------------------------------------------------------------


@pytest.mark.parametrize("objective", ["regression_l1", "huber", "tweedie"])
def test_default_path_fit_matches_jax(ref, objective):
    """quantile and poisson default-path fits are held to the reference
    through the estimator (``test_regressor_transform_matches_jax``), l2 in
    ``tests/test_torch_gbdt.py``."""
    X, y, w = _case(4, objective)
    rt, rj = _fit_both(ref, X, y, w, 63, objective=objective)
    _same_trees(rt.booster, rj.booster)
    jm = np.asarray(rj.booster.raw_margin(X))
    np.testing.assert_allclose(rt.booster.raw_margin(X, device="cpu"), jm, rtol=1e-5,
                               atol=1e-5 * np.abs(jm).max())
    assert (rt.stats.renewal_seconds > 0) == (objective in ("regression_l1", "quantile"))


@pytest.mark.parametrize("objective,mode", [
    ("regression_l1", dict(bagging_fraction=0.7, bagging_freq=1)),
    ("quantile", dict(boosting_type="goss", top_rate=0.3, other_rate=0.2)),
    ("regression_l1", dict(boosting_type="dart", drop_rate=0.5)),
    ("quantile", dict(boosting_type="rf", bagging_fraction=0.7, bagging_freq=1)),
], ids=["l1-bagging", "quantile-goss", "l1-dart", "quantile-rf"])
def test_renewal_under_bagging_goss_dart_and_rf(ref, objective, mode):
    """Renewal weighs rows by ``w * bag`` (GOSS weights included) and runs
    before the margin update, wherever the reference's step applies it:
    quantized text byte for byte."""
    X, y, w = _case(5, objective, n=1500)
    rt, rj = _fit_both(ref, X, y, w, 31, objective=objective, alpha=0.3, **QUANT, **mode)
    assert rt.booster.model_to_string() == rj.booster.model_to_string()


def test_quantile_fit_reaches_its_percentile():
    """Renewed leaves put about alpha of the targets below the prediction
    (gradient leaves alone move margins by at most ~lr a round)."""
    X, y, _ = _case(6, "quantile", n=2000)
    bt, mt = tbinning.bin_dataset(X, max_bin=31)
    for alpha in (0.2, 0.8):
        res = ttrain.train(bt, y, ttrain.TrainOptions(objective="quantile", alpha=alpha,
                                                      num_iterations=25, num_leaves=7,
                                                      max_bin=31), mapper=mt, device="cpu")
        share = float(np.mean(y <= res.booster.raw_margin(X, device="cpu")[:, 0]))
        assert abs(share - alpha) < 0.05, (alpha, share)


# -- the estimator and maxBinByFeature ------------------------------------------------


@pytest.mark.parametrize("objective", ["quantile", "poisson"])
def test_regressor_transform_matches_jax(ref, objective):
    """The prediction column, on the response scale (exp of the margin) for
    poisson and tweedie; alpha and the tweedie power reach the fit."""
    X, y, w = _case(7, objective, n=1500)
    params = dict(objective=objective, alpha=0.7, tweedieVariancePower=1.7, numIterations=5,
                  numLeaves=15, maxBin=31, learningRate=0.2, minGainToSplit=1e-3,
                  weightCol="w")
    tm = LightGBMRegressor(device="cpu", **params).fit(Table({"features": X, "label": y, "w": w}))
    jm = ref["Regressor"](parallelism="serial", **params).fit(
        ref["Table"]({"features": X, "label": y, "w": w}))
    got = tm.transform(Table({"features": X}))["prediction"]
    want = np.asarray(jm.transform(ref["Table"]({"features": X}))["prediction"])
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())
    assert got.dtype == np.float64
    if objective == "poisson":
        assert (got > 0).all()
    _same_trees(tm.booster, jm.booster)


def test_regressor_param_surface():
    r = LightGBMRegressor(objective="mae", alpha=0.3, tweedieVariancePower=1.2)
    opts = r._make_options()
    assert (opts.objective, opts.alpha, opts.tweedie_variance_power) == ("mae", 0.3, 1.2)
    with pytest.raises(ValueError):
        LightGBMRegressor(objective="lambdarank")


def test_max_bin_by_feature_bins_as_the_reference(ref):
    X, _, _ = _case(8, "regression", n=3000, f=5)
    X[:, 4] = np.round(X[:, 4])  # few distinct values: one bin each
    caps = [2, 7, 63, 16, 5]
    bt, mt = tbinning.bin_dataset(X, max_bin=63, max_bin_by_feature=caps)
    bj, mj = ref["binning"].bin_dataset(X, max_bin=63, max_bin_by_feature=caps)
    assert np.array_equal(bt, np.asarray(bj))
    assert np.array_equal(mt.edges, mj.edges) and np.array_equal(mt.num_bins, mj.num_bins)
    assert (mt.num_bins <= np.array(caps) + 1).all()


@pytest.mark.parametrize("caps,match", [([15, 15, 15], "entries for 4 features"),
                                        ([1, 15, 15, 15], r"\[2, maxBin=31\]"),
                                        ([15, 15, 64, 15], r"\[2, maxBin=31\]")])
def test_max_bin_by_feature_range_errors(ref, caps, match):
    X = np.random.default_rng(9).normal(size=(200, 4))
    with pytest.raises(ValueError, match=match):
        tbinning.bin_dataset(X, max_bin=31, max_bin_by_feature=caps)
    with pytest.raises(ValueError, match=match):
        ref["binning"].bin_dataset(X, max_bin=31, max_bin_by_feature=caps)


def test_max_bin_by_feature_fit_matches_jax(ref):
    X, y, w = _case(10, "regression", n=1500, f=6)
    params = dict(maxBinByFeature=[7, 7, 31, 31, 15, 3], numIterations=4, numLeaves=15,
                  maxBin=31, minGainToSplit=1e-3, weightCol="w")
    table = dict(features=X, label=y, w=w)
    tm = LightGBMRegressor(device="cpu", **params).fit(Table(table))
    jm = ref["Regressor"](parallelism="serial", **params).fit(ref["Table"](table))
    _same_trees(tm.booster, jm.booster)
    assert np.array_equal(tm.booster.bin_edges, jm.booster.bin_edges)


# -- the card -----------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("objective", OBJECTIVES)
def test_histogram_kernel_on_the_objectives_stats_on_card(objective):
    """histogram.cu on iteration 0's stats of each objective (poisson and
    tweedie hessians over orders of magnitude, l1 and quantile's +-w): bit
    for bit its plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the kernel has no CPU mode")
    dev = torch.device("cuda")
    X, y, w = _case(11, objective, n=200_003, f=12)
    bins, _ = tbinning.bin_dataset(X, max_bin=255)
    bins_t = torch.from_numpy(bins).to(dev).t().contiguous()
    obj = tobj.get_objective(objective)
    yd, wd = (torch.from_numpy(a.astype(np.float32)).to(dev) for a in (y, w))
    init = float(obj.init_score(y.astype(np.float32), 1, w.astype(np.float32))[0])
    g, h = obj.grad_hess(torch.full((len(y), 1), init, device=dev), yd, wd)
    node = torch.from_numpy(np.random.default_rng(0).integers(0, 9, len(y)).astype(np.int32))
    args = (bins_t, g[:, 0].contiguous(), h[:, 0].contiguous(), torch.ones_like(yd),
            node.to(dev), 8, 256)
    torch.testing.assert_close(hh.build_histograms_cuda(*args), hh.build_histograms_plain(*args),
                               rtol=0, atol=0)
