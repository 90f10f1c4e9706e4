"""The port's leaf-index and SHAP output, and linear-tree predict, against
the JAX package; and the new modules' isolation from it.

Boosters are fitted once per module by the reference (binary, 3-class and
categorical, on the CPU) and carried into the port with
``convert.booster_from_jax``, so both packages explain the same trees.
Tolerances: leaf slots exactly; SHAP values within 1e-9 (float64 in both,
the same recursion); SHAP adds up to the port's float32 margin within 1e-5;
linear-tree margins exactly (the leaf models run in float64 on the host in
the reference's order of operations).
"""

import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from mmlspark_tpu_torch.data.table import Table
from mmlspark_tpu_torch.lightgbm import LightGBMClassifier, LightGBMRanker, LightGBMRegressor
from mmlspark_tpu_torch.lightgbm.booster import Booster
from mmlspark_tpu_torch.lightgbm.convert import booster_from_jax
from mmlspark_tpu_torch.lightgbm.shap import tree_shap


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


try:
    _import_reference()
except ModuleNotFoundError as err:
    if err.name != "jax":
        raise

REPO = pathlib.Path(__file__).resolve().parents[1]
KINDS = ("binary", "multiclass", "categorical")

# Two splits (f0 <= 0.5, then f1 <= -1) and three linear leaves: leaf 0 = 1 +
# 0.5 f0, leaf 1 = 2 + f0 - f1, leaf 2 = 3 (no features); the fixture of
# tests/test_model_text.py::TestLinearTrees, as a literal.
LINEAR_MODEL = """tree
version=v3
num_class=1
num_tree_per_iteration=1
label_index=0
max_feature_idx=1
objective=regression
feature_names=f0 f1
feature_infos=[-10:10] [-10:10]
tree_sizes=300

Tree=0
num_leaves=3
num_cat=0
split_feature=0 1
split_gain=5 3
threshold=0.5 -1
decision_type=10 8
left_child=1 -1
right_child=-3 -2
leaf_value=10 20 30
leaf_weight=4 3 3
leaf_count=4 3 3
internal_value=0 0
internal_weight=10 7
internal_count=10 7
is_linear=1
leaf_const=1 2 3
num_features=1 2 0
leaf_features=0 0 1
leaf_coeff=0.5 1 -1
shrinkage=1


end of trees

feature_importances:
f0=1
f1=1

parameters:
end of parameters

pandas_categorical:null
"""


def _case(kind, seed=0, n=1200, f=6):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, f))
    if kind == "categorical":
        X[:, 0] = rng.integers(0, 9, n)
        s = np.where(np.isin(X[:, 0], [1, 4, 7]), 1.5, -1.0) + X[:, 1] + rng.normal(size=n)
        y = (s > 0).astype(float)
    elif kind == "multiclass":
        s = np.stack([X[:, 0] + X[:, 1], X[:, 2] - X[:, 0], X[:, 3] * X[:, 4]], 1)
        y = (s + rng.normal(size=s.shape)).argmax(1).astype(float)
    else:
        y = ((X[:, 0] + X[:, 1] * X[:, 2] + rng.normal(size=n)) > 0).astype(float)
    return X, y, rng.uniform(0.5, 2.0, n)


@pytest.fixture(scope="module")
def fitted():
    """kind -> (reference booster, port booster, query rows with NaNs and
    unseen categories)."""
    import mmlspark_tpu.lightgbm.binning as jbinning
    import mmlspark_tpu.lightgbm.train as jtrain

    out = {}
    for kind in KINDS:
        X, y, w = _case(kind)
        cats = [0] if kind == "categorical" else None
        bins, mapper = jbinning.bin_dataset(X, max_bin=31, categorical_features=cats)
        extra = dict(objective="multiclass", num_class=3) if kind == "multiclass" else {}
        opts = jtrain.TrainOptions(num_iterations=4, num_leaves=15, max_bin=31,
                                   min_gain_to_split=1e-3, min_data_per_group=20, **extra)
        jb = jtrain.train(bins, y, opts, w=w, mapper=mapper).booster
        Xq = _case(kind, seed=1, n=400)[0]
        Xq[::5, 1] = np.nan
        if kind == "categorical":
            Xq[::7, 0] = 99.0  # a category the fit never saw: routes right
        out[kind] = (jb, booster_from_jax(jb.to_dict()), Xq)
    return out


# -- leaf slots -----------------------------------------------------------------------


@pytest.mark.parametrize("kind", KINDS)
def test_predict_leaf_matches_jax(fitted, kind):
    jb, tb, Xq = fitted[kind]
    got = tb.predict_leaf(Xq, device="cpu")
    want = np.asarray(jb.predict_leaf(Xq))
    assert got.dtype == np.int32 and got.shape == (len(Xq), tb.num_trees)
    assert np.array_equal(got, want)
    assert tb.is_leaf[np.arange(tb.num_trees)[None, :], got].all()


def test_predict_leaf_honours_num_iteration(fitted):
    jb, tb, Xq = fitted["multiclass"]
    got = tb.predict_leaf(Xq, num_iteration=2, device="cpu")
    assert got.shape == (len(Xq), 6)
    assert np.array_equal(got, np.asarray(jb.predict_leaf(Xq, num_iteration=2)))


# -- SHAP -------------------------------------------------------------------------------


@pytest.mark.parametrize("kind", KINDS)
def test_shap_matches_jax(fitted, kind):
    from mmlspark_tpu.lightgbm.shap import tree_shap as jax_tree_shap

    jb, tb, Xq = fitted[kind]
    got = tb.features_shap(Xq, device="cpu")
    want = jax_tree_shap(jb, np.asarray(Xq, np.float64))
    assert got.dtype == np.float64 and got.shape == (len(Xq), tb.num_classes, Xq.shape[1] + 1)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-9)


@pytest.mark.parametrize("kind", KINDS)
def test_shap_adds_up_to_the_margin(fitted, kind):
    _, tb, Xq = fitted[kind]
    shap = tb.features_shap(Xq, device="cpu")
    np.testing.assert_allclose(shap.sum(-1), tb.raw_margin(Xq, device="cpu"), rtol=0, atol=1e-5)


def test_shap_honours_num_iteration(fitted):
    jb, tb, Xq = fitted["binary"]
    got = tree_shap(tb, Xq, num_iteration=2, device="cpu")
    np.testing.assert_allclose(got.sum(-1), tb.raw_margin(Xq, num_iteration=2, device="cpu"),
                               atol=1e-5)


# -- the output columns -------------------------------------------------------------


def _estimator_case(kind):
    X, y, _ = _case("multiclass" if kind == "multiclass" else "binary", seed=2, n=600, f=5)
    if kind == "regressor":
        y = X[:, 0] * 3 + X[:, 1]
    return X, y


@pytest.mark.parametrize("kind", ["binary", "multiclass", "regressor", "ranker"])
def test_leaf_and_shap_columns(kind):
    """LightGBM's layouts: leaf slots (N, T) as float64; SHAP (N, C*(F+1)),
    per class the feature contributions then the bias."""
    X, y = _estimator_case(kind)
    common = dict(numIterations=3, numLeaves=7, maxBin=31, device="cpu",
                  leafPredictionCol="leaves", featuresShapCol="shap")
    table = {"features": X, "label": y}
    if kind == "regressor":
        model = LightGBMRegressor(**common).fit(Table(table))
    elif kind == "ranker":
        table["g"] = np.repeat(np.arange(60), 10)
        model = LightGBMRanker(groupCol="g", **common).fit(Table(table))
    else:
        model = LightGBMClassifier(**common).fit(Table(table))
    out = model.transform(Table({"features": X}))
    b = model.booster
    c, f = b.num_classes, X.shape[1]
    assert out["leaves"].dtype == np.float64 and out["leaves"].shape == (len(X), b.num_trees)
    assert np.array_equal(out["leaves"], b.predict_leaf(X, device="cpu").astype(np.float64))
    shap = out["shap"]
    assert shap.shape == (len(X), c * (f + 1))
    per_class = shap.reshape(len(X), c, f + 1)
    np.testing.assert_allclose(per_class.sum(-1), b.raw_margin(X, device="cpu"), atol=1e-5)
    np.testing.assert_array_equal(per_class, b.features_shap(X, device="cpu"))


def test_columns_stay_off_by_default():
    X, y = _estimator_case("binary")
    model = LightGBMClassifier(numIterations=2, numLeaves=4, device="cpu").fit(
        Table({"features": X, "label": y}))
    assert model.transform(Table({"features": X})).columns == [
        "features", "rawPrediction", "probability", "prediction"]


# -- linear trees ---------------------------------------------------------------------


def _linear_pair():
    from mmlspark_tpu.lightgbm.model_text import from_lightgbm_text

    return from_lightgbm_text(LINEAR_MODEL), Booster.from_string(LINEAR_MODEL)


def test_linear_leaf_outputs():
    _, b = _linear_pair()
    assert b.has_linear
    X = np.array([[0.0, -2.0], [4.0, -2.0], [0.25, 4.0], [1.0, 0.0]])
    np.testing.assert_allclose(b.raw_margin(X, device="cpu")[:, 0], [1.0, 3.0, -1.75, 3.0],
                               atol=1e-12)


def test_linear_predict_matches_jax_with_nans():
    """A leaf whose model reads a NaN feature gives its plain value; random
    rows with NaNs give the reference's margins exactly."""
    jb, tb = _linear_pair()
    rng = np.random.default_rng(13)
    X = rng.normal(size=(500, 2)) * 2
    X[rng.random(X.shape) < 0.15] = np.nan
    got = tb.raw_margin(X, device="cpu")
    assert np.array_equal(got, np.asarray(jb.raw_margin(X)))
    assert np.array_equal(tb.predict_leaf(X, device="cpu"), np.asarray(jb.predict_leaf(X)))
    np.testing.assert_allclose(tb.raw_margin(np.array([[np.nan, 0.0]]), device="cpu")[:, 0],
                               [20.0])


def test_linear_booster_converts_and_round_trips():
    jb, _ = _linear_pair()
    tb = booster_from_jax(jb.to_dict())
    X = np.array([[0.0, -2.0], [0.25, 4.0], [np.nan, 0.0]])
    assert np.array_equal(tb.raw_margin(X, device="cpu"), np.asarray(jb.raw_margin(X)))
    back = Booster.from_string(tb.model_to_string())
    assert np.array_equal(back.raw_margin(X, device="cpu"), tb.raw_margin(X, device="cpu"))
    assert np.array_equal(Booster.from_dict(tb.to_dict()).raw_margin(X, device="cpu"),
                          tb.raw_margin(X, device="cpu"))


def test_linear_booster_refuses_shap():
    _, tb = _linear_pair()
    with pytest.raises(NotImplementedError, match="linear-tree"):
        tb.features_shap(np.zeros((2, 2)), device="cpu")


# -- isolation ----------------------------------------------------------------------


@pytest.mark.parametrize("module", ["regressor", "ranker", "shap", "objectives", "binning"])
def test_new_module_loads_neither_jax_nor_the_jax_package(module):
    code = (
        f"import sys, mmlspark_tpu_torch.lightgbm.{module}\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'mmlspark_tpu.'))"
        " or m == 'mmlspark_tpu']\n"
        "assert not bad, bad\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    subprocess.run([sys.executable, "-c", code], check=True, env=env, cwd=str(REPO),
                   timeout=120)


# -- the card -----------------------------------------------------------------------


@pytest.mark.cuda
def test_explain_on_card_matches_the_cpu_port():
    """Leaf slots and linear margins equal the CPU port's exactly, SHAP
    within 1e-9 and adding up to the card's margin within 1e-5."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    X, y, _ = _case("categorical", seed=3, n=3000)
    model = LightGBMClassifier(numIterations=4, numLeaves=15, maxBin=31, device="cuda",
                               categoricalSlotIndexes=[0]).fit(Table({"features": X, "label": y}))
    b = model.booster
    assert np.array_equal(b.predict_leaf(X, device="cuda"), b.predict_leaf(X, device="cpu"))
    shap = b.features_shap(X, device="cuda")
    np.testing.assert_allclose(shap, b.features_shap(X, device="cpu"), rtol=0, atol=1e-9)
    np.testing.assert_allclose(shap.sum(-1), b.raw_margin(X, device="cuda"), atol=1e-5)
    lin = Booster.from_string(LINEAR_MODEL)
    Xl = np.random.default_rng(4).normal(size=(1000, 2))
    Xl[::3, 0] = np.nan
    assert np.array_equal(lin.raw_margin(Xl, device="cuda"), lin.raw_margin(Xl, device="cpu"))
