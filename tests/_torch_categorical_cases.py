"""Imports, the reference's import shim, fixtures and helpers shared by
the test files of one subject:
``test_torch_categorical.py``, ``test_torch_categorical_fits.py``,
``test_torch_categorical_mixed.py``, ``test_torch_categorical_ovr.py``.

Not a test module: pytest collects nothing here. Each test file imports
by name what it uses, the fixtures included.
"""

import numpy as np
import pytest
import torch

from mmlspark_tpu_torch.data.table import Table
from mmlspark_tpu_torch.lightgbm import LightGBMClassifier
from mmlspark_tpu_torch.lightgbm import binning as tbinning
from mmlspark_tpu_torch.lightgbm import train as ttrain
from mmlspark_tpu_torch.lightgbm.booster import Booster, _cat_to_bins
from mmlspark_tpu_torch.lightgbm.convert import bin_mapper_from_jax, booster_from_jax
from mmlspark_tpu_torch.ops import u_histogram as tu


def _import_reference():
    """Import the JAX package's fit path through the u_histogram shim it
    needs on jax 0.9 (see ``tests/test_torch_gbdt.py``); the JAX package
    itself is not changed."""
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
    import jax
    import jax.numpy as jnp
    import mmlspark_tpu.lightgbm.binning as jbinning
    import mmlspark_tpu.lightgbm.train as jtrain
    import mmlspark_tpu.ops.u_histogram as ju
    from mmlspark_tpu.data.table import Table as JTable
    from mmlspark_tpu.lightgbm import LightGBMClassifier as JLightGBMClassifier
    from mmlspark_tpu.lightgbm.booster import Booster as JBooster
except ModuleNotFoundError as err:
    if err.name != "jax":
        raise

STRUCTURE = ("split_feature", "split_bin", "left_child", "right_child", "is_leaf")


def cat_case(n=2000, seed=0, cards=(3, 12, 40), conts=2, nan_share=0.02):
    """Categorical columns first (Zipf-skewed ids; the widest card overflows
    a small ``max_bin``), then continuous ones; the label carries per-category
    effects spread well apart and logistic noise."""
    rng = np.random.default_rng(seed)
    cols, logit = [], np.zeros(n)
    for c in cards:
        p = 1.0 / np.arange(1, c + 1) ** 0.8
        ids = rng.choice(c, size=n, p=p / p.sum()).astype(np.float64)
        effect = rng.permutation(np.linspace(-1.5, 1.5, c))
        logit += effect[ids.astype(int)]
        ids[rng.uniform(size=n) < nan_share] = np.nan
        cols.append(ids)
    for _ in range(conts):
        x = rng.normal(size=n)
        logit += 0.7 * x
        cols.append(x)
    y = (logit + rng.logistic(size=n) > 0).astype(np.float64)
    return np.column_stack(cols), y, list(range(len(cards)))


def _jax_mapper(mt):
    return jbinning.BinMapper(edges=mt.edges, num_bins=mt.num_bins, max_bin=mt.max_bin,
                              cat_values=mt.cat_values)


# -- split search -----------------------------------------------------------------


def _search_case(seed, k=3, f=4, b=16, cats=(0, 2)):
    """Histograms of real rows (so totals agree across features): bins per
    feature, grad and hess per row, nodes per row."""
    rng = np.random.default_rng(seed)
    n = 4000
    bins = rng.integers(0, b, size=(n, f))
    effect = rng.normal(size=(f, b)) * 2
    g = (effect[np.arange(f), bins].sum(axis=1) + rng.normal(size=n)).astype(np.float32)
    h = rng.uniform(0.1, 1.0, size=n).astype(np.float32)
    node = rng.integers(0, k, size=n)
    hist = np.zeros((k, f, b, 3), np.float32)
    for j in range(f):
        np.add.at(hist, (node, j, bins[:, j]), np.stack([g, h, np.ones(n, np.float32)], 1))
    totals = hist[:, 0].sum(axis=1)
    edges = np.tile(np.arange(b - 1, dtype=np.float32), (f, 1))
    return hist, totals, edges


SEARCH_CASES = {
    "sorted": dict(),
    "sorted_smooth0": dict(cat_smooth=0.5, cat_l2=1.0),
    "max_cat_threshold_2": dict(max_cat_threshold=2),
    "max_cat_threshold_1": dict(max_cat_threshold=1),
    "min_data_per_group_150": dict(min_data_per_group=150),
    "min_data_per_group_400": dict(min_data_per_group=400),
    "onehot": dict(onehot_slots=(0, 2)),
    "onehot_mixed": dict(onehot_slots=(2,)),
    "l1_l2": dict(lambda_l1=0.5, lambda_l2=2.0),
    "max_delta": dict(max_delta_step=0.3),
}


# -- fits ---------------------------------------------------------------------------

FIT = dict(objective="binary", num_iterations=4, num_leaves=15, max_bin=31, learning_rate=0.2,
           min_data_per_group=20, max_cat_threshold=16)
# (name, histogram_method, quantized, MMLSPARK_TPU_U_BUDGET)
PATHS = [
    ("compare", None, False, None),
    ("u", "u", False, None),
    ("u", "u", True, None),
    ("u_chunked", "u", False, "40000"),
    ("u_chunked", "u", True, "40000"),
]
PATH_IDS = ["compare", "u_bf16", "u_quant", "chunked_bf16", "chunked_quant"]


def _fit_both(monkeypatch, X, y, cats, budget=None, bundling=False, **kw):
    if budget is None:
        monkeypatch.delenv("MMLSPARK_TPU_U_BUDGET", raising=False)
    else:
        monkeypatch.setenv("MMLSPARK_TPU_U_BUDGET", budget)
    bkw = dict(max_bin=kw.get("max_bin", FIT["max_bin"]), categorical_features=cats,
               feature_bundling=bundling)
    bt, mt = tbinning.bin_dataset(X, **bkw)
    bj, mj = jbinning.bin_dataset(X, **bkw)
    opts = {**FIT, **kw}
    rt = ttrain.train(bt, y, ttrain.TrainOptions(**opts), mapper=mt, device="cpu")
    jb = jtrain.train(bj, y, jtrain.TrainOptions(**opts), mapper=mj).booster
    return rt, jb, mt


def _assert_same_forest(tb, jb, X):
    for field in STRUCTURE:
        assert np.array_equal(getattr(tb, field), getattr(jb, field)), field
    np.testing.assert_array_equal(tb.cat_nodes, jb.cat_nodes)
    np.testing.assert_array_equal(tb.cat_masks, jb.cat_masks)
    np.testing.assert_allclose(tb.leaf_values, jb.leaf_values, atol=1e-5)
    np.testing.assert_allclose(tb.raw_margin(X, device="cpu"), jb.raw_margin(X), atol=1e-5)


# -- predict, model text, carried boosters -------------------------------------------


@pytest.fixture(scope="module")
def cat_boosters():
    X, y, cats = cat_case(seed=15)
    bt, mt = tbinning.bin_dataset(X, max_bin=31, categorical_features=cats)
    bj, mj = jbinning.bin_dataset(X, max_bin=31, categorical_features=cats)
    tb = ttrain.train(bt, y, ttrain.TrainOptions(**FIT), mapper=mt, device="cpu").booster
    jb = jtrain.train(bj, y, jtrain.TrainOptions(**FIT), mapper=mj).booster
    return X, tb, jb


def _predict_batch(kind, X):
    rng = np.random.default_rng(16)
    Xp = X[:400].copy()
    if kind == "unseen":
        Xp[:, 1] = rng.choice([1000.0, -3.0, 55.5], size=len(Xp))
    elif kind == "nan":
        Xp[:, :3] = np.nan
    elif kind == "mixed":
        Xp[::3, 0] = 99.0
        Xp[1::3, 1] = np.nan
    return Xp


def _stump(cls):
    """One categorical split on feature 0: left set {bins 1, 2} (values 5
    and 7), leaves -1 (left) and +1 (right)."""
    mask = np.zeros((1, 3, 4), bool)
    mask[0, 0, [1, 2]] = True
    return cls(
        split_feature=np.zeros((1, 3), np.int32), split_threshold=np.full((1, 3), np.inf,
                                                                          np.float32),
        split_bin=np.zeros((1, 3), np.int32), left_child=np.array([[1, 0, 0]], np.int32),
        right_child=np.array([[2, 0, 0]], np.int32), is_leaf=np.array([[False, True, True]]),
        leaf_values=np.array([[0.0, -1.0, 1.0]], np.float32), init_score=np.zeros(1, np.float32),
        num_classes=1, objective="binary", max_depth=1,
        cat_nodes=np.array([[True, False, False]]), cat_masks=mask,
        cat_values={0: np.array([5.0, 7.0, 9.0])},
    )
