"""Categorical features in the port against the JAX package.

Value-identity binning, the categorical split search (sorted-set in both
directions and one-vs-rest), routing through categorical splits on the three
histogram paths (the membership product against U's categorical rows on the
resident U path), categorical predict, model text, the carried booster and
the estimator. Inputs come from numpy seeds and go through both packages on
the CPU: the port with its kernels' plain versions, the JAX package as its
own tests run it.

- categorical bins and ``cat_values``: byte-identical, overflow, NaN and
  unseen values in bin 0;
- the split search on one histogram: chosen (feature, bin, left set)
  identical, gains and leaf values within 1e-5 relative (the left sums are
  float32 sums taken in another order);
- fits: tree structure and left sets identical, leaf values and margins
  within 1e-5. The data carry label noise and category effects well apart,
  so no split is chosen between near-tied candidates;
- predict: within 1e-5 of the reference's ``raw_margin``; unseen and NaN
  categories go right.
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


# -- binning --------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("max_bin", [7, 31, 255])
def test_categorical_binning_matches_jax(seed, max_bin):
    X, _, cats = cat_case(seed=seed)
    bt, mt = tbinning.bin_dataset(X, max_bin=max_bin, categorical_features=cats)
    bj, mj = jbinning.bin_dataset(X, max_bin=max_bin, categorical_features=cats)
    assert sorted(mt.cat_values) == sorted(mj.cat_values) == cats
    for j in cats:
        np.testing.assert_array_equal(mt.cat_values[j], mj.cat_values[j])
        assert len(mt.cat_values[j]) <= max_bin - 1
    np.testing.assert_array_equal(mt.num_bins, mj.num_bins)
    np.testing.assert_array_equal(mt.edges, mj.edges)
    np.testing.assert_array_equal(bt, np.asarray(bj))
    # NaN and (at max_bin 7) the overflowed categories land in bin 0
    assert (bt[np.isnan(X[:, 0]), 0] == 0).all()
    if max_bin == 7:
        assert (bt[~np.isnan(X[:, 2]), 2] == 0).any()


@pytest.mark.parametrize("col", [
    [3.0, 1.0, np.nan, 7.0, 2.0],
    [np.nan, np.nan],
    [1e9, -1.0, 0.0, 2.5],
    [],
])
@pytest.mark.parametrize("values", [[1.0, 3.0, 2.0], [], [7.0]], ids=["three", "none", "one"])
def test_cat_to_bins_matches_jax(col, values):
    col, values = np.asarray(col, np.float64), np.asarray(values, np.float64)
    port = tbinning.cat_to_bins(col, values)
    np.testing.assert_array_equal(port, jbinning.cat_to_bins(col, values))
    assert (port[np.isnan(col)] == 0).all()
    # predict's torch form of the same rule
    order = np.argsort(values, kind="stable")
    on_device = _cat_to_bins(torch.from_numpy(col), torch.from_numpy(values[order]),
                             torch.from_numpy(order))
    np.testing.assert_array_equal(on_device.numpy(), port)


@pytest.mark.parametrize("mb", [2, 4, 64])
def test_cat_values_order_most_frequent_first_ties_by_value(mb):
    u = np.array([5.0, 1.0, 9.0, 3.0, 7.0])
    counts = np.array([4, 4, 1, 9, 4])
    port = tbinning._cat_values_from_counts(u, counts, mb)
    np.testing.assert_array_equal(port, jbinning._cat_values_from_counts(u, counts, mb))
    assert list(port) == [3.0, 1.0, 5.0, 7.0, 9.0][: mb - 1]


def test_unseen_categories_bin_to_zero_in_apply():
    X, _, cats = cat_case(seed=4)
    _, mt = tbinning.bin_dataset(X, max_bin=31, categorical_features=cats)
    Xv = X[:50].copy()
    Xv[:10, 1] = 1000.0  # never seen
    Xv[10:20, 1] = np.nan
    bins = tbinning.apply_bins(Xv, mt)
    assert (bins[:20, 1] == 0).all()
    np.testing.assert_array_equal(bins, np.asarray(jbinning.apply_bins(Xv, _jax_mapper(mt))))


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


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("case", list(SEARCH_CASES))
def test_categorical_split_search_matches_jax(case, seed):
    hist, totals, edges = _search_case(seed)
    kw = dict(categorical_slots=(0, 2), min_data_in_leaf=5, **SEARCH_CASES[case])
    f = hist.shape[1]
    port = ttrain._split_search(torch.from_numpy(hist), torch.from_numpy(totals),
                                torch.from_numpy(edges), torch.ones(f),
                                ttrain.TrainOptions(**kw))
    ref = jtrain._split_search(jnp.asarray(hist), jnp.asarray(totals), jnp.asarray(edges),
                               jnp.ones(f), jtrain.TrainOptions(**kw))
    for field in ("feat", "bin", "is_cat", "cat_mask"):
        np.testing.assert_array_equal(getattr(port, field).numpy(),
                                      np.asarray(getattr(ref, field)), err_msg=field)
    for field in ("gain", "lval", "rval", "value", "value_cat", "lcov", "rcov", "thr"):
        np.testing.assert_allclose(getattr(port, field).numpy(), np.asarray(getattr(ref, field)),
                                   rtol=1e-5, atol=1e-6, err_msg=field)
    assert not port.cat_mask[:, 0].any()  # bin 0 never goes left
    if case == "max_cat_threshold_1":
        assert (port.cat_mask.sum(dim=1) <= 1).all()


def test_sorted_search_takes_both_directions():
    """Across seeds the winners include an ascending and a descending set,
    each equal to the reference's."""
    directions = set()
    for seed in range(12):
        hist, totals, edges = _search_case(seed, k=2)
        opts = dict(categorical_slots=(0, 2), min_data_in_leaf=5, max_cat_threshold=4)
        port = ttrain._split_search(torch.from_numpy(hist), torch.from_numpy(totals),
                                    torch.from_numpy(edges), torch.ones(4),
                                    ttrain.TrainOptions(**opts))
        ref = jtrain._split_search(jnp.asarray(hist), jnp.asarray(totals), jnp.asarray(edges),
                                   jnp.ones(4), jtrain.TrainOptions(**opts))
        np.testing.assert_array_equal(port.cat_mask.numpy(), np.asarray(ref.cat_mask))
        for i in range(2):
            if not port.is_cat[i]:
                continue
            f_, cm = int(port.feat[i]), port.cat_mask[i].numpy()
            ratio = hist[i, f_, :, 0] / (hist[i, f_, :, 1] + 10.0)
            members = ratio[cm]
            others = ratio[~cm][1:] if not cm[0] else ratio[~cm]
            directions.add("asc" if members.max() <= others.min() else "desc")
    assert directions == {"asc", "desc"}


# -- membership on U ---------------------------------------------------------------


@pytest.mark.parametrize("k", [1, 5])
@pytest.mark.parametrize("widths", [(4, 9, 16), (2, 256, 3)])
def test_membership_matmul_matches_jax_and_the_gather(k, widths):
    rng = np.random.default_rng(k + len(widths))
    n = 1000
    bins = np.stack([rng.integers(0, w, n) for w in widths], 1).astype(np.uint8)
    spec = tu.make_u_spec(256, len(widths), widths)
    jspec = ju.make_u_spec(256, len(widths), widths)
    cats = (0, 2)
    rows, fr, lr = tu.cat_row_maps(spec, cats)
    for port, ref in zip((rows, fr, lr), ju.cat_row_maps(jspec, cats)):
        np.testing.assert_array_equal(port, ref)
    u = tu.build_u(torch.from_numpy(bins.T.copy()), spec)
    sf = rng.choice(cats, size=k)
    scm = rng.uniform(size=(k, 256)) < 0.4
    port = tu.membership_matmul(u[torch.from_numpy(rows).long()].to(torch.bfloat16),
                                torch.from_numpy(fr).long(), torch.from_numpy(lr).long(),
                                torch.from_numpy(sf), torch.from_numpy(scm), n)
    ju_u = ju.build_u(jnp.asarray(bins), jspec)
    ref = ju.membership_matmul(ju_u[jnp.asarray(rows)], jnp.asarray(fr), jnp.asarray(lr),
                               jnp.asarray(sf), jnp.asarray(scm), n)
    np.testing.assert_array_equal(port.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(port.numpy(), scm[np.arange(k)[:, None], bins[:, sf].T])


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


@pytest.mark.parametrize("subtraction", [True, False], ids=["sub", "nosub"])
@pytest.mark.parametrize("path,method,quant,budget", PATHS, ids=PATH_IDS)
def test_categorical_fit_matches_jax(monkeypatch, path, method, quant, budget, subtraction):
    X, y, cats = cat_case(seed=11)
    rt, jb, _ = _fit_both(monkeypatch, X, y, cats, budget, histogram_method=method,
                          use_quantized_grad=quant, histogram_subtraction=subtraction)
    assert rt.stats.histogram_path == path and rt.stats.quantized == quant
    assert rt.booster.has_categorical
    _assert_same_forest(rt.booster, jb, X)


@pytest.mark.parametrize("leaf_batch", [1, 4])
@pytest.mark.parametrize("max_cat_to_onehot", [4, 13])
def test_one_vs_rest_fit_matches_jax(monkeypatch, leaf_batch, max_cat_to_onehot):
    """max_cat_to_onehot = 13 puts the 12-category feature on one-vs-rest."""
    X, y, cats = cat_case(seed=12)
    rt, jb, _ = _fit_both(monkeypatch, X, y, cats, histogram_method="u",
                          leaf_batch=leaf_batch, max_cat_to_onehot=max_cat_to_onehot)
    _assert_same_forest(rt.booster, jb, X)


@pytest.mark.parametrize("path,method,quant,budget", PATHS, ids=PATH_IDS)
def test_mixed_categorical_and_bundled_fit_matches_jax(monkeypatch, path, method, quant,
                                                       budget):
    """Categorical columns beside one-hot blocks that bundle: categoricals
    stay identity columns of the packed matrix."""
    X, y, cats = cat_case(seed=13, n=2000)
    rng = np.random.default_rng(13)
    hot = rng.integers(0, 6, len(X))
    onehot = np.zeros((len(X), 6))
    onehot[np.arange(len(X)), hot] = 1.0
    X = np.hstack([X, onehot])
    y = np.where(hot == 2, 1.0 - y, y)
    rt, jb, mt = _fit_both(monkeypatch, X, y, cats, budget, bundling=True,
                           histogram_method=method, use_quantized_grad=quant)
    assert mt.bundles is not None and mt.bundles.num_columns < X.shape[1]
    assert rt.stats.histogram_path == path
    _assert_same_forest(rt.booster, jb, X)


def test_quantized_categorical_text_matches_across_paths(monkeypatch):
    """Resident, chunked and no-subtraction quantized categorical fits write
    one model text (chunked and resident passes sum the same integers)."""
    X, y, cats = cat_case(seed=14)
    b, m = tbinning.bin_dataset(X, max_bin=31, categorical_features=cats)
    texts = set()
    for sub, budget in ((True, None), (False, None), (True, "40000"), (False, "40000")):
        if budget is None:
            monkeypatch.delenv("MMLSPARK_TPU_U_BUDGET", raising=False)
        else:
            monkeypatch.setenv("MMLSPARK_TPU_U_BUDGET", budget)
        r = ttrain.train(b, y, ttrain.TrainOptions(**FIT, histogram_method="u",
                                                   use_quantized_grad=True,
                                                   histogram_subtraction=sub),
                         mapper=m, device="cpu")
        texts.add(r.booster.model_to_string())
    assert len(texts) == 1


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


@pytest.mark.parametrize("kind", ["train", "unseen", "nan", "mixed"])
def test_categorical_predict_matches_jax(cat_boosters, kind):
    X, tb, jb = cat_boosters
    Xp = _predict_batch(kind, X)
    np.testing.assert_allclose(tb.raw_margin(Xp, device="cpu"), jb.raw_margin(Xp), atol=1e-5)


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


def test_categorical_predict_leaves_the_input_unchanged(cat_boosters):
    X, tb, _ = cat_boosters
    Xp = _predict_batch("mixed", X)
    before = Xp.copy()
    tb.raw_margin(Xp, device="cpu")
    np.testing.assert_array_equal(Xp, before)


def test_unseen_and_nan_categories_go_right():
    X = np.array([[5.0, 0], [7.0, 0], [9.0, 0], [np.nan, 0], [100.0, 0], [-7.0, 0],
                  [6.0, 0], [2.0 ** 24 + 5, 0]])
    port = _stump(Booster).raw_margin(X, device="cpu")[:, 0]
    np.testing.assert_array_equal(port, [-1, -1, 1, 1, 1, 1, 1, 1])
    np.testing.assert_array_equal(port, _stump(JBooster).raw_margin(X)[:, 0])


def test_categorical_model_text_matches_jax_and_round_trips(cat_boosters):
    X, tb, jb = cat_boosters
    text = booster_from_jax(jb.to_dict()).model_to_string()
    assert text == jb.model_to_string()
    assert "cat_boundaries=" in tb.model_to_string()
    back = Booster.from_string(tb.model_to_string())
    assert back.has_categorical
    np.testing.assert_allclose(back.raw_margin(X[:500], device="cpu"),
                               tb.raw_margin(X[:500], device="cpu"), atol=1e-5)
    jback = JBooster.from_string(tb.model_to_string())
    np.testing.assert_allclose(jback.raw_margin(X[:500]), back.raw_margin(X[:500], device="cpu"),
                               atol=1e-5)


@pytest.mark.parametrize("kind", ["train", "unseen", "mixed"])
def test_carried_categorical_booster_predicts_as_the_reference(cat_boosters, kind):
    X, _, jb = cat_boosters
    carried = booster_from_jax(jb.to_dict())
    assert carried.has_categorical
    Xp = _predict_batch(kind, X)
    np.testing.assert_allclose(carried.raw_margin(Xp, device="cpu"), jb.raw_margin(Xp),
                               atol=1e-6)


def test_carried_categorical_mapper_bins_as_the_reference():
    X, _, cats = cat_case(seed=17)
    _, mj = jbinning.bin_dataset(X, max_bin=15, categorical_features=cats)
    mt = bin_mapper_from_jax(mj.edges, mj.num_bins, mj.max_bin, mj.cat_values, mj.bundles)
    Xv = _predict_batch("mixed", X)
    np.testing.assert_array_equal(tbinning.apply_bins(Xv, mt),
                                  np.asarray(jbinning.apply_bins(Xv, mj)))


# -- estimator --------------------------------------------------------------------


@pytest.mark.parametrize("by", ["index", "name", "both"])
def test_estimator_categorical_slots_match_jax(by):
    X, y, cats = cat_case(seed=18, n=1500)
    slots = {"index": dict(categoricalSlotIndexes=cats),
             "name": dict(categoricalSlotNames=[f"f{j}" for j in cats]),
             "both": dict(categoricalSlotIndexes=cats[:1],
                          categoricalSlotNames=[f"f{j}" for j in cats[1:]])}[by]
    params = dict(numIterations=3, numLeaves=7, maxBin=31, minDataPerGroup=20, catSmooth=5.0,
                  catL2=5.0, maxCatThreshold=8, maxCatToOnehot=4, **slots)
    port = LightGBMClassifier(device="cpu", **params).fit(Table({"features": X, "label": y}))
    ref = JLightGBMClassifier(**params).fit(JTable({"features": X, "label": y}))
    pb, jb = port.booster, ref.booster
    assert pb.has_categorical
    for field in STRUCTURE:
        assert np.array_equal(getattr(pb, field), getattr(jb, field)), field
    np.testing.assert_allclose(port.transform(Table({"features": X}))["probability"],
                               np.asarray(ref.transform(JTable({"features": X}))["probability"]),
                               atol=1e-5)
    assert port.get_model_string().count("num_cat=") == 3


@pytest.mark.parametrize("bad", [dict(categoricalSlotIndexes=[9]),
                                 dict(categoricalSlotNames=["nope"])])
def test_estimator_refuses_unknown_categorical_slots(bad):
    X, y, _ = cat_case(seed=19, n=300)
    with pytest.raises(ValueError, match="categoricalSlot"):
        LightGBMClassifier(device="cpu", numIterations=1, **bad).fit(
            Table({"features": X, "label": y}))


# -- on the card -------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("quant", [True, False], ids=["quant", "bf16"])
def test_categorical_bins_on_card(quant):
    """The three histogram kernels on value-identity bins (Zipf-skewed, an
    overflowing column full of bin 0) equal their plain versions bit for
    bit, and the membership product equals the left-set gather."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the kernels have no CPU mode")
    from mmlspark_tpu_torch.ops import hopper_histogram as hh

    dev = torch.device("cuda")
    X, _, cats = cat_case(n=300_001, seed=20, cards=(12, 31, 7, 22, 300, 300), conts=0)
    bins, m = tbinning.bin_dataset(X, max_bin=255, categorical_features=cats)
    bins_t = torch.from_numpy(bins.T.copy()).to(dev)
    n, k = bins.shape[0], 8
    spec = tu.make_u_spec(256, len(cats), m.num_bins)
    rng = np.random.default_rng(0)
    g, h = (torch.from_numpy(a.astype(np.float32)).to(dev)
            for a in (rng.normal(size=n), rng.uniform(0.01, 0.25, size=n)))
    c = torch.ones(n, device=dev)
    node = torch.from_numpy(rng.integers(0, k + 1, n).astype(np.int32)).to(dev)
    if quant:
        stats, _ = tu.stat_rows_quant(g, h, c, torch.rand((2, n), device=dev))
        scale = None
    else:
        stats = tu.stat_rows(g, h, c)
        scale = tu.stat_scales(stats)
    u = tu.build_u(bins_t, spec)
    out = tu.fused_panel_dot(u, stats, node, k, scale)
    assert torch.equal(out, tu.fused_panel_dot_plain(u, stats, node, k, scale))
    scat = hh.bin_scatter(bins_t, stats, node, k, spec, scale)
    assert torch.equal(scat, hh.bin_scatter_plain(bins_t, stats, node, k, spec, scale))
    hist = hh.build_histograms_cuda(bins_t, g, h, c, node, k, 256)
    assert torch.equal(hist, hh.build_histograms_plain(bins_t, g, h, c, node, k, 256))
    rows, fr, lr = tu.cat_row_maps(spec, cats)
    sf = torch.tensor([4, 5, 0, 1, 2, 3, 4, 5], device=dev)
    scm = torch.rand((8, 256), device=dev) < 0.3
    got = tu.membership_matmul(u[torch.as_tensor(rows, device=dev).long()].to(torch.bfloat16),
                               torch.as_tensor(fr, device=dev).long(),
                               torch.as_tensor(lr, device=dev).long(), sf, scm, n)
    want = scm[torch.arange(8, device=dev)[:, None], bins_t[sf].long()]
    assert torch.equal(got, want)
