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

from _torch_categorical_cases import (
    JBooster, SEARCH_CASES, _jax_mapper, _predict_batch, _search_case, _stump, cat_case,
    jbinning, jnp, jtrain, ju,
)
from _torch_categorical_cases import cat_boosters  # noqa: F401  (fixtures)


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


@pytest.mark.parametrize("kind", ["train", "unseen", "nan", "mixed"])
def test_categorical_predict_matches_jax(cat_boosters, kind):
    X, tb, jb = cat_boosters
    Xp = _predict_batch(kind, X)
    np.testing.assert_allclose(tb.raw_margin(Xp, device="cpu"), jb.raw_margin(Xp), atol=1e-5)


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
