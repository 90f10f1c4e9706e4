"""The port's train() options against the JAX package, continued from
``tests/test_torch_train_options.py`` (split off so the test workers can run
the two halves side by side): the out-of-memory retry of a bagged
iteration, validation sets on categorical and bundled fits, the mirrored
categorical tie, the options ``check_supported`` takes and refuses, and the
reference's other histogram methods. Tolerances as in that file.
"""

import dataclasses

import numpy as np
import pytest

from mmlspark_tpu_torch.lightgbm import binning as tbinning
from mmlspark_tpu_torch.lightgbm import objectives as tobj
from mmlspark_tpu_torch.lightgbm import train as ttrain
from mmlspark_tpu_torch.runtime.faults import FaultPlan, inject_faults

from _torch_train_options_cases import (
    BASE, _bins, _case, _cat_case, _fit_both, _one_hot_case, _same_evals, _same_trees,
)
from _torch_train_options_cases import _time_limit, ref  # noqa: F401  (fixtures)


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
