"""The port's many-models core (``lightgbm.train.train_many``) against the
port's own ``train()`` and against the JAX package's ``train_many``.

Inputs come from numpy seeds (label noise, U(0.5, 2) row weights) and go
through both packages on the CPU. Tolerances: every candidate's model text
equals the port's ``train()`` text for its options byte for byte; against
the reference it holds ``model_texts_close`` (rtol 1e-3, the default
path's tolerance: float32 sums taken in another order). The refusals carry
the reference's messages.
"""

import dataclasses
import re

import numpy as np
import pytest
import torch

from mmlspark_tpu_torch.lightgbm import binning as tbinning
from mmlspark_tpu_torch.lightgbm import train as ttrain
from mmlspark_tpu_torch.observability import events as tevents
from mmlspark_tpu_torch.observability import profiler as tprofiler
from mmlspark_tpu_torch.ops import histogram as thistogram


def _import_reference():
    """Import the JAX package's fit path through the u_histogram shim (see
    ``tests/test_torch_gbdt.py``): a dict holding the barrier rule stands
    in for jax 0.9's ``batching.primitive_batchers`` while the module
    imports. The JAX package itself is not changed."""
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

BASE = dict(num_iterations=4, num_leaves=15, max_bin=31, min_gain_to_split=1e-3)


@pytest.fixture(scope="module")
def ref():
    import mmlspark_tpu.lightgbm.binning as jbinning
    import mmlspark_tpu.lightgbm.train as jtrain
    from mmlspark_tpu.lightgbm.procfit import model_texts_close

    return dict(binning=jbinning, train=jtrain, texts_close=model_texts_close)


def _case(seed=0, n=1500, f=6, classes=2, regression=False):
    """Gaussian features; a noisy binary, 3-class or regression target;
    U(0.5, 2) row weights."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, f))
    s = X[:, 0] + X[:, 1] * X[:, 2] + 0.5 * np.sin(X[:, 3]) + 0.8 * rng.normal(size=n)
    if regression:
        y = 2.0 * s
    elif classes == 2:
        y = (s > 0).astype(np.float64)
    else:
        y = np.digitize(s, np.quantile(s, np.linspace(0, 1, classes + 1)[1:-1])).astype(float)
    return X, y, rng.uniform(0.5, 2.0, n)


def _variants(base, *changes):
    return [dataclasses.replace(base, **c) for c in changes]


LR = ({"learning_rate": 0.05}, {"learning_rate": 0.1}, {"learning_rate": 0.2})

# (name, TrainOptions fields of the bucket, per-candidate changes, case kwargs, bin kwargs)
BUCKETS = [
    ("lr_only", {}, LR, {}, {}),
    ("bagging", {}, ({"bagging_fraction": 0.7, "bagging_freq": 1},
                     {"bagging_fraction": 0.5, "bagging_freq": 2, "learning_rate": 0.2}), {}, {}),
    ("feature_fraction", {}, ({"feature_fraction": 0.5}, {"feature_fraction": 0.8},
                              {"learning_rate": 0.3}), {}, {}),
    ("stratified_bagging", {}, ({"pos_bagging_fraction": 0.5, "bagging_freq": 1},
                                {"neg_bagging_fraction": 0.6, "bagging_freq": 1,
                                 "feature_fraction": 0.7}), {}, {}),
    ("goss", {"boosting_type": "goss"}, LR, {}, {}),
    ("categorical", {}, LR[:2], {}, {"categorical_features": [4, 5]}),
    ("bundled", {}, LR[1:], {}, {"feature_bundling": True}),
    ("multiclass", {"objective": "multiclass", "num_class": 3}, LR[:2] + (
        {"feature_fraction": 0.7},), {"classes": 3}, {}),
    ("regression", {"objective": "regression"}, LR[:2] + (
        {"bagging_fraction": 0.8, "bagging_freq": 1},), {"regression": True}, {}),
]


def _bucket_data(case_kw, bin_kw):
    X, y, w = _case(**case_kw)
    if "categorical_features" in bin_kw:
        X[:, 4] = np.floor(np.abs(X[:, 4]) * 3)  # 0..~9 codes
        X[:, 5] = np.floor(np.abs(X[:, 5]) * 8)
    if bin_kw.get("feature_bundling"):
        # two sparse one-hot-like columns that never collide
        X[:, 4] = np.where(np.arange(len(y)) % 3 == 0, X[:, 4], 0.0)
        X[:, 5] = np.where(np.arange(len(y)) % 3 == 1, X[:, 5], 0.0)
    return X, y, w


@pytest.mark.parametrize("name,fields,changes,case_kw,bin_kw", BUCKETS,
                         ids=[b[0] for b in BUCKETS])
def test_each_candidate_writes_train_text(name, fields, changes, case_kw, bin_kw):
    X, y, w = _bucket_data(case_kw, bin_kw)
    bins, mapper = tbinning.bin_dataset(X, max_bin=31, **bin_kw)
    if bin_kw.get("feature_bundling"):
        assert mapper.bundles is not None and bins.shape[1] < X.shape[1]
    if "categorical_features" in bin_kw:
        assert sorted(mapper.cat_values) == [4, 5]
    opts = _variants(ttrain.TrainOptions(**BASE, **fields), *changes)
    many = ttrain.train_many(bins, y, opts, w=w, mapper=mapper, device="cpu")
    assert len(many) == len(opts)
    for o, r in zip(opts, many):
        one = ttrain.train(bins, y, o, w=w, mapper=mapper, device="cpu")
        assert r.booster.model_to_string() == one.booster.model_to_string(), o
        assert (r.stats.trees, r.stats.passes, r.stats.syncs) == (
            one.stats.trees, one.stats.passes, one.stats.syncs)
        assert r.evals == {} and r.best_iteration == 0


@pytest.mark.parametrize("name", ["mixed_binary", "multiclass"])
def test_close_to_the_reference_train_many(ref, name):
    kw = {"classes": 3} if name == "multiclass" else {}
    X, y, w = _case(seed=3, **kw)
    fields = dict(BASE, objective="multiclass", num_class=3) if kw else dict(BASE)
    changes = (({"learning_rate": 0.05}, {"feature_fraction": 0.7},
                {"bagging_fraction": 0.7, "bagging_freq": 1, "learning_rate": 0.2})
               if not kw else LR[:2])
    bt, mt = tbinning.bin_dataset(X, max_bin=31)
    bj, mj = ref["binning"].bin_dataset(X, max_bin=31)
    np.testing.assert_array_equal(bt, bj)
    port = ttrain.train_many(bt, y, _variants(ttrain.TrainOptions(**fields), *changes), w=w,
                             mapper=mt, device="cpu")
    want = ref["train"].train_many(
        bj, y, _variants(ref["train"].TrainOptions(**fields), *changes), w=w, mapper=mj)
    for p, j in zip(port, want):
        assert ref["texts_close"](p.booster.model_to_string(), j.booster.model_to_string())


def test_bucket_keys_group_as_the_reference(ref):
    cands = [dict(learning_rate=0.1), dict(learning_rate=0.3, feature_fraction=0.5),
             dict(num_leaves=7), dict(num_leaves=7, bagging_fraction=0.5, bagging_freq=2),
             dict(objective="regression"), dict(seed=3), dict(pos_bagging_fraction=0.5,
                                                             bagging_freq=1),
             dict(boosting_type="goss"), dict(boosting_type="goss", learning_rate=0.5),
             dict(lambda_l2=1.0), dict(histogram_method="segment")]

    def groups(mod):
        keys = [mod.many_bucket_key(mod.TrainOptions(**c)) for c in cands]
        return [sorted(i for i, k in enumerate(keys) if k == key) for key in keys]

    assert groups(ttrain) == groups(ref["train"])
    assert ttrain.MANY_VMAPPED_FIELDS == ref["train"].MANY_VMAPPED_FIELDS
    o = ttrain.TrainOptions(learning_rate=0.3, bagging_fraction=0.5, bagging_freq=3)
    assert dataclasses.asdict(ttrain.normalize_many_opts(o)) == dataclasses.asdict(
        ref["train"].normalize_many_opts(ref["train"].TrainOptions(
            learning_rate=0.3, bagging_fraction=0.5, bagging_freq=3)))


REFUSALS = [
    ("empty", [], "train_many requires at least one candidate"),
    ("two_buckets", [{}, {"num_leaves": 7}], "train_many candidates must share one shape-bucket"),
    ("dart", [{"boosting_type": "dart"}], "train_many supports boosting_type 'gbdt' or 'goss'"),
    ("rf", [{"boosting_type": "rf", "bagging_fraction": 0.5, "bagging_freq": 1}],
     "train_many supports boosting_type 'gbdt' or 'goss'"),
    ("no_iterations", [{"num_iterations": 0}], "train_many requires num_iterations > 0"),
    ("goss_bagging", [{"boosting_type": "goss", "bagging_fraction": 0.5, "bagging_freq": 1}],
     "boosting_type='goss' cannot be combined with bagging"),
    ("goss_rates", [{"boosting_type": "goss", "top_rate": 0.7, "other_rate": 0.5}],
     "goss requires top_rate + other_rate <= 1"),
    ("pos_neg_not_binary", [{"objective": "regression", "pos_bagging_fraction": 0.5,
                             "bagging_freq": 1}],
     "posBaggingFraction/negBaggingFraction require the binary objective"),
]


@pytest.mark.parametrize("name,cands,prefix", REFUSALS, ids=[r[0] for r in REFUSALS])
def test_refusals_carry_the_reference_messages(ref, name, cands, prefix):
    X, y, _ = _case(n=200)
    bt, mt = tbinning.bin_dataset(X, max_bin=31)
    with pytest.raises(ValueError, match=re.escape(prefix)):
        ttrain.train_many(bt, y, [ttrain.TrainOptions(**{**BASE, **c}) for c in cands], mapper=mt,
                          device="cpu")
    with pytest.raises(ValueError, match=re.escape(prefix)):
        ref["train"].train_many(bt, y, [ref["train"].TrainOptions(**{**BASE, **c}) for c in cands],
                                mapper=ref["binning"].bin_dataset(X, max_bin=31)[1])


def test_bundled_width_mismatch_is_refused(ref):
    X, y, _ = _bucket_data({}, {"feature_bundling": True})
    bins, mapper = tbinning.bin_dataset(X, max_bin=31, feature_bundling=True)
    prefix = f"bundled mapper expects packed bins with {mapper.bundles.num_columns} columns"
    wide = np.concatenate([bins, bins[:, :1]], axis=1)
    with pytest.raises(ValueError, match=re.escape(prefix)):
        ttrain.train_many(wide, y, [ttrain.TrainOptions(**BASE)], mapper=mapper, device="cpu")
    _, mj = ref["binning"].bin_dataset(X, max_bin=31, feature_bundling=True)
    with pytest.raises(ValueError, match=re.escape(prefix)):
        ref["train"].train_many(wide, y, [ref["train"].TrainOptions(**BASE)], mapper=mj)


def test_passes_are_k_times_the_single_fit(monkeypatch):
    """On the CPU the passes go to the plain version through the two
    kernel entries of ``ops/histogram.py``: a bucket of K calls each entry
    K times as often as one fit, here at phase 5's tree shape (31 leaves,
    leaf batch 8): 5 panel and 2 combined calls a tree."""
    calls = {"panel": 0, "combined": 0}
    for name, key in (("build_histograms_cuda", "panel"),
                      ("build_histograms_combined_cuda", "combined")):
        fn = getattr(thistogram, name)

        def counted(*a, _fn=fn, _key=key):
            calls[_key] += 1
            return _fn(*a)

        monkeypatch.setattr(thistogram, name, counted)
    X, y, w = _case(n=2000)
    bins, mapper = tbinning.bin_dataset(X, max_bin=31)
    base = ttrain.TrainOptions(num_iterations=2, num_leaves=31, leaf_batch=8, max_bin=31,
                               min_data_in_leaf=5)
    opts = _variants(base, *LR, {"feature_fraction": 0.8, "bagging_fraction": 0.8,
                                 "bagging_freq": 1})
    ttrain.train(bins, y, base, w=w, mapper=mapper, device="cpu")
    single = dict(calls)
    assert single == {"panel": 2 * 5, "combined": 2 * 2}
    calls.update(panel=0, combined=0)
    ttrain.train_many(bins, y, opts, w=w, mapper=mapper, device="cpu")
    assert calls == {k: len(opts) * v for k, v in single.items()}


def test_quantized_request_trains_exact_with_a_warning(caplog):
    X, y, w = _case(n=800)
    bins, mapper = tbinning.bin_dataset(X, max_bin=31)
    quant = _variants(ttrain.TrainOptions(**BASE, histogram_method="u", use_quantized_grad=True),
                      *LR[:2])
    exact = _variants(ttrain.TrainOptions(**BASE), *LR[:2])
    with caplog.at_level("WARNING", logger="mmlspark_tpu_torch.lightgbm"):
        got = ttrain.train_many(bins, y, quant, w=w, mapper=mapper, device="cpu")
    assert "training with exact stats" in caplog.text
    want = ttrain.train_many(bins, y, exact, w=w, mapper=mapper, device="cpu")
    for a, b in zip(got, want):
        assert not a.stats.quantized and a.stats.histogram_path == "compare"
        assert a.booster.model_to_string() == b.booster.model_to_string()


def test_profiler_books_one_scan_many_per_call(monkeypatch):
    monkeypatch.delenv("MMLSPARK_TPU_PROFILE", raising=False)
    prof = tprofiler.get_profiler()
    prof.disable()
    prof.clear()
    seen = []
    bus = tevents.get_bus()
    bus.add_listener(seen.append)
    X, y, w = _case(n=600, seed=11)
    bins, mapper = tbinning.bin_dataset(X, max_bin=31)
    opts = _variants(ttrain.TrainOptions(**dict(BASE, num_leaves=13)), *LR)
    try:
        prof.enable()
        for _ in range(2):
            ttrain.train_many(bins, y, opts, w=w, mapper=mapper, device="cpu")
        table = prof.snapshot()["functions"]
    finally:
        prof.disable()
        prof.clear()
        bus.remove_listener(seen.append)
    assert "gbdt.step" not in table
    row = table["gbdt.scan_many"]
    assert (row["compiles"], row["executions"], row["cache_hits"]) == (1, 2, 1)
    names = [type(e).__name__ for e in seen
             if getattr(e, "name", "") == "gbdt.scan_many"]
    assert names == ["ProfileCompiled", "ProfileExecuted", "ProfileExecuted"]


@pytest.mark.cuda
def test_train_many_on_the_card_writes_the_cpus_text():
    """HIGGS-shaped rows with weights, K = 3: the card's text equals the
    CPU port's byte for byte for every candidate."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rng = np.random.default_rng(0)
    n = 50_000
    X = rng.normal(size=(n, 28))
    logit = X[:, 0] * 1.5 + X[:, 1] * X[:, 2] + 0.8 * np.sin(X[:, 3]) + 0.5 * rng.normal(size=n)
    y, w = (logit > 0).astype(np.float64), rng.uniform(0.5, 2.0, n)
    bins, mapper = tbinning.bin_dataset(X, max_bin=255)
    opts = _variants(ttrain.TrainOptions(num_iterations=5, num_leaves=31, max_bin=255),
                     {"learning_rate": 0.05}, {"learning_rate": 0.2},
                     {"feature_fraction": 0.8, "bagging_fraction": 0.8, "bagging_freq": 1})
    texts = [[r.booster.model_to_string()
              for r in ttrain.train_many(bins, y, opts, w=w, mapper=mapper, device=d)]
             for d in ("cuda", "cpu")]
    assert texts[0] == texts[1]
