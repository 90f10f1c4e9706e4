"""The port's multiclass objective, boosting types (goss, dart, rf) and
depthwise growth against the JAX package.

Inputs come from numpy seeds and go through both packages on the CPU: the
port with ``device='cpu'`` (its kernels' plain versions), the JAX package
as its own CPU tests run it. Tolerances: identical tree structure, leaf
values and margins within 1e-5, metric histories within 1e-6 relative;
GOSS row sets and DART drop sets exactly; quantized model text byte for
byte. The fit data carry label noise and row weights uniform in [0.5, 2],
and the fits set ``min_gain_to_split`` 1e-3: with unit weights iteration
0's binary gradients take two values, so splits of different features
with the same class counts tie exactly, and a class absent from a leaf
leaves gains at float32 noise; the two packages sum histograms in other
orders (the port exactly, the reference in float32) and would break such
ties apart.
"""

import dataclasses

import numpy as np
import pytest
import torch

from mmlspark_tpu_torch.data.table import Table
from mmlspark_tpu_torch.lightgbm import binning as tbinning
from mmlspark_tpu_torch.lightgbm import objectives as tobj
from mmlspark_tpu_torch.lightgbm import train as ttrain
from mmlspark_tpu_torch.ops import hopper_histogram as hh
from mmlspark_tpu_torch.runtime.faults import FaultPlan, inject_faults

from _torch_boosting_cases import _case, _estimators, _fit_both, _opts, _same_margins, _same_trees
from _torch_boosting_cases import _time_limit, ref  # noqa: F401  (fixtures)


# -- the multiclass objective ---------------------------------------------------


@pytest.mark.parametrize("num_class", [3, 5, 7])
def test_multiclass_gradients_are_the_references_bit_for_bit(ref, num_class):
    """Softmax gradients and hessians equal the compiled reference's: the
    port copies XLA's CPU exp (Cephes with fused multiply-adds,
    flush-to-zero) and its left-to-right row sum."""
    jax = ref["jax"]
    rng = np.random.default_rng(num_class)
    n = 20_000
    margins = (rng.normal(size=(n, num_class)) * rng.choice([0.1, 1, 10, 60], (n, 1)))
    margins = margins.astype(np.float32)
    y = rng.integers(0, num_class, n).astype(np.float32)
    w = rng.uniform(0.5, 2.0, n).astype(np.float32)
    jo, to = ref["obj"].get_objective("multiclass"), tobj.get_objective("multiclass")
    jg, jh = jax.jit(lambda m, y_, w_: jo.grad_hess(m, y_, w_, num_classes=num_class))(
        margins, y, w)
    tg, th = to.grad_hess(torch.from_numpy(margins), torch.from_numpy(y), torch.from_numpy(w))
    assert np.array_equal(tg.numpy(), np.asarray(jg))
    assert np.array_equal(th.numpy(), np.asarray(jh))
    np.testing.assert_array_equal(to.init_score(y, num_class, w),
                                  jo.init_score(y, num_class, w))
    assert to.num_outputs_fn(num_class) == num_class


def test_exp_nonpositive_is_the_references_exp(ref):
    jax = ref["jax"]
    x = np.concatenate([np.linspace(-110.0, 0.0, 400_001), -np.abs(
        np.random.default_rng(0).normal(size=100_000)) * 8]).astype(np.float32)
    want = np.asarray(jax.jit(jax.numpy.exp)(x))
    got = tobj.xla_exp(torch.from_numpy(x)).numpy()
    assert np.array_equal(got, want)


@pytest.mark.parametrize("metric", ["multi_logloss", "multi_error"])
def test_multiclass_metrics_match_jax(ref, metric):
    rng = np.random.default_rng(4)
    margins = rng.normal(size=(3000, 4)) * 2
    y = rng.integers(0, 4, 3000).astype(np.float64)
    w = rng.uniform(0.5, 2.0, 3000)
    got = tobj.METRICS[metric][0](y, margins, w)
    assert got == pytest.approx(ref["obj"].METRICS[metric][0](y, margins, w), rel=1e-12)
    assert tobj.metric_higher_is_better(metric) is False
    assert np.array_equal(ttrain._margin_to_score(margins, metric, "multiclass"), margins)


# -- multiclass fits --------------------------------------------------------------


def test_multiclass_chunked_u_writes_the_resident_text(monkeypatch):
    X, y, w = _case(seed=31, num_class=3, n=1500)
    bt, mt = tbinning.bin_dataset(X, max_bin=31)
    opts = ttrain.TrainOptions(**_opts(3, histogram_method="u", use_quantized_grad=True))
    monkeypatch.delenv("MMLSPARK_TPU_U_BUDGET", raising=False)
    resident = ttrain.train(bt, y, opts, w=w, mapper=mt, device="cpu")
    monkeypatch.setenv("MMLSPARK_TPU_U_BUDGET", "60000")
    chunked = ttrain.train(bt, y, opts, w=w, mapper=mt, device="cpu")
    assert chunked.stats.histogram_path == "u_chunked" and chunked.stats.u_chunks > 1
    assert chunked.booster.model_to_string() == resident.booster.model_to_string()


# -- GOSS -------------------------------------------------------------------------


@pytest.mark.parametrize("num_class", [1, 3])
@pytest.mark.parametrize("it", [0, 4])
def test_goss_rows_are_the_references(ref, num_class, it):
    """The kept rows (the largest sum |g|, ties to the lower row as
    ``lax.top_k``) and the drawn rows equal the reference's, and so do the
    weights: the reference's step code run on the same gradients."""
    jax = ref["jax"]
    jnp = jax.numpy
    rng = np.random.default_rng(50 + num_class)
    n = 2000
    grad = rng.normal(size=(n, num_class)).astype(np.float32)
    grad[: n // 2] = grad[0]  # half the rows tie
    opts = ttrain.TrainOptions(boosting_type="goss", seed=7)

    def reference(g):
        gabs = jnp.abs(g).sum(axis=1)
        n_top = max(1, int(round(n * opts.top_rate)))
        _, top_idx = jax.lax.top_k(gabs, n_top)
        top = jnp.zeros(n, bool).at[top_idx].set(True)
        key = jax.random.fold_in(jax.random.PRNGKey(opts.seed), it)
        p = opts.other_rate / max(1e-12, 1.0 - opts.top_rate)
        sampled = (~top) & (jax.random.uniform(key, (n,)) < p)
        amp = (1.0 - opts.top_rate) / max(1e-12, opts.other_rate)
        return top.astype(g.dtype) + sampled.astype(g.dtype) * amp

    want = np.asarray(jax.jit(reference)(grad))
    got = ttrain._goss_weights(torch.from_numpy(grad), None, opts, it).numpy()
    assert np.array_equal(got, want)
    assert (got == 1.0).sum() == 400 and (got > 1.0).sum() > 0


@pytest.mark.parametrize("num_class", [2, 3])
def test_goss_fit_matches_jax(ref, num_class):
    X, y, w = _case(seed=60 + num_class, num_class=num_class)
    rt, rj, _, _ = _fit_both(ref, X, y, w, **_opts(num_class, boosting_type="goss"))
    _same_trees(rt.booster, rj.booster)
    _same_margins(rt.booster, rj.booster, X)


# -- rf and DART ------------------------------------------------------------------


@pytest.mark.parametrize("num_class", [2, 3])
def test_rf_fit_matches_jax(ref, num_class):
    """rf trees fit the init score at learning rate 1; the booster averages
    them (leaf values over the iterations)."""
    X, y, w = _case(seed=70 + num_class, num_class=num_class)
    kw = _opts(num_class, boosting_type="rf", bagging_fraction=0.7, bagging_freq=1)
    rt, rj, _, _ = _fit_both(ref, X, y, w, **kw)
    _same_trees(rt.booster, rj.booster)
    _same_margins(rt.booster, rj.booster, X)
    # every tree of an iteration sees the same init-score gradients: the
    # roots of iteration 0 and iteration 1 differ only through the bag
    assert np.abs(rt.booster.leaf_values).max() < 1.0


@pytest.mark.parametrize("num_class", [2, 3])
def test_dart_fit_matches_jax(ref, num_class):
    """The drop sets are the reference's stream (``default_rng(seed +
    7919)``, one draw per earlier iteration), and the rescaled leaf values
    match."""
    X, y, w = _case(seed=80 + num_class, num_class=num_class)
    kw = _opts(num_class, boosting_type="dart", drop_rate=0.3, num_iterations=6, seed=3)
    rt, rj, _, _ = _fit_both(ref, X, y, w, **kw)
    rng = np.random.default_rng(3 + 7919)
    want = [[]] + [np.nonzero(rng.random(i) < 0.3)[0].tolist() for i in range(1, 6)]
    assert rt.stats.dart_drops == want
    assert sum(len(d) for d in want) >= 2
    _same_trees(rt.booster, rj.booster)
    _same_margins(rt.booster, rj.booster, X)


def test_dart_valid_margins_match_jax(ref):
    X, y, w = _case(seed=85, num_class=3, n=2400)
    kw = _opts(3, boosting_type="dart", drop_rate=0.3, num_iterations=6, seed=1,
               metric="multi_error")
    rt, rj, _, _ = _fit_both(ref, X[:1600], y[:1600], w[:1600], valid=(X[1600:], y[1600:]),
                             **kw)
    np.testing.assert_allclose(rt.evals["v"]["multi_error"], rj.evals["v"]["multi_error"],
                               rtol=1e-6)
    _same_trees(rt.booster, rj.booster)
    # the valid margins, rescaled incrementally, are the final booster's
    want = tobj.multi_error(y[1600:], rt.booster.raw_margin(X[1600:], device="cpu"),
                            np.ones(800))
    assert rt.evals["v"]["multi_error"][-1] == pytest.approx(want, abs=1e-12)


def test_dart_oom_retry_reuses_the_drop_set(ref):
    """A retried iteration keeps its drop set: the degraded fit writes the
    clean fit's text, and that is the reference's."""
    X, y, w = _case(seed=90, num_class=2, n=1500)
    bt, mt = tbinning.bin_dataset(X, max_bin=31)
    opts = ttrain.TrainOptions(**_opts(2, boosting_type="dart", drop_rate=0.5,
                                       histogram_method="u", use_quantized_grad=True))
    clean = ttrain.train(bt, y, opts, w=w, mapper=mt, device="cpu")
    fault = FaultPlan()
    for it, attempt in ((2, 0), (3, 0), (3, 1)):
        fault.oom_task(it, kind="device", attempt=attempt)
    with inject_faults(fault):
        degraded = ttrain.train(bt, y, opts, w=w, mapper=mt, device="cpu")
    assert fault.fired == [("oom_device", 2, 0), ("oom_device", 3, 0), ("oom_device", 3, 1)]
    assert degraded.stats.oom_retries == 3
    assert degraded.stats.dart_drops == clean.stats.dart_drops
    assert any(degraded.stats.dart_drops[2:4])
    assert degraded.booster.model_to_string() == clean.booster.model_to_string()
    bj, mj = ref["binning"].bin_dataset(X, max_bin=31)
    jb = ref["train"].train(bj, y, ref["train"].TrainOptions(**dataclasses.asdict(opts)),
                            w=w, mapper=mj).booster
    assert degraded.booster.model_to_string() == jb.model_to_string()


# -- depthwise growth -------------------------------------------------------------


def test_depthwise_quantized_u_matches_jax(ref, caplog):
    """At depth 7 the quantized U levels (1-32 nodes) are integer-exact and
    the 64-node level takes the compare-built pass on exact stats, as the
    reference's does, with its warning; the leaves under that level agree
    within float32 rounding (the two packages sum float histograms in
    other orders)."""
    X, y, w = _case(seed=110)
    kw = _opts(2, growth="depthwise", max_depth=7, histogram_method="u",
               use_quantized_grad=True)
    with caplog.at_level("WARNING", logger="mmlspark_tpu_torch.lightgbm"):
        rt, rj, _, _ = _fit_both(ref, X, y, w, **kw)
    assert any("depthwise" in m and "exact" in m for m in caplog.messages)
    assert rt.stats.quantized
    _same_trees(rt.booster, rj.booster)


@pytest.mark.parametrize("num_class,max_bin,objective", [
    (2, 31, "binary"), (3, 63, "multiclass")])
def test_quantized_depthwise_stumps_are_the_references(ref, num_class, max_bin, objective):
    """At max_depth 1 the reference's compiled step keeps the dequantizing
    multiply apart from the right child's subtraction (the root's own value
    reads the same product, so XLA does not contract it), and the port
    computes it so: the text byte for byte. Seed 30 at 31 bins differed in
    7 leaves by an ulp while the port fused it at every depth."""
    X, y, w = _case(seed=30, num_class=num_class)
    kw = _opts(num_class, growth="depthwise", max_depth=1, max_bin=max_bin,
               histogram_method="u", use_quantized_grad=True)
    rt, rj, _, _ = _fit_both(ref, X, y, w, **kw)
    assert rt.stats.quantized and rt.booster.num_trees == 5 * (num_class if num_class > 2 else 1)
    assert rt.booster.model_to_string() == rj.booster.model_to_string()


@pytest.mark.parametrize("k", [64, 128])
def test_wide_level_groups_equal_one_pass(k):
    """The node groups of a wide level (each call keyed by the shifted
    node ids) concatenate to the one-call histogram bit for bit, in the
    plain version's arithmetic: every group sums with all N rows'
    fixed-point scales."""
    rng = np.random.default_rng(k)
    n, f, b = 6000, 5, 256
    bins_t = torch.from_numpy(rng.integers(0, b, (f, n), dtype=np.uint8))
    g = torch.from_numpy(rng.normal(size=n).astype(np.float32))
    h = torch.from_numpy(rng.uniform(0, 0.25, n).astype(np.float32))
    c = torch.ones(n)
    node = torch.from_numpy(rng.integers(-1, k + 1, n).astype(np.int32))  # some out of range
    groups = hh.node_groups(k, b)
    assert len(groups) == {64: 2, 128: 4}[k]
    assert all(size <= hh.MAX_NODES for _, size in groups)
    assert sum(size for _, size in groups) == k
    one = hh.build_histograms_plain(bins_t, g, h, c, node, k, b)
    grouped = hh.grouped(hh.build_histograms_plain, bins_t, g, h, c, node, k, b)
    assert torch.equal(grouped, one)
    assert torch.equal(hh.build_histograms_cuda(bins_t, g, h, c, node, k, b), one)


def test_node_groups_respect_shared_memory():
    for b in (2, 16, 64, 200, 256):
        for k in (1, 42, 43, 64, 100, 128, 256):
            groups = hh.node_groups(k, b)
            cap = min(hh.MAX_NODES, hh.SMEM_MAX // (b * hh.CELL_BYTES))
            assert [lo for lo, _ in groups] == list(np.cumsum([0] + [s for _, s in groups])[:-1])
            assert all(1 <= s <= cap for _, s in groups) and sum(s for _, s in groups) == k
            assert len(groups) == -(-k // cap)


def test_estimator_multiclass_columns_match_jax(ref):
    X, y, w = _case(seed=120, num_class=4)
    est_t, est_j = _estimators(ref, weightCol="w")
    mt = est_t.fit(Table({"features": X, "label": y, "w": w}))
    mj = est_j.fit(ref["Table"]({"features": X, "label": y, "w": w}))
    assert mt.getNumClasses() == 4 and mt.booster.num_classes == 4
    _same_trees(mt.booster, mj.booster)
    ot = mt.transform(Table({"features": X[:500]}))
    oj = mj.transform(ref["Table"]({"features": X[:500]}))
    for col in ("rawPrediction", "probability"):
        assert ot[col].shape == (500, 4)
        np.testing.assert_allclose(ot[col], np.asarray(oj[col]), atol=1e-5)
    np.testing.assert_allclose(ot["probability"].sum(axis=1), 1.0, atol=1e-6)
    assert np.array_equal(ot["prediction"], np.asarray(oj["prediction"]))


# -- the boosting types' contracts ------------------------------------------------


@pytest.mark.parametrize("kw,valid,match", [
    (dict(boosting_type="rf"), False, "requires bagging"),
    (dict(boosting_type="rf", bagging_fraction=0.5, bagging_freq=1), True, "validation"),
    (dict(boosting_type="goss", bagging_fraction=0.5, bagging_freq=1), False, "bagging"),
    (dict(boosting_type="goss", top_rate=0.6, other_rate=0.5), False, "top_rate"),
    (dict(boosting_type="dart", early_stopping_round=2), True, "early stopping"),
    (dict(boosting_type="gbrt"), False, "boosting_type"),
    (dict(growth="lossguide"), False, "growth"),
])
def test_boosting_contracts_raise_as_the_reference(ref, kw, valid, match):
    X, y, _ = _case(seed=150, n=300)
    bt, mt = tbinning.bin_dataset(X, max_bin=15)
    vs = [("v", bt, y, None)] if valid else None
    with pytest.raises(ValueError, match=match):
        ttrain.train(bt, y, ttrain.TrainOptions(max_bin=15, **kw), mapper=mt, valid_sets=vs,
                     device="cpu")
    if kw.get("boosting_type") != "gbrt" and "growth" not in kw:
        bj, mj = ref["binning"].bin_dataset(X, max_bin=15)
        with pytest.raises(ValueError):
            ref["train"].train(bj, y, ref["train"].TrainOptions(max_bin=15, **kw), mapper=mj,
                               valid_sets=[("v", bj, y, None)] if valid else None)


# -- the card ---------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("k", [64, 128])
def test_wide_level_launches_match_plain_version_on_card(k):
    """A level wider than one launch runs as ``len(node_groups)`` launches of
    histogram.cu, bit for bit the plain version over all nodes, and
    repeats bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the kernel has no CPU mode")
    dev = torch.device("cuda")
    rng = np.random.default_rng(k)
    n, f, b = 300_001, 28, 256
    bins_t = torch.from_numpy(rng.integers(0, b, (f, n), dtype=np.uint8)).to(dev)
    g = torch.from_numpy(rng.normal(size=n).astype(np.float32)).to(dev)
    h = torch.from_numpy(rng.uniform(0, 0.25, n).astype(np.float32)).to(dev)
    c = torch.ones(n, device=dev)
    node = torch.from_numpy(rng.integers(0, k + 1, n).astype(np.int32)).to(dev)
    before = hh.build_histograms_cuda.launches
    out = hh.build_histograms_cuda(bins_t, g, h, c, node, k, b)
    assert hh.build_histograms_cuda.launches - before == len(hh.node_groups(k, b))
    again = hh.build_histograms_cuda(bins_t, g, h, c, node, k, b)
    torch.testing.assert_close(out, hh.build_histograms_plain(bins_t, g, h, c, node, k, b),
                               rtol=0, atol=0)
    torch.testing.assert_close(out, again, rtol=0, atol=0)
