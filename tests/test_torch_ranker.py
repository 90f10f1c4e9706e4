"""The port's LightGBMRanker (lambdarank) against the JAX package.

The same seeded numpy inputs go through both packages on the CPU (the port
with ``device='cpu'``). Tolerances: group structure, the stable table sort
and NDCG exactly (host numpy in both); the lambdarank gradients and
hessians within 1e-6 of their largest magnitude (the reference sums each
row's pairs in float32 in XLA's order, the port in float64 rounded once,
and its sigmoid and 2^y in float64); a ranker fit's trees equal in
structure, leaves within 1e-5 of the largest, model text equal up to those
leaf values. The port's chunked gradients equal its one-shot ones bit for
bit: a row's lambdas depend only on its own query.
"""

import numpy as np
import pytest
import torch

from mmlspark_tpu_torch.data.table import Table
from mmlspark_tpu_torch.lightgbm import LightGBMRanker
from mmlspark_tpu_torch.lightgbm import binning as tbinning
from mmlspark_tpu_torch.lightgbm import objectives as tobj
from mmlspark_tpu_torch.lightgbm import ranker as tranker
from mmlspark_tpu_torch.lightgbm import train as ttrain
from mmlspark_tpu_torch.ops import hopper_histogram as hh


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

STRUCTURE = ("split_feature", "split_bin", "left_child", "right_child", "is_leaf")
LABEL_GAIN = [0.0, 1.0, 3.0, 7.0, 15.0]
PARAMS = dict(numIterations=5, numLeaves=15, maxBin=31, learningRate=0.2, minDataInLeaf=5,
              minGainToSplit=1e-3)


@pytest.fixture(scope="module")
def ref():
    import jax
    import mmlspark_tpu.lightgbm.ranker as jranker
    from mmlspark_tpu.data.table import Table as JTable
    from mmlspark_tpu.lightgbm.procfit import model_texts_close

    return dict(jax=jax, ranker=jranker, Table=JTable, texts_close=model_texts_close)


def _queries(seed, nq=60, max_size=40, f=6, shuffle=False):
    """Queries of skewed sizes (1 to ``max_size`` documents), relevance 0-4
    at skewed frequencies from a noisy score; row weights in [0.5, 2]."""
    rng = np.random.default_rng(seed)
    sizes = np.minimum(rng.geometric(1.0 / 12, nq), max_size)
    group = np.repeat(rng.permutation(nq) if shuffle else np.arange(nq), sizes)
    n = len(group)
    X = rng.normal(size=(n, f))
    rel = X[:, 0] + 0.5 * X[:, 1] * X[:, 2] + 0.5 * rng.normal(size=n)
    y = np.clip(np.floor(rel + 1.0), 0, 4)
    return X, y, group, rng.uniform(0.5, 2.0, n)


@pytest.fixture(scope="module")
def fitted(ref):
    """One ranker fit through each package (unsorted groups, labelGain)."""
    X, y, group, _ = _queries(1, nq=80, shuffle=True)
    table = dict(features=X, label=y, g=group)
    tm = LightGBMRanker(groupCol="g", labelGain=LABEL_GAIN, device="cpu", **PARAMS).fit(
        Table(table))
    jm = ref["ranker"].LightGBMRanker(groupCol="g", labelGain=LABEL_GAIN, parallelism="serial",
                                      **PARAMS).fit(ref["Table"](table))
    return tm, jm, X


# -- group structure and the table sort ---------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_group_structure_matches_jax(ref, seed):
    _, _, group, _ = _queries(seed)
    ti, tg = tranker.group_structure(group)
    ji, jg = ref["ranker"].group_structure(group)
    assert tg == jg and ti.dtype == ji.dtype and np.array_equal(ti, ji)


@pytest.mark.parametrize("ascending", [True, False])
def test_sort_by_is_stable_as_the_references(ref, ascending):
    rng = np.random.default_rng(3)
    cols = dict(g=rng.integers(0, 7, 300), x=np.arange(300.0))
    got = Table(cols).sort_by("g", ascending=ascending)
    want = ref["Table"](cols).sort_by("g", ascending=ascending)
    assert np.array_equal(got["x"], np.asarray(want["x"]))
    assert np.array_equal(got["g"], np.asarray(want["g"]))


# -- the lambdarank gradient ----------------------------------------------------------


def _grad_both(ref, seed, margins, label_gain, sigma=1.0):
    _, y, group, w = _queries(seed)
    n = len(y)
    y, w = y.astype(np.float32), w.astype(np.float32)
    m = margins(n).astype(np.float32)[:, None]
    idx, _ = ref["ranker"].group_structure(group)
    jo = ref["ranker"].make_lambdarank_objective(idx, sigma, label_gain)
    jg, jh = ref["jax"].jit(jo.grad_hess)(m, y, w)
    to = tranker.make_lambdarank_objective(idx, sigma, label_gain)
    tg, th = to.grad_hess(*map(torch.from_numpy, (m, y, w)))
    return (tg.numpy(), th.numpy()), (np.asarray(jg), np.asarray(jh)), (idx, m, y, w)


MARGINS = {
    # iteration 0: every margin equal, ranks from the stable sort's tie order
    "ties": lambda n: np.zeros(n),
    "random": lambda n: np.random.default_rng(n).normal(size=n),
    "coarse": lambda n: np.round(np.random.default_rng(n + 1).normal(size=n), 1),
}


@pytest.mark.parametrize("label_gain", [None, LABEL_GAIN], ids=["default_gain", "label_gain"])
@pytest.mark.parametrize("margins", list(MARGINS))
def test_lambdarank_gradient_matches_jax(ref, margins, label_gain):
    (tg, th), (jg, jh), _ = _grad_both(ref, 4, MARGINS[margins], label_gain)
    for got, want in ((tg, jg), (th, jh)):
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * np.abs(want).max())
    assert (th > 0).all()


def test_lambdarank_sigma(ref):
    (tg, th), (jg, jh), _ = _grad_both(ref, 5, MARGINS["random"], None, sigma=2.5)
    np.testing.assert_allclose(tg, jg, rtol=0, atol=1e-6 * np.abs(jg).max())
    np.testing.assert_allclose(th, jh, rtol=0, atol=1e-6 * np.abs(jh).max())


@pytest.mark.parametrize("budget", [1, 100, 5000, 1 << 30])
def test_chunked_lambdas_equal_one_shot(budget):
    """Chunks of at most ``budget`` pair cells (one query at least) give the
    one-shot result bit for bit, at iteration 0's ties and after."""
    _, y, group, w = _queries(6, nq=50)
    idx, _ = tranker.group_structure(group)
    n = len(y)
    args = [torch.from_numpy(a.astype(np.float32)) for a in (y, w)]
    for m in (np.zeros(n), np.random.default_rng(7).normal(size=n)):
        m = torch.from_numpy(m.astype(np.float32))[:, None]
        one = tranker.make_lambdarank_objective(idx, 1.0, pair_budget=1 << 40).grad_hess(m, *args)
        chunked = tranker.make_lambdarank_objective(idx, 1.0, pair_budget=budget).grad_hess(
            m, *args)
        for a, b in zip(one, chunked):
            assert torch.equal(a, b)


def test_chunks_cover_every_row_once_within_budget():
    _, _, group, _ = _queries(8, nq=70)
    idx, _ = tranker.group_structure(group)
    n = len(group)
    budget = 2000
    chunks = tranker.lambdarank_chunks(idx, n, budget)
    rows = np.concatenate([c[c < n] for c in chunks])
    assert np.array_equal(np.sort(rows), np.arange(n))
    sizes = np.diff(np.flatnonzero(np.r_[True, group[1:] != group[:-1], True]))
    for c in chunks:
        assert c.shape[0] * c.shape[1] ** 2 <= budget or c.shape[0] == 1
        assert c.shape[1] == max(int((row < n).sum()) for row in c)
    assert max(c.shape[1] for c in chunks) == sizes.max()


# -- NDCG ---------------------------------------------------------------------------


@pytest.mark.parametrize("k", [1, 3, 5, 10])
@pytest.mark.parametrize("label_gain", [None, LABEL_GAIN], ids=["default_gain", "label_gain"])
def test_ndcg_matches_jax(ref, k, label_gain):
    _, y, group, _ = _queries(9)
    score = np.round(np.random.default_rng(k).normal(size=len(y)), 1)  # with ties
    got = tranker.ndcg_at_k(y, score, group, k, label_gain)
    assert got == ref["ranker"].ndcg_at_k(y, score, group, k, label_gain)
    assert 0.0 < got <= 1.0


def test_ndcg_of_the_ideal_order_is_one():
    y = np.array([0, 2, 1, 3, 0, 0, 1], float)
    group = np.array([0, 0, 0, 0, 1, 1, 1])
    assert tranker.ndcg_at_k(y, y, group, 3) == pytest.approx(1.0)


# -- fits ---------------------------------------------------------------------------


def test_ranker_fit_matches_jax(ref, fitted):
    tm, jm, X = fitted
    tb, jb = tm.booster, jm.booster
    for field in STRUCTURE:
        assert np.array_equal(getattr(tb, field), np.asarray(getattr(jb, field))), field
    jl = np.asarray(jb.leaf_values)
    np.testing.assert_allclose(tb.leaf_values, jl, rtol=0, atol=1e-5 * np.abs(jl).max())
    assert tb.objective == "lambdarank"
    text = tm.get_model_string()
    assert "objective=lambdarank" in text
    assert ref["texts_close"](text, jm.get_model_string())


def test_ranker_transform_matches_jax(ref, fitted):
    tm, jm, X = fitted
    got = tm.transform(Table({"features": X}))["prediction"]
    want = np.asarray(jm.transform(ref["Table"]({"features": X}))["prediction"])
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())


def test_ranker_fit_registers_no_objective(fitted):
    assert "lambdarank" not in tobj.OBJECTIVES
    with pytest.raises(ValueError, match="lambdarank"):
        tobj.get_objective("lambdarank")


def test_ranker_monitors_l2_unless_a_metric_is_set():
    assert LightGBMRanker(groupCol="g")._extra_train_options() == {"metric": "l2"}
    assert LightGBMRanker(groupCol="g", metric="l1")._extra_train_options() == {}


def test_label_gain_shorter_than_the_labels_is_refused():
    X, y, group, _ = _queries(10, nq=10)
    with pytest.raises(ValueError, match="labelGain has 3 entries"):
        LightGBMRanker(groupCol="g", labelGain=[0, 1, 3], device="cpu", numIterations=1).fit(
            Table(dict(features=X, label=y, g=group)))


def test_train_takes_the_objective_directly():
    """A per-fit objective through ``train(objective=...)``: the booster and
    the metric see its name, nothing is registered."""
    X, y, group, w = _queries(11, nq=30)
    bins, mapper = tbinning.bin_dataset(X, max_bin=15)
    idx, _ = tranker.group_structure(group)
    obj = tranker.make_lambdarank_objective(idx)
    res = ttrain.train(bins, y, ttrain.TrainOptions(num_iterations=2, num_leaves=4, max_bin=15,
                                                    metric="l2", provide_training_metric=True,
                                                    min_data_in_leaf=3),
                       w=w, mapper=mapper, device="cpu", objective=obj)
    assert res.booster.objective == "lambdarank" and res.booster.num_trees == 2
    assert len(res.evals["training"]["l2"]) == 2
    assert np.array_equal(res.booster.init_score, [0.0])


# -- the card -----------------------------------------------------------------------


@pytest.mark.cuda
def test_lambdarank_on_card_matches_the_cpu_port_and_feeds_the_kernel():
    """The lambdas on the card equal the CPU port's within 1e-6 of the
    largest (float64 pair sums, in the card's reduction order), and
    histogram.cu on iteration 0's lambdarank stats (many rows at g = 0, h =
    1e-16) is bit for bit its plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the kernel has no CPU mode")
    dev = torch.device("cuda")
    X, y, group, w = _queries(12, nq=400, max_size=300)
    idx, _ = tranker.group_structure(group)
    obj = tranker.make_lambdarank_objective(idx, pair_budget=1 << 18)
    m = torch.zeros(len(y), 1)
    yw = [torch.from_numpy(a.astype(np.float32)) for a in (y, w)]
    g_cpu, h_cpu = obj.grad_hess(m, *yw)
    g, h = obj.grad_hess(m.to(dev), *(a.to(dev) for a in yw))
    for a, b in ((g, g_cpu), (h, h_cpu)):
        np.testing.assert_allclose(a.cpu().numpy(), b.numpy(), rtol=0,
                                   atol=1e-6 * float(b.abs().max()))
    bins, _ = tbinning.bin_dataset(X, max_bin=255)
    bins_t = torch.from_numpy(bins).to(dev).t().contiguous()
    node = torch.from_numpy(np.random.default_rng(0).integers(0, 9, len(y)).astype(np.int32))
    args = (bins_t, g[:, 0].contiguous(), h[:, 0].contiguous(), torch.ones(len(y), device=dev),
            node.to(dev), 8, 256)
    torch.testing.assert_close(hh.build_histograms_cuda(*args), hh.build_histograms_plain(*args),
                               rtol=0, atol=0)
