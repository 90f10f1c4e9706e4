"""The port's nearest neighbors (``mmlspark_tpu_torch.nn``) and its top-k
(``mmlspark_tpu_torch.ops.topk``) against the JAX package's, on the CPU:
every case of ``tests/test_nn.py`` as a parity case, seeded numpy inputs
through both packages.

Bit for bit: the ball tree's answers (host numpy in both), and the
brute-force indices and scores wherever the scores are exact (integer
keys and queries, so every product and sum is an exact float32 integer):
duplicate keys tie exactly, and the port takes ``lax.top_k``'s order (the
lower index first). Within ``TOL`` = 1e-6 of the largest magnitude: the
brute-force scores of real-valued keys (``Q @ K.T`` in float32 sums in the
device's order, torch's here and XLA's in the reference), with equal
indices. Tests marked ``cuda`` need the card.
"""

import numpy as np
import pytest
import torch


def _import_reference():
    """Import the JAX package through the u_histogram shim (see
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

from mmlspark_tpu_torch.core.pipeline import PipelineStage
from mmlspark_tpu_torch.data.table import Table
from mmlspark_tpu_torch.lightgbm.convert import knn_model_from_jax
from mmlspark_tpu_torch.nn import (
    KNN,
    BallTree,
    ConditionalBallTree,
    ConditionalKNN,
    ConditionalKNNModel,
    KNNModel,
)
from mmlspark_tpu_torch.nn import knn as tknn
from mmlspark_tpu_torch.ops import topk as ttopk

TOL = 1e-6  # brute-force scores of real-valued keys, of the largest magnitude


@pytest.fixture(scope="module")
def ref():
    import jax
    from mmlspark_tpu import nn as jnn
    from mmlspark_tpu.core.pipeline import PipelineStage as JStage
    from mmlspark_tpu.data.table import Table as JTable
    from mmlspark_tpu.nn import knn as jknn

    return dict(nn=jnn, knn=jknn, Table=JTable, Stage=JStage, jax=jax)


def _index(rng, n=200, d=8):
    keys = rng.normal(size=(n, d))
    values = [f"v{i}" for i in range(n)]
    return keys, values


def _brute_topk(keys, q, k):
    scores = keys @ q
    order = np.argsort(-scores)[:k]
    return order, scores[order]


def _close(got, want, tol=TOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert err <= tol, f"max error {err:.3g} of the largest magnitude (tolerance {tol})"


def _same_matches(got, want, exact=False):
    """Two output columns of match lists: equal values (and labels), and
    distances bit for bit (``exact``) or within ``TOL``."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert [m["value"] for m in g] == [m["value"] for m in w]
        assert [m.get("label") for m in g] == [m.get("label") for m in w]
        if not g:
            continue
        gd, wd = [m["distance"] for m in g], [m["distance"] for m in w]
        if exact:
            assert gd == wd
        else:
            _close(gd, wd)


# -- ball tree -------------------------------------------------------------------


class TestBallTree:
    def test_matches_brute_force(self, ref):
        rng = np.random.default_rng(42)
        keys, values = _index(rng)
        tree = BallTree(keys, values, leaf_size=10)
        jtree = ref["nn"].BallTree(keys, values, leaf_size=10)
        for _ in range(5):
            q = rng.normal(size=8)
            got = tree.find_maximum_inner_products(q, k=7)
            want = jtree.find_maximum_inner_products(q, k=7)
            assert [(m.index, m.distance) for m in got] == [(m.index, m.distance) for m in want]
            exp_idx, exp_scores = _brute_topk(keys, q, 7)
            assert [m.index for m in got] == list(exp_idx)
            np.testing.assert_allclose([m.distance for m in got], exp_scores, rtol=1e-9)

    def test_save_load(self, tmp_path):
        rng = np.random.default_rng(42)
        keys, values = _index(rng, n=50)
        tree = BallTree(keys, values, leaf_size=5)
        path = str(tmp_path / "tree.pkl")
        tree.save(path)
        loaded = BallTree.load(path)
        q = rng.normal(size=8)
        assert [m.index for m in tree.find_maximum_inner_products(q, 3)] == \
               [m.index for m in loaded.find_maximum_inner_products(q, 3)]

    def test_loads_a_tree_the_reference_saved(self, ref, tmp_path):
        rng = np.random.default_rng(3)
        keys, values = _index(rng, n=60)
        labels = ["a" if i % 3 else "b" for i in range(60)]
        path = str(tmp_path / "jtree.pkl")
        ref["nn"].ConditionalBallTree(keys, values, labels, leaf_size=6).save(path)
        loaded = ConditionalBallTree.load(path)
        assert type(loaded) is ConditionalBallTree
        q = rng.normal(size=8)
        fresh = ConditionalBallTree(keys, values, labels, leaf_size=6)
        for cond in (None, {"b"}):
            a = loaded.find_maximum_inner_products(q, 4, conditioner=cond)
            b = fresh.find_maximum_inner_products(q, 4, conditioner=cond)
            assert [(m.index, m.distance) for m in a] == [(m.index, m.distance) for m in b]
        with pytest.raises(TypeError, match="expected"):
            KNNBallTreeSubclass.load(path)

    def test_duplicate_points(self, ref):
        keys = np.ones((20, 4))
        tree = BallTree(keys, list(range(20)), leaf_size=3)
        got = tree.find_maximum_inner_products(np.ones(4), k=3)
        want = ref["nn"].BallTree(keys, list(range(20)), leaf_size=3) \
            .find_maximum_inner_products(np.ones(4), k=3)
        assert [m.index for m in got] == [m.index for m in want]
        assert len(got) == 3
        assert all(abs(m.distance - 4.0) < 1e-12 for m in got)


class KNNBallTreeSubclass(BallTree):
    """A subclass the reference never pickled: loading its file must refuse."""


class TestConditionalBallTree:
    def test_conditioner_filters(self, ref):
        rng = np.random.default_rng(42)
        keys, values = _index(rng, n=100)
        labels = ["even" if i % 2 == 0 else "odd" for i in range(100)]
        tree = ConditionalBallTree(keys, values, labels, leaf_size=8)
        jtree = ref["nn"].ConditionalBallTree(keys, values, labels, leaf_size=8)
        q = rng.normal(size=8)
        got = tree.find_maximum_inner_products(q, k=5, conditioner={"even"})
        want = jtree.find_maximum_inner_products(q, k=5, conditioner={"even"})
        assert [(m.index, m.distance) for m in got] == [(m.index, m.distance) for m in want]
        assert all(int(m.index) % 2 == 0 for m in got)
        even = np.arange(0, 100, 2)
        exp = even[np.argsort(-(keys[even] @ q))[:5]]
        assert [m.index for m in got] == list(exp)


# -- KNN -------------------------------------------------------------------------


@pytest.mark.parametrize("method", ["brute", "balltree"])
class TestKNN:
    def test_fit_transform(self, ref, method):
        rng = np.random.default_rng(42)
        keys, values = _index(rng)
        qx = rng.normal(size=(11, 8))
        model = KNN(k=4, method=method, outputCol="matches", device="cpu").fit(
            Table({"features": keys, "values": np.array(values, dtype=object)}))
        jmodel = ref["nn"].KNN(k=4, method=method, outputCol="matches").fit(
            ref["Table"]({"features": keys, "values": np.array(values, dtype=object)}))
        matches = model.transform(Table({"features": qx}))["matches"]
        want = jmodel.transform(ref["Table"]({"features": qx}))["matches"]
        _same_matches(matches, want, exact=method == "balltree")
        assert len(matches) == 11
        for r in range(11):
            exp_idx, exp_scores = _brute_topk(keys, qx[r], 4)
            assert [m["value"] for m in matches[r]] == [values[i] for i in exp_idx]
            np.testing.assert_allclose([m["distance"] for m in matches[r]], exp_scores,
                                       rtol=1e-4)


class TestConditionalKNN:
    @pytest.mark.parametrize("method", ["brute", "balltree"])
    def test_per_row_conditioners(self, ref, method):
        rng = np.random.default_rng(42)
        keys, values = _index(rng, n=60)
        labels = [["a", "b", "c"][i % 3] for i in range(60)]
        conds = [{"a"}, {"b"}, {"a", "c"}, {"b", "c"}, {"a", "b", "c"}]
        qx = rng.normal(size=(5, 8))
        cols = {"features": keys, "values": np.array(values, dtype=object),
                "labels": np.array(labels, dtype=object)}
        model = ConditionalKNN(k=3, labelCol="labels", outputCol="m", method=method,
                               device="cpu").fit(Table(cols))
        jmodel = ref["nn"].ConditionalKNN(k=3, labelCol="labels", outputCol="m",
                                          method=method).fit(ref["Table"](cols))
        q = {"features": qx, "conditioner": np.array(conds, dtype=object)}
        out = model.transform(Table(q))["m"]
        _same_matches(out, jmodel.transform(ref["Table"](q))["m"], exact=method == "balltree")
        for r in range(5):
            for m in out[r]:
                assert m["label"] in conds[r]
            mask = np.array([l in conds[r] for l in labels])
            sub = np.where(mask)[0]
            exp = sub[np.argsort(-(keys[sub] @ qx[r]))[:3]]
            assert [values[i] for i in exp] == [m["value"] for m in out[r]]

    def test_empty_conditioner(self, ref):
        rng = np.random.default_rng(42)
        keys, values = _index(rng, n=10)
        cols = {"features": keys, "values": np.array(values, dtype=object),
                "labels": np.array(["x"] * 10, dtype=object)}
        q = {"features": rng.normal(size=(2, 8)),
             "conditioner": np.array([{"nope"}, {"x"}], dtype=object)}
        out = ConditionalKNN(k=2, labelCol="labels", outputCol="m", device="cpu") \
            .fit(Table(cols)).transform(Table(q))
        want = ref["nn"].ConditionalKNN(k=2, labelCol="labels", outputCol="m") \
            .fit(ref["Table"](cols)).transform(ref["Table"](q))
        _same_matches(out["m"], want["m"])
        assert out["m"][0] == []
        assert len(out["m"][1]) == 2

    def test_model_save_load(self, tmp_path):
        rng = np.random.default_rng(42)
        keys, values = _index(rng, n=30)
        model = KNN(k=2, outputCol="m", device="cpu").fit(
            Table({"features": keys, "values": np.array(values, dtype=object)}))
        path = str(tmp_path / "knn_model")
        model.save(path)
        loaded = KNNModel.load(path).setDevice("cpu")
        queries = Table({"features": rng.normal(size=(3, 8))})
        _same_matches(loaded.transform(queries)["m"], model.transform(queries)["m"],
                      exact=True)


@pytest.mark.parametrize("k", [5, 3, 1])
def test_knn_k_beyond_the_admissible_rows(ref, k):
    rng = np.random.default_rng(42)
    keys = rng.normal(size=(3, 4))
    cols = {"features": keys, "values": np.array(["a", "b", "c"], dtype=object),
            "labels": np.array(["p", "q", "p"], dtype=object)}
    qx = rng.normal(size=(2, 4))
    out = KNN(k=k, outputCol="m", device="cpu").fit(Table(cols)).transform(
        Table({"features": qx}))["m"]
    want = ref["nn"].KNN(k=k, outputCol="m").fit(ref["Table"](cols)).transform(
        ref["Table"]({"features": qx}))["m"]
    _same_matches(out, want)
    assert len(out[0]) == min(k, 3)
    q = {"features": qx, "conditioner": np.array([{"p"}, {"q"}], dtype=object)}
    cout = ConditionalKNN(k=k, labelCol="labels", outputCol="m", device="cpu").fit(
        Table(cols)).transform(Table(q))["m"]
    cwant = ref["nn"].ConditionalKNN(k=k, labelCol="labels", outputCol="m").fit(
        ref["Table"](cols)).transform(ref["Table"](q))["m"]
    _same_matches(cout, cwant)
    assert [len(c) for c in cout] == [min(k, 2), min(k, 1)]


def test_duplicate_keys_tie_in_the_references_order(ref):
    """Integer keys: exact float32 scores with many exact ties; indices and
    scores bit for bit, lower index first among equals."""
    rng = np.random.default_rng(11)
    base = rng.integers(-3, 4, size=(40, 6)).astype(np.float64)
    keys = np.concatenate([base, base, base[:10]])[rng.permutation(90)]
    values = [f"v{i}" for i in range(90)]
    labels = [["a", "b"][i % 2] for i in range(90)]
    qx = rng.integers(-2, 3, size=(17, 6)).astype(np.float64)
    qx[3] = 0.0  # every score 0: the first k indices
    cols = {"features": keys, "values": np.array(values, dtype=object),
            "labels": np.array(labels, dtype=object)}
    out = KNN(k=9, outputCol="m", device="cpu").fit(Table(cols)).transform(
        Table({"features": qx}))["m"]
    want = ref["nn"].KNN(k=9, outputCol="m").fit(ref["Table"](cols)).transform(
        ref["Table"]({"features": qx}))["m"]
    _same_matches(out, want, exact=True)
    assert [m["value"] for m in out[3]] == values[:9]
    q = {"features": qx, "conditioner": np.array([{"a"}, {"b"}] * 8 + [{"a", "b"}],
                                                dtype=object)}
    _same_matches(
        ConditionalKNN(k=6, labelCol="labels", outputCol="m", device="cpu").fit(
            Table(cols)).transform(Table(q))["m"],
        ref["nn"].ConditionalKNN(k=6, labelCol="labels", outputCol="m").fit(
            ref["Table"](cols)).transform(ref["Table"](q))["m"], exact=True)


def test_query_batches_and_no_queries(ref, monkeypatch):
    rng = np.random.default_rng(2)
    keys = rng.integers(-4, 5, size=(50, 5)).astype(np.float64)
    qx = rng.integers(-4, 5, size=(23, 5)).astype(np.float64)
    whole = tknn._topk_inner_products(keys, qx, 6, device="cpu")
    monkeypatch.setattr(tknn, "_QUERY_BATCH", 4)
    batched = tknn._topk_inner_products(keys, qx, 6, device="cpu")
    js, ji = ref["knn"]._topk_inner_products(keys, qx, 6)
    for got in (whole, batched):
        assert got[0].tobytes() == np.asarray(js).tobytes()
        assert got[1].tobytes() == np.asarray(ji).tobytes()
    s, i = tknn._topk_inner_products(keys, qx[:0], 6, device="cpu")
    assert s.shape == (0, 6) and i.shape == (0, 6)


def test_saved_models_load_both_ways(ref, tmp_path):
    rng = np.random.default_rng(42)
    keys, values = _index(rng, n=40)
    cols = {"features": keys, "values": np.array(values, dtype=object),
            "labels": np.array([["a", "b"][i % 2] for i in range(40)], dtype=object)}
    q = {"features": rng.normal(size=(6, 8)),
         "conditioner": np.array([{"a"}, {"b"}, {"a", "b"}] * 2, dtype=object)}
    jm = ref["nn"].ConditionalKNN(k=3, labelCol="labels", outputCol="m").fit(ref["Table"](cols))
    tm = ConditionalKNN(k=3, labelCol="labels", outputCol="m", device="cpu").fit(Table(cols))
    jm.save(str(tmp_path / "from_jax"))
    back = PipelineStage.load(str(tmp_path / "from_jax"))
    assert type(back) is ConditionalKNNModel and back.getDevice() == "cuda"
    _same_matches(back.setDevice("cpu").transform(Table(q))["m"], tm.transform(Table(q))["m"],
                  exact=True)
    tm.save(str(tmp_path / "from_port"))
    jback = ref["Stage"].load(str(tmp_path / "from_port"))
    assert type(jback).__name__ == "ConditionalKNNModel"
    _same_matches(tm.transform(Table(q))["m"], jback.transform(ref["Table"](q))["m"])


def test_carried_from_jax(ref):
    rng = np.random.default_rng(42)
    keys, values = _index(rng, n=40)
    labels = [["a", "b"][i % 2] for i in range(40)]
    cols = {"features": keys, "values": np.array(values, dtype=object),
            "labels": np.array(labels, dtype=object)}
    jm = ref["nn"].ConditionalKNN(k=3, labelCol="labels", outputCol="m").fit(ref["Table"](cols))
    carried = knn_model_from_jax(np.asarray(jm.getIndexKeys()), jm.getIndexValues(),
                                 jm.getIndexLabels(), k=3, outputCol="m", device="cpu")
    assert type(carried) is ConditionalKNNModel
    q = {"features": rng.normal(size=(4, 8)),
         "conditioner": np.array([{"a"}, {"b"}] * 2, dtype=object)}
    _same_matches(carried.transform(Table(q))["m"], jm.transform(ref["Table"](q))["m"])
    plain = knn_model_from_jax(keys, values, k=2, outputCol="m", device="cpu")
    assert type(plain) is KNNModel


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    rng = np.random.default_rng(0)
    keys, values = _index(rng, n=10)
    cols = {"features": keys, "values": np.array(values, dtype=object)}
    with pytest.raises(RuntimeError, match="device='cpu'"):
        KNN(k=2).fit(Table(cols))
    model = KNN(k=2, device="cpu").fit(Table(cols))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        model.setDevice("cuda").transform(Table({"features": keys}))
    # the host ball tree needs no device
    assert len(model.setMethod("balltree").transform(Table({"features": keys}))
               [model.getOutputCol()][0]) == 2


# -- top-k ---------------------------------------------------------------------------


def _rows_with_ties(seed, rows=12, n=3706):
    rng = np.random.default_rng(seed)
    s = np.zeros((rows, n), np.float32)
    for r in range(rows):
        s[r, rng.choice(n, 40, replace=False)] = rng.integers(1, 4, 40)
    s[0, [5, 900, 3000]] = 1.0  # the three-ones row
    s[1, :] = 0.0
    s[2, [7, 8]] = -0.0
    s[3, [10, 11]] = np.nan
    s[4, [12, 13]] = -np.inf
    s[5] = rng.normal(size=n).astype(np.float32)
    return s


@pytest.mark.parametrize("method", ["sort", "select", None])
@pytest.mark.parametrize("k", [1, 3, 10, 45, 3706])
def test_topk_order_equals_lax_top_k(ref, method, k):
    s = _rows_with_ties(k)
    jv, ji = ref["jax"].lax.top_k(s, k)
    v, i = ttopk.topk_ordered(torch.from_numpy(s), k, method=method)
    assert i.numpy().astype(np.int32).tobytes() == np.asarray(ji).tobytes()
    assert v.numpy().tobytes() == np.asarray(jv).tobytes()


def test_topk_three_ones():
    s = torch.zeros((1, 3706))
    s[0, [5, 900, 3000]] = 1.0
    for method in ("sort", "select"):
        _, i = ttopk.topk_ordered(s, 10, method=method)
        assert i[0].tolist() == [5, 900, 3000, 0, 1, 2, 3, 4, 6, 7]
    with pytest.raises(TypeError, match="float32"):
        ttopk.topk_ordered(s.double(), 2)
    with pytest.raises(ValueError, match="method"):
        ttopk.topk_ordered(s, 2, method="heap")


@pytest.mark.cuda
def test_card_knn_agrees_with_the_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rng = np.random.default_rng(5)
    keys = rng.normal(size=(5000, 64)).astype(np.float32)
    keys[100:200] = keys[:100]  # duplicate keys tie exactly
    qx = rng.normal(size=(300, 64))
    cs, ci = tknn._topk_inner_products(keys, qx, 7, device="cuda")
    ps, pi = tknn._topk_inner_products(keys, qx, 7, device="cpu")
    _close(cs, ps)
    # indices equal at every rank whose score stands apart from its neighbours
    gap = TOL * np.abs(ps).max()
    pad = np.full((len(ps), 1), np.inf)
    apart = np.minimum(np.abs(np.diff(np.hstack([pad, ps, pad]), axis=1))[:, :-1],
                       np.abs(np.diff(np.hstack([pad, ps, pad]), axis=1))[:, 1:]) > gap
    assert np.array_equal(ci[apart], pi[apart])
    ints = rng.integers(-3, 4, size=(5000, 16)).astype(np.float32)
    iq = rng.integers(-3, 4, size=(300, 16)).astype(np.float32)
    for method in ("sort", "select"):
        s = torch.from_numpy(iq @ ints.T)
        cv, cidx = ttopk.topk_ordered(s.cuda(), 25, method=method)
        pv, pidx = ttopk.topk_ordered(s, 25, method="sort")
        assert torch.equal(cidx.cpu(), pidx) and torch.equal(cv.cpu(), pv)
