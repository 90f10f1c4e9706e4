"""The port's recommendation package (``mmlspark_tpu_torch.recommendation``)
against the JAX package's, on the CPU: every case of
``tests/test_recommendation.py`` as a parity case, seeded numpy inputs
through both packages.

Bit for bit: the affinity (host float64), the co-occurrence (integer counts
below 2^24 in float32, exact on any device) and so the similarity; the
ranking metrics, splits, indexers and adapter lists (host code); and the
top-k order on exact ties (an unseen item's score is exactly 0 on both
sides, and ties go to the lower item, as ``lax.top_k`` takes them).
Within ``TOL`` = 1e-6 of the largest: the float32 scores ``A @ S`` (the
sum's order follows the device), with equal items at every rank whose
score stands more than ``TOL`` apart from its neighbours. Tests marked
``cuda`` need the card.
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
from mmlspark_tpu_torch.lightgbm.convert import sar_model_from_jax
from mmlspark_tpu_torch.recommendation import (
    SAR,
    AdvancedRankingMetrics,
    RankingAdapter,
    RankingEvaluator,
    RankingTrainValidationSplit,
    RecommendationIndexer,
    SARModel,
)
from mmlspark_tpu_torch.recommendation import sar as tsar

TOL = 1e-6  # float32 scores, of the largest


@pytest.fixture(scope="module")
def ref():
    from mmlspark_tpu import recommendation as jrec
    from mmlspark_tpu.core.pipeline import PipelineStage as JStage
    from mmlspark_tpu.data.table import Table as JTable

    return dict(rec=jrec, Table=JTable, Stage=JStage)


def _events():
    """The reference tests' 4 users × 5 items; users 0/1 share items
    {0,1,2}, users 2/3 share {3,4}."""
    users, items = [], []
    for u, its in [(0, [0, 1, 2]), (1, [0, 1, 2]), (2, [3, 4]), (3, [3, 4, 0])]:
        for i in its:
            users.append(u)
            items.append(i)
    return {"user": np.array(users, dtype=np.int64), "item": np.array(items, dtype=np.int64),
            "rating": np.ones(len(users))}


def _movielens_like(n_users=300, n_items=180, n_events=6000, seed=0):
    """A small MovieLens-shaped event log: Zipf item popularity, ratings
    1-5, timestamps over three years."""
    rng = np.random.default_rng(seed)
    items = (rng.zipf(1.3, size=n_events) - 1) % n_items
    return {"user": rng.integers(0, n_users, n_events).astype(np.int64),
            "item": items.astype(np.int64),
            "rating": rng.integers(1, 6, n_events).astype(np.float64),
            "timestamp": rng.uniform(0, 3 * 365 * 86400, n_events) + 9.5e8}


def _bits(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert got.tobytes() == want.astype(got.dtype).tobytes(), f"{np.sum(got != want)} differ"


def _close(got, want, tol=TOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert err <= tol, f"max error {err:.3g} of the largest (tolerance {tol})"


def _same_recommendations(got_idx, got_s, want_idx, want_s, tol=TOL):
    """Scores within ``tol`` of the largest; items equal at every rank whose
    score stands apart from its neighbours, and at every exactly tied
    rank."""
    got_idx, want_idx = np.asarray(got_idx), np.asarray(want_idx)
    got_s, want_s = np.asarray(got_s, np.float64), np.asarray(want_s, np.float64)
    _close(got_s, want_s, tol)
    gap = tol * max(np.abs(want_s).max(), 1e-30)
    pad = np.full((len(want_s), 1), np.inf)
    d = np.abs(np.diff(np.hstack([pad, want_s, pad]), axis=1))
    apart = np.minimum(d[:, :-1], d[:, 1:]) > gap
    exact_tie = (got_s == want_s) & ~apart
    assert np.array_equal(got_idx[apart | exact_tie], want_idx[apart | exact_tie])
    return float(apart.mean())


def _both(ref, cols, **params):
    jm = ref["rec"].SAR(**params).fit(ref["Table"](cols))
    tm = SAR(device="cpu", **params).fit(Table(cols))
    return jm, tm


class TestSAR:
    @pytest.mark.parametrize("fn", ["jaccard", "lift", "cooccurrence"])
    @pytest.mark.parametrize("threshold", [1, 3])
    def test_factors_are_the_references_bits(self, ref, fn, threshold):
        for cols in (_events(), _movielens_like()):
            jm, tm = _both(ref, cols, supportThreshold=threshold, similarityFunction=fn)
            _bits(tm.getUserAffinity(), jm.getUserAffinity())
            _bits(tm.getItemSimilarity(), jm.getItemSimilarity())

    def test_cooccurrence_similarity(self, ref):
        jm, model = _both(ref, _events(), supportThreshold=1, similarityFunction="cooccurrence")
        sim = model.getItemSimilarity()
        assert sim[0, 1] == 2.0 and sim[0, 0] == 3.0 and sim[3, 4] == 2.0 and sim[1, 3] == 0.0

    def test_jaccard_similarity(self, ref):
        _, model = _both(ref, _events(), supportThreshold=1)
        sim = model.getItemSimilarity()
        np.testing.assert_allclose(sim[0, 1], 2 / 3, rtol=1e-6)
        np.testing.assert_allclose(sim[1, 2], 1.0, rtol=1e-6)

    def test_lift_similarity(self, ref):
        _, model = _both(ref, _events(), supportThreshold=1, similarityFunction="lift")
        np.testing.assert_allclose(model.getItemSimilarity()[0, 1], 2 / (3 * 2), rtol=1e-6)

    def test_support_threshold(self, ref):
        _, model = _both(ref, _events(), supportThreshold=3, similarityFunction="cooccurrence")
        sim = model.getItemSimilarity()
        assert sim[0, 1] == 0.0 and sim[0, 0] == 3.0

    @pytest.mark.parametrize("start", [None, "1970-01-31T00:00:00"])
    def test_time_decay(self, ref, start):
        cols = {"user": np.array([0, 0], dtype=np.int64),
                "item": np.array([0, 1], dtype=np.int64),
                "timestamp": np.array([0.0, 30 * 24 * 3600.0])}
        jm, tm = _both(ref, cols, timeDecayCoeff=30, supportThreshold=1, startTime=start)
        _bits(tm.getUserAffinity(), jm.getUserAffinity())
        if start is None:
            np.testing.assert_allclose(tm.getUserAffinity()[0], [0.5, 1.0], rtol=1e-6)

    def test_iso_string_times(self, ref):
        cols = {"user": np.array([0, 1, 1], dtype=np.int64),
                "item": np.array([0, 1, 0], dtype=np.int64),
                "timestamp": np.array(["2020-01-01T00:00:00", "2020-02-01T12:00:00",
                                       "2020-03-01"], dtype=object)}
        jm, tm = _both(ref, cols, supportThreshold=1)
        _bits(tm.getUserAffinity(), jm.getUserAffinity())

    def test_recommendations(self, ref):
        jm, model = _both(ref, _events(), supportThreshold=1)
        recs = model.recommend_for_all_users(3)
        want = jm.recommend_for_all_users(3)
        assert recs.num_rows == 4
        _same_recommendations(recs["recommendations"], recs["ratings"],
                              want["recommendations"], want["ratings"])
        top = set(int(v) for v in recs["recommendations"][0])
        assert {0, 1, 2} & top
        r = recs["ratings"][0]
        assert all(r[i] >= r[i + 1] for i in range(len(r) - 1))

    @pytest.mark.parametrize("k", [1, 10, 180, 500])
    def test_recommendations_at_movielens_shape(self, ref, k):
        jm, tm = _both(ref, _movielens_like(), supportThreshold=4)
        got, want = tm.recommend_for_all_users(k), jm.recommend_for_all_users(k)
        _bits(got["user"], want["user"])
        _same_recommendations(got["recommendations"], got["ratings"],
                              want["recommendations"], want["ratings"])

    def test_all_zero_rows_tie_in_item_order(self, ref):
        """Users whose every score is 0 (their items have no similar items
        above the threshold) get items 0..k-1, as lax.top_k orders ties."""
        cols = _movielens_like(n_users=60, n_items=90, n_events=2000, seed=4)
        # 8 users of one rare item each (seen once: below the threshold),
        # then a gap of ids (users with no events at all)
        rare = {"user": np.arange(70, 78), "item": np.arange(90, 98),
                "rating": np.full(8, 3.0), "timestamp": np.full(8, 1e9)}
        cols = {c: np.concatenate([cols[c], rare[c].astype(cols[c].dtype)]) for c in cols}
        jm, tm = _both(ref, cols, supportThreshold=4)
        got, want = tm.recommend_for_all_users(12), jm.recommend_for_all_users(12)
        zero = np.all(np.asarray(want["ratings"]) == 0.0, axis=1)
        assert zero.sum() >= 18
        _bits(got["recommendations"][zero], want["recommendations"][zero])
        assert np.all(got["recommendations"][zero] == np.arange(12))
        _same_recommendations(got["recommendations"], got["ratings"],
                              want["recommendations"], want["ratings"])

    def test_user_subset(self, ref):
        jm, model = _both(ref, _events(), supportThreshold=1)
        sub = {"user": np.array([2, 2, 3], dtype=np.int64),
               "item": np.array([0, 0, 0], dtype=np.int64)}
        recs = model.recommend_for_user_subset(Table(sub), 2)
        want = jm.recommend_for_user_subset(ref["Table"](sub), 2)
        assert list(recs["user"]) == [2, 3] == list(want["user"])
        _same_recommendations(recs["recommendations"], recs["ratings"],
                              want["recommendations"], want["ratings"])

    def test_transform_scores(self, ref):
        jm, model = _both(ref, _events(), supportThreshold=1)
        out = model.transform(Table(_events()))
        assert out["prediction"].shape == (len(_events()["user"]),)
        _bits(out["prediction"], jm.transform(ref["Table"](_events()))["prediction"])

    def test_save_load(self, tmp_path):
        model = SAR(supportThreshold=1, device="cpu").fit(Table(_events()))
        model.save(str(tmp_path / "sar"))
        loaded = SARModel.load(str(tmp_path / "sar"))
        assert loaded.getDevice() == "cuda"
        np.testing.assert_array_equal(model.getItemSimilarity(), loaded.getItemSimilarity())

    def test_saved_models_load_both_ways(self, ref, tmp_path):
        cols = _movielens_like()
        jm, tm = _both(ref, cols, supportThreshold=2)
        jm.save(str(tmp_path / "from_jax"))
        back = PipelineStage.load(str(tmp_path / "from_jax"))
        assert type(back) is SARModel
        _bits(back.getItemSimilarity(), tm.getItemSimilarity())
        a = back.setDevice("cpu").recommend_for_all_users(5)
        b = tm.recommend_for_all_users(5)
        _bits(a["recommendations"], b["recommendations"])
        _bits(a["ratings"], b["ratings"])
        tm.save(str(tmp_path / "from_port"))
        jback = ref["Stage"].load(str(tmp_path / "from_port"))
        assert type(jback).__name__ == "SARModel"
        _bits(jback.getUserAffinity(), tm.getUserAffinity())

    def test_carried_from_jax(self, ref):
        jm, tm = _both(ref, _movielens_like(), supportThreshold=2)
        carried = sar_model_from_jax(jm.getUserAffinity(), jm.getItemSimilarity(),
                                     device="cpu")
        a, b = carried.recommend_for_all_users(4), tm.recommend_for_all_users(4)
        _bits(a["recommendations"], b["recommendations"])
        _bits(a["ratings"], b["ratings"])

    def test_similarity_copy_is_dropped_when_set(self):
        tm = SAR(supportThreshold=1, device="cpu").fit(Table(_events()))
        first = tm.recommend_for_all_users(2)
        cached = tm._similarity_on(torch.device("cpu"))
        assert tm._similarity_on(torch.device("cpu")) is cached
        tm.setItemSimilarity(np.eye(5))
        assert tm._similarity_on(torch.device("cpu")) is not cached
        again = tm.recommend_for_all_users(2)
        assert not np.array_equal(again["ratings"], first["ratings"])
        twin = tm.copy({"itemSimilarity": tm.getItemSimilarity() * 2})
        assert twin._similarity_on(torch.device("cpu")) is not \
            tm._similarity_on(torch.device("cpu"))

    def test_entry_points_default_to_the_card(self):
        if torch.cuda.is_available():
            pytest.skip("a card is present")
        with pytest.raises(RuntimeError, match="device='cpu'"):
            SAR(supportThreshold=1).fit(Table(_events()))
        model = SAR(supportThreshold=1, device="cpu").fit(Table(_events()))
        with pytest.raises(RuntimeError, match="device='cpu'"):
            model.setDevice("cuda").recommend_for_all_users(2)

    def test_negative_ids_raise(self, ref):
        cols = _events()
        cols["user"][0] = -1
        with pytest.raises(ValueError, match="non-negative"):
            SAR(device="cpu").fit(Table(cols))


class TestRankingMetrics:
    def test_known_values(self, ref):
        pairs = [([1, 2, 3], [1, 3]), ([4, 5], [6])]
        m = AdvancedRankingMetrics(pairs, k=3, n_items=6)
        jm = ref["rec"].AdvancedRankingMetrics(pairs, k=3, n_items=6)
        assert m.get_all_metrics() == jm.get_all_metrics()
        np.testing.assert_allclose(m.mean_average_precision(), (5 / 6) / 2)
        np.testing.assert_allclose(m.mean_reciprocal_rank(), 0.5)
        np.testing.assert_allclose(m.precision_at_k(), (2 / 3) / 2)
        np.testing.assert_allclose(m.recall_at_k(), (2 / 3) / 2)
        np.testing.assert_allclose(m.diversity_at_k(), 5 / 6)
        np.testing.assert_allclose(m.max_diversity(), 1.0)

    def test_ndcg_perfect(self):
        np.testing.assert_allclose(
            AdvancedRankingMetrics([([1, 2], [1, 2])], k=2, n_items=2).ndcg_at(), 1.0)

    def test_random_lists(self, ref):
        rng = np.random.default_rng(8)
        pairs = [(list(rng.choice(30, rng.integers(0, 8), replace=False)),
                  list(rng.choice(30, rng.integers(0, 6), replace=False))) for _ in range(50)]
        for k in (1, 5, 10):
            assert AdvancedRankingMetrics(pairs, k, 30).get_all_metrics() == \
                ref["rec"].AdvancedRankingMetrics(pairs, k, 30).get_all_metrics()

    def test_evaluator(self, ref):
        cols = {"prediction": np.array([[1, 2, 3], [4, 5, 6]]),
                "label": np.array([[1, 3, 7], [9, 9, 9]])}
        ev = RankingEvaluator(k=3, nItems=10, metricName="precisionAtk")
        jev = ref["rec"].RankingEvaluator(k=3, nItems=10, metricName="precisionAtk")
        assert ev.evaluate(Table(cols)) == jev.evaluate(ref["Table"](cols))
        np.testing.assert_allclose(ev.evaluate(Table(cols)), (2 / 3) / 2)
        allm = ev.get_metrics_map(Table(cols))
        assert set(allm) == set(AdvancedRankingMetrics._DISPATCH)
        assert allm == jev.get_metrics_map(ref["Table"](cols))
        assert RankingEvaluator(k=2).get_metrics_map(Table(cols)) == \
            ref["rec"].RankingEvaluator(k=2).get_metrics_map(ref["Table"](cols))


class TestRankingAdapter:
    def test_fit_transform(self, ref):
        out = RankingAdapter(recommender=SAR(supportThreshold=1, device="cpu"), k=3) \
            .fit(Table(_events())).transform(Table(_events()))
        want = ref["rec"].RankingAdapter(recommender=ref["rec"].SAR(supportThreshold=1), k=3) \
            .fit(ref["Table"](_events())).transform(ref["Table"](_events()))
        assert set(out.columns) == {"prediction", "label"}
        assert out.num_rows == 4
        assert [list(p) for p in out["prediction"]] == [list(p) for p in want["prediction"]]
        assert [list(p) for p in out["label"]] == [list(p) for p in want["label"]]
        ev = RankingEvaluator(k=3, nItems=5)
        assert 0.0 <= ev.evaluate(out) <= 1.0


class TestRecommendationIndexer:
    def test_roundtrip(self, ref):
        cols = {"customer": np.array(["alice", "bob", "alice"], dtype=object),
                "product": np.array(["x", "y", "y"], dtype=object)}
        kw = dict(userInputCol="customer", userOutputCol="user", itemInputCol="product",
                  itemOutputCol="item")
        model = RecommendationIndexer(**kw).fit(Table(cols))
        jmodel = ref["rec"].RecommendationIndexer(**kw).fit(ref["Table"](cols))
        out = model.transform(Table(cols))
        want = jmodel.transform(ref["Table"](cols))
        for c in ("user", "item"):
            _bits(out[c], want[c])
        assert set(np.unique(out["user"])) == {0, 1}
        assert list(model.recover_user(out["user"])) == ["alice", "bob", "alice"]
        assert list(model.recover_item(out["item"])) == list(jmodel.recover_item(want["item"]))


class TestRankingTVS:
    def test_split_and_fit(self, ref):
        kw = dict(trainRatio=0.6, seed=7)
        tvs = RankingTrainValidationSplit(estimator=SAR(supportThreshold=1, device="cpu"),
                                          evaluator=RankingEvaluator(k=2, nItems=5), **kw)
        jtvs = ref["rec"].RankingTrainValidationSplit(
            estimator=ref["rec"].SAR(supportThreshold=1),
            evaluator=ref["rec"].RankingEvaluator(k=2, nItems=5), **kw)
        train, valid = tvs.split(Table(_events()))
        jtrain, jvalid = jtvs.split(ref["Table"](_events()))
        for a, b in ((train, jtrain), (valid, jvalid)):
            for c in ("user", "item", "rating"):
                _bits(a[c], b[c])
        assert train.num_rows + valid.num_rows == len(_events()["user"])
        assert set(np.unique(train["user"])) == {0, 1, 2, 3}
        model = tvs.fit(Table(_events()))
        assert model.getValidationMetrics() == jtvs.fit(
            ref["Table"](_events())).getValidationMetrics()
        assert "prediction" in model.transform(Table(_events()))

    def test_split_at_movielens_shape(self, ref):
        kw = dict(trainRatio=0.75, seed=3, minRatingsU=5, minRatingsI=3)
        cols = _movielens_like()
        a = RankingTrainValidationSplit(estimator=SAR(device="cpu"), **kw).split(Table(cols))
        b = ref["rec"].RankingTrainValidationSplit(estimator=ref["rec"].SAR(), **kw).split(
            ref["Table"](cols))
        for x, y in zip(a, b):
            for c in ("user", "item", "rating", "timestamp"):
                _bits(x[c], y[c])

    def test_grid_over_param_maps(self, ref):
        maps = [{"supportThreshold": 1}, {"supportThreshold": 2, "similarityFunction": "lift"}]
        cols = _movielens_like(n_users=80, n_items=60, n_events=1500, seed=9)
        got = RankingTrainValidationSplit(
            estimator=SAR(device="cpu"), estimatorParamMaps=maps, seed=1,
            evaluator=RankingEvaluator(k=5, metricName="map")).fit(Table(cols))
        want = ref["rec"].RankingTrainValidationSplit(
            estimator=ref["rec"].SAR(), estimatorParamMaps=maps, seed=1,
            evaluator=ref["rec"].RankingEvaluator(k=5, metricName="map")).fit(
            ref["Table"](cols))
        np.testing.assert_allclose(got.getValidationMetrics(), want.getValidationMetrics(),
                                   rtol=1e-12)

    def test_min_ratings_filter(self, ref):
        kw = dict(minRatingsU=3, minRatingsI=1, userCol="user", itemCol="item")
        filtered = RankingTrainValidationSplit(
            estimator=SAR(supportThreshold=1, device="cpu"), **kw)._filter_min_ratings(
            Table(_events()))
        want = ref["rec"].RankingTrainValidationSplit(
            estimator=ref["rec"].SAR(supportThreshold=1), **kw)._filter_min_ratings(
            ref["Table"](_events()))
        _bits(filtered["user"], want["user"])
        assert 2 not in set(np.unique(filtered["user"]))


def test_cold_start_ids(ref):
    jm, model = _both(ref, _events(), supportThreshold=1)
    t = {"user": np.array([0, 99], dtype=np.int64), "item": np.array([55, 0], dtype=np.int64)}
    out = model.transform(Table(t))
    assert out["prediction"][0] == 0.0 and out["prediction"][1] == 0.0
    _bits(out["prediction"], jm.transform(ref["Table"](t))["prediction"])
    sub = {"user": np.array([1, 42], dtype=np.int64), "item": np.array([0, 0], dtype=np.int64)}
    recs = model.recommend_for_user_subset(Table(sub), 2)
    assert list(recs["user"]) == [1]


@pytest.mark.cuda
def test_card_recommendations_agree_with_the_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cols = _movielens_like(n_users=2000, n_items=700, n_events=60000, seed=2)
    card = SAR(supportThreshold=4, device="cuda").fit(Table(cols))
    cpu = SAR(supportThreshold=4, device="cpu").fit(Table(cols))
    _bits(card.getItemSimilarity(), cpu.getItemSimilarity())
    a = card.recommend_for_all_users(10)
    b = cpu.recommend_for_all_users(10)
    _same_recommendations(a["recommendations"], a["ratings"], b["recommendations"],
                          b["ratings"])
    assert tsar._cooccurrence(np.ones((3, 2), np.float32), "cuda").tolist() == [[3, 3], [3, 3]]
