"""Ranking evaluation + adapters (reference ``recommendation/``):

- :class:`AdvancedRankingMetrics` / :class:`RankingEvaluator` —
  ``RankingEvaluator.scala:15-152`` (map, ndcgAt, precisionAtk, recallAtK,
  diversityAtK, maxDiversity, mrr, fcp).
- :class:`RankingAdapter` / :class:`RankingAdapterModel` —
  ``RankingAdapter.scala:67-151`` (wrap any recommender to emit per-user
  (prediction, label) ranked lists for evaluation).
- :class:`RecommendationIndexer` — ``RecommendationIndexer.scala:17-101``
  (user/item value → dense index).
- :class:`RankingTrainValidationSplit` —
  ``RankingTrainValidationSplit.scala:24-328`` (user-stratified split with
  min-ratings filters, then fit/evaluate over a param grid).

The port's copy of ``mmlspark_tpu/recommendation/ranking.py`` (host code);
the recommender it wraps runs on its own ``device``.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from mmlspark_tpu_torch.core.params import Param, gt, one_of, to_float, to_int, to_str
from mmlspark_tpu_torch.core.pipeline import Estimator, Evaluator, Model, Transformer
from mmlspark_tpu_torch.data.table import Table
from mmlspark_tpu_torch.featurize.indexers import ValueIndexer


class AdvancedRankingMetrics:
    """All ranking metrics over per-row (predicted items, actual items)
    pairs — formulas match mllib ``RankingMetrics`` plus the reference's
    extras (``RankingEvaluator.scala:15-93``)."""

    def __init__(self, pred_and_labels: Sequence[Tuple[Sequence, Sequence]],
                 k: int, n_items: int):
        self.pairs = [(list(p), list(l)) for p, l in pred_and_labels]
        self.k = k
        self.n_items = n_items

    def mean_average_precision(self) -> float:
        out = []
        for pred, lab in self.pairs:
            lab_set = set(lab)
            if not lab_set:
                out.append(0.0)
                continue
            hits, score = 0, 0.0
            for i, p in enumerate(pred):
                if p in lab_set:
                    hits += 1
                    score += hits / (i + 1.0)
            out.append(score / len(lab_set))
        return float(np.mean(out)) if out else 0.0

    def ndcg_at(self) -> float:
        k = self.k
        out = []
        for pred, lab in self.pairs:
            lab_set = set(lab)
            if not lab_set:
                out.append(0.0)
                continue
            n = min(max(len(pred), len(lab)), k)
            dcg = sum(
                1.0 / np.log2(i + 2)
                for i in range(min(len(pred), n))
                if pred[i] in lab_set
            )
            idcg = sum(1.0 / np.log2(i + 2) for i in range(min(len(lab_set), n)))
            out.append(dcg / idcg if idcg > 0 else 0.0)
        return float(np.mean(out)) if out else 0.0

    def precision_at_k(self) -> float:
        k = self.k
        out = [
            len(set(pred[:k]) & set(lab)) / float(k)
            for pred, lab in self.pairs
        ]
        return float(np.mean(out)) if out else 0.0

    def recall_at_k(self) -> float:
        # Reference quirk preserved: denominator is |pred|, not |label|
        # (``RankingEvaluator.scala:27-30``).
        out = [
            len(set(pred) & set(lab)) / float(len(pred)) if pred else 0.0
            for pred, lab in self.pairs
        ]
        return float(np.mean(out)) if out else 0.0

    def diversity_at_k(self) -> float:
        recommended = set()
        for pred, _ in self.pairs:
            recommended.update(pred)
        return len(recommended) / float(self.n_items)

    def max_diversity(self) -> float:
        seen = set()
        for pred, lab in self.pairs:
            seen.update(lab)
            seen.update(pred)
        return len(seen) / float(self.n_items)

    def mean_reciprocal_rank(self) -> float:
        out = []
        for pred, lab in self.pairs:
            lab_set = set(lab)
            rr = 0.0
            if lab_set:
                for i, p in enumerate(pred):
                    if p in lab_set:
                        rr = 1.0 / (i + 1)
                        break
            out.append(rr)
        return float(np.mean(out)) if out else 0.0

    def fraction_concordant_pairs(self) -> float:
        out = []
        for pred, lab in self.pairs:
            nc = nd = 0.0
            for i, p in enumerate(pred):
                if i < len(lab):
                    if p == lab[i]:
                        nc += 1
                    else:
                        nd += 1
            out.append(nc / (nc + nd) if (nc + nd) > 0 else 0.0)
        return float(np.mean(out)) if out else 0.0

    _DISPATCH = {
        "map": mean_average_precision,
        "ndcgAt": ndcg_at,
        "precisionAtk": precision_at_k,
        "recallAtK": recall_at_k,
        "diversityAtK": diversity_at_k,
        "maxDiversity": max_diversity,
        "mrr": mean_reciprocal_rank,
        "fcp": fraction_concordant_pairs,
    }

    def match_metric(self, name: str) -> float:
        return self._DISPATCH[name](self)

    def get_all_metrics(self) -> Dict[str, float]:
        return {name: fn(self) for name, fn in self._DISPATCH.items()}


class RankingEvaluator(Evaluator):
    """Evaluates a table of per-user ``predictionCol``/``labelCol`` item
    lists (``RankingEvaluator.scala:98-152``)."""

    k = Param("Cutoff for ndcg/precision", default=10, converter=to_int,
              validator=gt(0))
    nItems = Param("Catalog size for diversity metrics", default=-1,
                   converter=to_int)
    metricName = Param("Which metric evaluate() returns", default="ndcgAt",
                       converter=to_str,
                       validator=one_of(*AdvancedRankingMetrics._DISPATCH))
    predictionCol = Param("Predicted item-list column", default="prediction",
                          converter=to_str)
    labelCol = Param("Actual item-list column", default="label", converter=to_str)

    def _metrics(self, table: Table) -> AdvancedRankingMetrics:
        preds = table.column(self.getPredictionCol())
        labels = table.column(self.getLabelCol())
        pairs = list(zip([list(p) for p in preds], [list(l) for l in labels]))
        n_items = self.getNItems()
        if n_items <= 0:
            n_items = len({i for p, l in pairs for i in list(p) + list(l)})
        return AdvancedRankingMetrics(pairs, self.getK(), max(n_items, 1))

    def get_metrics_map(self, table: Table) -> Dict[str, float]:
        return self._metrics(table).get_all_metrics()

    def evaluate(self, table: Table) -> float:
        return self._metrics(table).match_metric(self.getMetricName())

    def is_larger_better(self) -> bool:
        return True


class RecommendationIndexer(Estimator):
    """User/item value → dense index, with inverse transform
    (``RecommendationIndexer.scala:17-101``); composed from two
    :class:`ValueIndexer` fits."""

    userInputCol = Param("Raw user column", converter=to_str)
    userOutputCol = Param("Indexed user column", converter=to_str)
    itemInputCol = Param("Raw item column", converter=to_str)
    itemOutputCol = Param("Indexed item column", converter=to_str)
    ratingCol = Param("Rating column (passed through)", default="rating",
                      converter=to_str)

    def _fit(self, table: Table) -> "RecommendationIndexerModel":
        user_model = ValueIndexer(
            inputCol=self.getUserInputCol(), outputCol=self.getUserOutputCol()
        ).fit(table)
        item_model = ValueIndexer(
            inputCol=self.getItemInputCol(), outputCol=self.getItemOutputCol()
        ).fit(table)
        model = RecommendationIndexerModel(
            userInputCol=self.getUserInputCol(),
            userOutputCol=self.getUserOutputCol(),
            itemInputCol=self.getItemInputCol(),
            itemOutputCol=self.getItemOutputCol(),
            userIndexModel=user_model,
            itemIndexModel=item_model,
        )
        model.parent = self
        return model


class RecommendationIndexerModel(Model):
    userInputCol = Param("Raw user column", converter=to_str)
    userOutputCol = Param("Indexed user column", converter=to_str)
    itemInputCol = Param("Raw item column", converter=to_str)
    itemOutputCol = Param("Indexed item column", converter=to_str)
    userIndexModel = Param("Fitted user ValueIndexerModel", is_complex=True,
                           default=None)
    itemIndexModel = Param("Fitted item ValueIndexerModel", is_complex=True,
                           default=None)

    def transform(self, table: Table) -> Table:
        out = self.getUserIndexModel().transform(table)
        return self.getItemIndexModel().transform(out)

    def recover_user(self, indices: np.ndarray) -> np.ndarray:
        from mmlspark_tpu_torch.featurize.indexers import decode_levels

        return decode_levels(indices, self.getUserIndexModel().getLevels())

    def recover_item(self, indices: np.ndarray) -> np.ndarray:
        from mmlspark_tpu_torch.featurize.indexers import decode_levels

        return decode_levels(indices, self.getItemIndexModel().getLevels())


class RankingAdapter(Estimator):
    """Wraps a recommender Estimator so its output can feed
    :class:`RankingEvaluator` (``RankingAdapter.scala:67-97``)."""

    recommender = Param("The wrapped recommender estimator", is_complex=True)
    k = Param("Recommendations per user", default=10, converter=to_int,
              validator=gt(0))
    mode = Param("allUsers (recommendForAllUsers)", default="allUsers",
                 converter=to_str, validator=one_of("allUsers"))
    labelCol = Param("Output column of per-user actual items", default="label",
                     converter=to_str)

    def _fit(self, table: Table) -> "RankingAdapterModel":
        rec_model = self.getRecommender().fit(table)
        model = RankingAdapterModel(
            recommenderModel=rec_model,
            k=self.getK(),
            mode=self.getMode(),
            labelCol=self.getLabelCol(),
        )
        model.parent = self
        return model


class RankingAdapterModel(Model):
    """transform(): per-user top-k ground truth (by rating desc) joined with
    the recommender's top-k predictions (``RankingAdapter.scala:116-141``)."""

    recommenderModel = Param("Fitted recommender", is_complex=True, default=None)
    k = Param("Recommendations per user", default=10, converter=to_int)
    mode = Param("allUsers", default="allUsers", converter=to_str)
    labelCol = Param("Per-user actual item lists", default="label", converter=to_str)

    def transform(self, table: Table) -> Table:
        rec = self.getRecommenderModel()
        user_col, item_col = rec.getUserCol(), rec.getItemCol()
        rating_col = rec.getRatingCol()
        k = self.getK()

        users = table.column(user_col).astype(np.int64)
        items = table.column(item_col).astype(np.int64)
        ratings = (
            table.column(rating_col).astype(np.float64)
            if rating_col in table
            else np.ones(len(users))
        )
        # per-user actual top-k items ordered by rating desc, item asc
        order = np.lexsort((items, -ratings, users))
        actual: Dict[int, List[int]] = {}
        for i in order:
            u = int(users[i])
            lst = actual.setdefault(u, [])
            if len(lst) < k:
                lst.append(int(items[i]))

        recs = rec.recommend_for_user_subset(table, k)
        rec_users = recs.column(user_col).astype(np.int64)
        rec_items = recs.column("recommendations")

        preds = np.empty(len(rec_users), dtype=object)
        labels = np.empty(len(rec_users), dtype=object)
        for n, u in enumerate(rec_users):
            preds[n] = [int(v) for v in rec_items[n]]
            labels[n] = actual.get(int(u), [])
        return Table({"prediction": preds, self.getLabelCol(): labels})


class RankingTrainValidationSplit(Estimator):
    """User-stratified train/validation split + grid evaluation
    (``RankingTrainValidationSplit.scala:24-328``). Rows of users/items with
    fewer than ``minRatingsU``/``minRatingsI`` events are dropped, each
    user's events are split by ``trainRatio``, and each param map is
    fitted on train / scored on validation with :class:`RankingEvaluator`."""

    estimator = Param("Recommender estimator (fit via RankingAdapter)",
                      is_complex=True)
    evaluator = Param("RankingEvaluator", is_complex=True, default=None)
    estimatorParamMaps = Param("Param maps to sweep (list of dicts)",
                               default=None, is_complex=True)
    trainRatio = Param("Fraction of each user's events in train", default=0.75,
                       converter=to_float, validator=lambda v: 0.0 < v < 1.0)
    minRatingsU = Param("Min events per user", default=1, converter=to_int,
                        validator=gt(0))
    minRatingsI = Param("Min events per item", default=1, converter=to_int,
                        validator=gt(0))
    userCol = Param("User column", default="user", converter=to_str)
    itemCol = Param("Item column", default="item", converter=to_str)
    ratingCol = Param("Rating column", default="rating", converter=to_str)
    seed = Param("Split RNG seed", default=42, converter=to_int)

    def _filter_min_ratings(self, table: Table) -> Table:
        users = table.column(self.getUserCol()).astype(np.int64)
        items = table.column(self.getItemCol()).astype(np.int64)
        keep = np.ones(len(users), dtype=bool)
        u_counts = np.bincount(users)
        i_counts = np.bincount(items)
        keep &= u_counts[users] >= self.getMinRatingsU()
        keep &= i_counts[items] >= self.getMinRatingsI()
        return table.filter(keep)

    def split(self, table: Table) -> Tuple[Table, Table]:
        table = self._filter_min_ratings(table)
        users = table.column(self.getUserCol()).astype(np.int64)
        rng = np.random.default_rng(self.getSeed())
        ratio = self.getTrainRatio()
        in_train = np.zeros(len(users), dtype=bool)
        # one O(n log n) pass: group rows by user, shuffle within each group
        order = np.argsort(users, kind="stable")
        _, starts = np.unique(users[order], return_index=True)
        bounds = np.append(starts, len(users))
        for s, e in zip(bounds[:-1], bounds[1:]):
            rows = order[s:e].copy()
            rng.shuffle(rows)
            n_train = max(1, int(round(len(rows) * ratio)))
            in_train[rows[:n_train]] = True
        return table.filter(in_train), table.filter(~in_train)

    def _fit(self, table: Table) -> "RankingTrainValidationSplitModel":
        train, valid = self.split(table)
        evaluator = self.getEvaluator() or RankingEvaluator()
        grids = self.getEstimatorParamMaps() or [{}]
        best_metric, best_model, all_metrics = None, None, []
        for grid in grids:
            est = self.getEstimator().copy(grid) if grid else self.getEstimator()
            adapter = RankingAdapter(recommender=est, k=evaluator.getK())
            model = adapter.fit(train)
            metric = evaluator.evaluate(model.transform(valid))
            all_metrics.append(metric)
            better = (
                best_metric is None
                or (metric > best_metric) == evaluator.is_larger_better()
            )
            if better:
                best_metric, best_model = metric, model
        out = RankingTrainValidationSplitModel(
            bestModel=best_model,
            validationMetrics=all_metrics,
        )
        out.parent = self
        return out


class RankingTrainValidationSplitModel(Model):
    bestModel = Param("Best RankingAdapterModel", is_complex=True, default=None)
    validationMetrics = Param("Metric per param map", default=None)

    def transform(self, table: Table) -> Table:
        return self.getBestModel().transform(table)
