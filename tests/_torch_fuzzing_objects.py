"""Per-stage fixtures of the port's fuzzing meta-suite.

The port's copy of ``tests/fuzzing_objects.py``: the same fixtures, on the
port's stages, each stage that runs torch given ``device="cpu"``. Every
concrete public ``PipelineStage`` of ``mmlspark_tpu_torch`` (but
``cognitive``, fuzzed in its own tests) must appear in ``TEST_OBJECTS``, be
named as a fixture's ``fit_produces`` model, or carry an ``EXEMPT`` entry
with the reference's reason. ``tests/test_torch_fuzzing.py`` enforces it.

Fixtures are zero-arg callables so stage/table construction stays lazy.
Each fits, transforms and round-trips in well under a second here (tiny
tables, a few trees), so none is a heavy case. Not a test module: pytest
collects nothing here.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

import numpy as np

from mmlspark_tpu_torch.data.table import Table


@dataclasses.dataclass
class TestObject:
    __test__ = False  # a fixture, not a test class
    stage: Any
    table: Table
    transform_table: Optional[Table] = None  # defaults to `table`
    check_transform: bool = True  # False: construct/serde only (needs a live server)
    fit_produces: Optional[str] = None  # qualname of the model class fit() returns


def _rng(seed=0):
    return np.random.default_rng(seed)


def _numeric_table(n=40, f=4, seed=0):
    rng = _rng(seed)
    X = rng.normal(size=(n, f))
    y = (X[:, 0] > 0).astype(np.float64)
    return Table({"features": X, "label": y})


def _mixed_table():
    rng = _rng(1)
    n = 30
    return Table(
        {
            "num": rng.normal(size=n),
            "cat": np.array([["red", "green", "blue"][i % 3] for i in range(n)], dtype=object),
            "label": (rng.random(n) > 0.5).astype(np.float64),
        }
    )


def _image_table():
    rng = _rng(2)
    images = np.empty(3, dtype=object)
    for i in range(3):
        images[i] = rng.integers(0, 256, size=(16, 16, 3), dtype=np.uint8)
    return Table({"id": np.arange(3), "image": images})


def _text_table():
    return Table(
        {
            "text": np.array(
                ["the quick brown fox", "jumps over the dog", "hello world again"],
                dtype=object,
            ),
            "label": np.array([1.0, 0.0, 1.0]),
        }
    )


def _events_table():
    users, items = [], []
    for u, its in [(0, [0, 1, 2]), (1, [0, 1, 2]), (2, [3, 4]), (3, [3, 4, 0])]:
        for i in its:
            users.append(u)
            items.append(i)
    return Table(
        {
            "user": np.array(users, dtype=np.int64),
            "item": np.array(items, dtype=np.int64),
            "rating": np.ones(len(users)),
        }
    )


def _http_request_table():
    req = np.empty(2, dtype=object)
    req[0] = {"url": "http://localhost:1/x", "method": "GET"}
    req[1] = {"url": "http://localhost:1/y", "method": "GET"}
    return Table({"req": req, "payload": np.array(["a", "b"], dtype=object)})


def _dnn_apply(params, inputs):
    x = inputs["x"] if isinstance(inputs, dict) else inputs
    return {"y": x * 2.0}


from mmlspark_tpu_torch.core.params import Param as _Param
from mmlspark_tpu_torch.core.params import to_str as _to_str
from mmlspark_tpu_torch.core.pipeline import Transformer as _Transformer


class _FuzzLinearModel(_Transformer):
    """Inner model for LIME fixtures: y = x @ w. State lives in Params so
    the stage-serializer (save_stage persists params only) roundtrips it."""

    weights = _Param("weight vector", is_complex=True, default=None)
    col = _Param("input column", default="features", converter=_to_str)

    def __init__(self, w=None, **kw):
        super().__init__(**kw)
        if w is not None:
            self.set("weights", np.asarray(w, dtype=np.float64))

    def transform(self, table):
        w = np.asarray(self.getWeights(), dtype=np.float64)
        X = np.asarray(
            [np.asarray(r, dtype=np.float64).ravel() for r in table.column(self.getCol())]
        )
        X = X[:, : len(w)]
        return table.with_column("prediction", X @ w)


class _FuzzImageModel(_Transformer):
    """ImageLIME inner model: mean intensity per image."""

    col = _Param("input column", default="image", converter=_to_str)

    def transform(self, table):
        scores = np.asarray(
            [float(np.asarray(x, dtype=np.float64).mean()) for x in table.column(self.getCol())]
        )
        return table.with_column("prediction", scores)


def _udf_double(c):
    return c * 2


def _lambda_fn(t):
    return t.with_column("twice", t.column("num") * 2)


def _custom_in(row):
    return {"url": "http://localhost:1/z", "method": "GET", "body": str(row)}


def _custom_out(resp):
    return str(resp)


def _make_test_objects() -> Dict[str, Callable[[], TestObject]]:
    reg: Dict[str, Callable[[], TestObject]] = {}

    def add(qualname: str, fn: Callable[[], TestObject]):
        reg[qualname] = fn

    # --- lightgbm -----------------------------------------------------------
    def lgbm_clf():
        from mmlspark_tpu_torch.lightgbm import LightGBMClassifier

        return TestObject(
            LightGBMClassifier(numIterations=5, numLeaves=5, parallelism="serial", device="cpu"),
            _numeric_table(),
            fit_produces="mmlspark_tpu_torch.lightgbm.classifier.LightGBMClassificationModel",
        )

    add("mmlspark_tpu_torch.lightgbm.classifier.LightGBMClassifier", lgbm_clf)

    def lgbm_reg():
        from mmlspark_tpu_torch.lightgbm import LightGBMRegressor

        t = _numeric_table(seed=3)
        t = t.with_column("label", t.column("features")[:, 0] * 2.0)
        return TestObject(
            LightGBMRegressor(numIterations=5, numLeaves=5, parallelism="serial", device="cpu"),
            t,
            fit_produces="mmlspark_tpu_torch.lightgbm.regressor.LightGBMRegressionModel",
        )

    add("mmlspark_tpu_torch.lightgbm.regressor.LightGBMRegressor", lgbm_reg)

    def lgbm_ranker():
        from mmlspark_tpu_torch.lightgbm import LightGBMRanker

        rng = _rng(4)
        n = 24
        t = Table(
            {
                "features": rng.normal(size=(n, 3)),
                "label": rng.integers(0, 3, size=n).astype(np.float64),
                "group": np.repeat(np.arange(4), 6),
            }
        )
        return TestObject(
            LightGBMRanker(
                numIterations=4, numLeaves=5, groupCol="group", parallelism="serial",
                device="cpu",
            ),
            t,
            fit_produces="mmlspark_tpu_torch.lightgbm.ranker.LightGBMRankerModel",
        )

    add("mmlspark_tpu_torch.lightgbm.ranker.LightGBMRanker", lgbm_ranker)

    # --- vw -----------------------------------------------------------------
    def vw_clf():
        from mmlspark_tpu_torch.vw import VowpalWabbitClassifier

        return TestObject(
            VowpalWabbitClassifier(numPasses=1, device="cpu"),
            _numeric_table(seed=5),
            fit_produces="mmlspark_tpu_torch.vw.classifier.VowpalWabbitClassificationModel",
        )

    add("mmlspark_tpu_torch.vw.classifier.VowpalWabbitClassifier", vw_clf)

    def vw_reg():
        from mmlspark_tpu_torch.vw import VowpalWabbitRegressor

        t = _numeric_table(seed=6)
        t = t.with_column("label", t.column("features")[:, 0])
        return TestObject(
            VowpalWabbitRegressor(numPasses=1, device="cpu"),
            t,
            fit_produces="mmlspark_tpu_torch.vw.regressor.VowpalWabbitRegressionModel",
        )

    add("mmlspark_tpu_torch.vw.regressor.VowpalWabbitRegressor", vw_reg)

    def vw_feat():
        from mmlspark_tpu_torch.vw import VowpalWabbitFeaturizer

        return TestObject(
            VowpalWabbitFeaturizer(inputCols=["text"], outputCol="features", stringSplit=True),
            _text_table(),
        )

    add("mmlspark_tpu_torch.vw.featurizer.VowpalWabbitFeaturizer", vw_feat)

    def vw_inter():
        from mmlspark_tpu_torch.vw import VowpalWabbitFeaturizer, VowpalWabbitInteractions

        t = _text_table()
        t = VowpalWabbitFeaturizer(inputCols=["text"], outputCol="fa", numBits=10, stringSplit=True).transform(t)
        t = VowpalWabbitFeaturizer(inputCols=["label"], outputCol="fb", numBits=10).transform(t)
        return TestObject(
            VowpalWabbitInteractions(inputCols=["fa", "fb"], outputCol="cross", numBits=10),
            t,
        )

    add("mmlspark_tpu_torch.vw.interactions.VowpalWabbitInteractions", vw_inter)

    # --- featurize ----------------------------------------------------------
    def clean():
        from mmlspark_tpu_torch.featurize import CleanMissingData

        rng = _rng(7)
        a = rng.normal(size=20)
        a[::4] = np.nan
        return TestObject(
            CleanMissingData(inputCols=["a"], cleaningMode="Mean"),
            Table({"a": a}),
            fit_produces="mmlspark_tpu_torch.featurize.clean.CleanMissingDataModel",
        )

    add("mmlspark_tpu_torch.featurize.clean.CleanMissingData", clean)

    def conv():
        from mmlspark_tpu_torch.featurize import DataConversion

        return TestObject(
            DataConversion(inputCols=["x"], convertTo="double"),
            Table({"x": np.arange(5, dtype=np.int64)}),
        )

    add("mmlspark_tpu_torch.featurize.conversion.DataConversion", conv)

    def assemble():
        from mmlspark_tpu_torch.featurize import AssembleFeatures

        return TestObject(
            AssembleFeatures(inputCols=["num", "label"]),
            _mixed_table(),
            fit_produces="mmlspark_tpu_torch.featurize.featurize.FeaturizeModel",
        )

    add("mmlspark_tpu_torch.featurize.featurize.AssembleFeatures", assemble)

    def featurize():
        from mmlspark_tpu_torch.featurize import Featurize

        return TestObject(
            Featurize(inputCols=["num", "cat"], outputCol="features"),
            _mixed_table(),
            fit_produces="mmlspark_tpu_torch.featurize.featurize.FeaturizeModel",
        )

    add("mmlspark_tpu_torch.featurize.featurize.Featurize", featurize)

    def value_indexer():
        from mmlspark_tpu_torch.featurize import ValueIndexer

        return TestObject(
            ValueIndexer(inputCol="cat", outputCol="idx"),
            _mixed_table(),
            fit_produces="mmlspark_tpu_torch.featurize.indexers.ValueIndexerModel",
        )

    add("mmlspark_tpu_torch.featurize.indexers.ValueIndexer", value_indexer)

    def index_to_value():
        from mmlspark_tpu_torch.featurize import ValueIndexer, IndexToValue

        t = _mixed_table()
        t2 = ValueIndexer(inputCol="cat", outputCol="idx").fit(t).transform(t)
        return TestObject(IndexToValue(inputCol="idx", outputCol="orig"), t2)

    add("mmlspark_tpu_torch.featurize.indexers.IndexToValue", index_to_value)

    def text_featurizer():
        from mmlspark_tpu_torch.featurize import TextFeaturizer

        return TestObject(
            TextFeaturizer(inputCol="text", outputCol="features"),
            _text_table(),
            fit_produces="mmlspark_tpu_torch.featurize.text.TextFeaturizerModel",
        )

    add("mmlspark_tpu_torch.featurize.text.TextFeaturizer", text_featurizer)

    def multi_ngram():
        from mmlspark_tpu_torch.featurize import MultiNGram

        t = _text_table()
        toks = np.empty(t.num_rows, dtype=object)
        for i, s in enumerate(t.column("text")):
            toks[i] = s.split()
        return TestObject(
            MultiNGram(inputCol="tokens", outputCol="grams", lengths=[1, 2]),
            t.with_column("tokens", toks),
        )

    add("mmlspark_tpu_torch.featurize.text.MultiNGram", multi_ngram)

    def page_splitter():
        from mmlspark_tpu_torch.featurize import PageSplitter

        return TestObject(
            PageSplitter(inputCol="text", outputCol="pages", maximumPageLength=10),
            _text_table(),
        )

    add("mmlspark_tpu_torch.featurize.text.PageSplitter", page_splitter)

    # --- image --------------------------------------------------------------
    def image_transformer():
        from mmlspark_tpu_torch.image import ImageTransformer

        return TestObject(
            ImageTransformer(inputCol="image", outputCol="out", device="cpu").resize(8, 8),
            _image_table(),
        )

    add("mmlspark_tpu_torch.image.transforms.ImageTransformer", image_transformer)

    def image_augmenter():
        from mmlspark_tpu_torch.image import ImageSetAugmenter

        return TestObject(
            ImageSetAugmenter(inputCol="image", outputCol="image", device="cpu"), _image_table()
        )

    add("mmlspark_tpu_torch.image.transforms.ImageSetAugmenter", image_augmenter)

    def unroll():
        from mmlspark_tpu_torch.image import UnrollImage

        return TestObject(UnrollImage(inputCol="image", outputCol="vec"), _image_table())

    add("mmlspark_tpu_torch.image.unroll.UnrollImage", unroll)

    def image_featurizer():
        from mmlspark_tpu_torch.image import ImageFeaturizer
        from mmlspark_tpu_torch.models import init_resnet

        params = init_resnet(variant="resnet18", num_classes=4, small_inputs=True)
        return TestObject(
            ImageFeaturizer(
                inputCol="image", outputCol="features", modelParams=params,
                inputHeight=32, inputWidth=32, batchSize=2, device="cpu",
            ),
            _image_table(),
        )

    add("mmlspark_tpu_torch.image.featurizer.ImageFeaturizer", image_featurizer)

    def superpixel():
        from mmlspark_tpu_torch.lime import SuperpixelTransformer

        return TestObject(
            SuperpixelTransformer(inputCol="image", cellSize=8), _image_table()
        )

    add("mmlspark_tpu_torch.lime.superpixel.SuperpixelTransformer", superpixel)

    # --- lime ---------------------------------------------------------------
    def tabular_lime():
        from mmlspark_tpu_torch.lime import TabularLIME

        return TestObject(
            TabularLIME(
                model=_FuzzLinearModel(np.array([1.0, -1.0, 0.5, 0.0])),
                inputCol="features", outputCol="weights", nSamples=60, seed=1, device="cpu",
            ),
            _numeric_table(seed=8),
            fit_produces="mmlspark_tpu_torch.lime.lime.TabularLIMEModel",
        )

    add("mmlspark_tpu_torch.lime.lime.TabularLIME", tabular_lime)

    def image_lime():
        from mmlspark_tpu_torch.lime import ImageLIME

        return TestObject(
            ImageLIME(
                model=_FuzzImageModel(), inputCol="image", outputCol="weights",
                nSamples=8, cellSize=8, seed=1, device="cpu",
            ),
            _image_table(),
        )

    add("mmlspark_tpu_torch.lime.lime.ImageLIME", image_lime)

    # --- nn -----------------------------------------------------------------
    def knn():
        from mmlspark_tpu_torch.nn import KNN

        rng = _rng(9)
        t = Table(
            {
                "features": rng.normal(size=(30, 4)),
                "values": np.arange(30).astype(np.float64),
            }
        )
        return TestObject(
            KNN(k=3, outputCol="matches", device="cpu"),
            t,
            fit_produces="mmlspark_tpu_torch.nn.knn.KNNModel",
        )

    add("mmlspark_tpu_torch.nn.knn.KNN", knn)

    def cknn():
        from mmlspark_tpu_torch.nn import ConditionalKNN

        rng = _rng(10)
        labels = np.array([["a", "b"][i % 2] for i in range(30)], dtype=object)
        t = Table(
            {
                "features": rng.normal(size=(30, 4)),
                "values": np.arange(30).astype(np.float64),
                "labels": labels,
            }
        )
        q = Table(
            {
                "features": rng.normal(size=(5, 4)),
                "conditioner": np.array([["a"]] * 5, dtype=object),
            }
        )
        return TestObject(
            ConditionalKNN(k=2, labelCol="labels", outputCol="matches", device="cpu"),
            t,
            transform_table=q,
            fit_produces="mmlspark_tpu_torch.nn.knn.ConditionalKNNModel",
        )

    add("mmlspark_tpu_torch.nn.knn.ConditionalKNN", cknn)

    # --- isolation forest ---------------------------------------------------
    def iforest():
        from mmlspark_tpu_torch.isolationforest import IsolationForest

        return TestObject(
            IsolationForest(numEstimators=10, device="cpu"),
            _numeric_table(seed=11),
            fit_produces="mmlspark_tpu_torch.isolationforest.forest.IsolationForestModel",
        )

    add("mmlspark_tpu_torch.isolationforest.forest.IsolationForest", iforest)

    # --- recommendation -----------------------------------------------------
    def sar():
        from mmlspark_tpu_torch.recommendation import SAR

        return TestObject(
            SAR(supportThreshold=1, device="cpu"),
            _events_table(),
            fit_produces="mmlspark_tpu_torch.recommendation.sar.SARModel",
        )

    add("mmlspark_tpu_torch.recommendation.sar.SAR", sar)

    def rec_indexer():
        from mmlspark_tpu_torch.recommendation import RecommendationIndexer

        t = Table(
            {
                "customer": np.array(["alice", "bob", "alice"], dtype=object),
                "product": np.array(["x", "y", "y"], dtype=object),
            }
        )
        return TestObject(
            RecommendationIndexer(
                userInputCol="customer", userOutputCol="user",
                itemInputCol="product", itemOutputCol="item",
            ),
            t,
            fit_produces="mmlspark_tpu_torch.recommendation.ranking.RecommendationIndexerModel",
        )

    add("mmlspark_tpu_torch.recommendation.ranking.RecommendationIndexer", rec_indexer)

    def ranking_adapter():
        from mmlspark_tpu_torch.recommendation import RankingAdapter, SAR

        return TestObject(
            RankingAdapter(recommender=SAR(supportThreshold=1, device="cpu"), k=2),
            _events_table(),
            fit_produces="mmlspark_tpu_torch.recommendation.ranking.RankingAdapterModel",
        )

    add("mmlspark_tpu_torch.recommendation.ranking.RankingAdapter", ranking_adapter)

    def ranking_tvs():
        from mmlspark_tpu_torch.recommendation import (
            RankingEvaluator,
            RankingTrainValidationSplit,
            SAR,
        )

        return TestObject(
            RankingTrainValidationSplit(
                estimator=SAR(supportThreshold=1, device="cpu"),
                evaluator=RankingEvaluator(k=2, nItems=5),
                trainRatio=0.6,
                seed=7,
            ),
            _events_table(),
            fit_produces="mmlspark_tpu_torch.recommendation.ranking.RankingTrainValidationSplitModel",
        )

    add("mmlspark_tpu_torch.recommendation.ranking.RankingTrainValidationSplit", ranking_tvs)

    # --- stages -------------------------------------------------------------
    def _words_table():
        return Table(
            {
                "num": np.arange(6, dtype=np.float64),
                "words": np.array(list("abcdef"), dtype=object),
                "label": np.array([0, 1, 0, 1, 0, 1], dtype=np.float64),
            }
        )

    simple = {
        "Cacher": lambda S: TestObject(S(), _words_table()),
        "DropColumns": lambda S: TestObject(S(cols=["num"]), _words_table()),
        "SelectColumns": lambda S: TestObject(S(cols=["num", "words"]), _words_table()),
        "RenameColumn": lambda S: TestObject(S(inputCol="words", outputCol="w2"), _words_table()),
        "Repartition": lambda S: TestObject(S(n=2), _words_table()),
        "StratifiedRepartition": lambda S: TestObject(S(labelCol="label"), _words_table()),
        "SummarizeData": lambda S: TestObject(S(), _words_table()),
        "UnicodeNormalize": lambda S: TestObject(S(inputCol="words", outputCol="norm"), _words_table()),
        "Explode": lambda S: TestObject(
            S(inputCol="vals"),
            Table({"vals": np.array([[1, 2], [3]], dtype=object)}),
        ),
        "UDFTransformer": lambda S: TestObject(
            S(inputCol="num", outputCol="n2", udf=_udf_double), _words_table()
        ),
        "Lambda": lambda S: TestObject(S(transformFunc=_lambda_fn), _words_table()),
        "TextPreprocessor": lambda S: TestObject(
            S(inputCol="words", outputCol="pp", map={"a": "z"}), _words_table()
        ),
    }
    for name, maker in simple.items():
        qual = f"mmlspark_tpu_torch.stages.basic.{name}"

        def fx(maker=maker, name=name):
            import mmlspark_tpu_torch.stages.basic as basic

            return maker(getattr(basic, name))

        add(qual, fx)

    def class_balancer():
        from mmlspark_tpu_torch.stages.basic import ClassBalancer

        return TestObject(
            ClassBalancer(inputCol="label"),
            _words_table(),
            fit_produces="mmlspark_tpu_torch.stages.basic.ClassBalancerModel",
        )

    add("mmlspark_tpu_torch.stages.basic.ClassBalancer", class_balancer)

    def ensemble_by_key():
        from mmlspark_tpu_torch.stages.basic import EnsembleByKey

        t = Table(
            {
                "key": np.array(["a", "a", "b"], dtype=object),
                "score": np.array([1.0, 3.0, 5.0]),
            }
        )
        return TestObject(EnsembleByKey(keys=["key"], cols=["score"]), t)

    add("mmlspark_tpu_torch.stages.basic.EnsembleByKey", ensemble_by_key)

    def multi_column_adapter():
        from mmlspark_tpu_torch.stages.basic import MultiColumnAdapter, UDFTransformer

        return TestObject(
            MultiColumnAdapter(
                baseStage=UDFTransformer(udf=_udf_double),
                inputCols=["num", "label"],
                outputCols=["num2", "label2"],
            ),
            _words_table(),
        )

    add("mmlspark_tpu_torch.stages.basic.MultiColumnAdapter", multi_column_adapter)

    def timer():
        from mmlspark_tpu_torch.stages.basic import Timer, UDFTransformer

        return TestObject(
            Timer(stage=UDFTransformer(inputCol="num", outputCol="n2", udf=_udf_double)),
            _words_table(),
            fit_produces="mmlspark_tpu_torch.stages.basic.TimerModel",
        )

    add("mmlspark_tpu_torch.stages.basic.Timer", timer)

    def fixed_batcher():
        from mmlspark_tpu_torch.stages.batching import FixedMiniBatchTransformer

        return TestObject(FixedMiniBatchTransformer(batchSize=2), _words_table())

    add("mmlspark_tpu_torch.stages.batching.FixedMiniBatchTransformer", fixed_batcher)

    def dynamic_batcher():
        from mmlspark_tpu_torch.stages.batching import DynamicMiniBatchTransformer

        return TestObject(DynamicMiniBatchTransformer(maxBatchSize=3), _words_table())

    add("mmlspark_tpu_torch.stages.batching.DynamicMiniBatchTransformer", dynamic_batcher)

    def time_batcher():
        from mmlspark_tpu_torch.stages.batching import TimeIntervalMiniBatchTransformer

        return TestObject(
            TimeIntervalMiniBatchTransformer(millisToWait=5), _words_table()
        )

    add("mmlspark_tpu_torch.stages.batching.TimeIntervalMiniBatchTransformer", time_batcher)

    def flatten_batch():
        from mmlspark_tpu_torch.stages.batching import FixedMiniBatchTransformer, FlattenBatch

        t = FixedMiniBatchTransformer(batchSize=2).transform(_words_table())
        return TestObject(FlattenBatch(), t)

    add("mmlspark_tpu_torch.stages.batching.FlattenBatch", flatten_batch)

    # --- train --------------------------------------------------------------
    def train_classifier():
        from mmlspark_tpu_torch.lightgbm import LightGBMClassifier
        from mmlspark_tpu_torch.train import TrainClassifier

        return TestObject(
            TrainClassifier(
                model=LightGBMClassifier(numIterations=4, numLeaves=5, parallelism="serial",
                                     device="cpu"),
                labelCol="label",
            ),
            _mixed_table(),
            fit_produces="mmlspark_tpu_torch.train.trainers.TrainedClassifierModel",
        )

    add("mmlspark_tpu_torch.train.trainers.TrainClassifier", train_classifier)

    def train_regressor():
        from mmlspark_tpu_torch.lightgbm import LightGBMRegressor
        from mmlspark_tpu_torch.train import TrainRegressor

        t = _mixed_table()
        t = t.with_column("label", t.column("num") * 2.0)
        return TestObject(
            TrainRegressor(
                model=LightGBMRegressor(numIterations=4, numLeaves=5, parallelism="serial",
                                    device="cpu"),
                labelCol="label",
            ),
            t,
            fit_produces="mmlspark_tpu_torch.train.trainers.TrainedRegressorModel",
        )

    add("mmlspark_tpu_torch.train.trainers.TrainRegressor", train_regressor)

    def compute_stats():
        from mmlspark_tpu_torch.lightgbm import LightGBMClassifier
        from mmlspark_tpu_torch.train import ComputeModelStatistics, TrainClassifier

        t = _mixed_table()
        out = (
            TrainClassifier(
                model=LightGBMClassifier(numIterations=4, numLeaves=5, parallelism="serial",
                                     device="cpu"),
                labelCol="label",
            )
            .fit(t)
            .transform(t)
        )
        return TestObject(ComputeModelStatistics(labelCol="label"), out)

    add("mmlspark_tpu_torch.train.statistics.ComputeModelStatistics", compute_stats)

    def per_instance_stats():
        from mmlspark_tpu_torch.lightgbm import LightGBMClassifier
        from mmlspark_tpu_torch.train import ComputePerInstanceStatistics, TrainClassifier

        t = _mixed_table()
        out = (
            TrainClassifier(
                model=LightGBMClassifier(numIterations=4, numLeaves=5, parallelism="serial",
                                     device="cpu"),
                labelCol="label",
            )
            .fit(t)
            .transform(t)
        )
        return TestObject(ComputePerInstanceStatistics(labelCol="label"), out)

    add("mmlspark_tpu_torch.train.statistics.ComputePerInstanceStatistics", per_instance_stats)

    # --- dnn ----------------------------------------------------------------
    def dnn_model():
        from mmlspark_tpu_torch.dnn import DNNModel

        return TestObject(
            DNNModel(
                applyFn=_dnn_apply,
                modelParams={},
                feedDict={"x": "features"},
                fetchDict={"out": "y"},
                batchSize=4,
                device="cpu",
            ),
            _numeric_table(seed=12),
        )

    add("mmlspark_tpu_torch.dnn.model.DNNModel", dnn_model)

    # --- io/http (client stack: pure parsers transform; live-server stages
    # are serde-only here, exercised end-to-end in tests/test_http.py) -------
    def json_input_parser():
        from mmlspark_tpu_torch.io.http import JSONInputParser

        return TestObject(
            JSONInputParser(url="http://localhost:1/api", inputCol="payload", outputCol="req"),
            _http_request_table(),
        )

    add("mmlspark_tpu_torch.io.http.transformers.JSONInputParser", json_input_parser)

    def custom_input_parser():
        from mmlspark_tpu_torch.io.http import CustomInputParser

        return TestObject(
            CustomInputParser(inputCol="payload", outputCol="req", udf=_custom_in),
            _http_request_table(),
        )

    add("mmlspark_tpu_torch.io.http.transformers.CustomInputParser", custom_input_parser)

    def custom_output_parser():
        from mmlspark_tpu_torch.io.http import CustomOutputParser

        return TestObject(
            CustomOutputParser(inputCol="req", outputCol="parsed", udf=_custom_out),
            _http_request_table(),
        )

    add("mmlspark_tpu_torch.io.http.transformers.CustomOutputParser", custom_output_parser)

    def string_output_parser():
        from mmlspark_tpu_torch.io.http import StringOutputParser

        return TestObject(
            StringOutputParser(inputCol="req", outputCol="s"),
            _http_request_table(),
            check_transform=False,  # consumes HTTPResponseData from a live call
        )

    add("mmlspark_tpu_torch.io.http.transformers.StringOutputParser", string_output_parser)

    def json_output_parser():
        from mmlspark_tpu_torch.io.http import JSONOutputParser

        return TestObject(
            JSONOutputParser(inputCol="req", outputCol="parsed"),
            _http_request_table(),
            check_transform=False,
        )

    add("mmlspark_tpu_torch.io.http.transformers.JSONOutputParser", json_output_parser)

    def http_transformer():
        from mmlspark_tpu_torch.io.http import HTTPTransformer

        return TestObject(
            HTTPTransformer(inputCol="req", outputCol="resp"),
            _http_request_table(),
            check_transform=False,
        )

    add("mmlspark_tpu_torch.io.http.transformers.HTTPTransformer", http_transformer)

    def simple_http():
        from mmlspark_tpu_torch.io.http import JSONInputParser, SimpleHTTPTransformer

        return TestObject(
            SimpleHTTPTransformer(
                inputCol="payload",
                outputCol="out",
                inputParser=JSONInputParser(url="http://localhost:1/api"),
            ),
            _http_request_table(),
            check_transform=False,
        )

    add("mmlspark_tpu_torch.io.http.transformers.SimpleHTTPTransformer", simple_http)

    def powerbi():
        from mmlspark_tpu_torch.io.powerbi import PowerBIWriter

        return TestObject(
            PowerBIWriter(url="http://localhost:1/push", batchSize=2),
            Table({"a": np.arange(3, dtype=np.float64)}),
            check_transform=False,  # pushes to a live endpoint
        )

    add("mmlspark_tpu_torch.io.powerbi.PowerBIWriter", powerbi)

    def consolidator():
        from mmlspark_tpu_torch.io.http import PartitionConsolidator

        return TestObject(
            PartitionConsolidator(inputCol="req", outputCol="resp", concurrency=2),
            _http_request_table(),
            check_transform=False,
        )

    add("mmlspark_tpu_torch.io.http.transformers.PartitionConsolidator", consolidator)

    return reg


TEST_OBJECTS = _make_test_objects()


# Classes that are deliberately NOT fuzzed directly, with the reason — the
# analogue of FuzzingTest.scala's exemption lists. Abstract/base classes and
# models that only exist via their estimator's fit() (covered through
# fit_produces) do not belong here; this list is for everything else.
EXEMPT: Dict[str, str] = {
    "mmlspark_tpu_torch.core.pipeline.PipelineStage": "abstract base",
    "mmlspark_tpu_torch.core.pipeline.Transformer": "abstract base",
    "mmlspark_tpu_torch.core.pipeline.Estimator": "abstract base",
    "mmlspark_tpu_torch.core.pipeline.Model": "abstract base",
    "mmlspark_tpu_torch.core.pipeline.Pipeline": "meta-stage; roundtrip covered in test_torch_pipeline Pipeline tests",
    "mmlspark_tpu_torch.core.pipeline.PipelineModel": "meta-stage; covered with Pipeline",
    "mmlspark_tpu_torch.lightgbm.base.LightGBMBase": "abstract learner base (objective hooks unimplemented)",
    "mmlspark_tpu_torch.lightgbm.base.LightGBMModelBase": "abstract model base",
    "mmlspark_tpu_torch.vw.base.VowpalWabbitBase": "abstract learner base",
    "mmlspark_tpu_torch.vw.base.VowpalWabbitModelBase": "abstract model base",
    "mmlspark_tpu_torch.automl.tune.TuneHyperparameters": "estimator-of-estimators; covered in test_torch_automl (needs param grids)",
    "mmlspark_tpu_torch.automl.tune.TuneHyperparametersModel": "produced by TuneHyperparameters; covered in test_torch_automl",
    "mmlspark_tpu_torch.automl.tune.FindBestModel": "model-selection meta-stage; covered in test_torch_automl",
    "mmlspark_tpu_torch.automl.tune.BestModel": "produced by FindBestModel; covered in test_torch_automl",
    "mmlspark_tpu_torch.sweep.estimator.TrainValidSweep": "estimator-of-estimators; covered in test_torch_sweep (needs param spaces)",
    "mmlspark_tpu_torch.sweep.estimator.TrainValidSweepModel": "produced by TrainValidSweep; covered in test_torch_sweep",
}


def on_cpu(obj):
    """Set ``device`` to the CPU on a stage and every stage among its
    params, recursively (a loaded stage has the default, the card)."""
    from mmlspark_tpu_torch.core.params import Params

    if isinstance(obj, (list, tuple)):
        for item in obj:
            on_cpu(item)
    elif isinstance(obj, Params):
        if obj.hasParam("device"):
            obj.setDevice("cpu")
        for value in obj.extractParamMap().values():
            if isinstance(value, (Params, list, tuple)):
                on_cpu(value)
    return obj
