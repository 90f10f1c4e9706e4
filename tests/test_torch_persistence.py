"""Model persistence in the port against the JAX package: stages save and
load in the reference's on-disk layout, each package loads the other's
saved LightGBM models and pipelines, and LightGBM model text crosses both
ways.

Fits are small (400 rows, 4 features) and run on the CPU: the port with
``device='cpu'``, the reference with ``parallelism='serial'``. Boosters
compare field for field, bit for bit (``to_dict()``); margins from model
text within ``rtol=1e-6`` (the reference's own test of native model text).
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from test_torch_gbdt import REPO, _import_reference

# At import, so that every pytest worker has the JAX package's fit path
# before it collects the JAX package's own test files (see
# tests/test_torch_gbdt.py); the card machine has no jax.
try:
    _import_reference()
except ModuleNotFoundError as err:
    if err.name != "jax":
        raise

from mmlspark_tpu_torch.core import serialize as tser
from mmlspark_tpu_torch.core.params import (
    HasInputCol,
    HasOutputCol,
    Param,
    lookup_class,
    persisted_class_name,
    to_int,
)
from mmlspark_tpu_torch.core.pipeline import (
    Pipeline,
    PipelineModel,
    PipelineStage,
    Transformer,
    make_pipeline_model,
)
from mmlspark_tpu_torch.data.table import Table
from mmlspark_tpu_torch.lightgbm import (
    LightGBMClassificationModel,
    LightGBMClassifier,
    LightGBMRanker,
    LightGBMRankerModel,
    LightGBMRegressionModel,
    LightGBMRegressor,
)
from mmlspark_tpu_torch.lightgbm.booster import Booster

LEARNERS = ("classifier", "regressor", "ranker")
COMMON = dict(numIterations=4, numLeaves=7, minDataInLeaf=10)
PORT = {"classifier": (LightGBMClassifier, LightGBMClassificationModel),
        "regressor": (LightGBMRegressor, LightGBMRegressionModel),
        "ranker": (LightGBMRanker, LightGBMRankerModel)}


def _data(learner, n=400, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, 4))
    X[rng.uniform(size=n) < 0.02, 1] = np.nan
    w = rng.uniform(0.5, 2.0, size=n)
    signal = X[:, 0] + 0.5 * np.nan_to_num(X[:, 1]) * X[:, 2] + 0.4 * rng.normal(size=n)
    cols = {"features": X, "w": w}
    if learner == "classifier":
        cols["label"] = (signal > 0).astype(np.float64)
    elif learner == "regressor":
        cols["label"] = signal
    else:
        cols["label"] = np.clip(np.round(signal + 1.5), 0, 3)
        cols["g"] = np.repeat(np.arange(n // 20), 20)
    return cols


def _params(learner):
    extra = {"groupCol": "g"} if learner == "ranker" else {"weightCol": "w"}
    return {**COMMON, **extra}


@pytest.fixture(scope="module")
def ref():
    from mmlspark_tpu.core.pipeline import Pipeline as JPipeline
    from mmlspark_tpu.core.pipeline import PipelineStage as JStage
    from mmlspark_tpu.data.table import Table as JTable
    from mmlspark_tpu.lightgbm import (
        LightGBMClassificationModel as JCM,
        LightGBMClassifier as JC,
        LightGBMRanker as JK,
        LightGBMRankerModel as JKM,
        LightGBMRegressionModel as JRM,
        LightGBMRegressor as JR,
    )

    return dict(Stage=JStage, Pipeline=JPipeline, Table=JTable,
                est={"classifier": JC, "regressor": JR, "ranker": JK},
                model={"classifier": JCM, "regressor": JRM, "ranker": JKM})


@pytest.fixture(scope="module")
def port_models():
    return {lr: PORT[lr][0](device="cpu", **_params(lr)).fit(Table(_data(lr)))
            for lr in LEARNERS}


@pytest.fixture(scope="module")
def ref_models(ref):
    return {lr: ref["est"][lr](parallelism="serial", **_params(lr)).fit(ref["Table"](_data(lr)))
            for lr in LEARNERS}


def _assert_boosters_equal(a: dict, b: dict):
    assert a.keys() == b.keys()
    for k in a:
        x, y = a[k], b[k]
        if isinstance(x, np.ndarray):
            assert isinstance(y, np.ndarray) and x.dtype == y.dtype and x.shape == y.shape, k
            assert x.tobytes() == y.tobytes(), k
        elif isinstance(x, dict):
            assert x.keys() == y.keys(), k
            for c in x:
                assert np.asarray(x[c]).tobytes() == np.asarray(y[c]).tobytes(), (k, c)
        else:
            assert type(x) is type(y) and x == y, k


def _cpu(model):
    """A loaded model (or pipeline) set to predict on the CPU."""
    for stage in model.getStages() if isinstance(model, PipelineModel) else [model]:
        if stage.hasParam("device"):
            stage.setDevice("cpu")
    return model


# -- stage round trips in the port ---------------------------------------------


class PortDummy(HasInputCol, HasOutputCol, Transformer):
    k = Param("An int", default=1, converter=to_int)
    payload = Param("Anything", is_complex=True)
    extras = Param("A JSON value")

    def transform(self, table):
        return table.with_column(self.getOutputCol(), table.column(self.getInputCol()) * self.k)


@pytest.mark.parametrize("extras", [None, [1, 2.5, "x"], {"a": [1, {"b": None}]}, (3, 4), True])
def test_dummy_stage_round_trip(tmp_path, extras):
    s = PortDummy(inputCol="x", outputCol="y", k=3, extras=extras)
    s.save(str(tmp_path / "s"))
    back = PipelineStage.load(str(tmp_path / "s"))
    assert type(back) is PortDummy and back.uid == s.uid
    want = list(extras) if isinstance(extras, tuple) else extras
    assert back.getExtras() == want and back.getK() == 3 and not back.isSet("payload")
    meta = json.load(open(tmp_path / "s" / "metadata.json"))
    assert meta["class"] == f"{__name__}.PortDummy" and meta["complex_params"] == []


@pytest.mark.parametrize("value", [
    np.arange(12, dtype=np.float64).reshape(3, 4),
    np.array([1, -2, 3], dtype=np.int32),
    np.array(["a", None, (1, 2)], dtype=object),
    torch.arange(6, dtype=torch.float32).reshape(2, 3),
])
def test_complex_array_param_round_trip(tmp_path, value):
    s = PortDummy(inputCol="x", outputCol="y", payload=value)
    s.save(str(tmp_path / "s"))
    assert open(tmp_path / "s" / "params" / "payload" / "_type").read() == "ndarray"
    got = PortDummy.load(str(tmp_path / "s")).getPayload()
    want = value.numpy() if isinstance(value, torch.Tensor) else value
    assert got.dtype == want.dtype and got.shape == want.shape
    assert list(got.ravel()) == list(want.ravel())


def test_table_param_keeps_metadata_and_partitions(tmp_path):
    t = Table({"a": np.arange(5.0), "s": np.array(list("abcde"), dtype=object)},
              metadata={"a": {"unit": "s"}}, num_partitions=3)
    PortDummy(inputCol="a", outputCol="b", payload=t).save(str(tmp_path / "s"))
    assert open(tmp_path / "s" / "params" / "payload" / "_type").read() == "table"
    back = PortDummy.load(str(tmp_path / "s")).getPayload()
    assert back.columns == ["a", "s"] and back.num_partitions == 3
    assert back.metadata("a") == {"unit": "s"} and list(back["s"]) == list("abcde")


def test_dict_of_arrays_takes_the_pickle_tag_and_closures_cloudpickle(tmp_path):
    tree = {"w": np.ones(3, np.float32), "b": [torch.zeros(2), 1.5]}
    PortDummy(inputCol="a", outputCol="b", payload=tree).save(str(tmp_path / "s"))
    assert open(tmp_path / "s" / "params" / "payload" / "_type").read() == "pickle"
    back = PortDummy.load(str(tmp_path / "s")).getPayload()
    assert isinstance(back["b"][0], np.ndarray) and back["b"][1] == 1.5  # tensors leave as numpy
    scale = 7
    PortDummy(inputCol="a", outputCol="b", payload=lambda v: v * scale).save(str(tmp_path / "c"))
    assert PortDummy.load(str(tmp_path / "c")).getPayload()(2) == 14


def test_pytree_tag_is_refused_by_name(tmp_path):
    p = tmp_path / "s"
    PortDummy(inputCol="a", outputCol="b", payload=np.zeros(2)).save(str(p))
    (p / "params" / "payload" / "_type").write_text("pytree")
    with pytest.raises(ValueError, match="'pytree' tag"):
        PortDummy.load(str(p))


@pytest.mark.parametrize("module,name", [("jax.numpy", "zeros"),
                                         ("mmlspark_tpu.vw.base", "VowpalWabbitBase"),
                                         ("mmlspark_tpu.data.sparse", "NoSuchClass")])
def test_unpickler_refuses_globals_without_a_port_counterpart(tmp_path, module, name):
    import pickle

    path = tmp_path / "g.pkl"
    # a protocol-2 pickle of the bare global module.name
    path.write_bytes(b"\x80\x02c" + module.encode() + b"\n" + name.encode() + b"\n.")
    with open(path, "rb") as fh, pytest.raises(pickle.UnpicklingError, match=name):
        tser.load_pickle(fh)


def test_unpickler_maps_reference_globals_onto_the_port(tmp_path):
    from mmlspark_tpu_torch.data.sparse import SparseRows

    path = tmp_path / "g.pkl"
    path.write_bytes(b"\x80\x02cmmlspark_tpu.data.sparse\nSparseRows\n.")
    with open(path, "rb") as fh:
        assert tser.load_pickle(fh) is SparseRows


def test_lookup_class_maps_both_prefixes():
    name = "lightgbm.classifier.LightGBMClassificationModel"
    assert lookup_class("mmlspark_tpu." + name) is LightGBMClassificationModel
    assert lookup_class("mmlspark_tpu_torch." + name) is LightGBMClassificationModel
    assert persisted_class_name(LightGBMClassificationModel) == "mmlspark_tpu." + name
    assert persisted_class_name(PortDummy) == f"{__name__}.PortDummy"
    with pytest.raises(LookupError, match="no counterpart"):
        lookup_class("mmlspark_tpu.vw.classifier.VowpalWabbitClassifier")


def test_pipeline_model_round_trip_in_the_port(tmp_path):
    d = _data("classifier")
    pm = Pipeline(stages=[PortDummy(inputCol="w", outputCol="w2", k=2),
                          LightGBMClassifier(device="cpu", **_params("classifier"))]).fit(Table(d))
    pm.save(str(tmp_path / "pm"))
    back = _cpu(PipelineModel.load(str(tmp_path / "pm")))
    a, b = pm.transform(Table(d)), back.transform(Table(d))
    for c in ("w2", "rawPrediction", "probability", "prediction"):
        assert a[c].tobytes() == b[c].tobytes()
    assert make_pipeline_model(*pm.getStages()).transform(Table(d))["prediction"].tobytes() == \
        a["prediction"].tobytes()


# -- the LightGBM model API --------------------------------------------------------


@pytest.mark.parametrize("learner", LEARNERS)
def test_native_model_api(tmp_path, port_models, learner):
    model = port_models[learner]
    X = _data(learner)["features"]
    path = str(tmp_path / "model.txt")
    model.save_native_model(path)
    cls = PORT[learner][1]
    loaded = cls.load_native_model(path, device="cpu")
    want = model.booster.raw_margin(X, device="cpu")
    np.testing.assert_allclose(loaded.booster.raw_margin(X, device="cpu"), want, rtol=1e-6)
    from_text = cls.from_model_string(model.get_model_string(), device="cpu")
    assert from_text.get_model_string() == loaded.get_model_string()
    js = Booster.from_string(model.booster.to_json_string())
    _assert_boosters_equal(js.to_dict(), model.booster.to_dict())
    assert js.raw_margin(X, device="cpu").tobytes() == want.tobytes()
    for kind in ("split", "gain"):
        np.testing.assert_array_equal(model.get_feature_importances(kind),
                                      model.booster.feature_importances(kind))
    fresh = cls(device="cpu")
    fresh.set_booster(model.booster)
    _assert_boosters_equal(fresh.booster.to_dict(), model.booster.to_dict())


# -- across the packages -------------------------------------------------------------


@pytest.mark.parametrize("learner", LEARNERS)
def test_port_saved_model_loads_in_the_reference(tmp_path, ref, port_models, learner):
    model = port_models[learner]
    model.save(str(tmp_path / "m"))
    meta = json.load(open(tmp_path / "m" / "metadata.json"))
    assert meta["class"] == f"mmlspark_tpu.lightgbm.{learner}.{type(model).__name__}"
    assert "device" not in meta["params"]
    loaded = ref["Stage"].load(str(tmp_path / "m"))
    assert type(loaded) is ref["model"][learner]
    _assert_boosters_equal(loaded.booster.to_dict(), model.booster.to_dict())


@pytest.mark.parametrize("learner", LEARNERS)
def test_reference_saved_model_loads_in_the_port(tmp_path, ref_models, learner):
    model = ref_models[learner]
    model.save(str(tmp_path / "m"))
    loaded = PipelineStage.load(str(tmp_path / "m"))
    assert type(loaded) is PORT[learner][1] and loaded.getDevice() == "cuda"
    _assert_boosters_equal(loaded.booster.to_dict(), model.booster.to_dict())
    X = _data(learner)["features"]
    np.testing.assert_allclose(_cpu(loaded).booster.raw_margin(X, device="cpu"),
                               model.booster.raw_margin(X), rtol=1e-6, atol=1e-6)


def test_pipeline_model_crosses_both_ways(tmp_path, ref):
    d = _data("classifier")
    pm = Pipeline(stages=[LightGBMClassifier(device="cpu", **_params("classifier"))]).fit(
        Table(d))
    pm.save(str(tmp_path / "p"))
    jm = ref["Stage"].load(str(tmp_path / "p"))
    assert type(jm).__module__ == "mmlspark_tpu.core.pipeline"
    _assert_boosters_equal(jm.getStages()[0].booster.to_dict(), pm.getStages()[0].booster.to_dict())
    jpm = ref["Pipeline"](stages=[ref["est"]["classifier"](parallelism="serial",
                                                          **_params("classifier"))]).fit(
        ref["Table"](d))
    jpm.save(str(tmp_path / "j"))
    back = _cpu(PipelineStage.load(str(tmp_path / "j")))
    assert type(back) is PipelineModel
    _assert_boosters_equal(back.getStages()[0].booster.to_dict(),
                           jpm.getStages()[0].booster.to_dict())
    np.testing.assert_allclose(back.transform(Table(d))["rawPrediction"],
                               jpm.transform(ref["Table"](d))["rawPrediction"], rtol=1e-6)


@pytest.mark.parametrize("direction", ["port_to_ref", "ref_to_port"])
def test_estimator_crosses_with_its_params(tmp_path, ref, direction):
    params = dict(numIterations=7, learningRate=0.05, categoricalSlotIndexes=[1],
                  isUnbalance=True)
    if direction == "port_to_ref":
        LightGBMClassifier(device="cpu", **params).save(str(tmp_path / "e"))
        est = ref["Stage"].load(str(tmp_path / "e"))
        assert type(est) is ref["est"]["classifier"]
    else:
        ref["est"]["classifier"](**params).save(str(tmp_path / "e"))
        est = PipelineStage.load(str(tmp_path / "e"))
        assert type(est) is LightGBMClassifier and est.getDevice() == "cuda"
    assert {k: est.getOrDefault(k) for k in params} == params


@pytest.mark.parametrize("learner", LEARNERS)
@pytest.mark.parametrize("direction", ["port_to_ref", "ref_to_port"])
def test_model_text_crosses_through_load_native_model(tmp_path, ref, port_models, ref_models,
                                                      learner, direction):
    X = _data(learner)["features"]
    path = str(tmp_path / "model.txt")
    if direction == "port_to_ref":
        src = port_models[learner]
        src.save_native_model(path)
        got = ref["model"][learner].load_native_model(path).booster.raw_margin(X)
        want = src.booster.raw_margin(X, device="cpu")
    else:
        src = ref_models[learner]
        src.save_native_model(path)
        got = PORT[learner][1].load_native_model(path, device="cpu").booster.raw_margin(
            X, device="cpu")
        want = src.booster.raw_margin(X)
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_json_dump_crosses_both_ways(ref_models, port_models):
    from mmlspark_tpu.lightgbm.booster import Booster as JBooster

    for learner in LEARNERS:
        jb = ref_models[learner].booster
        _assert_boosters_equal(Booster.from_string(jb.to_json_string()).to_dict(), jb.to_dict())
        pb = port_models[learner].booster
        _assert_boosters_equal(JBooster.from_string(pb.to_json_string()).to_dict(), pb.to_dict())


@pytest.mark.parametrize("stage", ["estimator", "model"])
def test_device_is_never_written(tmp_path, port_models, stage):
    obj = LightGBMClassifier(device="cpu") if stage == "estimator" else port_models["classifier"]
    obj.save(str(tmp_path / "s"))
    root = str(tmp_path / "s")
    listing = [os.path.relpath(os.path.join(r, f), root) for r, _, fs in os.walk(root) for f in fs]
    assert not any("device" in p for p in listing)
    assert "device" not in open(tmp_path / "s" / "metadata.json").read()


def test_cross_package_load_imports_neither_jax_nor_the_reference(tmp_path, ref_models):
    """A JAX-saved PipelineModel loads and scores in a fresh process that
    has only the port."""
    from mmlspark_tpu.core.pipeline import PipelineModel as JPipelineModel

    JPipelineModel(stages=[ref_models["classifier"]]).save(str(tmp_path / "p"))
    np.save(tmp_path / "X.npy", _data("classifier")["features"])
    code = (
        "import sys, numpy as np\n"
        "from mmlspark_tpu_torch.core.pipeline import PipelineStage\n"
        "from mmlspark_tpu_torch.data.table import Table\n"
        f"m = PipelineStage.load({str(tmp_path / 'p')!r})\n"
        "m.getStages()[0].setDevice('cpu')\n"
        f"out = m.transform(Table({{'features': np.load({str(tmp_path / 'X.npy')!r})}}))\n"
        "np.save(sys.argv[1], out['rawPrediction'])\n"
        "bad = sorted(k for k in sys.modules if k == 'jax' or k.startswith(('jax.', 'mmlspark_tpu.'))"
        " or k == 'mmlspark_tpu')\n"
        "assert not bad, bad\n"
    )
    out = tmp_path / "raw.npy"
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", code, str(out)], cwd=str(tmp_path), env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    X = _data("classifier")["features"]
    m = ref_models["classifier"].booster.raw_margin(X)[:, 0]
    np.testing.assert_allclose(np.load(out), np.stack([-m, m], axis=1), rtol=1e-6)
