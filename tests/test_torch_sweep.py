"""The port's many-models sweep plane (``mmlspark_tpu_torch.sweep``)
against the JAX package: mirrors ``tests/test_sweep.py``, VW buckets
included (a VW bucket's metrics are within rtol 1e-5 of its candidates'
sequential fits and of the reference's bucket, whose sequential path runs
with ``_select_mesh`` pinned to None, as ``tests/test_sweep.py`` pins it).

Shape-bucketing, the seeded split and the candidate maps must equal the
reference's exactly; batched scores equal sequential fits' within rtol
1e-5 (the reference's own tolerance); sweep metrics are within rtol 1e-5
of the reference's with the same winner. Fits run on the CPU
(``device="cpu"``); reference estimators run with ``parallelism="serial"``
(conftest's 8 virtual devices would give them a mesh otherwise). The gang
runs spawn 2 worker processes on the CPU at the reference's 240 rows.
``tests/test_torch_automl.py`` holds the CPU dry run of ``chip_smoke.py``'s
phase 28.
"""

import os

import numpy as np
import pytest
import torch

from mmlspark_tpu_torch import observability as tobs
from mmlspark_tpu_torch import sweep as tsweep
from mmlspark_tpu_torch.automl.hyperparam import (
    DiscreteHyperParam,
    DoubleRangeHyperParam,
    GridSpace,
    RandomSpace,
)
from mmlspark_tpu_torch.automl.tune import _evaluate
from mmlspark_tpu_torch.core.pipeline import Pipeline, PipelineStage
from mmlspark_tpu_torch.data.table import Table
from mmlspark_tpu_torch.lightgbm import LightGBMClassifier, LightGBMRanker, LightGBMRegressor
from mmlspark_tpu_torch.lightgbm.base import LightGBMBase
from mmlspark_tpu_torch.lightgbm.callbacks import TrainingCallback
from mmlspark_tpu_torch.runtime.faults import FaultPlan
from mmlspark_tpu_torch.runtime.journal import ModelStore
from mmlspark_tpu_torch.sweep import (
    GBDT_VMAPPED,
    VW_VMAPPED,
    TrainValidSweep,
    TrainValidSweepModel,
    bucket_candidates,
    fit_bucket,
)


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

TIMING = {"t", "wt", "seconds"}
EST = dict(labelCol="label", numIterations=5, numLeaves=7, maxBin=32)


@pytest.fixture(scope="module")
def ref():
    import mmlspark_tpu.automl.hyperparam as jhyper
    import mmlspark_tpu.lightgbm as jlgb
    import mmlspark_tpu.observability as jobs
    import mmlspark_tpu.sweep as jsweep
    from mmlspark_tpu.core.pipeline import Pipeline as JPipeline
    from mmlspark_tpu.data.table import Table as JTable

    return dict(hyper=jhyper, lgb=jlgb, obs=jobs, sweep=jsweep, Table=JTable,
                Pipeline=JPipeline)


def _clf_data(n=240, f=6, seed=42):
    """``tests/test_sweep.py``'s table (``default_rng(42)``), with label noise."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, f))
    y = (X[:, 0] + 0.5 * X[:, 1] + 0.3 * rng.normal(size=n) > 0).astype(np.float64)
    return X, y


@pytest.fixture
def clf_table():
    X, y = _clf_data()
    return Table({"features": X, "label": y})


def _port_clf(**kw):
    return LightGBMClassifier(**{**EST, "device": "cpu", **kw})


def _ref_clf(ref, **kw):
    return ref["lgb"].LightGBMClassifier(**{**EST, "parallelism": "serial", **kw})


def _layout(buckets):
    return [(b.kind, b.indices, b.param_maps) for b in buckets]


# -- bucketing -------------------------------------------------------------------


def test_vmapped_params_share_one_bucket():
    maps = [{"learningRate": 0.05}, {"learningRate": 0.1, "featureFraction": 0.8},
            {"learningRate": 0.2, "baggingFraction": 0.7, "baggingFreq": 1}]
    (bucket,) = bucket_candidates([(_port_clf(), m) for m in maps])
    assert (bucket.kind, bucket.size, bucket.indices) == ("gbdt", 3, [0, 1, 2])


def test_static_params_split_buckets():
    maps = [{"learningRate": 0.1, "numLeaves": 7}, {"learningRate": 0.2, "numLeaves": 7},
            {"learningRate": 0.1, "numLeaves": 15}]
    buckets = bucket_candidates([(_port_clf(), m) for m in maps])
    assert sorted(b.size for b in buckets) == [1, 2]
    assert sorted(i for b in buckets for i in b.indices) == [0, 1, 2]


def test_classifier_and_regressor_never_share():
    cands = [(_port_clf(), {"learningRate": 0.1}),
             (LightGBMRegressor(numIterations=5, device="cpu"), {"learningRate": 0.1})]
    assert len(bucket_candidates(cands)) == 2


class _Hook(TrainingCallback):
    pass


# estimator params of a candidate the batched core does not take: each
# candidate lands in its own singleton bucket
UNBATCHABLE = [
    ("early_stopping", {"earlyStoppingRound": 2}),
    ("dart", {"boostingType": "dart"}),
    ("rf", {"boostingType": "rf", "baggingFraction": 0.5, "baggingFreq": 1}),
    ("batches", {"numBatches": 2}),
    ("processes", {"numProcesses": 2}),
    ("warm_start", {"modelString": "tree"}),
    ("init_score", {"initScoreCol": "init"}),
    ("valid_indicator", {"validationIndicatorCol": "valid"}),
    ("training_metric", {"isProvideTrainingMetric": True}),
]


@pytest.mark.parametrize("name,params", UNBATCHABLE, ids=[u[0] for u in UNBATCHABLE])
def test_unbatchable_candidates_are_singletons_as_in_the_reference(ref, name, params):
    maps = [{"learningRate": lr} for lr in (0.1, 0.2)]
    port = bucket_candidates([(_port_clf(**params), m) for m in maps])
    want = ref["sweep"].bucket_candidates([(_ref_clf(ref, **params), m) for m in maps])
    assert _layout(port) == _layout(want) == [(None, [0], [maps[0]]), (None, [1], [maps[1]])]


def test_callbacks_rankers_and_other_estimators_are_singletons():
    maps = [{"learningRate": lr} for lr in (0.1, 0.2)]
    hooked = _port_clf().set_delegate(_Hook())
    assert [b.kind for b in bucket_candidates([(hooked, m) for m in maps])] == [None, None]
    # the ranker's objective closes over its fit's query groups
    ranker = LightGBMRanker(numIterations=5, device="cpu")
    assert [b.kind for b in bucket_candidates([(ranker, m) for m in maps])] == [None, None]
    pipe = Pipeline(stages=[])
    assert _layout(bucket_candidates([(pipe, {}), (pipe, {})])) == [
        (None, [0], [{}]), (None, [1], [{}])]


def test_buckets_equal_the_reference(ref):
    """A mixed candidate list: the same buckets, kinds, indices and param
    maps in both packages."""
    maps = [{"learningRate": 0.05, "numLeaves": 7}, {"learningRate": 0.1, "numLeaves": 15},
            {"learningRate": 0.2, "numLeaves": 7, "featureFraction": 0.8},
            {"numLeaves": 15, "baggingFraction": 0.7, "baggingFreq": 1},
            {"numLeaves": 7, "lambdaL2": 1.0}, {"numLeaves": 7, "earlyStoppingRound": 2},
            {"numLeaves": 7, "posBaggingFraction": 0.5, "baggingFreq": 2}]
    reg_maps = [{"learningRate": 0.1}, {"learningRate": 0.3}]
    port = bucket_candidates([(_port_clf(), m) for m in maps] + [
        (LightGBMRegressor(numIterations=5, device="cpu"), m) for m in reg_maps])
    want = ref["sweep"].bucket_candidates([(_ref_clf(ref), m) for m in maps] + [
        (ref["lgb"].LightGBMRegressor(numIterations=5, parallelism="serial"), m)
        for m in reg_maps])
    assert _layout(port) == _layout(want)
    assert [b.size for b in port] == [3, 2, 1, 1, 2]


def test_vmapped_name_sets(ref):
    est = _port_clf()
    assert all(est.hasParam(n) for n in GBDT_VMAPPED)
    assert GBDT_VMAPPED == ref["sweep"].GBDT_VMAPPED and VW_VMAPPED == ref["sweep"].VW_VMAPPED


def _port_vw(**kw):
    from mmlspark_tpu_torch.vw import VowpalWabbitClassifier

    return VowpalWabbitClassifier(**{"labelCol": "label", "numPasses": 2, "device": "cpu", **kw})


def _ref_vw(ref, **kw):
    import mmlspark_tpu.vw as jvw

    return jvw.VowpalWabbitClassifier(**{"labelCol": "label", "numPasses": 2, **kw})


VW_MAPS = [{"learningRate": 0.3, "powerT": 0.5}, {"learningRate": 0.6, "powerT": 0.0, "l2": 1e-6},
           {"learningRate": 0.3, "numPasses": 3}, {"l1": 1e-4, "batchSize": 32}]


@pytest.mark.parametrize("args", ["", "--learning_rate 0.2", "--ftrl", "--cubic abc"])
def test_vw_buckets_equal_the_reference(ref, args):
    """Candidates differing only in vmapped lanes share a ``"vw"`` bucket;
    a pass-through arg pinning a lane, or a bad one, makes singletons."""
    port = bucket_candidates([(_port_vw(passThroughArgs=args), m) for m in VW_MAPS])
    want = ref["sweep"].bucket_candidates([(_ref_vw(ref, passThroughArgs=args), m)
                                           for m in VW_MAPS])
    assert _layout(port) == _layout(want)
    if args in ("--learning_rate 0.2", "--cubic abc"):
        assert [(b.kind, b.size) for b in port] == [(None, 1)] * 4
    else:
        assert [(b.kind, b.size) for b in port] == [("vw", 2), ("vw", 1), ("vw", 1)]


def test_vw_batched_scores_match_sequential_and_the_reference(ref, clf_table, monkeypatch):
    import mmlspark_tpu.vw.base as jbase

    monkeypatch.setattr(jbase.VowpalWabbitBase, "_select_mesh", lambda self: None)
    maps = VW_MAPS[:2]
    est = _port_vw()
    (bucket,) = bucket_candidates([(est, m) for m in maps])
    train, valid = _split(clf_table)
    scored = fit_bucket(bucket, train, valid, "label", "accuracy")
    (jbucket,) = ref["sweep"].bucket_candidates([(_ref_vw(ref), m) for m in maps])
    jtrain, jvalid = (ref["Table"]({c: t.column(c) for c in t.columns}) for t in (train, valid))
    jscored = ref["sweep"].fit_bucket(jbucket, jtrain, jvalid, "label", "accuracy")
    for m, (metric, model), (jmetric, _) in zip(maps, scored, jscored):
        seq = est.copy(m).fit(train)
        assert np.isclose(metric, _evaluate(seq.transform(valid), "label", "accuracy"), rtol=1e-5)
        assert np.isclose(metric, jmetric, rtol=1e-5)
        w, ws = model.getModelWeights(), seq.getModelWeights()
        assert np.abs(w - ws).max() <= 1e-5 * np.abs(ws).max()
        assert model.parent.getLearningRate() == m["learningRate"]


# -- batched parity --------------------------------------------------------------


def _split(table):
    mask = np.zeros(table.num_rows, dtype=bool)
    mask[: table.num_rows * 3 // 4] = True
    return table.filter(mask), table.filter(~mask)


def test_gbdt_batched_scores_match_sequential(clf_table):
    est = _port_clf()
    maps = [{"learningRate": lr} for lr in (0.05, 0.1, 0.2)] + [
        {"featureFraction": 0.7, "baggingFraction": 0.8, "baggingFreq": 1}]
    (bucket,) = bucket_candidates([(est, m) for m in maps])
    train, valid = _split(clf_table)
    scored = fit_bucket(bucket, train, valid, "label", "AUC")
    for m, (metric, model) in zip(maps, scored):
        seq = est.copy(m).fit(train)
        assert np.isclose(metric, _evaluate(seq.transform(valid), "label", "AUC"), rtol=1e-5)
        assert model.get_model_string() == seq.get_model_string()
        assert model.parent.getLearningRate() == seq.parent.getLearningRate()


def test_multiclass_bucket_infers_classes_per_candidate():
    X, y = _clf_data()
    y = np.digitize(X[:, 0], [-0.5, 0.5]).astype(float)
    table = Table({"features": X, "label": y})
    est = _port_clf()
    maps = [{"learningRate": lr} for lr in (0.1, 0.2)]
    (bucket,) = bucket_candidates([(est, m) for m in maps])
    train, valid = _split(table)
    for m, (metric, model) in zip(maps, fit_bucket(bucket, train, valid, "label", "accuracy")):
        seq = est.copy(m).fit(train)
        assert model.getNumClasses() == 3
        assert model.get_model_string() == seq.get_model_string()


def test_one_binning_per_bucket(clf_table, monkeypatch):
    """A bucket bins its rows once, through candidate 0's ``_bin_dataset``
    (the reference guards the same amortization by counting compiles)."""
    calls = []
    original = LightGBMBase._bin_dataset

    def counted(self, *a, **kw):
        calls.append(self.getLearningRate())
        return original(self, *a, **kw)

    monkeypatch.setattr(LightGBMBase, "_bin_dataset", counted)
    maps = [{"learningRate": lr} for lr in (0.05, 0.1, 0.2)]
    (bucket,) = bucket_candidates([(_port_clf(), m) for m in maps])
    train, valid = _split(clf_table)
    fit_bucket(bucket, train, valid, "label", "AUC")
    assert calls == [0.05]
    for m in maps:
        _port_clf().copy(m).fit(train)
    assert len(calls) == 4


# -- TrainValidSweep -------------------------------------------------------------


def _grid_sweep(mod_sweep, est, grid_cls, **kw):
    return mod_sweep.TrainValidSweep(
        estimator=est, paramSpace=grid_cls({"learningRate": [0.05, 0.1, 0.2],
                                            "numLeaves": [7, 15]}),
        labelCol="label", evaluationMetric="AUC", seed=3, **kw)


@pytest.mark.parametrize("space", ["grid", "random", "dists", "maps"])
def test_split_and_candidates_equal_the_reference(ref, space):
    jh = ref["hyper"]
    spaces = {
        "grid": (GridSpace({"learningRate": [0.05, 0.2], "numLeaves": [7, 15]}),
                 jh.GridSpace({"learningRate": [0.05, 0.2], "numLeaves": [7, 15]})),
        "random": (RandomSpace({"learningRate": DoubleRangeHyperParam(0.05, 0.3)}, seed=4),
                   jh.RandomSpace({"learningRate": jh.DoubleRangeHyperParam(0.05, 0.3)}, seed=4)),
        "dists": ({"learningRate": DoubleRangeHyperParam(0.05, 0.3),
                   "numLeaves": DiscreteHyperParam([7, 15])},
                  {"learningRate": jh.DoubleRangeHyperParam(0.05, 0.3),
                   "numLeaves": jh.DiscreteHyperParam([7, 15])}),
        "maps": (None, None),
    }
    tspace, jspace = spaces[space]
    extra = {"paramMaps": [{"numLeaves": 3}, {"learningRate": 0.4}]} if space == "maps" else {}
    port = TrainValidSweep(estimator=_port_clf(), paramSpace=tspace, numRuns=3, seed=1,
                           trainRatio=0.6, **extra)
    want = ref["sweep"].TrainValidSweep(estimator=_ref_clf(ref), paramSpace=jspace, numRuns=3,
                                        seed=1, trainRatio=0.6, **extra)
    assert [m for _, m in port._candidates()] == [m for _, m in want._candidates()]
    for n in (2, 3, 240, 1001):
        np.testing.assert_array_equal(port._split(n), want._split(n))
    with pytest.raises(ValueError, match="cannot split"):
        port._split(1)


def _records(seen, drop=()):
    return [(type(e).__name__, {k: v for k, v in e.to_record().items()
                                if k not in TIMING | set(drop)}) for e in seen]


def _series(reg):
    out = {}
    for name in ("sweep_candidates_total", "sweep_buckets", "sweep_best_metric",
                 "sweep_runs_total"):
        metric = reg.get(name)
        out[name] = None if metric is None else metric.value
    return out


def test_sweep_matches_the_reference_and_commits_standalone_bytes(ref, clf_table, tmp_path,
                                                                  monkeypatch):
    X, y = clf_table["features"], clf_table["label"]
    runs = {}
    for pkg, sweep_mod, est, grid, table, obs in (
            ("port", tsweep, _port_clf(),
             GridSpace, clf_table, tobs),
            ("ref", ref["sweep"], _ref_clf(ref), ref["hyper"].GridSpace,
             ref["Table"]({"features": X, "label": y}), ref["obs"])):
        monkeypatch.setenv("MMLSPARK_TPU_CHECKPOINT_DIR", str(tmp_path / pkg))
        seen = []
        bus, reg = obs.get_bus(), obs.get_registry()
        before = _series(reg)
        bus.add_listener(seen.append)
        try:
            sweep = _grid_sweep(sweep_mod, est, grid)
            model = sweep.fit(table)
        finally:
            bus.remove_listener(seen.append)
        after = _series(reg)
        runs[pkg] = dict(sweep=sweep, model=model, events=seen, est=est,
                         series={k: (after[k] - (before[k] or 0.0)) if k.endswith("_total")
                                 else after[k] for k in after})
    port, want = runs["port"]["model"], runs["ref"]["model"]
    metrics = port.getAllMetrics()
    assert len(metrics) == 6
    np.testing.assert_allclose(metrics, want.getAllMetrics(), rtol=1e-5)
    assert port.getBestParams() == want.getBestParams()
    assert int(np.nanargmax(metrics)) == int(np.nanargmax(want.getAllMetrics()))
    assert metrics[int(np.nanargmax(metrics))] == port.getBestMetric()
    assert port.getModelVersion() == want.getModelVersion() == 1
    assert "prediction" in port.transform(clf_table)

    # the committed model IS a standalone fit with the winning params
    version, text = ModelStore(str(tmp_path / "port" / "models")).latest(
        "sweep-lightgbmclassificationmodel")
    assert version == 1
    assert text == runs["port"]["est"].copy(port.getBestParams()).fit(clf_table).get_model_string()

    board = port.leaderboard()
    assert list(board["rank"]) == list(range(6))
    assert board["metric"][0] == port.getBestMetric()
    jboard = want.leaderboard()
    assert list(board["candidate"]) == list(jboard["candidate"])

    # events and sweep_* series, field for field, timings and floats aside
    floats = ("best_metric",)
    assert _records(runs["port"]["events"], floats) == _records(runs["ref"]["events"], floats)
    names = [name for name, _ in _records(runs["port"]["events"])]
    assert names.count("CandidateBatchFitted") == 2 and names[0] == "SweepStarted"
    assert names[-1] == "SweepCompleted"
    ps, js = runs["port"]["series"], runs["ref"]["series"]
    assert np.isclose(ps.pop("sweep_best_metric"), js.pop("sweep_best_metric"), rtol=1e-5)
    assert ps == js == {"sweep_candidates_total": 6.0, "sweep_buckets": 2.0,
                        "sweep_runs_total": 1.0}


def test_dist_dict_space_samples_num_runs(clf_table):
    sweep = TrainValidSweep(
        estimator=_port_clf(numIterations=3),
        paramSpace={"learningRate": DoubleRangeHyperParam(0.05, 0.3),
                    "numLeaves": DiscreteHyperParam([7, 15])},
        labelCol="label", numRuns=3, seed=1, commitModel=False)
    model = sweep.fit(clf_table)
    assert len(model.getAllMetrics()) == 3
    assert model.getModelVersion() == -1
    with pytest.raises(ValueError, match="paramSpace must be"):
        TrainValidSweep(estimator=_port_clf(), paramSpace={"a": [1, 2]}).fit(clf_table)
    with pytest.raises(ValueError, match="no estimator"):
        TrainValidSweep(estimator=None).fit(clf_table)


def test_sweep_model_saves_and_loads(clf_table, tmp_path):
    model = _grid_sweep(tsweep, _port_clf(),
                        GridSpace, commitModel=False).fit(clf_table)
    model.save(str(tmp_path / "sweep_model"))
    back = PipelineStage.load(str(tmp_path / "sweep_model"))
    assert isinstance(back, TrainValidSweepModel)
    assert back.getAllMetrics() == model.getAllMetrics()
    assert back.getBestParams() == model.getBestParams()
    assert back.getBestMetric() == model.getBestMetric()
    best = back.getBestModel()
    best.setDevice("cpu")  # a loaded model's device is the default, the card
    assert best.get_model_string() == model.getBestModel().get_model_string()
    np.testing.assert_array_equal(back.transform(clf_table)["probability"],
                                  model.transform(clf_table)["probability"])


# -- gang mode (2 worker processes on the CPU) -----------------------------------


def test_gang_spec_pickles_the_port_estimator(clf_table):
    """The gang's spec goes through the standard pickle: the estimator
    keeps every param, the port-only ``device`` included."""
    import pickle

    est = _port_clf(learningRate=0.3, numLeaves=9)
    back = pickle.loads(pickle.dumps({"estimator": est, "table": clf_table}, protocol=4))
    assert back["estimator"].extractParamMap() == est.extractParamMap()
    assert back["estimator"].getDevice() == "cpu" and back["estimator"].uid == est.uid
    np.testing.assert_array_equal(back["table"]["features"], clf_table["features"])


def test_a_member_without_its_device_fails_before_any_work(tmp_path):
    """A member whose device cannot start raises before it reads the spec,
    so the gang reports it failed instead of fitting elsewhere."""
    from types import SimpleNamespace

    from mmlspark_tpu_torch.sweep.distributed import sweep_worker_entry

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present, so the payload's device starts")
    ctx = SimpleNamespace(payload={"device": "cuda", "spec": str(tmp_path / "missing.pkl")})
    with pytest.raises(RuntimeError, match="device='cpu'"):
        sweep_worker_entry(ctx)


def _gang_sweep(table, num_processes=0, group_options=None):
    sweep = TrainValidSweep(
        estimator=_port_clf(numIterations=4),
        paramSpace=GridSpace({"learningRate": [0.05, 0.2], "numLeaves": [7, 15]}),
        labelCol="label", evaluationMetric="AUC", seed=3, numProcesses=num_processes)
    if group_options is not None:
        sweep._group_options = group_options
    return sweep, sweep.fit(table)


def _gang_threads(monkeypatch):
    """Two gang workers on a CPU, each with torch's default thread pool
    (every core), spin against each other and run ~16x slower; one thread
    each serves the 240 rows best. The workers read this when they start
    (results do not depend on it)."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")


def test_gang_matches_inline(clf_table, tmp_path, monkeypatch):
    _gang_threads(monkeypatch)
    monkeypatch.setenv("MMLSPARK_TPU_CHECKPOINT_DIR", str(tmp_path / "inline"))
    _, inline = _gang_sweep(clf_table)
    monkeypatch.setenv("MMLSPARK_TPU_CHECKPOINT_DIR", str(tmp_path / "gang"))
    sweep, gang = _gang_sweep(clf_table, num_processes=2,
                              group_options={"epoch_timeout_s": 180.0})
    info = sweep._process_sweep
    assert info["epochs"] == 1
    assert sorted(r["device"] for r in info["worker_results"].values()) == ["cpu", "cpu"]
    np.testing.assert_allclose(gang.getAllMetrics(), inline.getAllMetrics(), rtol=1e-5)
    assert gang.getBestParams() == inline.getBestParams()


def test_sigkill_mid_sweep_does_not_change_selection(clf_table, tmp_path, monkeypatch):
    """Kill a sweep worker mid-bucket: the gang re-forms, journaled
    buckets resume with zero re-execution, and the final leaderboard and
    committed ModelStore version and bytes are the undisturbed run's."""
    _gang_threads(monkeypatch)
    event_log = str(tmp_path / "events.jsonl")
    monkeypatch.setenv("MMLSPARK_TPU_EVENT_LOG", event_log)
    monkeypatch.setenv("MMLSPARK_TPU_CHECKPOINT_DIR", str(tmp_path / "base"))
    _, base = _gang_sweep(clf_table, num_processes=2, group_options={"epoch_timeout_s": 180.0})
    monkeypatch.setenv("MMLSPARK_TPU_CHECKPOINT_DIR", str(tmp_path / "chaos"))
    plan = FaultPlan(seed=11).kill_process(1, iteration=1)
    sweep, chaos = _gang_sweep(clf_table, num_processes=2,
                               group_options={"faults": plan, "epoch_timeout_s": 180.0})
    monkeypatch.delenv("MMLSPARK_TPU_EVENT_LOG")
    tobs.events._sync_env_sink()

    assert plan.fired == [("kill_process", 1, 0)]
    info = sweep._process_sweep
    assert info["epochs"] == 2
    killed = [s for s in info["exit_statuses"] if s.reason == "signal:9"]
    assert len(killed) == 1 and killed[0].member == 1
    assert chaos.getAllMetrics() == base.getAllMetrics()
    assert chaos.getBestParams() == base.getBestParams()
    assert chaos.getModelVersion() == base.getModelVersion() == 1
    name = "sweep-lightgbmclassificationmodel"
    _, base_text = ModelStore(str(tmp_path / "base" / "models")).latest(name)
    _, chaos_text = ModelStore(str(tmp_path / "chaos" / "models")).latest(name)
    assert chaos_text == base_text
    names = [type(e).__name__ for e in tobs.replay(event_log)]
    assert names.count("ProcessLost") == 1
    assert names.count("GroupReformed") == 1
    assert names.count("SweepStarted") == 2
    assert names.count("SweepCompleted") == 2
    assert os.path.exists(event_log)
