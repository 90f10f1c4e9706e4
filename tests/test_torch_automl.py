"""The port's AutoML (``mmlspark_tpu_torch.automl``) and model statistics
(``mmlspark_tpu_torch.train.statistics``) against the JAX package.

Mirrors ``tests/test_automl.py`` and the statistics half of
``tests/test_train.py``; ends with a CPU dry run of ``chip_smoke.py``'s
phase 28 (many models). Hyperparameter draws are numpy's in both
packages, so they must be equal exactly; statistics are numpy reductions
over the same scored table, equal within 1e-12; tuned metrics within rtol
1e-5 of the reference's, with the same winner. Fits run on the CPU
(``device="cpu"``); the reference estimator runs with
``parallelism="serial"`` (conftest's 8 virtual devices would give it a
mesh otherwise).
"""

import os
import time

import numpy as np
import pytest
import torch

import mmlspark_tpu_torch.automl as tautoml
from mmlspark_tpu_torch.automl import (
    DefaultHyperparams,
    DiscreteHyperParam,
    DoubleRangeHyperParam,
    FindBestModel,
    GridSpace,
    HyperparamBuilder,
    IntRangeHyperParam,
    RandomSpace,
    TuneHyperparameters,
)
from mmlspark_tpu_torch.data.table import Table
from mmlspark_tpu_torch.lightgbm import LightGBMClassifier, LightGBMRegressor
from mmlspark_tpu_torch.train import (
    ComputeModelStatistics,
    ComputePerInstanceStatistics,
    binary_auc,
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


@pytest.fixture(scope="module")
def ref():
    import mmlspark_tpu.automl as jautoml
    import mmlspark_tpu.train.statistics as jstats
    from mmlspark_tpu.data.table import Table as JTable
    from mmlspark_tpu.lightgbm import LightGBMClassifier as JClassifier

    return dict(automl=jautoml, stats=jstats, Table=JTable, Classifier=JClassifier)


def _clf_data(n=200, f=5, seed=42):
    """``tests/test_automl.py``'s table, with label noise."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, f))
    y = (X[:, 0] + 0.5 * X[:, 1] + 0.3 * rng.normal(size=n) > 0).astype(np.float64)
    return X, y


@pytest.fixture
def clf_table():
    X, y = _clf_data()
    return Table({"features": X, "label": y})


# -- hyperparameter spaces -------------------------------------------------------


def _dists(mod):
    return {"d": mod.DiscreteHyperParam([1, "two", 3.5]), "i": mod.IntRangeHyperParam(5, 10),
            "x": mod.DoubleRangeHyperParam(0.1, 0.2)}


def test_dist_draws_equal_the_reference(ref):
    port, want = _dists(tautoml), _dists(ref["automl"])
    for name in port:
        a, b = np.random.default_rng(7), np.random.default_rng(7)
        assert [port[name].get_next(a) for _ in range(50)] == \
            [want[name].get_next(b) for _ in range(50)]
    assert all(5 <= port["i"].get_next(np.random.default_rng(0)) < 10 for _ in range(5))
    with pytest.raises(ValueError):
        IntRangeHyperParam(3, 3)
    with pytest.raises(ValueError):
        DoubleRangeHyperParam(1.0, 0.5)
    with pytest.raises(ValueError):
        DiscreteHyperParam([])


def test_spaces_equal_the_reference(ref):
    ja = ref["automl"]
    space = (HyperparamBuilder().add_hyperparam("a", DiscreteHyperParam([1, 2]))
             .add_hyperparam("b", DoubleRangeHyperParam(0, 1)).build())
    jspace = (ja.HyperparamBuilder().add_hyperparam("a", ja.DiscreteHyperParam([1, 2]))
              .add_hyperparam("b", ja.DoubleRangeHyperParam(0, 1)).build())
    assert list(space.param_maps(6)) == list(jspace.param_maps(6))
    rs = RandomSpace({"n": IntRangeHyperParam(2, 40), "x": DoubleRangeHyperParam(0, 1)}, seed=9)
    jrs = ja.RandomSpace({"n": ja.IntRangeHyperParam(2, 40), "x": ja.DoubleRangeHyperParam(0, 1)},
                         seed=9)
    assert list(rs.param_maps(5)) == list(jrs.param_maps(5))
    grid = {"a": [1, 2], "b": ["x", "y"], "c": [0.5]}
    assert list(GridSpace(grid).param_maps()) == list(ja.GridSpace(grid).param_maps())
    assert list(GridSpace(grid).param_maps(3)) == list(ja.GridSpace(grid).param_maps(3))
    assert len(list(GridSpace(grid).param_maps())) == 4


def test_default_hyperparams(ref):
    """``lightgbm()`` names real params of the port's estimators; every
    space draws what the reference's draws."""
    for est in (LightGBMClassifier(), LightGBMRegressor()):
        for name in DefaultHyperparams.lightgbm():
            assert est.hasParam(name), name
    for space in ("lightgbm", "sgd", "vw"):
        port = getattr(DefaultHyperparams, space)()
        want = getattr(ref["automl"].DefaultHyperparams, space)()
        assert list(port) == list(want)
        a, b = np.random.default_rng(3), np.random.default_rng(3)
        assert [{k: d.get_next(a) for k, d in port.items()} for _ in range(4)] == \
            [{k: d.get_next(b) for k, d in want.items()} for _ in range(4)]


# -- TuneHyperparameters ---------------------------------------------------------


def _tune_kwargs(mod, clf, **est_kw):
    return dict(
        models=clf(numIterations=5, maxBin=32, **est_kw),
        paramSpace={"numLeaves": mod.DiscreteHyperParam([3, 15]),
                    "learningRate": mod.DoubleRangeHyperParam(0.05, 0.3)},
        evaluationMetric="AUC", numFolds=2, numRuns=3, seed=5,
    )


def test_tune_batched_threadpool_and_parallel_agree(clf_table):
    kw = _tune_kwargs(tautoml, LightGBMClassifier, device="cpu")
    batched = TuneHyperparameters(sweepMode="batched", **kw).fit(clf_table)
    serial = TuneHyperparameters(sweepMode="threadpool", **kw).fit(clf_table)
    parallel = TuneHyperparameters(sweepMode="threadpool", parallelism=2, **kw).fit(clf_table)
    assert batched.getAllMetrics() == serial.getAllMetrics() == parallel.getAllMetrics()
    assert batched.getBestParams() == serial.getBestParams() == parallel.getBestParams()
    assert len(batched.getAllMetrics()) == 3
    assert 0.5 <= batched.getBestMetric() <= 1.0
    assert batched.getBestModel().getDevice() == "cpu"
    assert "prediction" in batched.transform(clf_table)


def test_tune_matches_the_reference(ref, clf_table):
    X, y = clf_table["features"], clf_table["label"]
    port = TuneHyperparameters(sweepMode="batched",
                               **_tune_kwargs(tautoml, LightGBMClassifier, device="cpu")
                               ).fit(clf_table)
    want = ref["automl"].TuneHyperparameters(
        sweepMode="batched", **_tune_kwargs(ref["automl"], ref["Classifier"],
                                             parallelism="serial")
    ).fit(ref["Table"]({"features": X, "label": y}))
    np.testing.assert_allclose(port.getAllMetrics(), want.getAllMetrics(), rtol=1e-5)
    assert port.getBestParams() == want.getBestParams()


def test_tune_accuracy_and_per_estimator_space(clf_table):
    est = LightGBMClassifier(numIterations=5, maxBin=32, device="cpu")
    tuned = TuneHyperparameters(
        models=[est], paramSpace={est.uid: {"numLeaves": DiscreteHyperParam([3, 7])}},
        evaluationMetric="accuracy", numFolds=2, numRuns=2, seed=1, sweepMode="batched",
    ).fit(clf_table)
    assert len(tuned.getAllMetrics()) == 2
    assert 0.5 <= tuned.getBestMetric() <= 1.0
    with pytest.raises(ValueError, match="no estimators"):
        TuneHyperparameters(models=[]).fit(clf_table)


def test_auto_mode_falls_back_to_the_pool_and_batched_does_not(clf_table, monkeypatch):
    """``sweepMode="auto"`` runs the thread pool when the batched plane
    raises (the reference's semantics); ``"batched"`` lets the error out."""
    from mmlspark_tpu_torch.sweep import batched as tbatched

    kw = _tune_kwargs(tautoml, LightGBMClassifier, device="cpu")
    want = TuneHyperparameters(sweepMode="threadpool", **kw).fit(clf_table).getAllMetrics()

    def broken(*a, **k):
        raise RuntimeError("batched plane down")

    monkeypatch.setattr(tbatched, "cv_metrics_batched", broken)
    assert TuneHyperparameters(sweepMode="auto", **kw).fit(clf_table).getAllMetrics() == want
    with pytest.raises(RuntimeError, match="batched plane down"):
        TuneHyperparameters(sweepMode="batched", **kw).fit(clf_table)


def _hammer(fn, threads=16, calls=200):
    """``fn(i)`` from ``threads`` threads at once (more than the cores),
    with a short switch interval; every thread must finish in 60 s."""
    import sys
    import threading

    saved = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        workers = [threading.Thread(target=lambda t=t: [fn(t * calls + i) for i in range(calls)])
                   for t in range(threads)]
        for w in workers:
            w.start()
        for w in workers:
            w.join(timeout=60)
        assert not any(w.is_alive() for w in workers)
    finally:
        sys.setswitchinterval(saved)


def test_launch_counters_lose_no_update_under_threads():
    """A tuner's thread pool launches kernels concurrently: each wrapper's
    count takes a lock (``count_launch``), so none is lost."""
    from mmlspark_tpu_torch.ops import hopper_histogram as hh

    saved = hh.build_histograms_cuda.launches
    hh.build_histograms_cuda.launches = 0
    try:
        _hammer(lambda i: hh.count_launch(hh.build_histograms_cuda))
        assert hh.build_histograms_cuda.launches == 16 * 200
    finally:
        hh.build_histograms_cuda.launches = saved


def test_model_store_commits_from_threads_take_distinct_versions(tmp_path):
    """Fits of a thread pool under a checkpoint root each open their own
    ModelStore on one directory: every commit gets its own version."""
    from mmlspark_tpu_torch.runtime.journal import ModelStore

    root = str(tmp_path / "models")
    versions = []
    _hammer(lambda i: versions.append(ModelStore(root).commit(f"m{i}", name="m")), threads=8,
            calls=10)
    assert sorted(versions) == list(range(1, 81))
    assert ModelStore(root).latest("m")[0] == 80


def test_remap_classes_equals_the_reference_loop(ref):
    """The vectorized remap against the reference's dict lookup, id for id."""
    from mmlspark_tpu_torch.train.statistics import remap_classes

    rng = np.random.default_rng(8)
    cases = [(rng.integers(0, 4, 300).astype(float), rng.integers(1, 5, 300)),
             (np.array([-0.0, 0.0, 2.5, 1e300, -1e-300]), np.array([0.0, 2.5, 2.5, -0.0, 7.0])),
             (np.array(["b", "a", "c"], dtype=object), np.array([1, 2, 3]))]
    for labels, pred in cases:
        got, want = remap_classes(labels, pred), ref["stats"].remap_classes(labels, pred)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)


# -- FindBestModel ---------------------------------------------------------------


def test_find_best_model(clf_table):
    good = LightGBMClassifier(numIterations=20, numLeaves=15, device="cpu").fit(clf_table)
    weak = LightGBMClassifier(numIterations=1, numLeaves=2, device="cpu").fit(clf_table)
    best = FindBestModel(models=[weak, good], evaluationMetric="AUC").fit(clf_table)
    evald = best.get_evaluated_models()
    assert evald.num_rows == 2
    assert list(evald["model"]) == [weak.uid, good.uid]
    assert best.getBestModelMetrics() == evald["metric"].max()
    assert best.getBestModel() is (good if evald["metric"][1] > evald["metric"][0] else weak)
    assert "prediction" in best.transform(clf_table)


def test_find_best_model_without_models_raises(clf_table):
    with pytest.raises(ValueError, match="no trained models"):
        FindBestModel(models=[]).fit(clf_table)


# -- model statistics ------------------------------------------------------------

_rng = np.random.default_rng(17)
_P3 = _rng.dirichlet(np.ones(3), size=40)
_P2 = _rng.dirichlet(np.ones(2), size=40)
SCORED = {
    "binary_2col": dict(label=_rng.integers(0, 2, 40).astype(float),
                        prediction=_P2.argmax(1).astype(float), probability=_P2),
    "binary_1col": dict(label=_rng.integers(0, 2, 40).astype(float),
                        prediction=(_P2[:, 1] > 0.5).astype(float), probability=_P2[:, 1]),
    "multiclass": dict(label=_rng.integers(0, 3, 40).astype(float),
                       prediction=_P3.argmax(1).astype(float), probability=_P3),
    "string_labels": dict(label=np.array(["no", "yes"] * 20, dtype=object),
                          prediction=np.where(_P2[:, 1] > 0.5, "yes", "no").astype(object),
                          probability=_P2),
    "subset_classes": dict(label=np.array([0.0, 2.0] * 20),
                           prediction=np.array([0.0, 2.0, 2.0, 1.0] * 10), probability=_P3),
    "reindexed_binary": dict(label=np.array([1.0, 2.0] * 20),
                             prediction=np.array([1.0, 2.0, 2.0, 2.0] * 10), probability=_P2),
    "regression": dict(label=_rng.normal(size=40) * 3, prediction=_rng.normal(size=40) * 3),
    "integer_regression": dict(label=_rng.integers(0, 500, 40).astype(float),
                               prediction=_rng.integers(0, 500, 40).astype(float)),
}


def _assert_tables_close(port, want, atol=1e-12):
    assert port.columns == want.columns
    for name in port.columns:
        a, b = port[name], want[name]
        if a.dtype == object or b.dtype == object:
            assert list(a) == list(b), name
        else:
            np.testing.assert_allclose(a, b, rtol=0, atol=atol, err_msg=name)


# (scored table, evaluationMetric): every classification table under
# "auto" and "classification", the numeric ones under "regression" too
STAT_CASES = [(case, kind) for case in sorted(SCORED) for kind in ("auto", "classification",
                                                                    "regression")
              if not (kind == "classification" and case.endswith("regression"))
              and not (kind == "regression" and case == "string_labels")]


@pytest.mark.parametrize("case,kind", STAT_CASES, ids=[f"{c}-{k}" for c, k in STAT_CASES])
def test_statistics_equal_the_reference(ref, case, kind):
    cols = SCORED[case]
    port_t, want_t = Table(dict(cols)), ref["Table"](dict(cols))
    js = ref["stats"]
    _assert_tables_close(
        ComputeModelStatistics(labelCol="label", evaluationMetric=kind).transform(port_t),
        js.ComputeModelStatistics(labelCol="label", evaluationMetric=kind).transform(want_t))
    _assert_tables_close(
        ComputePerInstanceStatistics(labelCol="label", evaluationMetric=kind).transform(port_t),
        js.ComputePerInstanceStatistics(labelCol="label", evaluationMetric=kind
                                        ).transform(want_t))


def test_statistics_known_values():
    t = Table({"label": np.array([0, 0, 1, 1, 1, 0]),
               "prediction": np.array([0, 1, 1, 1, 0, 0]),
               "probability": np.array([[0.8, 0.2], [0.4, 0.6], [0.1, 0.9], [0.2, 0.8],
                                        [0.7, 0.3], [0.9, 0.1]])})
    stats = ComputeModelStatistics(labelCol="label").transform(t)
    assert stats["accuracy"][0] == pytest.approx(4 / 6)
    cm = stats["confusion_matrix"][0].reshape(2, 2)
    assert cm.sum() == 6 and cm[0, 0] == 2 and cm[1, 1] == 2
    reg = ComputeModelStatistics(labelCol="label", evaluationMetric="regression").transform(
        Table({"label": np.array([1.0, 2.0, 3.0]), "prediction": np.array([1.1, 1.9, 3.2])}))
    assert reg["mean_squared_error"][0] == pytest.approx(0.02, abs=1e-9)
    per = ComputePerInstanceStatistics(labelCol="label").transform(
        Table({"label": np.array([0.0, 2.0]), "prediction": np.array([0.0, 2.0]),
               "probability": np.array([[0.8, 0.1, 0.1], [0.1, 0.1, 0.8]])}))
    np.testing.assert_allclose(per["log_loss"], [-np.log(0.8), -np.log(0.8)])


def test_binary_auc(ref):
    labels = np.array([0, 0, 1, 1])
    assert binary_auc(labels, np.array([0.1, 0.4, 0.35, 0.8])) == pytest.approx(0.75)
    assert binary_auc(labels, np.array([0.5, 0.5, 0.5, 0.5])) == pytest.approx(0.5)
    assert np.isnan(binary_auc(np.ones(3), np.arange(3.0)))
    rng = np.random.default_rng(5)
    lab, sc = rng.integers(0, 2, 500), np.round(rng.normal(size=500), 1)  # ties
    assert binary_auc(lab, sc) == ref["stats"].binary_auc(lab, sc)


# -- chip_smoke's phase 28 on the CPU ----------------------------------------------


class _CudaStub:
    """``torch.cuda`` for a CPU dry run: syncs and memory calls do nothing,
    events read the host clock."""

    class Event:
        def __init__(self, enable_timing=False):
            self.t = 0.0

        def record(self):
            self.t = time.perf_counter()

        def elapsed_time(self, end):
            return (end.t - self.t) * 1e3

    def synchronize(self, *a):
        pass

    def empty_cache(self):
        pass

    def reset_peak_memory_stats(self, *a):
        pass

    def max_memory_allocated(self, *a):
        return 0


class _TorchProxy:
    """``torch`` with every device the CPU and ``cuda`` a stub."""

    cuda = _CudaStub()

    def __getattr__(self, name):
        return getattr(torch, name)

    @staticmethod
    def device(*a, **kw):
        return torch.device("cpu")


def test_chip_smoke_many_models_phase_runs_on_the_cpu(tmp_path, monkeypatch):
    """A dry run of ``chip_smoke.phase_many_models`` at 4,000 rows and 2
    iterations through a torch proxy, with the entry points' device
    patched to the CPU and the kernel entries counting their plain calls
    as launches: catches name errors and broken checks before a chip call.
    Torch takes one thread in the test and in the gang workers: a parallel
    test run has every core busy already."""
    import chip_smoke
    from mmlspark_tpu_torch import automl as tautoml
    from mmlspark_tpu_torch import runtime as truntime
    from mmlspark_tpu_torch.lightgbm import base as tbase
    from mmlspark_tpu_torch.lightgbm import binning as tbinning
    from mmlspark_tpu_torch.lightgbm import booster as tbooster
    from mmlspark_tpu_torch.lightgbm import objectives as tobjectives
    from mmlspark_tpu_torch.lightgbm import train as ttrain
    from mmlspark_tpu_torch.observability import profiler as tprofiler
    from mmlspark_tpu_torch.ops import histogram as thistogram
    from mmlspark_tpu_torch.ops import hopper_histogram as hh
    from mmlspark_tpu_torch.ops import u_histogram as uh
    from mmlspark_tpu_torch.sweep import batched as tbatched

    cpu = lambda device=None: torch.device("cpu")  # noqa: E731
    for module in (ttrain, tbase, tbooster):
        monkeypatch.setattr(module, "resolve_device", cpu)
    for name in ("build_histograms_cuda", "build_histograms_combined_cuda"):
        fn = getattr(thistogram, name)

        def counted(*a, _fn=fn, _entry=getattr(hh, name)):
            out = _fn(*a)
            hh.count_launch(_entry)
            return out

        monkeypatch.setattr(thistogram, name, counted)
    monkeypatch.setattr(chip_smoke, "_card_line", lambda: "NVIDIA H100 80GB HBM3, 700.00 W")
    monkeypatch.setattr(chip_smoke, "_compute_mode", lambda: "Default")
    monkeypatch.setattr(chip_smoke, "DATA_DIR", str(tmp_path))
    monkeypatch.setattr(chip_smoke, "N_MANY_GANG", 400)
    monkeypatch.setattr(chip_smoke, "N_MANY_TUNE", 400)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")  # the gang workers read it at start
    monkeypatch.setitem(chip_smoke.HIGGS_PARAMS, "device", "cpu")
    monkeypatch.setitem(chip_smoke.HIGGS_PARAMS, "numIterations", 2)
    n, n_test = 4_000, 500
    X, y = chip_smoke._make_data(n + n_test, chip_smoke.N_FEATURES, seed=0)
    bins, mapper = tbinning.bin_dataset(X[:n], max_bin=chip_smoke.NUM_BINS - 1)
    higgs = dict(bins=bins, mapper=mapper, X=X[:n], y=y[:n], X_test=X[n:], y_test=y[n:])
    from mmlspark_tpu_torch import observability as tobs
    from mmlspark_tpu_torch import sweep as tsweep

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        rec = chip_smoke.phase_many_models(
            _TorchProxy(), uh, hh, tprofiler.device_peaks("NVIDIA H100 80GB HBM3"), tbase,
            ttrain, tobjectives, tbatched, tsweep, tautoml, truntime, tobs.events, Table,
            LightGBMClassifier, tobjectives.auc, higgs)
    finally:
        torch.set_num_threads(threads)
    assert rec["train_many"]["launches"]["hist_panel"] == 4 * 5 * 2
    assert rec["sweep"]["candidates"] == 6 and rec["gang"]["killed"]["epochs"] == 2
    assert set(rec["kernels"]) == {1, 8} and rec["launches"]["hist_panel"] > 0
