"""The port's TrainClassifier and TrainRegressor (mmlspark_tpu_torch.train)
against the JAX package's, over each package's LightGBM on the CPU, on a
mixed table (strings with None, NaN and numpy scalars, numerics with NaN,
text, a label with noise) and row weights: the featurized matrix is equal,
the model texts hold ``model_texts_close`` and the decoded predictions are
equal. Trained models move between the packages; no new module imports
jax or the JAX package; chip_smoke's phase 32 runs on the CPU.
"""

import os
import pathlib
import subprocess
import sys
import time
import types

import numpy as np
import pytest


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


# At import, so that every pytest worker has the module before it collects
# the JAX package's own test files.
try:
    _import_reference()
except ModuleNotFoundError as err:
    if err.name != "jax":
        raise

import torch

from mmlspark_tpu_torch.core.pipeline import PipelineStage
from mmlspark_tpu_torch.data.table import Table
from mmlspark_tpu_torch.lightgbm import LightGBMClassifier, LightGBMRegressor
from mmlspark_tpu_torch.train import (
    TrainClassifier,
    TrainedClassifierModel,
    TrainedRegressorModel,
    TrainRegressor,
)

REPO = pathlib.Path(__file__).resolve().parents[1]
PARAMS = dict(numIterations=4, numLeaves=7, minGainToSplit=1e-3, minDataInLeaf=10)


@pytest.fixture(scope="module")
def ref():
    import mmlspark_tpu.core.pipeline as jpipeline
    import mmlspark_tpu.train as jtrain
    from mmlspark_tpu.data.table import Table as JTable
    from mmlspark_tpu.lightgbm import LightGBMClassifier as JClassifier
    from mmlspark_tpu.lightgbm import LightGBMRegressor as JRegressor
    from mmlspark_tpu.lightgbm.procfit import model_texts_close

    return types.SimpleNamespace(train=jtrain, Table=JTable, Classifier=JClassifier,
                                 Regressor=JRegressor, close=model_texts_close,
                                 pipeline=jpipeline)


def _raw(n=1200, seed=0):
    """A raw table: a categorical string column with None, NaN and numpy
    scalars, a near-unique text column, numerics with NaN, row weights,
    and a latent with label noise."""
    rng = np.random.default_rng(seed)
    pool = ["red", "green", "blue", None, float("nan"), np.float64(2.5), np.int64(3)]
    cat = np.empty(n, dtype=object)
    cat[:] = [pool[i] for i in rng.integers(0, len(pool), n)]
    code = np.array([f"AP{i:03d}" for i in rng.integers(0, 140, n)], dtype=object)
    num = rng.normal(size=n)
    num[rng.random(n) < 0.1] = np.nan
    ints = rng.integers(0, 50, n)
    effect = rng.normal(0, 0.8, 140)[np.array([int(c[2:]) for c in code])]
    latent = np.nan_to_num(num) + 0.7 * (cat == "red") + effect + 0.02 * ints
    noisy = latent + rng.logistic(size=n)
    return {"cat": cat, "code": code, "num": num, "ints": ints,
            "w": rng.uniform(0.5, 2.0, n)}, latent, noisy


def _fit_both(ref, trainer, learner, label, cols, **kw):
    port_learner = {"clf": LightGBMClassifier, "reg": LightGBMRegressor}[learner]
    ref_learner = {"clf": ref.Classifier, "reg": ref.Regressor}[learner]
    port_trainer = {"clf": TrainClassifier, "reg": TrainRegressor}[trainer]
    ref_trainer = {"clf": ref.train.TrainClassifier, "reg": ref.train.TrainRegressor}[trainer]
    port = port_trainer(model=port_learner(device="cpu", weightCol="w", **PARAMS),
                        labelCol=label, **kw).fit(Table(cols))
    want = ref_trainer(model=ref_learner(parallelism="serial", weightCol="w", **PARAMS),
                       labelCol=label, **kw).fit(ref.Table(cols))
    return port, want


def _check(ref, port, want, cols, label, pred_equal=True):
    test = {k: v for k, v in cols.items() if k != label}
    feats = port.getFeaturizerModel().transform(Table(cols))[port.getFeaturesCol()]
    np.testing.assert_array_equal(
        feats, want.getFeaturizerModel().transform(ref.Table(cols))[want.getFeaturesCol()])
    assert port.getFeaturesCol() == want.getFeaturesCol()
    assert ref.close(port.getFittedModel().get_model_string(),
                     want.getFittedModel().get_model_string())
    got, exp = port.transform(Table(test)), want.transform(ref.Table(test))
    assert got.columns == exp.columns
    if pred_equal:
        assert [repr(v) for v in got["prediction"]] == [repr(v) for v in exp["prediction"]]
    return got, exp


@pytest.mark.parametrize("labels", ["strings", "numbers", "indices", "bools"])
def test_train_classifier_equals_the_reference(ref, labels):
    cols, _, noisy = _raw()
    cols["label"] = {
        "strings": np.where(noisy > 0.5, "Y", "N").astype(object),
        "numbers": np.where(noisy > 0.5, 7.0, -2.0),
        "indices": (noisy > 0.5).astype(np.int64),
        "bools": noisy > 0.5,
    }[labels]
    port, want = _fit_both(ref, "clf", "clf", "label", cols)
    assert port.getLabelLevels() == want.getLabelLevels()
    got, _ = _check(ref, port, want, cols, "label")
    assert set(np.unique(got["prediction"].astype(str))) <= {
        "strings": {"N", "Y"}, "numbers": {"7.0", "-2.0"}, "indices": {"0.0", "1.0"},
        "bools": {"0.0", "1.0"}}[labels]


def test_multiclass_and_unindexed_labels_equal_the_reference(ref):
    cols, _, noisy = _raw(seed=1)
    cols["label"] = np.array(["lo", "mid", "hi"], dtype=object)[np.digitize(noisy, [0.0, 1.0])]
    port, want = _fit_both(ref, "clf", "clf", "label", cols)
    assert port.getLabelLevels() == ["hi", "lo", "mid"]
    _check(ref, port, want, cols, "label")
    cols["label"] = (noisy > 0.5).astype(np.float64)
    port, want = _fit_both(ref, "clf", "clf", "label", cols, reindexLabel=False,
                           numFeatures=64, featuresCol="feats")
    assert port.getLabelLevels() is None and port.getFeaturesCol() == "feats"
    _check(ref, port, want, cols, "label")


def test_train_regressor_equals_the_reference(ref):
    cols, latent, _ = _raw(seed=2)
    cols["y"] = (10 * latent + np.random.default_rng(9).normal(size=len(latent))).astype(np.float32)
    port, want = _fit_both(ref, "reg", "reg", "y", cols)
    assert isinstance(port, TrainedRegressorModel)
    got, exp = _check(ref, port, want, cols, "y", pred_equal=False)
    np.testing.assert_allclose(got["prediction"], exp["prediction"], rtol=1e-5, atol=1e-5)


def test_a_vector_column_is_not_featurized(ref):
    rng = np.random.default_rng(4)
    X = rng.normal(size=(600, 5))
    cols = {"features": X, "label": np.where(X[:, 0] + rng.logistic(size=600) > 0, "a", "b")
            .astype(object)}
    port = TrainClassifier(model=LightGBMClassifier(device="cpu", **PARAMS),
                           labelCol="label").fit(Table(cols))
    want = ref.train.TrainClassifier(model=ref.Classifier(parallelism="serial", **PARAMS),
                                     labelCol="label").fit(ref.Table(cols))
    assert port.getFeaturizerModel() is None and port.getFeaturesCol() == "features"
    assert ref.close(port.getFittedModel().get_model_string(),
                     want.getFittedModel().get_model_string())
    assert list(port.transform(Table({"features": X}))["prediction"]) == \
        list(want.transform(ref.Table({"features": X}))["prediction"])


def test_trained_models_move_between_the_packages(ref, tmp_path):
    cols, latent, noisy = _raw(seed=3)
    cols["label"] = np.where(noisy > 0.5, "Y", "N").astype(object)
    port, want = _fit_both(ref, "clf", "clf", "label", cols)
    test = {k: v for k, v in cols.items() if k != "label"}
    port.save(str(tmp_path / "port"))
    want.save(str(tmp_path / "ref"))
    from_ref = PipelineStage.load(str(tmp_path / "ref"))
    assert isinstance(from_ref, TrainedClassifierModel)
    from_ref.getFittedModel().setDevice("cpu")
    from_port = ref.pipeline.PipelineStage.load(str(tmp_path / "port"))
    for a, b in ((from_ref.transform(Table(test)), want.transform(ref.Table(test))),
                 (port.transform(Table(test)), from_port.transform(ref.Table(test)))):
        assert list(a["prediction"]) == list(b["prediction"])
        np.testing.assert_allclose(a["probability"], b["probability"], rtol=1e-6, atol=1e-7)
    cols["y"] = latent
    reg, _ = _fit_both(ref, "reg", "reg", "y", {k: v for k, v in cols.items() if k != "label"})
    reg.save(str(tmp_path / "reg"))
    loaded = PipelineStage.load(str(tmp_path / "reg"))
    loaded.getFittedModel().setDevice("cpu")
    np.testing.assert_array_equal(loaded.transform(Table(test))["prediction"],
                                  reg.transform(Table(test))["prediction"])


@pytest.mark.parametrize("module", ["ops.hashing", "featurize", "stages", "train",
                                    "data.table", "data.sharded"])
def test_new_module_loads_neither_jax_nor_the_jax_package(module):
    code = (f"import sys, mmlspark_tpu_torch.{module}\n"
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'mmlspark_tpu.'))"
            " or m == 'mmlspark_tpu']\n"
            "assert not bad, bad\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    subprocess.run([sys.executable, "-c", code], check=True, env=env, cwd=str(REPO),
                   timeout=120)


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


class _TorchProxy:
    """``torch`` with every device the CPU and ``cuda`` a stub."""

    cuda = _CudaStub()

    def __getattr__(self, name):
        return getattr(torch, name)

    @staticmethod
    def device(*a, **kw):
        return torch.device("cpu")


def test_chip_smoke_trainers_phase_runs_on_the_cpu(tmp_path, monkeypatch):
    """A dry run of ``chip_smoke.phase_trainers`` at 2,000 rows and 2
    iterations through a torch proxy, the entry points' device patched to
    the CPU and the kernel entries counting their plain calls as launches:
    catches name errors and broken checks before a chip call."""
    import chip_smoke
    from mmlspark_tpu_torch import featurize
    from mmlspark_tpu_torch.lightgbm import base as tbase
    from mmlspark_tpu_torch.lightgbm import booster as tbooster
    from mmlspark_tpu_torch.lightgbm import objectives as tobjectives
    from mmlspark_tpu_torch.lightgbm import train as ttrain
    from mmlspark_tpu_torch.observability import profiler as tprofiler
    from mmlspark_tpu_torch.ops import histogram as thistogram
    from mmlspark_tpu_torch.ops import hopper_histogram as hh
    from mmlspark_tpu_torch.ops import u_histogram as uh

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
    monkeypatch.setattr(chip_smoke, "DATA_DIR", str(tmp_path))
    for name, value in (("N_TRAINERS", 2000), ("N_TEST", 1000), ("N_TRAINERS_CPU", 200),
                        ("N_TRAINERS_REG", 500), ("N_TRAINERS_REG_TEST", 200)):
        monkeypatch.setattr(chip_smoke, name, value)
    monkeypatch.setitem(chip_smoke.TRAINERS_PARAMS, "numIterations", 2)
    rec = chip_smoke.phase_trainers(
        _TorchProxy(), uh, hh, tprofiler.device_peaks("NVIDIA H100 80GB HBM3"), tbase,
        tobjectives, ttrain, featurize, Table, PipelineStage, LightGBMClassifier,
        LightGBMRegressor, TrainClassifier, TrainRegressor, tobjectives.auc,
        "NVIDIA H100 80GB HBM3, 700.00 W")
    assert rec["fit"]["plans"] == chip_smoke.TRAINERS_PLAN
    assert rec["fit"]["columns"] == 590 and rec["card_cpu"]["text_equal"]
    assert all(rec["save_load"]["columns_equal"].values())
    assert set(rec["kernels"]) == {1, 8} and rec["launches"]["hist_panel"] > 0
    assert all(r["max_abs_err"] == 0.0 for r in rec["kernels"].values())
