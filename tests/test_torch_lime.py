"""The port's LIME (``mmlspark_tpu_torch.lime``) against the JAX package's,
on the CPU: every case of ``tests/test_lime.py`` as a parity case, seeded
numpy inputs through both packages, and TabularLIME over a
``LightGBMRegressor`` fitted by the reference and carried to the port.

Bit for bit: SLIC labels and clusters, masked images, the perturbations
(numpy's ``default_rng(seed)`` on the host in both) and so the inner
model's inputs. Within ``TOL`` = 1e-5 of the largest magnitude: the lasso
weights. The coordinate descent runs 100 sweeps of float32 column steps
whose products ``X @ w`` and ``X[:, j] @ r`` sum in the device's order
(XLA's vmapped dots in the reference, ``bmm`` in the port), so the weights
part in the last bits; on seeded problems of up to 40 columns the gap
measured 1.4e-6 of the largest (an ill-conditioned 50 x 40 problem) and
2e-7 to 4e-7 otherwise. Tests marked ``cuda`` need the card.
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

from mmlspark_tpu_torch.core.pipeline import PipelineStage, Transformer
from mmlspark_tpu_torch.data.table import Table
from mmlspark_tpu_torch.lightgbm import LightGBMRegressionModel
from mmlspark_tpu_torch.lightgbm.convert import booster_from_jax, tabular_lime_model_from_jax
from mmlspark_tpu_torch.lime import (
    ImageLIME,
    SuperpixelTransformer,
    TabularLIME,
    TabularLIMEModel,
    fit_lasso_batch,
    mask_image,
    slic,
)
from mmlspark_tpu_torch.lime import lasso as tlasso

TOL = 1e-5  # lasso weights, of the largest magnitude


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """torch on one thread for this file: the lasso's 2,800 sequential steps
    of small ops stall in the thread pools' barriers when the test workers
    share the cores (under the full run's 6 workers, 500 s against 15 s)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def ref():
    from mmlspark_tpu import lime as jlime
    from mmlspark_tpu.core.pipeline import PipelineStage as JStage
    from mmlspark_tpu.core.pipeline import Transformer as JTransformer
    from mmlspark_tpu.data.table import Table as JTable
    from mmlspark_tpu.lightgbm import LightGBMRegressor as JRegressor

    return dict(lime=jlime, Table=JTable, Stage=JStage, Transformer=JTransformer,
                Regressor=JRegressor)


def _linear_model(base):
    """Inner model y = x @ w (a Transformer of ``base``'s package)."""

    class _LinearModel(base):
        def __init__(self, w, input_col="features", pred_col="prediction", **kw):
            super().__init__(**kw)
            self._w = np.asarray(w, dtype=np.float64)
            self._in = input_col
            self._out = pred_col

        def transform(self, table):
            X = np.asarray(table.column(self._in), dtype=np.float64)
            if X.ndim > 2:
                X = X.reshape(len(X), -1)[:, : len(self._w)]
            return table.with_column(self._out, X @ self._w)

    return _LinearModel


def _region_model(base):
    """Inner image model: responds to the top-left 8x8 block's intensity."""

    class _RegionModel(base):
        def transform(self, table):
            imgs = np.asarray(table.column("image"), dtype=np.float64)
            score = imgs[:, :8, :8].mean(axis=(1, 2, 3))
            return table.with_column("prediction", score)

    return _RegionModel


def _close(got, want, tol=TOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert err <= tol, f"max error {err:.3g} of the largest magnitude (tolerance {tol})"


def _weights(col):
    return np.stack([np.asarray(w, dtype=np.float64) for w in col])


class TestLasso:
    def test_least_squares_recovery(self, ref):
        rng = np.random.default_rng(42)
        X = rng.normal(size=(4, 200, 3))
        w_true = np.array([2.0, -1.0, 0.5])
        y = X @ w_true
        W = fit_lasso_batch(X, y, 0.0, device="cpu")
        _close(W, ref["lime"].fit_lasso_batch(X, y, 0.0))
        np.testing.assert_allclose(W, np.tile(w_true, (4, 1)), atol=1e-3)

    def test_soft_threshold_sparsity(self, ref):
        rng = np.random.default_rng(42)
        X = rng.normal(size=(1, 400, 5))
        y = X @ np.array([3.0, 0.0, 0.0, 0.0, 0.0])
        W = fit_lasso_batch(X, y, 0.5, device="cpu")
        _close(W, ref["lime"].fit_lasso_batch(X, y, 0.5))
        assert abs(W[0, 0]) > 2.0
        assert np.abs(W[0, 1:]).max() < 0.2

    @pytest.mark.parametrize("shape,lam", [((8, 300, 28), 0.0), ((8, 300, 28), 0.01),
                                           ((6, 1000, 12), 0.1), ((3, 50, 40), 0.0),
                                           ((5, 64, 6), 5.0)],
                             ids=["higgs_width", "higgs_width_l1", "wide_rows",
                                  "ill_conditioned", "all_thresholded"])
    def test_weights_agree(self, ref, shape, lam):
        rng = np.random.default_rng(sum(shape))
        X = rng.normal(size=shape)
        y = X @ rng.normal(size=shape[2]) + 0.1 * rng.normal(size=shape[:2])
        want = ref["lime"].fit_lasso_batch(X, y, lam)
        got = fit_lasso_batch(X, y, lam, device="cpu")
        if not np.any(want):
            assert not np.any(got)
        else:
            _close(got, want)

    def test_zero_columns_and_fewer_sweeps(self, ref):
        rng = np.random.default_rng(3)
        X = rng.normal(size=(2, 40, 4))
        X[:, :, 2] = 0.0  # col_sq floored at 1e-12: its weight stays 0
        y = X[..., 0] * 2 - X[..., 3]
        for it in (1, 7):
            _close(fit_lasso_batch(X, y, 0.0, max_iter=it, device="cpu"),
                   ref["lime"].fit_lasso_batch(X, y, 0.0, max_iter=it))
        assert np.all(fit_lasso_batch(X, y, 0.0, device="cpu")[:, 2] == 0.0)

    def test_batch_members_are_independent(self):
        rng = np.random.default_rng(4)
        X = rng.normal(size=(5, 120, 7)).astype(np.float32)
        y = rng.normal(size=(5, 120)).astype(np.float32)
        whole = fit_lasso_batch(X, y, 0.05, device="cpu")
        one = fit_lasso_batch(X[2:3], y[2:3], 0.05, device="cpu")
        _close(one[0], whole[2])


class TestTabularLIME:
    def test_recovers_linear_model(self, ref):
        rng = np.random.default_rng(42)
        w_true = np.array([1.5, -2.0, 0.0, 3.0])
        X = rng.normal(size=(6, 4))
        kw = dict(inputCol="features", outputCol="weights", nSamples=400, seed=1)
        out = TabularLIME(model=_linear_model(Transformer)(w_true), device="cpu", **kw) \
            .fit(Table({"features": X})).transform(Table({"features": X}))
        want = ref["lime"].TabularLIME(model=_linear_model(ref["Transformer"])(w_true), **kw) \
            .fit(ref["Table"]({"features": X})).transform(ref["Table"]({"features": X}))
        W = _weights(out["weights"])
        _close(W, _weights(want["weights"]))
        np.testing.assert_allclose(W, np.tile(w_true, (6, 1)), atol=0.05)

    def test_perturbations_are_the_references(self, ref):
        """The inner model sees the reference's perturbed rows bit for bit."""
        seen = {}

        def recorder(base, key):
            class _Rec(base):
                def transform(self, table):
                    seen[key] = np.asarray(table.column("features"))
                    return table.with_column("prediction", seen[key].sum(axis=1))
            return _Rec()

        X = np.random.default_rng(7).normal(size=(3, 5))
        kw = dict(inputCol="features", outputCol="w", nSamples=30, seed=9)
        TabularLIME(model=recorder(Transformer, "port"), device="cpu", **kw).fit(
            Table({"features": X})).transform(Table({"features": X}))
        ref["lime"].TabularLIME(model=recorder(ref["Transformer"], "ref"), **kw).fit(
            ref["Table"]({"features": X})).transform(ref["Table"]({"features": X}))
        assert seen["port"].tobytes() == seen["ref"].tobytes()

    def test_over_a_carried_lightgbm_regressor(self, ref):
        """The slice end to end: the reference's LightGBMRegressor, carried
        to the port, explained by both packages' TabularLIME."""
        rng = np.random.default_rng(34)
        X = rng.normal(size=(2000, 6))
        y = X[:, 0] * 2 - X[:, 1] + np.sin(X[:, 2]) + 0.1 * rng.normal(size=2000)
        jreg = ref["Regressor"](parallelism="serial", numIterations=10, numLeaves=7,
                                minGainToSplit=1e-3).fit(ref["Table"]({"features": X,
                                                                        "label": y}))
        treg = LightGBMRegressionModel(boosterData=booster_from_jax(jreg.booster.to_dict())
                                       .to_dict(), device="cpu")
        rows = X[:20]
        kw = dict(inputCol="features", outputCol="w", nSamples=300, seed=3,
                  regularization=0.001)
        want = ref["lime"].TabularLIME(model=jreg, **kw).fit(ref["Table"]({"features": X})) \
            .transform(ref["Table"]({"features": rows}))
        lime = TabularLIME(model=treg, device="cpu", **kw).fit(Table({"features": X}))
        got = lime.transform(Table({"features": rows}))
        _close(_weights(got["w"]), _weights(want["w"]))
        assert np.abs(_weights(got["w"])[:, 0]).mean() > 1.0

    def test_save_load(self, tmp_path):
        X = np.random.default_rng(42).normal(size=(3, 2))
        model = TabularLIME(model=_linear_model(Transformer)(np.ones(2)), inputCol="features",
                            outputCol="w", nSamples=50, device="cpu").fit(Table({"features": X}))
        model.save(str(tmp_path / "lime"))
        loaded = TabularLIMEModel.load(str(tmp_path / "lime"))
        np.testing.assert_allclose(loaded.getColumnMeans(), model.getColumnMeans())
        assert loaded.getDevice() == "cuda"

    def test_saved_models_load_both_ways(self, ref, tmp_path):
        rng = np.random.default_rng(12)
        X = rng.normal(size=(400, 4))
        y = X[:, 0] - 2 * X[:, 3] + 0.1 * rng.normal(size=400)
        jreg = ref["Regressor"](parallelism="serial", numIterations=5, numLeaves=5,
                                minGainToSplit=1e-3).fit(ref["Table"]({"features": X,
                                                                        "label": y}))
        kw = dict(inputCol="features", outputCol="w", nSamples=120, seed=5)
        jm = ref["lime"].TabularLIME(model=jreg, **kw).fit(ref["Table"]({"features": X}))
        jm.save(str(tmp_path / "from_jax"))
        back = PipelineStage.load(str(tmp_path / "from_jax"))
        assert type(back) is TabularLIMEModel
        back.setDevice("cpu")
        back.getModel().setDevice("cpu")
        rows = X[:5]
        want = jm.transform(ref["Table"]({"features": rows}))["w"]
        _close(_weights(back.transform(Table({"features": rows}))["w"]), _weights(want))
        back.save(str(tmp_path / "from_port"))
        jback = ref["Stage"].load(str(tmp_path / "from_port"))
        assert type(jback).__name__ == "TabularLIMEModel"
        _close(_weights(jback.transform(ref["Table"]({"features": rows}))["w"]), _weights(want))

    def test_carried_from_jax(self, ref):
        rng = np.random.default_rng(13)
        X = rng.normal(size=(50, 3))
        w = np.array([0.5, -1.0, 2.0])
        kw = dict(inputCol="features", outputCol="w", nSamples=80, seed=2)
        jm = ref["lime"].TabularLIME(model=_linear_model(ref["Transformer"])(w), **kw).fit(
            ref["Table"]({"features": X}))
        carried = tabular_lime_model_from_jax(jm.getColumnMeans(), jm.getColumnSTDs(),
                                              _linear_model(Transformer)(w), device="cpu", **kw)
        _close(_weights(carried.transform(Table({"features": X[:4]}))["w"]),
               _weights(jm.transform(ref["Table"]({"features": X[:4]}))["w"]))

    def test_entry_points_default_to_the_card(self):
        if torch.cuda.is_available():
            pytest.skip("a card is present")
        X = np.random.default_rng(0).normal(size=(3, 2))
        lime = TabularLIME(model=_linear_model(Transformer)(np.ones(2)), inputCol="features",
                           outputCol="w", nSamples=10)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            lime.fit(Table({"features": X}))
        with pytest.raises(RuntimeError, match="device='cpu'"):
            fit_lasso_batch(np.zeros((1, 3, 2)), np.zeros((1, 3)), 0.0)
        model = lime.setDevice("cpu").fit(Table({"features": X}))
        with pytest.raises(RuntimeError, match="device='cpu'"):
            model.setDevice("cuda").transform(Table({"features": X}))


class TestSuperpixel:
    def test_slic_covers_image(self, ref):
        img = np.zeros((32, 32, 3))
        img[:, 16:] = 1.0
        sp = slic(img, cell_size=8)
        want = ref["lime"].slic(img, cell_size=8)
        assert sp.labels.tobytes() == want.labels.tobytes()
        assert sp.labels.shape == (32, 32)
        assert sp.num_clusters >= 2
        assert sum(len(c) for c in sp.clusters) == 32 * 32

    @pytest.mark.parametrize("shape,cell,modifier", [((24, 20, 3), 6, 130.0),
                                                     ((17, 23), 5, 40.0),
                                                     ((40, 40, 3), 16, 300.0)])
    def test_slic_labels_and_masks_are_the_references(self, ref, shape, cell, modifier):
        rng = np.random.default_rng(cell)
        img = rng.random(shape)
        sp = slic(img, cell_size=cell, modifier=modifier)
        want = ref["lime"].slic(img, cell_size=cell, modifier=modifier)
        assert sp.labels.tobytes() == want.labels.tobytes()
        assert len(sp.clusters) == len(want.clusters)
        assert all(a.tobytes() == b.tobytes() for a, b in zip(sp.clusters, want.clusters))
        states = rng.random(sp.num_clusters) > 0.5
        assert mask_image(img, sp, states).tobytes() == \
            ref["lime"].mask_image(img, want, states).tobytes()

    def test_mask_image(self):
        img = np.ones((16, 16, 3))
        sp = slic(img, cell_size=8)
        assert mask_image(img, sp, np.zeros(sp.num_clusters, dtype=bool)).sum() == 0
        np.testing.assert_array_equal(mask_image(img, sp, np.ones(sp.num_clusters, dtype=bool)),
                                      img)

    def test_transformer(self, ref):
        imgs = np.stack([np.random.default_rng(0).random((16, 16, 3))] * 2)
        out = SuperpixelTransformer(inputCol="image", cellSize=8).transform(Table({"image": imgs}))
        want = ref["lime"].SuperpixelTransformer(inputCol="image", cellSize=8).transform(
            ref["Table"]({"image": imgs}))
        assert out["superpixels"][0].num_clusters > 0
        for a, b in zip(out["superpixels"], want["superpixels"]):
            assert a.labels.tobytes() == b.labels.tobytes()


class TestImageLIME:
    def test_finds_informative_region(self, ref):
        img = np.random.default_rng(42).random((16, 16, 3))
        kw = dict(inputCol="image", outputCol="weights", predictionCol="prediction",
                  cellSize=8, nSamples=200, seed=2)
        out = ImageLIME(model=_region_model(Transformer)(), device="cpu", **kw).transform(
            Table({"image": img[None]}))
        want = ref["lime"].ImageLIME(model=_region_model(ref["Transformer"])(), **kw).transform(
            ref["Table"]({"image": img[None]}))
        sp = out["superpixels"][0]
        w = out["weights"][0]
        _close(w, want["weights"][0])
        assert len(w) == sp.num_clusters
        centers = np.array([c.mean(axis=0) for c in sp.clusters])
        informative = (centers[:, 0] < 8) & (centers[:, 1] < 8)
        assert w[informative].sum() > w[~informative].sum()

    def test_images_of_different_cluster_counts(self, ref):
        rng = np.random.default_rng(6)
        a = rng.random((16, 16, 3))
        b = np.zeros((16, 16, 3))
        b[:, 8:] = 1.0
        imgs = np.empty(2, dtype=object)
        imgs[0], imgs[1] = a, b
        kw = dict(inputCol="image", outputCol="weights", predictionCol="prediction",
                  cellSize=8, nSamples=60, seed=4)
        out = ImageLIME(model=_region_model(Transformer)(), device="cpu", **kw).transform(
            Table({"image": np.stack([a, b])}))
        want = ref["lime"].ImageLIME(model=_region_model(ref["Transformer"])(), **kw).transform(
            ref["Table"]({"image": np.stack([a, b])}))
        for g, w in zip(out["weights"], want["weights"]):
            _close(g, w)


@pytest.mark.cuda
def test_card_lasso_agrees_with_the_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rng = np.random.default_rng(1)
    X = rng.normal(size=(40, 1000, 28))
    y = X @ rng.normal(size=28) + 0.1 * rng.normal(size=(40, 1000))
    _close(fit_lasso_batch(X, y, 0.001, device="cuda"),
           fit_lasso_batch(X, y, 0.001, device="cpu"))
    assert tlasso.MAX_ITER == 100


class _CudaStub:
    """``torch.cuda`` for a CPU dry run: syncs and memory calls do nothing,
    events read the host clock."""

    class Event:
        def __init__(self, enable_timing=False):
            self.t = 0.0

        def record(self):
            import time

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


def test_chip_smoke_other_learners_phase_runs_on_the_cpu(monkeypatch):
    """A dry run of ``chip_smoke.phase_other_learners`` at cut sizes through
    a torch proxy, the entry points' device patched to the CPU and the
    kernel entries counting their plain calls as launches: catches name
    errors and broken checks before a chip call."""
    import chip_smoke
    from mmlspark_tpu_torch.isolationforest import forest as tforest
    from mmlspark_tpu_torch.lightgbm import LightGBMRegressor
    from mmlspark_tpu_torch.lightgbm import base as tbase
    from mmlspark_tpu_torch.lightgbm import booster as tbooster
    from mmlspark_tpu_torch.lightgbm import objectives as tobjectives
    from mmlspark_tpu_torch.lightgbm import train as ttrain
    from mmlspark_tpu_torch.lime import lime as tlime
    from mmlspark_tpu_torch.nn import knn as tknn
    from mmlspark_tpu_torch.observability import profiler as tprofiler
    from mmlspark_tpu_torch.ops import histogram as thistogram
    from mmlspark_tpu_torch.ops import hopper_histogram as hh
    from mmlspark_tpu_torch.ops import u_histogram as uh
    from mmlspark_tpu_torch.recommendation import sar as tsar

    cpu = lambda device=None: torch.device("cpu")  # noqa: E731
    for module in (ttrain, tbase, tbooster, tforest, tknn, tsar, tlasso, tlime):
        monkeypatch.setattr(module, "resolve_device", cpu)
    for name in ("build_histograms_cuda", "build_histograms_combined_cuda"):
        fn = getattr(thistogram, name)

        def counted(*a, _fn=fn, _entry=getattr(hh, name)):
            out = _fn(*a)
            hh.count_launch(_entry)
            return out

        monkeypatch.setattr(thistogram, name, counted)
    for name, value in (("SAR_USERS", 300), ("SAR_ITEMS", 200), ("SAR_EVENTS", 20_000),
                        ("N_SAR_CPU", 50), ("N_IF", 20_000), ("IF_TREES", 30),
                        ("N_IF_CPU", 5_000), ("N_KNN_INDEX", 3_000), ("KNN_DIM", 32),
                        ("N_KNN_QUERIES", 600), ("N_KNN_CPU", 100), ("N_LIME_FIT", 4_000),
                        ("LIME_TREES", 5), ("N_LIME_ROWS", 30), ("LIME_SAMPLES", 200),
                        ("N_LIME_CPU", 5)):
        monkeypatch.setattr(chip_smoke, name, value)
    rec = chip_smoke.phase_other_learners(
        _TorchProxy(), uh, hh, tprofiler.device_peaks("NVIDIA H100 80GB HBM3"), tobjectives,
        ttrain, tbase, Table, LightGBMRegressor, "NVIDIA H100 80GB HBM3, 700.00 W")
    assert rec["sar"]["card_cpu"]["ok"] and rec["sar"]["cooccurrence_equal"]
    assert rec["iforest"]["trees_equal"] and rec["iforest"]["bit_equal"]
    assert rec["knn"]["conditional"]["card_cpu"]["ok"]
    assert rec["lime"]["max_rel_err"] <= chip_smoke.LIME_TOL
    assert set(rec["kernels"]) == {1, 8} and rec["launches"]["hist_panel"] > 0
    assert all(r["max_abs_err"] == 0.0 for r in rec["kernels"].values())
    assert set(rec["parts_s"]) == {"a", "b", "c", "d"}
