"""The port's leafwise GBDT (mmlspark_tpu_torch.lightgbm) against the JAX package.

Inputs come from numpy seeds and go through both packages on the CPU: the
port with ``device='cpu'`` (its histogram's plain version), the JAX package
as its own CPU tests run it. Binning must be byte-identical and tree
structure identical; float results agree within the tolerances below
(float32 sums taken in another order).
"""

import dataclasses
import os
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from mmlspark_tpu_torch.data.table import Table
from mmlspark_tpu_torch.lightgbm import LightGBMClassifier
from mmlspark_tpu_torch.lightgbm import binning as tbinning
from mmlspark_tpu_torch.lightgbm import objectives as tobj
from mmlspark_tpu_torch.lightgbm import train as ttrain
from mmlspark_tpu_torch.lightgbm.convert import bin_mapper_from_jax, booster_from_jax

REPO = pathlib.Path(__file__).resolve().parents[1]
PORT_DIR = REPO / "mmlspark_tpu_torch"


def _import_reference():
    """Import the JAX package's fit path through a shim: on jax 0.9
    ``mmlspark_tpu/ops/u_histogram.py`` fails at import (it tests membership
    in ``batching.primitive_batchers``, which jax 0.9 no longer makes
    iterable), and every JAX fit imports it. While the module imports, a
    plain dict that already holds the barrier rule stands in; then the
    original table is restored. The JAX package itself is not changed."""
    from jax._src.lax import lax as lax_internal
    from jax.interpreters import batching

    saved = batching.primitive_batchers
    batching.primitive_batchers = {lax_internal.optimization_barrier_p: None}
    try:
        import mmlspark_tpu.ops.u_histogram  # noqa: F401
    finally:
        batching.primitive_batchers = saved


# At import, so that every pytest worker has the module before it collects
# the JAX package's own test files. A machine without jax (the card's) runs
# only the `cuda` tests, which need none of it.
try:
    _import_reference()
except ModuleNotFoundError as err:
    if err.name != "jax":
        raise


@pytest.fixture(scope="module")
def ref():
    import mmlspark_tpu.lightgbm.binning as jbinning
    import mmlspark_tpu.lightgbm.objectives as jobj
    import mmlspark_tpu.lightgbm.train as jtrain
    from mmlspark_tpu.lightgbm.procfit import model_texts_close

    return dict(binning=jbinning, obj=jobj, train=jtrain, texts_close=model_texts_close)


def _higgs_like(n, f, seed=0):
    """``bench.py``'s generator: Gaussian features, a nonlinear logit."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, f))
    logit = X[:, 0] * 1.5 + X[:, 1] * X[:, 2] + 0.8 * np.sin(X[:, 3]) + 0.5 * rng.normal(size=n)
    return X, logit


# -- binning ------------------------------------------------------------------


@pytest.mark.parametrize("n,max_bin", [(2000, 63), (210_000, 255)])
def test_binning_is_byte_identical(ref, n, max_bin):
    rng = np.random.default_rng(n)
    X = rng.normal(size=(n, 3))
    X[:, 1] = np.round(X[:, 1] * 3)  # few distinct values: one bin per value
    X[rng.uniform(size=n) < 0.01, 2] = np.nan
    bj, mj = ref["binning"].bin_dataset(X, max_bin=max_bin)
    bt, mt = tbinning.bin_dataset(X, max_bin=max_bin)
    assert bt.dtype == np.uint8 and bt.tobytes() == np.asarray(bj).tobytes()
    np.testing.assert_array_equal(mt.edges, mj.edges)
    np.testing.assert_array_equal(mt.num_bins, mj.num_bins)


# -- objectives ---------------------------------------------------------------


@pytest.mark.parametrize("name", ["binary", "regression"])
def test_objective_matches_jax(ref, name):
    rng = np.random.default_rng(1)
    n = 1000
    margins = rng.normal(size=(n, 1)).astype(np.float32) * 3
    y = ((rng.uniform(size=n) > 0.4) if name == "binary" else rng.normal(size=n)).astype(np.float32)
    w = rng.uniform(0.5, 2.0, size=n).astype(np.float32)
    jo, to = ref["obj"].get_objective(name), tobj.get_objective(name)
    jg, jh = jo.grad_hess(margins, y, w)
    tg, th = to.grad_hess(torch.from_numpy(margins), torch.from_numpy(y), torch.from_numpy(w))
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(to.init_score(y, 1, w), jo.init_score(y, 1, w), atol=1e-6)


def _binary_case(kind, n=2_000_000):
    """Float32 margins (N(0, 1), or U(-120, 120) where exp and the sigmoid
    reach their clamps and subnormals), Bernoulli(0.5) labels and U(0.5, 2)
    weights from ``default_rng(1)``."""
    rng = np.random.default_rng(1)
    if kind == "normal":
        m = rng.standard_normal(n).astype(np.float32)
    else:
        m = rng.uniform(-120, 120, n).astype(np.float32)
    y = (rng.random(n) < 0.5).astype(np.float32)
    w = rng.uniform(0.5, 2.0, n).astype(np.float32)
    return m[:, None], y, w


@pytest.mark.parametrize("kind", ["normal", "wide"])
def test_binary_gradients_are_the_compiled_references_bits(ref, kind):
    """The reference's sigmoid compiles to 1 / (1 + exp(-x)) with XLA's CPU
    exp and flush-to-zero; g and h feed the quantized stats, so they must
    be its bits."""
    import jax

    m, y, w = _binary_case(kind)
    jg, jh = jax.jit(ref["obj"]._binary_grad_hess)(m, y, w)
    tg, th = tobj._binary_grad_hess(torch.from_numpy(m), torch.from_numpy(y), torch.from_numpy(w))
    assert tg.numpy().tobytes() == np.asarray(jg).tobytes()
    assert th.numpy().tobytes() == np.asarray(jh).tobytes()


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["normal", "wide"])
def test_binary_gradients_on_the_card_are_the_cpus_bits(kind):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    m, y, w = (torch.from_numpy(a) for a in _binary_case(kind))
    cpu = tobj._binary_grad_hess(m, y, w)
    card = tobj._binary_grad_hess(m.cuda(), y.cuda(), w.cuda())
    for a, b in zip(card, cpu):
        assert torch.equal(a.cpu(), b)


def _higgs_weighted(n=50_000, f=28):
    """The HIGGS-shaped case of the card-against-CPU text check: chip_smoke's
    generator with U(0.5, 2) row weights, ``default_rng(0)``."""
    rng = np.random.default_rng(0)
    X = rng.normal(size=(n, f))
    logit = X[:, 0] * 1.5 + X[:, 1] * X[:, 2] + 0.8 * np.sin(X[:, 3]) + 0.5 * rng.normal(size=n)
    return X, (logit > 0).astype(np.float64), rng.uniform(0.5, 2.0, n)


@pytest.mark.cuda
def test_default_path_text_on_the_card_is_the_cpus():
    """The default path's float32 reductions over the bins are one chain in
    bin order on both devices, so a weighted HIGGS-shaped fit writes the
    same model text on the card as on the CPU."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    X, y, w = _higgs_weighted()
    bins, mapper = tbinning.bin_dataset(X, max_bin=255)
    opts = ttrain.TrainOptions(objective="binary", num_iterations=5, num_leaves=31, max_bin=255)
    texts = [ttrain.train(bins, y, opts, w=w, mapper=mapper, device=d).booster.model_to_string()
             for d in ("cuda", "cpu")]
    assert texts[0] == texts[1]


@pytest.mark.parametrize("shape,dim", [((3, 5, 64, 3), 2), ((4, 63, 3), 1), ((2, 7, 256, 3), 2)])
def test_bin_reductions_are_one_float32_chain(shape, dim):
    """The default path's prefix and totals over the bins: numpy's float32
    chain in bin order on the CPU (torch.cumsum would accumulate in
    float64), exact sums on integer (quantized) histograms."""
    rng = np.random.default_rng(sum(shape))
    h = (rng.normal(size=shape) * 10.0 ** rng.integers(-3, 4, size=shape)).astype(np.float32)
    chain = np.cumsum(h, axis=dim, dtype=np.float32)
    assert ttrain._chain_prefix(torch.from_numpy(h), dim).numpy().tobytes() == chain.tobytes()
    total = np.take(chain, -1, axis=dim)
    assert ttrain._bin_sum(torch.from_numpy(h), dim).numpy().tobytes() == total.tobytes()
    if dim == 2:
        assert ttrain._bin_prefix(torch.from_numpy(h), False).numpy().tobytes() == chain.tobytes()
    ints = torch.from_numpy(rng.integers(-500, 500, size=shape))
    assert torch.equal(ttrain._bin_sum(ints, dim), ints.sum(dim=dim))


def test_metrics_match_jax(ref):
    rng = np.random.default_rng(2)
    y = (rng.uniform(size=5000) > 0.5).astype(np.float64)
    score = np.round(rng.normal(size=5000) + y, 1)  # ties
    w = rng.uniform(0.5, 2, size=5000)
    assert tobj.auc(y, score, w) == pytest.approx(ref["obj"].auc(y, score, w), rel=1e-12)
    assert tobj.binary_logloss(y, score, w) == pytest.approx(
        ref["obj"].binary_logloss(y, score, w), rel=1e-12)


# -- split search -------------------------------------------------------------


@pytest.mark.parametrize("seed", range(4))
def test_split_search_matches_jax(ref, seed):
    rng = np.random.default_rng(seed)
    n, k, f, b = 3000, 6, 5, 64
    node = rng.integers(0, k, size=n)
    bins = rng.integers(0, b - 1, size=(n, f))
    stats = np.stack([rng.normal(size=n), rng.uniform(0.1, 0.3, size=n), np.ones(n)], 1)
    hist = np.zeros((k, f, b, 3), np.float32)
    for j in range(f):
        np.add.at(hist[:, j], (node, bins[:, j]), stats.astype(np.float32))
    totals = hist[:, 0].sum(axis=1)
    edges = np.sort(rng.normal(size=(f, b - 2)), axis=1).astype(np.float32)
    opts = dict(lambda_l2=0.5, min_data_in_leaf=5)
    js = ref["train"]._split_search(hist, totals, edges, np.ones(f, np.float32),
                                    ref["train"].TrainOptions(**opts))
    ts = ttrain._split_search(torch.from_numpy(hist), torch.from_numpy(totals),
                              torch.from_numpy(edges), torch.ones(f),
                              ttrain.TrainOptions(**opts))
    np.testing.assert_array_equal(ts.feat.numpy(), np.asarray(js.feat))
    np.testing.assert_array_equal(ts.bin.numpy(), np.asarray(js.bin))
    np.testing.assert_allclose(ts.gain.numpy(), np.asarray(js.gain), rtol=1e-5)
    for field in ("thr", "value", "lval", "rval", "lcov", "rcov"):
        np.testing.assert_allclose(getattr(ts, field).numpy(), np.asarray(getattr(js, field)),
                                   rtol=1e-5, atol=1e-6, err_msg=field)


# -- the slice as a whole -----------------------------------------------------

STRUCTURE = ("split_feature", "split_bin", "left_child", "right_child", "is_leaf")


def _fit_both(ref, objective, leaf_batch):
    X, logit = _higgs_like(2000, 6)
    y = (logit > 0).astype(np.float64) if objective == "binary" else logit
    kw = dict(objective=objective, num_iterations=5, num_leaves=15, max_bin=63,
              leaf_batch=leaf_batch, histogram_subtraction=True)
    bj, mj = ref["binning"].bin_dataset(X, max_bin=63)
    bt, mt = tbinning.bin_dataset(X, max_bin=63)
    rj = ref["train"].train(bj, y, ref["train"].TrainOptions(**kw), mapper=mj)
    rt = ttrain.train(bt, y, ttrain.TrainOptions(**kw), mapper=mt, device="cpu")
    return X, rj.booster, rt


@pytest.mark.parametrize("objective", ["binary", "regression"])
@pytest.mark.parametrize("leaf_batch", [1, 8])
def test_fit_matches_jax(ref, objective, leaf_batch):
    X, jb, rt = _fit_both(ref, objective, leaf_batch)
    tb = rt.booster
    for field in STRUCTURE:
        same = np.array_equal(getattr(tb, field), getattr(jb, field))
        if not same:  # show the competing gains of a flipped near-tie
            print(field, "port gains", tb.split_gain, "jax gains", jb.split_gain)
        assert same, field
    np.testing.assert_allclose(tb.leaf_values, jb.leaf_values, atol=1e-5)
    np.testing.assert_allclose(tb.raw_margin(X, device="cpu"), jb.raw_margin(X), atol=1e-5)
    assert ref["texts_close"](tb.model_to_string(), jb.model_to_string())
    assert rt.stats.trees == 5
    assert rt.stats.passes >= 5 * (1 + -(-14 // leaf_batch))


def test_estimator_matches_jax(ref):
    from mmlspark_tpu.data.table import Table as JTable
    from mmlspark_tpu.lightgbm import LightGBMClassifier as JClassifier

    X, logit = _higgs_like(1500, 5, seed=3)
    y = (logit > 0).astype(np.float64)
    params = dict(numIterations=4, numLeaves=7, maxBin=31, leafBatch=4)
    jout = JClassifier(**params).fit(JTable({"features": X, "label": y})).transform(
        JTable({"features": X, "label": y}))
    model = LightGBMClassifier(device="cpu", **params).fit(Table({"features": X, "label": y}))
    tout = model.transform(Table({"features": X, "label": y}))
    for col in ("rawPrediction", "probability", "prediction"):
        np.testing.assert_allclose(tout[col], jout[col], atol=1e-5, err_msg=col)


def test_carried_booster_predicts_as_jax(ref):
    X, jb, _ = _fit_both(ref, "binary", 8)
    tb = booster_from_jax(jb.to_dict())
    np.testing.assert_allclose(tb.raw_margin(X, device="cpu"), jb.raw_margin(X), atol=1e-6)
    assert tb.model_to_string() == jb.model_to_string()


def test_carried_bin_mapper_bins_as_jax(ref):
    X, _ = _higgs_like(3000, 4, seed=5)
    bj, mj = ref["binning"].bin_dataset(X, max_bin=31)
    mapper = bin_mapper_from_jax(mj.edges, mj.num_bins, mj.max_bin, cat_values=mj.cat_values,
                                 bundles=mj.bundles)
    assert tbinning.apply_bins(X, mapper).tobytes() == np.asarray(bj).tobytes()


def test_model_text_round_trips():
    X, logit = _higgs_like(800, 4, seed=7)
    bt, mt = tbinning.bin_dataset(X, max_bin=31)
    booster = ttrain.train(bt, logit, ttrain.TrainOptions(objective="regression",
                           num_iterations=3, num_leaves=5, max_bin=31),
                           mapper=mt, device="cpu").booster
    back = type(booster).from_string(booster.model_to_string())
    np.testing.assert_allclose(back.raw_margin(X, device="cpu"),
                               booster.raw_margin(X, device="cpu"), atol=1e-5)


# -- isolation and device policy ---------------------------------------------


def test_import_loads_neither_jax_nor_the_jax_package():
    code = (
        "import sys, mmlspark_tpu_torch, mmlspark_tpu_torch.lightgbm, "
        "mmlspark_tpu_torch.lightgbm.convert, mmlspark_tpu_torch.lightgbm.bundling, "
        "mmlspark_tpu_torch.lightgbm.train, mmlspark_tpu_torch.ops.histogram, "
        "mmlspark_tpu_torch.ops.hopper_histogram, mmlspark_tpu_torch.ops.u_histogram, "
        "mmlspark_tpu_torch.kernels.build, mmlspark_tpu_torch.core.serialize, "
        "mmlspark_tpu_torch.core.pipeline, mmlspark_tpu_torch.core.profiling, "
        "mmlspark_tpu_torch.core.utils, mmlspark_tpu_torch.dataguard.guards, "
        "mmlspark_tpu_torch.observability.events, mmlspark_tpu_torch.observability.tracing, "
        "mmlspark_tpu_torch.observability.registry, mmlspark_tpu_torch.train.statistics, "
        "mmlspark_tpu_torch.automl, mmlspark_tpu_torch.automl.tune, mmlspark_tpu_torch.sweep, "
        "mmlspark_tpu_torch.sweep.batched, mmlspark_tpu_torch.sweep.bucketing, "
        "mmlspark_tpu_torch.sweep.estimator, mmlspark_tpu_torch.sweep.distributed\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'mmlspark_tpu.'))"
        " or m == 'mmlspark_tpu']\n"
        "assert not bad, bad\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    subprocess.run([sys.executable, "-c", code], check=True, env=env, cwd=str(REPO),
                   timeout=120)


def test_no_source_imports_jax_or_the_jax_package():
    pattern = re.compile(r"^\s*(import|from)\s+(jax|mmlspark_tpu)(\s|\.|$)", re.M)
    scanned = list(PORT_DIR.rglob("*.py"))
    offenders = [str(p) for p in scanned if pattern.search(p.read_text())]
    assert not offenders, offenders
    # the many-models plane is among the scanned sources
    names = {str(p.relative_to(PORT_DIR)) for p in scanned}
    assert {"train/statistics.py", "automl/tune.py", "automl/hyperparam.py",
            "sweep/batched.py", "sweep/bucketing.py", "sweep/estimator.py",
            "sweep/distributed.py"} <= names


def test_entry_points_refuse_the_cpu_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("the default device exists here")
    X, logit = _higgs_like(300, 4)
    bt, mt = tbinning.bin_dataset(X, max_bin=15)
    opts = ttrain.TrainOptions(num_iterations=1, num_leaves=3, max_bin=15)
    y = (logit > 0).astype(float)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ttrain.train(bt, y, opts, mapper=mt)
    booster = ttrain.train(bt, y, opts, mapper=mt, device="cpu").booster
    with pytest.raises(RuntimeError, match="device='cpu'"):
        booster.raw_margin(X)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        LightGBMClassifier(numIterations=1).fit(Table({"features": X, "label": y}))
    assert booster.raw_margin(X, device="cpu").shape == (300, 1)


@pytest.mark.parametrize(
    "option", [dict(objective="lambdarank"), dict(tree_learner="voting_parallel"),
               dict(objective="cross_entropy"), dict(tree_learner="feature_parallel")],
)
def test_unported_options_raise(option):
    """Objectives outside the registry still raise. Every tree learner is
    ported: unsharded, voting is the full reduction without sibling
    subtraction (so a default fit's text with subtraction off), and any
    other value is the data-parallel path (the default fit's text)."""
    opts = ttrain.TrainOptions(**option)
    if "objective" in option:
        with pytest.raises((NotImplementedError, ValueError)):
            ttrain.check_supported(opts)
        return
    ttrain.check_supported(opts)
    X, logit = _higgs_like(600, 4, seed=3)
    bins, mapper = tbinning.bin_dataset(X, max_bin=15)
    y = (logit > 0).astype(float)
    kw = dict(num_iterations=2, num_leaves=5, max_bin=15)
    got = ttrain.train(bins, y, dataclasses.replace(opts, **kw), mapper=mapper, device="cpu")
    if option["tree_learner"] == "voting_parallel":
        kw["histogram_subtraction"] = False
    want = ttrain.train(bins, y, ttrain.TrainOptions(**kw), mapper=mapper, device="cpu")
    assert got.booster.model_to_string() == want.booster.model_to_string()


def test_unported_estimator_params_raise():
    """numProcesses is ported; what the reference refuses a process fit
    (bagging, voting) raises its ValueError before a worker starts."""
    X, logit = _higgs_like(100, 4)
    t = Table({"features": X, "label": (logit > 0).astype(float)})
    with pytest.raises(ValueError, match="bagging"):
        LightGBMClassifier(device="cpu", numProcesses=2, baggingFraction=0.8,
                           baggingFreq=1).fit(t)
    with pytest.raises(ValueError, match="voting_parallel"):
        LightGBMClassifier(device="cpu", numProcesses=2, parallelism="voting_parallel").fit(t)


def test_bin_dataset_to_device_is_the_uploaded_bins(ref):
    """``binning.bin_dataset_to_device``: the reference's host bins and
    mapper, as the (C, N) tensor ``train.upload_bins`` makes."""
    X, _ = _higgs_like(3000, 6, seed=21)
    X[::7, 2] = np.nan
    got, mapper = tbinning.bin_dataset_to_device(X, max_bin=63, device="cpu")
    want, jmapper = ref["binning"].bin_dataset_to_device(X, max_bin=63)
    assert got.dtype == torch.uint8 and got.device.type == "cpu"
    assert np.array_equal(got.numpy().T, np.asarray(want))
    assert np.array_equal(mapper.edges, np.asarray(jmapper.edges))
    bins, _ = tbinning.bin_dataset(X, max_bin=63, mapper=mapper)
    assert torch.equal(got, ttrain.upload_bins(bins, torch.device("cpu")))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tbinning.bin_dataset_to_device(X)


def test_clear_compiled_caches_empties_the_bounded_caches():
    """Every bounded ``lru_cache`` of the port's loaded modules is emptied;
    the kernel library's unbounded cache is left alone."""
    import functools
    import sys

    import mmlspark_tpu_torch
    from mmlspark_tpu_torch.kernels import build

    ttrain._cat_static_maps((0, 2), (2,), 3, torch.device("cpu"))
    assert ttrain._cat_static_maps.cache_info().currsize >= 1
    mmlspark_tpu_torch.clear_compiled_caches()
    bounded = [v for name, m in list(sys.modules.items())
               if name.startswith("mmlspark_tpu_torch.") and m is not None
               for v in vars(m).values()
               if isinstance(v, functools._lru_cache_wrapper) and v.cache_info().maxsize]
    assert ttrain._cat_static_maps in bounded and len(bounded) >= 7
    assert all(c.cache_info().currsize == 0 for c in bounded)
    assert build.histogram_extension.cache_info().maxsize is None
