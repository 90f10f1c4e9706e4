"""The port's isolation forest (``mmlspark_tpu_torch.isolationforest``)
against the JAX package's, on the CPU: every case of
``tests/test_isolationforest.py`` as a parity case, seeded numpy inputs
through both packages.

Bit for bit, with no tolerance: the packed trees (the host build draws
the reference's ``default_rng`` stream), the outlier scores and the
labels. The mean path length over the trees is a float32 sum; the port
adds it in the order of XLA's CPU reduction (``forest._xla_sum``: windows
of 32 trees, zero-padded half in front), on the card too. At 21-32 trees
the reference's compiled reduction sums in 8 vector lanes instead (its
gather is fused into the reduce), so there the scores hold ``LANES_TOL``
= 1e-6 of the largest (one float32 ulp of the mean path). Tests marked
``cuda`` need the card.
"""

import os
import subprocess
import sys
from pathlib import Path

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
from mmlspark_tpu_torch.isolationforest import IsolationForest, IsolationForestModel
from mmlspark_tpu_torch.isolationforest import forest as tforest
from mmlspark_tpu_torch.lightgbm.convert import isolation_forest_from_jax

REPO = Path(__file__).resolve().parents[1]
TREE_KEYS = ("feature", "threshold", "left", "right", "path_adjust")
LANES_TOL = 1e-6  # scores at 21-32 trees, of the largest


@pytest.fixture(scope="module")
def ref():
    from mmlspark_tpu.core.pipeline import PipelineStage as JStage
    from mmlspark_tpu.data.table import Table as JTable
    from mmlspark_tpu.isolationforest import IsolationForest as JForest
    from mmlspark_tpu.isolationforest import forest as jforest

    return dict(Forest=JForest, forest=jforest, Table=JTable, Stage=JStage)


def _anomaly(seed=42):
    """The reference tests' table: 300 inliers, 10 planted outliers."""
    rng = np.random.default_rng(seed)
    inliers = rng.normal(size=(300, 4))
    outliers = rng.normal(size=(10, 4)) * 0.5 + 8.0
    return np.vstack([inliers, outliers]), np.array([0] * 300 + [1] * 10)


def _bits(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert got.tobytes() == want.tobytes(), f"{np.sum(got != want)} values differ"


def _both(ref, X, **params):
    jm = ref["Forest"](**params).fit(ref["Table"]({"features": X}))
    tm = IsolationForest(device="cpu", **params).fit(Table({"features": X}))
    return jm, tm


def _same_trees(jm, tm):
    jt, tt = jm.getTrees(), tm.getTrees()
    for k in TREE_KEYS:
        a, b = np.asarray(jt[k]), tt[k]
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), k
    for p in ("numSamples", "maxDepth"):
        assert jm.getOrDefault(p) == tm.getOrDefault(p)


def test_c_factor_known_values(ref):
    for n in (0, 1, 2, 3, 7.5, 64, 256, 1e6):
        assert tforest.c_factor(n) == ref["forest"].c_factor(n)
    assert tforest.c_factor(1) == 0.0 and tforest.c_factor(2) == 1.0
    assert 10.0 < tforest.c_factor(256) < 10.5


@pytest.mark.parametrize("params", [
    dict(numEstimators=50, maxSamples=64.0),
    dict(numEstimators=60, maxFeatures=0.5),
    dict(numEstimators=10, randomSeed=3),
    dict(numEstimators=20, maxSamples=0.5, bootstrap=True),
    dict(numEstimators=12, maxSamples=1000.0, maxFeatures=3.0),
    dict(numEstimators=100),
    dict(numEstimators=1100, maxSamples=8.0),
], ids=["samples64", "features_half", "seed3", "bootstrap_fraction", "capped", "default",
        "two_window_levels"])
def test_trees_are_the_references_bits_and_scores_agree(ref, params):
    X, truth = _anomaly()
    jm, tm = _both(ref, X, **params)
    _same_trees(jm, tm)
    j = jm.transform(ref["Table"]({"features": X}))
    t = tm.transform(Table({"features": X}))
    _bits(t["outlierScore"], j["outlierScore"])
    _bits(t["predictedLabel"], j["predictedLabel"])
    scores = t["outlierScore"]
    assert scores.min() >= 0.0 and scores.max() <= 1.0
    assert scores[truth == 1].mean() > scores[truth == 0].mean()


def test_outliers_score_higher(ref):
    X, truth = _anomaly()
    _, tm = _both(ref, X, numEstimators=50, maxSamples=64.0)
    scores = tm.transform(Table({"features": X}))["outlierScore"]
    assert scores[truth == 1].mean() > scores[truth == 0].mean() + 0.1


def test_contamination_threshold(ref):
    X, truth = _anomaly()
    jm, tm = _both(ref, X, numEstimators=50, maxSamples=64.0, contamination=10 / 310)
    assert tm.getOutlierScoreThreshold() == jm.getOutlierScoreThreshold()
    flagged = tm.transform(Table({"features": X}))["predictedLabel"].astype(bool)
    want = np.asarray(jm.transform(ref["Table"]({"features": X}))["predictedLabel"], bool)
    assert np.array_equal(flagged, want)
    assert flagged.sum() >= 5
    assert truth[flagged].mean() > 0.6


def test_deterministic_given_seed():
    X, _ = _anomaly()
    a = IsolationForest(numEstimators=10, randomSeed=3, device="cpu").fit(Table({"features": X}))
    b = IsolationForest(numEstimators=10, randomSeed=3, device="cpu").fit(Table({"features": X}))
    sa = a.transform(Table({"features": X}))["outlierScore"]
    sb = b.transform(Table({"features": X}))["outlierScore"]
    assert sa.tobytes() == sb.tobytes()


def test_row_blocks_give_one_blocks_bits(monkeypatch):
    """Descending in row blocks (the bound on the (trees, rows) tensor)
    changes no bit: each row's sum over trees is its own."""
    X, _ = _anomaly()
    m = IsolationForest(numEstimators=30, device="cpu").fit(Table({"features": X}))
    whole = m._scores(X)
    monkeypatch.setattr(tforest, "BLOCK_NODES", 30 * 7)
    assert m._scores(X).tobytes() == whole.tobytes()


@pytest.mark.parametrize("trees", [20, 25, 33])
def test_duplicate_rows_and_a_constant_feature(ref, trees):
    rng = np.random.default_rng(5)
    X = np.repeat(rng.normal(size=(20, 3)), 8, axis=0)
    X[:, 1] = 2.5
    jm, tm = _both(ref, X, numEstimators=trees, maxSamples=32.0)
    _same_trees(jm, tm)
    got = tm.transform(Table({"features": X}))["outlierScore"]
    want = jm.transform(ref["Table"]({"features": X}))["outlierScore"]
    if 21 <= trees <= 32:
        err = np.abs(got - want).max() / np.abs(want).max()
        assert err <= LANES_TOL, f"max error {err:.3g} of the largest"
    else:
        _bits(got, want)


def test_save_load(tmp_path):
    X, _ = _anomaly()
    model = IsolationForest(numEstimators=10, device="cpu").fit(Table({"features": X}))
    model.save(str(tmp_path / "iforest"))
    loaded = IsolationForestModel.load(str(tmp_path / "iforest")).setDevice("cpu")
    a = model.transform(Table({"features": X}))["outlierScore"]
    assert loaded.transform(Table({"features": X}))["outlierScore"].tobytes() == a.tobytes()


def test_saved_models_load_both_ways(ref, tmp_path):
    X, _ = _anomaly()
    jm, tm = _both(ref, X, numEstimators=15, maxSamples=64.0, contamination=0.05)
    jm.save(str(tmp_path / "from_jax"))
    back = PipelineStage.load(str(tmp_path / "from_jax"))
    assert type(back) is IsolationForestModel and back.getDevice() == "cuda"
    back.setDevice("cpu")
    _same_trees(jm, back)
    assert back.getOutlierScoreThreshold() == jm.getOutlierScoreThreshold()
    want = tm.transform(Table({"features": X}))["outlierScore"]
    assert back.transform(Table({"features": X}))["outlierScore"].tobytes() == want.tobytes()

    tm.save(str(tmp_path / "from_port"))
    jback = ref["Stage"].load(str(tmp_path / "from_port"))
    assert type(jback).__name__ == "IsolationForestModel"
    _same_trees(jback, tm)
    _bits(want, jback.transform(ref["Table"]({"features": X}))["outlierScore"])


def test_carried_from_jax(ref):
    X, _ = _anomaly()
    jm, tm = _both(ref, X, numEstimators=15)
    carried = isolation_forest_from_jax(
        {k: np.asarray(v) for k, v in jm.getTrees().items()}, jm.getNumSamples(),
        jm.getMaxDepth(), jm.getOutlierScoreThreshold(), device="cpu")
    _same_trees(jm, carried)
    got = carried.transform(Table({"features": X}))["outlierScore"]
    assert got.tobytes() == tm.transform(Table({"features": X}))["outlierScore"].tobytes()
    with pytest.raises(ValueError, match="path_adjust"):
        isolation_forest_from_jax({k: jm.getTrees()[k] for k in TREE_KEYS[:4]}, 8, 3, 0.5)


def test_entry_points_default_to_the_card():
    X, _ = _anomaly()
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        IsolationForest(numEstimators=2).fit(Table({"features": X}))
    m = IsolationForest(numEstimators=2, device="cpu").fit(Table({"features": X}))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        m.setDevice("cuda").transform(Table({"features": X}))


def test_importing_the_new_packages_loads_no_jax():
    code = ("import sys\nimport mmlspark_tpu_torch.isolationforest, mmlspark_tpu_torch.nn\n"
            "import mmlspark_tpu_torch.recommendation, mmlspark_tpu_torch.lime\n"
            "import mmlspark_tpu_torch.plot, mmlspark_tpu_torch.lightgbm.convert\n"
            "import mmlspark_tpu_torch.serving.fleet, mmlspark_tpu_torch.ops.topk\n"
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', "
            "'mmlspark_tpu.')) or m == 'mmlspark_tpu']\nassert not bad, bad\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    subprocess.run([sys.executable, "-c", code], check=True, env=env, cwd=str(REPO),
                   timeout=120)


@pytest.mark.cuda
def test_card_scores_are_the_cpus_bits():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rng = np.random.default_rng(7)
    X = np.vstack([rng.normal(size=(20000, 6)), rng.normal(size=(200, 6)) + 6])
    m = IsolationForest(numEstimators=40, device="cpu").fit(Table({"features": X}))
    cpu = m._scores(X)
    card = m.setDevice("cuda")._scores(X)
    _bits(card, cpu)
