"""The port's VW learners (``mmlspark_tpu_torch.vw``) against the JAX
package's, on the CPU.

Seeded numpy inputs go through both packages: ``train_linear`` (adagrad
and FTRL; logistic, squared, hinge and quantile losses; l1, l2, ``powerT``
0 and 0.5, ``--noconstant``, warm start), ``train_linear_many``, the
estimators with their pass-through args, the 8-slot mesh fit against the
reference's fit on conftest's 8 virtual devices, and saved models both
ways.

Tolerance: weights and margins within ``TOL`` = 1e-5 of the largest
magnitude. The reference's compiled loop contracts some products into fused
multiply-adds that the port does not, so SGD's trajectories part in the
last bits; they are not compared bit for bit. The card's scatter form (each
run of equal indices summed in position order, then added once) runs here
too, and holds ``CARD_TOL`` = 1e-4 against the flat form (the CPU's and
the reference's): adding a run's updates to a weight one by one drops each
update below half an ulp of the weight, most of all at the constant
feature's B adds a step, while a run's sum keeps them (on an NVIDIA H100,
phase 33's 20,000 documents part by 6.8e-5 after 3 passes;
``tools/torch_vw_ab.py`` holds both forms against a float64 fit). On the
card, the weights and margins hold ``TOL`` against the CPU running the
card's own scatter form, so the form accounts for the gap. The reference's
unmeshed fits pin ``_select_mesh`` to None, as ``tests/test_sweep.py``
does. Tests marked ``cuda`` need the card.
"""

import logging
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
from mmlspark_tpu_torch.data import sparse as tsparse
from mmlspark_tpu_torch.data.table import Table
from mmlspark_tpu_torch.lightgbm.convert import vw_model_from_jax
from mmlspark_tpu_torch.observability import profiler as tprofiler
from mmlspark_tpu_torch.parallel import mesh as tmesh
from mmlspark_tpu_torch.vw import (
    VowpalWabbitClassificationModel,
    VowpalWabbitClassifier,
    VowpalWabbitFeaturizer,
    VowpalWabbitRegressor,
)
from mmlspark_tpu_torch.vw import base as tbase

REPO = Path(__file__).resolve().parents[1]
TOL = 1e-5  # of the largest magnitude, weights and margins
CARD_TOL = 1e-4  # the card's scatter form against the flat form
# cases whose float32 trajectory moves by more than TOL under any change of
# rounding (see test_the_card_equals_the_cpu_running_its_scatter_form)
FLOAT32_NOISY = {"ftrl_warm_start"}


@pytest.fixture(scope="module")
def ref():
    import mmlspark_tpu.vw as jvw
    import mmlspark_tpu.vw.base as jbase
    from mmlspark_tpu.core.pipeline import PipelineStage as JStage
    from mmlspark_tpu.data import sparse as jsparse
    from mmlspark_tpu.data.table import Table as JTable

    return dict(vw=jvw, base=jbase, sparse=jsparse, Table=JTable, Stage=JStage)


@pytest.fixture
def unmeshed_ref(ref, monkeypatch):
    monkeypatch.setattr(ref["base"].VowpalWabbitBase, "_select_mesh", lambda self: None)
    return ref


def _close(got, want, tol=TOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = max(np.abs(want).max(), 1e-30)
    err = np.abs(got - want).max() / scale
    assert err <= tol, f"max error {err:.3g} of the largest magnitude (tolerance {tol})"


def _rows(n=640, k=6, dim=512, seed=0, loss="logistic"):
    """Zipf-skewed indices (duplicates within a minibatch), 20% zero
    values, row weights; labels from a noisy linear model."""
    rng = np.random.default_rng(seed)
    idx = (rng.zipf(1.3, size=(n, k)) % dim).astype(np.int32)
    val = rng.normal(size=(n, k)).astype(np.float32)
    val[rng.random((n, k)) < 0.2] = 0
    m = (rng.normal(size=dim)[idx] * val).sum(1) + rng.normal(size=n)
    y = (np.where(m > 0, 1.0, -1.0) if loss in ("logistic", "hinge") else m).astype(np.float32)
    sw = rng.uniform(0.5, 2.0, size=n).astype(np.float32)
    return idx, val, y, sw, dim


def _margins(idx, val, w, const):
    m = (w[idx] * val).sum(1)
    return m if const < 0 else m + w[const]


CASES = {
    "logistic": dict(loss="logistic", learning_rate=0.5, power_t=0.5, l1=0.0, l2=0.0),
    "logistic_pt0_l1_l2": dict(loss="logistic", learning_rate=0.5, power_t=0.0, l1=1e-4,
                               l2=1e-3),
    "squared_l2": dict(loss="squared", learning_rate=0.3, power_t=0.5, l1=0.0, l2=1e-3),
    "hinge": dict(loss="hinge", learning_rate=0.3, power_t=0.5, l1=0.0, l2=0.0),
    "quantile": dict(loss="quantile", learning_rate=0.3, power_t=0.5, l1=0.0, l2=0.0,
                     quantile_tau=0.3),
    "noconstant": dict(loss="squared", learning_rate=0.2, power_t=0.5, l1=0.0, l2=0.0,
                       constant_index=-1),
    "warm_start": dict(loss="logistic", learning_rate=0.5, power_t=0.5, l1=0.0, l2=0.0,
                       warm=True),
    "ftrl_squared_l1_l2": dict(loss="squared", learning_rate=0.5, power_t=0.5, l1=1e-3,
                               l2=1e-3, optimizer="ftrl"),
    "ftrl_logistic": dict(loss="logistic", learning_rate=0.5, power_t=0.5, l1=0.0, l2=0.0,
                          optimizer="ftrl"),
    "ftrl_warm_start": dict(loss="logistic", learning_rate=0.5, power_t=0.0, l1=0.0, l2=1e-3,
                            optimizer="ftrl", warm=True),
}


def _case_kwargs(case, dim):
    kw = dict(CASES[case])
    kw.setdefault("constant_index", 7)
    warm = kw.pop("warm", False)
    if warm:
        kw["initial_weights"] = np.random.default_rng(5).normal(size=dim).astype(np.float32) * 0.1
    return dict(num_passes=3, batch_size=16, **kw)


@pytest.mark.parametrize("case", sorted(CASES))
def test_train_linear_matches_the_reference(ref, case):
    idx, val, y, sw, dim = _rows(loss=CASES[case]["loss"])
    kw = _case_kwargs(case, dim)
    want = ref["base"].train_linear(ref["sparse"].SparseBatch(idx, val, dim), y, sw, mesh=None,
                                    **kw)
    got = tbase.train_linear(tsparse.SparseBatch(idx, val, dim), y, sw, device="cpu", **kw)
    _close(got.weights, want.weights)
    const = kw["constant_index"]
    _close(_margins(idx, val, got.weights, const), _margins(idx, val, want.weights, const))
    assert got.stats["steps"] == 3 * 40 and got.stats["shards"] == 1


def _lanes(idx, val, y, sw, dim, kw, device, sorted_scatter):
    """``train_linear``'s unmeshed fit as a ``_Lanes``, with the scatter
    form chosen (``train_linear`` takes the platform's: sorted run sums on
    the card, flat order on the CPU)."""
    b = kw["batch_size"]
    hp = tbase._Hyper(loss=kw["loss"], optimizer=kw.get("optimizer", "adagrad"),
                      quantile_tau=kw.get("quantile_tau", 0.5), ftrl_alpha=0.005,
                      ftrl_beta=0.1, l1=kw["l1"], l2=kw["l2"], many=False)
    ri, rv, ry, rw, k, nb = tbase._prep_rows(tsparse.SparseBatch(idx, val, dim), y, sw,
                                             kw["constant_index"], b, 1)
    steps = tbase._step_sizes([kw["learning_rate"]], [kw["power_t"]], kw["num_passes"] * nb)
    w0 = kw.get("initial_weights")
    w0 = np.zeros(dim, np.float32) if w0 is None else np.array(w0, np.float32)
    return tbase._Lanes(ri.reshape(nb, 1, b, k), rv.reshape(nb, 1, b, k), ry.reshape(nb, 1, b),
                        rw.reshape(nb, 1, b), 1, dim, torch.device(device), hp, sorted_scatter,
                        w0, steps)


def _lanes_fit(idx, val, y, sw, dim, kw, device, sorted_scatter):
    lanes = _lanes(idx, val, y, sw, dim, kw, device, sorted_scatter)
    return tbase._run_lanes([lanes], kw["num_passes"], average=False)[0].cpu().numpy()


@pytest.mark.parametrize("case", ["logistic", "squared_l2", "ftrl_squared_l1_l2"])
def test_the_card_scatter_form_on_the_cpu(case):
    """The card's sorted run sums, run here: two fits bit-identical, and
    within ``CARD_TOL`` of the flat (position-order) form."""
    idx, val, y, sw, dim = _rows(loss=CASES[case]["loss"], seed=1)
    kw = _case_kwargs(case, dim)
    flat = tbase.train_linear(tsparse.SparseBatch(idx, val, dim), y, sw, device="cpu",
                              **kw).weights
    assert flat.tobytes() == _lanes_fit(idx, val, y, sw, dim, kw, "cpu", False).tobytes()
    runs = [_lanes_fit(idx, val, y, sw, dim, kw, "cpu", True) for _ in range(2)]
    assert runs[0].tobytes() == runs[1].tobytes()
    _close(runs[0], flat, CARD_TOL)


@pytest.mark.parametrize("optimizer", ["adagrad", "ftrl"])
def test_train_linear_many_matches_train_linear_and_the_reference(ref, optimizer):
    idx, val, y, sw, dim = _rows(n=400, seed=2)
    lanes = dict(learning_rates=[0.3, 0.6, 0.5], power_ts=[0.5, 0.0, 0.5],
                 l1s=[0.0, 1e-4, 0.0], l2s=[1e-3, 0.0, 0.0])
    kw = dict(loss="logistic", num_passes=2, batch_size=16, constant_index=3,
              optimizer=optimizer)
    many = tbase.train_linear_many(tsparse.SparseBatch(idx, val, dim), y, sw, device="cpu",
                                   **lanes, **kw)
    want = ref["base"].train_linear_many(ref["sparse"].SparseBatch(idx, val, dim), y, sw,
                                         **lanes, **kw)
    for j, (r, w) in enumerate(zip(many, want)):
        one = tbase.train_linear(tsparse.SparseBatch(idx, val, dim), y, sw, device="cpu",
                                 learning_rate=lanes["learning_rates"][j],
                                 power_t=lanes["power_ts"][j], l1=lanes["l1s"][j],
                                 l2=lanes["l2s"][j], **kw)
        _close(r.weights, one.weights)
        _close(r.weights, w.weights)
    with pytest.raises(ValueError, match="disagree on K"):
        tbase.train_linear_many(tsparse.SparseBatch(idx, val, dim), y, sw, device="cpu",
                                **dict(lanes, l2s=[0.0]), **kw)


def _text_table(n=400, seed=3):
    rng = np.random.default_rng(seed)
    words = np.array([f"w{i}" for i in range(200)])
    tilt = rng.normal(size=200)
    y = (rng.random(n) > 0.5).astype(np.float64)
    docs = np.empty(n, dtype=object)
    for i in range(n):
        p = np.exp(tilt * (1 if y[i] else -1)) / np.arange(1, 201)
        docs[i] = " ".join(words[rng.choice(200, size=rng.integers(3, 12), p=p / p.sum())])
    return docs, y


def _featurized(ref, docs, y, bits=12):
    kw = dict(inputCols=["text"], outputCol="features", stringSplit=True, numBits=bits)
    jt = ref["vw"].VowpalWabbitFeaturizer(**kw).transform(ref["Table"]({"text": docs, "label": y}))
    tt = VowpalWabbitFeaturizer(**kw).transform(Table({"text": docs, "label": y}))
    return jt, tt


@pytest.mark.parametrize("args", ["", "--ftrl --l1 1e-4 --passes 2", "--noconstant -l 0.3"])
def test_classifier_matches_the_reference(unmeshed_ref, args):
    ref = unmeshed_ref
    docs, y = _text_table()
    jt, tt = _featurized(ref, docs, y)
    jm = ref["vw"].VowpalWabbitClassifier(numPasses=3, passThroughArgs=args).fit(jt)
    tm = VowpalWabbitClassifier(numPasses=3, passThroughArgs=args, device="cpu").fit(tt)
    assert tm.getConstantIndex() == jm.getConstantIndex()
    assert tm.getSparseDim() == jm.getSparseDim() == 1 << 12
    _close(tm.getModelWeights(), jm.getModelWeights())
    got, want = tm.transform(tt), jm.transform(jt)
    _close(got["rawPrediction"], want["rawPrediction"])
    _close(got["probability"], want["probability"])
    assert (got["prediction"] == want["prediction"]).mean() > 0.99


def test_regressor_link_and_dense_features_match_the_reference(unmeshed_ref):
    ref = unmeshed_ref
    rng = np.random.default_rng(8)
    X = rng.normal(size=(300, 5))
    y = (X[:, 0] - X[:, 1] + 0.3 * rng.normal(size=300) > 0).astype(float)
    args = "--loss_function logistic --link logistic"
    jm = ref["vw"].VowpalWabbitRegressor(numPasses=3, passThroughArgs=args).fit(
        ref["Table"]({"features": X, "label": y}))
    tm = VowpalWabbitRegressor(numPasses=3, passThroughArgs=args, device="cpu").fit(
        Table({"features": X, "label": y}))
    assert tm.getLinkFunction() == "logistic" and tm.getConstantIndex() == 5
    _close(tm.getModelWeights(), jm.getModelWeights())
    _close(tm.transform(Table({"features": X}))["prediction"],
           jm.transform(ref["Table"]({"features": X}))["prediction"])


@pytest.mark.parametrize("args", ["", "--ftrl"])
def test_eight_slot_mesh_matches_the_references_eight_devices(ref, args):
    """conftest gives the reference 8 CPU devices, so its estimator fits 8
    shards with a per-pass mean; the port's 8 logical CPU slots do the same."""
    docs, y = _text_table(n=500, seed=4)
    jt, tt = _featurized(ref, docs, y)
    jm = ref["vw"].VowpalWabbitClassifier(numPasses=3, passThroughArgs=args).fit(jt)
    tmesh.force_platform("cpu", 8)
    try:
        tm = VowpalWabbitClassifier(numPasses=3, passThroughArgs=args, device="cpu").fit(tt)
    finally:
        tmesh.force_platform(None)
    assert tm.getTrainingStats()["shards"] == jm.getTrainingStats()["shards"] == 8
    _close(tm.getModelWeights(), jm.getModelWeights())
    _close(tm.transform(tt)["rawPrediction"], jm.transform(jt)["rawPrediction"])


def test_one_device_fits_without_a_mesh():
    assert VowpalWabbitClassifier(device="cpu")._select_mesh() is None
    tmesh.force_platform("cpu", 3)
    try:
        mesh = VowpalWabbitClassifier(device="cpu")._select_mesh()
    finally:
        tmesh.force_platform(None)
    assert mesh.shape["data"] == 3


def test_a_mesh_on_another_platform_raises():
    idx, val, y, sw, dim = _rows(n=64)
    mesh = tmesh.make_mesh(tmesh.MeshConfig(data=2), devices=["meta", "meta"])
    with pytest.raises(ValueError, match="not on the fit's device"):
        tbase.train_linear(tsparse.SparseBatch(idx, val, dim), y, sw, device="cpu", mesh=mesh,
                           **_case_kwargs("logistic", dim))


# -- the arg parser ---------------------------------------------------------------


@pytest.mark.parametrize("args", [
    "", "--passes=4 --learning_rate 0.4", "--ftrl --ftrl_alpha 0.1 --ftrl_beta 1",
    "-l 0.2 --l1 1e-4 --l2=1e-3 --power_t 0", "-b 14 --hash_seed 9 --noconstant",
    "--loss_function quantile --quantile_tau 0.9 --link identity",
    "--quiet --holdout_off --cache_file /tmp/x.cache --passes 4 -P 1000",
])
def test_parsed_args_equal_the_references(ref, args):
    got = VowpalWabbitClassifier(passThroughArgs=args)._parse_args()
    assert got == ref["vw"].VowpalWabbitClassifier(passThroughArgs=args)._parse_args()


@pytest.mark.parametrize("args,match", [
    ("--cubic abc", "unsupported VW flag '--cubic'"), ("-q ab", "unsupported VW flag '-q'"),
    ("--ftrl=1", "takes no value"), ("--passes", "expects a value"),
    ("--link glf1", "--link 'glf1' not supported"),
])
def test_arg_errors_equal_the_references(ref, args, match):
    with pytest.raises(ValueError, match=match) as got:
        VowpalWabbitClassifier(passThroughArgs=args)._parse_args()
    with pytest.raises(ValueError) as want:
        ref["vw"].VowpalWabbitClassifier(passThroughArgs=args)._parse_args()
    assert str(got.value) == str(want.value)


def test_noop_flags_warn_and_model_flags_apply(caplog):
    rng = np.random.default_rng(7)
    X = rng.normal(size=(100, 3))
    t = Table({"features": X, "label": (X[:, 0] > 0).astype(float)})
    with caplog.at_level(logging.WARNING, logger="mmlspark_tpu_torch.vw"):
        m = VowpalWabbitClassifier(
            numPasses=2, device="cpu",
            passThroughArgs="--quiet --holdout_off --cache_file /tmp/x.cache --passes 4 -P 1000",
        ).fit(t)
    skipped = [r.message for r in caplog.records if "ignoring diagnostic" in r.message]
    assert len(skipped) == 4
    assert m.getTrainingStats()["passes"] == 4
    stats = m.get_performance_statistics()
    assert stats["rows"][0] == 100 and stats["learn_time_s"][0] > 0


# -- persistence ----------------------------------------------------------------


def test_saved_models_load_both_ways(unmeshed_ref, tmp_path):
    ref = unmeshed_ref
    docs, y = _text_table(n=200, seed=6)
    jt, tt = _featurized(ref, docs, y)
    tm = VowpalWabbitClassifier(numPasses=2, device="cpu").fit(tt)
    tm.save(str(tmp_path / "port"))
    back_in_ref = ref["Stage"].load(str(tmp_path / "port"))
    assert type(back_in_ref).__module__ == "mmlspark_tpu.vw.classifier"
    want = tm.transform(tt)
    got = back_in_ref.transform(jt)
    for c in ("rawPrediction", "probability", "prediction"):
        assert np.asarray(got[c]).tobytes() == np.asarray(want[c]).tobytes(), c

    jm = ref["vw"].VowpalWabbitRegressor(numPasses=2).fit(jt)
    jm.save(str(tmp_path / "ref"))
    back_in_port = PipelineStage.load(str(tmp_path / "ref"))
    assert type(back_in_port).__name__ == "VowpalWabbitRegressionModel"
    assert back_in_port.getDevice() == "cuda"  # a loaded model predicts on the card by default
    back_in_port.setDevice("cpu")
    assert back_in_port.transform(tt)["prediction"].tobytes() == \
        jm.transform(jt)["prediction"].tobytes()
    assert back_in_port.getTrainingStats()["rows"] == 200

    carried = vw_model_from_jax({k: jm.getOrDefault(k) for k in (
        "modelWeights", "sparseDim", "constantIndex", "numBits", "linkFunction")},
        kind="regressor", device="cpu")
    assert carried.transform(tt)["prediction"].tobytes() == \
        jm.transform(jt)["prediction"].tobytes()
    with pytest.raises(ValueError, match="kind"):
        vw_model_from_jax({"modelWeights": [0.0]}, kind="ranker")


# -- devices, imports, the profiler -------------------------------------------------


def test_the_card_is_the_default_and_raises_without_one():
    if torch.cuda.is_available():
        pytest.skip("the default device exists here")
    rng = np.random.default_rng(0)
    X = rng.normal(size=(32, 2))
    t = Table({"features": X, "label": (X[:, 0] > 0).astype(float)})
    with pytest.raises(RuntimeError, match="device='cpu'"):
        VowpalWabbitClassifier().fit(t)
    m = VowpalWabbitClassifier(device="cpu").fit(t)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        VowpalWabbitClassificationModel(modelWeights=m.getModelWeights()).transform(t)


def test_importing_the_vw_port_loads_no_jax():
    code = ("import sys\nimport mmlspark_tpu_torch.vw, mmlspark_tpu_torch.vw.base\n"
            "import mmlspark_tpu_torch.data.sparse, mmlspark_tpu_torch.lightgbm.convert\n"
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', "
            "'mmlspark_tpu.')) or m == 'mmlspark_tpu']\nassert not bad, bad\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    subprocess.run([sys.executable, "-c", code], check=True, env=env, cwd=str(REPO),
                   timeout=120)


def test_profiler_books_fit_many_on_the_host_clock(monkeypatch):
    monkeypatch.delenv("MMLSPARK_TPU_PROFILE", raising=False)
    prof = tprofiler.get_profiler()
    prof.disable()
    prof.clear()
    idx, val, y, sw, dim = _rows(n=96, seed=9)
    try:
        prof.enable()
        for _ in range(2):
            tbase.train_linear_many(tsparse.SparseBatch(idx, val, dim), y, sw, device="cpu",
                                    loss="logistic", num_passes=1, learning_rates=[0.1, 0.2],
                                    power_ts=[0.5, 0.5], l1s=[0.0, 0.0], l2s=[0.0, 0.0],
                                    batch_size=16, constant_index=0)
        row = prof.snapshot()["functions"]["vw.fit_many"]
    finally:
        prof.disable()
        prof.clear()
    assert (row["compiles"], row["executions"], row["cache_hits"]) == (1, 2, 1)


# -- the card --------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["logistic_pt0_l1_l2", "hinge", "quantile", "noconstant",
                                  "ftrl_squared_l1_l2", "ftrl_warm_start"])
def test_card_fits_repeat_and_agree_with_the_cpu(case):
    """Two card fits give the same bits (sorted run sums, no float atomics);
    the card's weights and margins are within ``CARD_TOL`` of the CPU
    port's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    idx, val, y, sw, dim = _rows(n=4000, k=12, dim=4096, seed=11, loss=CASES[case]["loss"])
    kw = _case_kwargs(case, dim)
    batch = tsparse.SparseBatch(idx, val, dim)
    cards = [tbase.train_linear(batch, y, sw, device="cuda", **kw).weights for _ in range(2)]
    cpu = tbase.train_linear(batch, y, sw, device="cpu", **kw).weights
    assert cards[0].tobytes() == cards[1].tobytes()
    _close(cards[0], cpu, CARD_TOL)
    const = kw["constant_index"]
    _close(_margins(idx, val, cards[0], const), _margins(idx, val, cpu, const), CARD_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["logistic", "logistic_pt0_l1_l2", "hinge", "quantile",
                                  "noconstant", "ftrl_squared_l1_l2", "ftrl_warm_start"])
def test_the_card_equals_the_cpu_running_its_scatter_form(case):
    """Held against the CPU running the card's sorted run sums, the card's
    weights and margins are within ``TOL``: the whole of its ``CARD_TOL``
    gap to the CPU port lies in the scatter's form. FTRL from a warm start
    is the exception: on these rows its float32 trajectory moves by more
    than ``TOL`` under any change of rounding (the CPU's own two scatter
    forms part by 2.0e-5; on an NVIDIA H100 the card's other roundings,
    its ``torch.sigmoid`` and its FTRL denominator, part it from the
    sorted form by 6.9e-5). It is held at ``CARD_TOL``, and only while the
    CPU's two forms part by more than ``TOL``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    idx, val, y, sw, dim = _rows(n=4000, k=12, dim=4096, seed=11, loss=CASES[case]["loss"])
    kw = _case_kwargs(case, dim)
    card = tbase.train_linear(tsparse.SparseBatch(idx, val, dim), y, sw, device="cuda",
                              **kw).weights
    cpu_sorted = _lanes_fit(idx, val, y, sw, dim, kw, "cpu", True)
    tol = TOL
    if case in FLOAT32_NOISY:
        flat = _lanes_fit(idx, val, y, sw, dim, kw, "cpu", False)
        assert np.abs(flat - cpu_sorted).max() / np.abs(cpu_sorted).max() > TOL
        tol = CARD_TOL
    _close(card, cpu_sorted, tol)
    const = kw["constant_index"]
    _close(_margins(idx, val, card, const), _margins(idx, val, cpu_sorted, const), tol)


class _CudaStub:
    """``torch.cuda`` for a CPU dry run: syncs do nothing."""

    def synchronize(self, *a):
        pass


class _TorchProxy:
    """``torch`` with ``cuda`` a stub."""

    cuda = _CudaStub()

    def __getattr__(self, name):
        return getattr(torch, name)


def test_chip_smoke_vw_phase_runs_on_the_cpu(monkeypatch):
    """A dry run of ``chip_smoke.phase_vw`` at 2,000 documents through a
    torch proxy, the learners' device patched to the CPU and the card's
    mesh slots mapped to it: catches name errors and broken checks before a
    chip call."""
    import chip_smoke
    from mmlspark_tpu_torch import parallel, sweep
    from mmlspark_tpu_torch import vw as tvw
    from mmlspark_tpu_torch.ops import hopper_histogram as hh
    from mmlspark_tpu_torch.ops import u_histogram as uh

    monkeypatch.setattr(tbase, "resolve_device", lambda device=None: torch.device("cpu"))
    for name, value in (("N_VW", 2000), ("N_VW_TEST", 400), ("N_VW_CPU", 600),
                        ("N_VW_MANY", 800), ("N_VW_FTRL", 1200), ("VW_PROFILE_BATCHES", 3)):
        monkeypatch.setattr(chip_smoke, name, value)

    class _Parallel:
        MeshConfig = parallel.MeshConfig

        @staticmethod
        def make_mesh(config, devices):
            return parallel.make_mesh(config, devices=["cpu"] * len(devices))

    rec = chip_smoke.phase_vw(_TorchProxy(), uh, hh, Table, tvw, tbase, _Parallel, sweep,
                              "NVIDIA H100 80GB HBM3, 700.00 W")
    assert rec["fit"]["bit_identical"] and rec["fit"]["steps"] == 3 * 32
    assert rec["fit"]["launches_per_step"] is None  # no device events on the CPU
    assert rec["mesh"]["shards"] == 4 and rec["many"]["k"] == 4
    assert set(rec["parts_s"]) == set("abcdef")
    assert rec["fit_source_batch"]["bit_identical"] and rec["fit_source_batch"]["steps"] == 3 * 2
    assert rec["card_cpu"]["sorted_weights_err"] <= chip_smoke.VW_SORTED_TOL


@pytest.mark.parametrize("case", ["logistic_pt0_l1_l2", "ftrl_squared_l1_l2"])
@pytest.mark.parametrize("sorted_scatter", [False, True])
def test_the_counters_path_equals_the_indexed_path(case, sorted_scatter):
    """The card replays one captured step that reads its batch and step
    through device counters; that path, run here without a graph, gives the
    Python-indexed path's bits."""
    idx, val, y, sw, dim = _rows(n=200, loss=CASES[case]["loss"], seed=3)
    kw = dict(_case_kwargs(case, dim), num_passes=2)
    indexed = _lanes_fit(idx, val, y, sw, dim, kw, "cpu", sorted_scatter)
    lanes = _lanes(idx, val, y, sw, dim, kw, "cpu", sorted_scatter)
    for _ in range(kw["num_passes"]):  # the card's passes, each step on the counters
        lanes.cur.zero_()
        for _ in range(lanes.num_batches):
            lanes.run_step(None, None)
    assert indexed.tobytes() == lanes.fitted()[0].numpy().tobytes()
