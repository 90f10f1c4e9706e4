"""The port's partitioned, durable and batch-chained fits, and the scheduler
path of ShardedDataset, against its inline paths and the JAX package.

Inputs come from numpy seeds (HIGGS-like rows with label noise and row
weights) and go through both packages on the CPU. Faults are injected from
seeded FaultPlans, ambient or through a policy:

- ``numExecutors`` (or an ambient ``runtime.policy``) bins on the
  scheduler, and under every fault the model text is the inline fit's byte
  for byte; on the quantized path it is also the reference's partitioned
  text;
- durable binning under ``MMLSPARK_TPU_CHECKPOINT_DIR``: a rerun, by
  either package, re-executes no partition, and the ModelStore holds the
  model string;
- ``numBatches``: the quantized text is the reference's; the default
  path's margins are within 1e-5 of it;
- the scheduled sharded ingest writes the sequential pass's bytes, with
  the task count doubled and quadrupled under memory pressure.
"""

import os

import numpy as np
import pytest
import torch

from mmlspark_tpu_torch import runtime as trt
from mmlspark_tpu_torch.data.sharded import ShardedDataset
from mmlspark_tpu_torch.data.table import Table
from mmlspark_tpu_torch.lightgbm import LightGBMClassifier, LightGBMRanker
from mmlspark_tpu_torch.lightgbm import base as tbase
from mmlspark_tpu_torch.lightgbm import binning as tbinning
from mmlspark_tpu_torch.lightgbm.convert import booster_from_jax


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


try:
    _import_reference()
except ModuleNotFoundError as err:
    if err.name != "jax":
        raise

FAST = dict(backoff_base=0.01, heartbeat_interval=0.02)
PARAMS = dict(numIterations=4, numLeaves=15, maxBin=63, weightCol="weight")
QUANT = {"histogram_method": "u", "use_quantized_grad": True}
N, F = 2400, 6
MODEL_NAME = "lightgbmclassificationmodel"


class QuantizedClassifier(LightGBMClassifier):
    """The classifier on the quantized U path (not an estimator param)."""

    def _extra_train_options(self):
        return dict(QUANT)


@pytest.fixture(scope="module")
def ref():
    from mmlspark_tpu import runtime as jrt
    from mmlspark_tpu.data import Table as JTable
    from mmlspark_tpu.data import sharded as jsharded
    from mmlspark_tpu.lightgbm import LightGBMClassifier as JClassifier
    from mmlspark_tpu.lightgbm import base as jbase
    from mmlspark_tpu.lightgbm import binning as jbinning

    class JQuantized(JClassifier):
        def _extra_train_options(self):
            return dict(QUANT)

    return dict(runtime=jrt, Table=JTable, sharded=jsharded, Classifier=JClassifier,
                Quantized=JQuantized, base=jbase, binning=jbinning)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    X = rng.normal(size=(N, F))
    y = (X[:, 0] + X[:, 1] * X[:, 2] + 0.5 * rng.normal(size=N) > 0).astype(np.float64)
    w = rng.uniform(0.5, 2.0, N)
    return X, y, w


def _cols(data):
    X, y, w = data
    return {"features": X, "label": y, "weight": w}


@pytest.fixture(scope="module")
def inline_text(data):
    return LightGBMClassifier(device="cpu", **PARAMS).fit(Table(_cols(data))).get_model_string()


def _plan(rt, fault):
    plan = rt.FaultPlan(seed=11)
    if fault == "kill_random_task":
        return plan.kill_random_task(3)
    if fault == "corrupt_result":
        return plan.corrupt_result(1)
    if fault == "drop_heartbeat":
        return plan.drop_heartbeat(2)
    return plan.oom_task(0, kind="host")


FAULTS = ["kill_random_task", "corrupt_result", "drop_heartbeat", "oom_host"]
FIRED = {"kill_random_task": "kill", "corrupt_result": "corrupt_result",
         "drop_heartbeat": "drop_heartbeat", "oom_host": "oom_host"}


def _faulted_fit(rt, est, table, fault):
    """Fit ``est`` with ``fault`` injected into its binning: through an
    ambient policy for a heartbeat loss (its timeout cut), through
    ``numExecutors`` otherwise. Returns the fit model and the plan."""
    plan = _plan(rt, fault)
    with rt.inject_faults(plan):
        if fault == "drop_heartbeat":
            with rt.policy(max_workers=3, heartbeat_timeout=0.3, **FAST):
                model = est.fit(table)
        else:
            model = est.setNumExecutors(3).fit(table)
    return model, plan


@pytest.mark.parametrize("fault", FAULTS)
def test_partitioned_fit_writes_the_inline_text_under_faults(data, inline_text, fault):
    est = LightGBMClassifier(device="cpu", **PARAMS)
    model, plan = _faulted_fit(trt, est, Table(_cols(data)), fault)
    assert [k for k, _, _ in plan.fired] == [FIRED[fault]]
    assert model.get_model_string() == inline_text
    s = est._runtime_metrics.summary()
    assert s["tasks_done"] == 3 and s["retries_total"] == 1


@pytest.mark.parametrize("fault", ["kill_random_task", "corrupt_result", "oom_host"])
def test_quantized_partitioned_fit_writes_the_reference_text(ref, data, fault):
    est = QuantizedClassifier(device="cpu", **PARAMS)
    port, tplan = _faulted_fit(trt, est, Table(_cols(data)), fault)
    jest = ref["Quantized"](parallelism="serial", **PARAMS)
    want, jplan = _faulted_fit(ref["runtime"], jest, ref["Table"](_cols(data)), fault)
    assert tplan.fired == jplan.fired
    assert port.get_model_string() == want.get_model_string()
    assert port.get_model_string() == QuantizedClassifier(device="cpu", **PARAMS).fit(
        Table(_cols(data))).get_model_string()


def test_bundle_plan_above_sample_cnt_is_the_reference_partitioned_plan(ref):
    rng = np.random.default_rng(3)
    hot = rng.integers(0, 6, N)
    X = np.hstack([rng.normal(size=(N, 3)), np.eye(6)[hot], (rng.random((N, 2)) < 0.05)])
    kw = dict(max_bin=31, sample_cnt=700, feature_bundling=True)
    bt, mt = tbinning.bin_dataset_partitioned(X, policy=trt.SchedulerPolicy(max_workers=3,
                                                                            **FAST), **kw)
    bj, mj = ref["binning"].bin_dataset_partitioned(
        X, policy=ref["runtime"].SchedulerPolicy(max_workers=3, **FAST), **kw)
    assert mt.bundles is not None and mt.bundles.num_columns < X.shape[1]
    assert mt.bundles.members == tuple(tuple(m) for m in mj.bundles.members)
    assert bt.dtype == bj.dtype and bt.tobytes() == bj.tobytes()
    # the estimator takes the same plan; CSR input takes the inline path
    est = LightGBMClassifier(device="cpu", numExecutors=3, featureBundling=True,
                             binSampleCount=700, maxBin=31)
    bins, mapper = est._bin_dataset(X, est._make_options(), set())
    assert bins.tobytes() == bt.tobytes() and mapper.bundles == mt.bundles
    from mmlspark_tpu_torch.data.sparse import CSRMatrix

    rows, cols = np.nonzero(X)
    csr = CSRMatrix(X[rows, cols], cols.astype(np.int32),
                    np.searchsorted(rows, np.arange(N + 1)).astype(np.int64), X.shape)
    got, _ = tbinning.bin_dataset_partitioned(csr, max_bin=31, sample_cnt=700)
    assert got.tobytes() == tbinning.bin_dataset(X, max_bin=31, sample_cnt=700)[0].tobytes()


def test_csr_fit_after_a_partitioned_fit_keeps_no_stale_metrics(data, inline_text, tmp_path,
                                                                 monkeypatch):
    from mmlspark_tpu_torch.data.sparse import CSRMatrix, SparseRows

    X, y, w = data
    est = LightGBMClassifier(device="cpu", numExecutors=3, **PARAMS)
    assert est.fit(Table(_cols(data))).get_model_string() == inline_text
    assert est._runtime_metrics.summary()["tasks_done"] == 3
    # the CSR fit bins inline under the same numExecutors and a checkpoint
    # root: fresh metrics with no task, and no binning journal
    monkeypatch.setenv(trt.CHECKPOINT_DIR_ENV, str(tmp_path))
    c = CSRMatrix.from_dense(X)
    col = SparseRows(c.indices, c.data, c.indptr, F)
    sparse_text = est.fit(Table({"features": col, "label": y, "weight": w})).get_model_string()
    assert est._runtime_metrics.summary()["tasks_done"] == 0
    assert not (tmp_path / "binning").exists()
    dense32 = CSRMatrix(col.values, col.indices, col.indptr, c.shape).to_dense()
    assert sparse_text == LightGBMClassifier(device="cpu", **PARAMS).fit(
        Table({"features": dense32, "label": y, "weight": w})).get_model_string()


def _journal_lines(root):
    out = []
    for d in sorted(os.listdir(root)):
        with open(os.path.join(root, d, "journal.jsonl")) as fh:
            out += fh.read().splitlines()
    return out


def test_durable_binning_reruns_nothing_in_either_package(ref, data, inline_text, tmp_path,
                                                          monkeypatch):
    monkeypatch.setenv(trt.CHECKPOINT_DIR_ENV, str(tmp_path))
    est = LightGBMClassifier(device="cpu", numExecutors=3, **PARAMS)
    first = est.fit(Table(_cols(data))).get_model_string()
    lines = _journal_lines(tmp_path / "binning")
    assert first == inline_text and len(lines) == 3
    store = trt.ModelStore(str(tmp_path / "models"))
    assert store.latest(MODEL_NAME) == (1, first)
    again = LightGBMClassifier(device="cpu", numExecutors=3, **PARAMS)
    assert again.fit(Table(_cols(data))).get_model_string() == first
    assert _journal_lines(tmp_path / "binning") == lines
    assert again._runtime_metrics.summary()["tasks_recovered"] == 3
    assert store.latest(MODEL_NAME) == (2, first)
    # the reference finds the port's journal under the same root and key
    jest = ref["Classifier"](numExecutors=3, parallelism="serial", **PARAMS)
    jest.fit(ref["Table"](_cols(data)))
    assert _journal_lines(tmp_path / "binning") == lines
    assert jest._runtime_metrics.summary()["tasks_recovered"] == 3
    assert ref["runtime"].ModelStore(str(tmp_path / "models")).latest(MODEL_NAME)[0] == 3


def test_numbatches_quantized_text_is_the_reference(ref, data):
    port = QuantizedClassifier(device="cpu", numBatches=3, **PARAMS).fit(Table(_cols(data)))
    want = ref["Quantized"](parallelism="serial", numBatches=3, **PARAMS).fit(
        ref["Table"](_cols(data)))
    assert port.booster.num_trees == 12 and port.fit_stats.trees == 12
    assert port.get_model_string() == want.get_model_string()


def test_numbatches_default_path_margins_match_the_reference(ref, data):
    X = data[0]
    port = LightGBMClassifier(device="cpu", numBatches=3, **PARAMS).fit(Table(_cols(data)))
    want = ref["Classifier"](parallelism="serial", numBatches=3, **PARAMS).fit(
        ref["Table"](_cols(data)))
    got = port.booster.raw_margin(X, device="cpu")
    np.testing.assert_allclose(got, np.asarray(want.booster.raw_margin(X)), rtol=0, atol=1e-5)


@pytest.mark.parametrize("bundled", [False, True])
def test_ensemble_margin_equals_the_reference(ref, data, bundled):
    """The chained margin, routed in bin space (EFB-packed bins included),
    is the reference's bit for bit; on a merged booster it is its raw
    margin."""
    X, y, w = data
    if bundled:
        X = np.hstack([X, np.eye(4)[np.random.default_rng(5).integers(0, 4, N)]])
    bj, mj = ref["binning"].bin_dataset(X, max_bin=63, feature_bundling=bundled)
    bt, mt = tbinning.bin_dataset(X, max_bin=63, feature_bundling=bundled)
    assert bt.tobytes() == bj.tobytes()
    from mmlspark_tpu.lightgbm import train as jtrain

    opts = jtrain.TrainOptions(objective="binary", num_iterations=3, num_leaves=15, max_bin=63)
    boosters = []
    for lo, hi in ((0, 800), (800, 1600)):  # chained on the shared mapper's bins
        im = ref["base"]._ensemble_margin(boosters, bj[lo:hi], mj) if boosters else None
        boosters.append(jtrain.train(bj[lo:hi], y[lo:hi], opts, w=w[lo:hi], init_margins=im,
                                     mapper=mj).booster)
    want = ref["base"]._ensemble_margin(boosters, bj, mj)
    ported = [booster_from_jax(b.to_dict()) for b in boosters]
    got = tbase._ensemble_margin(ported, bt, mt, "cpu")
    assert got.dtype == np.float32 and got.tobytes() == np.asarray(want).tobytes()
    merged = tbase._merge_boosters(ported)
    assert merged.num_trees == sum(b.num_trees for b in ported)
    np.testing.assert_allclose(tbase._ensemble_margin([merged], bt, mt, "cpu"),
                               merged.raw_margin(X, device="cpu"), rtol=0, atol=1e-5)


def test_numbatches_refusals(data):
    with pytest.raises(ValueError, match="exclusive"):
        LightGBMClassifier(device="cpu", numBatches=3, numProcesses=2).fit(Table(_cols(data)))
    X, y, _ = data
    groups = np.repeat(np.arange(N // 20), 20)
    with pytest.raises(ValueError, match="query groups"):
        LightGBMRanker(device="cpu", numBatches=2, groupCol="g", numIterations=2).fit(
            Table({"features": X, "label": np.floor(y * 3), "g": groups}))


# -- the scheduler path of ShardedDataset ----------------------------------------------


@pytest.fixture(scope="module")
def shards(tmp_path_factory):
    rng = np.random.default_rng(1)
    X = rng.normal(size=(2000, F)).astype(np.float32)
    y = (X[:, 0] > 0).astype(np.float64)
    w = rng.uniform(0.5, 2.0, 2000)
    ds = ShardedDataset.write_shards(str(tmp_path_factory.mktemp("shards")), X, y, w,
                                     rows_per_shard=500)
    mapper = ds.fit_mapper(max_bin=63, sample_per_shard=200)
    out = str(tmp_path_factory.mktemp("seq") / "seq.u8")
    bins, y_all, w_all = ShardedDataset(ds.paths).bin_to_memmap(mapper, out_path=out)
    return ds.paths, mapper, np.asarray(bins).tobytes(), y_all, w_all


@pytest.mark.parametrize("case,tasks", [("policy", 4), ("ambient", 4), ("rows_per_task", 12),
                                        ("warn", 8), ("critical", 16)])
def test_scheduled_ingest_writes_the_sequential_bytes(ref, shards, tmp_path, case, tasks):
    paths, mapper, want, y_want, w_want = shards
    jmapper = ref["binning"].BinMapper(edges=mapper.edges, num_bins=mapper.num_bins,
                                       max_bin=mapper.max_bin)
    level = {"warn": trt.PressureLevel.WARN, "critical": trt.PressureLevel.CRITICAL}.get(
        case, trt.PressureLevel.OK)
    rows = 200 if case == "rows_per_task" else None
    counts = []
    prev = trt.set_pressure_level("memory", level)
    jprev = ref["runtime"].set_pressure_level("memory", level)
    try:
        for rt, Sharded, m in ((trt, ShardedDataset, mapper),
                               (ref["runtime"], ref["sharded"].ShardedDataset, jmapper)):
            metrics = rt.RuntimeMetrics()
            pol = rt.SchedulerPolicy(max_workers=3, **FAST)
            out = str(tmp_path / f"{rt.__name__}.u8")
            if case == "ambient":
                with rt.policy(pol):
                    got = Sharded(paths).bin_to_memmap(m, out_path=out, metrics=metrics)
            else:
                got = Sharded(paths).bin_to_memmap(m, out_path=out, policy=pol, metrics=metrics,
                                                   rows_per_task=rows)
            bins, y_all, w_all = got
            assert np.asarray(bins).tobytes() == want
            assert y_all.tobytes() == y_want.tobytes() and w_all.tobytes() == w_want.tobytes()
            counts.append(metrics.summary()["tasks_done"])
    finally:
        trt.set_pressure_level("memory", prev)
        ref["runtime"].set_pressure_level("memory", jprev)
    assert counts == [tasks, tasks]


def test_scheduled_ingest_recovers_a_killed_task_and_a_torn_read(shards, tmp_path):
    paths, mapper, want, _, _ = shards
    plan = trt.FaultPlan(seed=2).kill_task(1).truncate_shard("shard_00002", count=1)
    metrics = trt.RuntimeMetrics()
    with trt.inject_faults(plan):
        bins, _, _ = ShardedDataset(paths).bin_to_memmap(
            mapper, out_path=str(tmp_path / "b.u8"), metrics=metrics,
            policy=trt.SchedulerPolicy(max_workers=2, **FAST))
    assert np.asarray(bins).tobytes() == want
    assert sorted(k for k, _, _ in plan.fired) == ["kill", "truncate_shard"]
    assert metrics.summary()["retries_total"] == 2


def test_truncate_shard_quarantines_under_permissive_and_raises_under_failfast(ref, shards,
                                                                               tmp_path):
    paths = shards[0]
    got = []
    for rt, Sharded in ((trt, ShardedDataset), (ref["runtime"], ref["sharded"].ShardedDataset)):
        plan = rt.FaultPlan().truncate_shard("shard_00001")
        with rt.inject_faults(plan):
            ds = Sharded(paths, mode="permissive")
            got.append((ds.num_rows, ds.paths, [r.to_record() for r in ds.quarantined]))
        assert plan.fired == [("truncate_shard", 0, 0)]
        plan = rt.FaultPlan().truncate_shard("shard_00003")
        with rt.inject_faults(plan), pytest.raises(RuntimeError) as ei:
            Sharded(paths).fit_mapper(max_bin=63, sample_per_shard=200)
        got.append((type(ei.value).__name__, str(ei.value)))
    port, want = got[:2], got[2:]
    assert port == want
    assert port[0][0] == 1500 and port[0][2][0]["reason"] == "CorruptShardError"
    assert port[1][0] == "CorruptShardError"


@pytest.mark.cuda
def test_partitioned_fit_on_the_card_writes_the_inline_card_text(data):
    """On the card, a fit that bins on the scheduler under a killed executor
    and a corrupted result writes the card's inline fit text."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    want = LightGBMClassifier(device="cuda", **PARAMS).fit(Table(_cols(data)))
    plan = trt.FaultPlan(seed=11).kill_random_task(3).corrupt_result(1)
    with trt.inject_faults(plan), trt.policy(max_workers=3, result_integrity=True, **FAST):
        est = LightGBMClassifier(device="cuda", **PARAMS)
        got = est.fit(Table(_cols(data)))
    assert len(plan.fired) == 2 and est._runtime_metrics.summary()["retries_total"] == 2
    assert got.get_model_string() == want.get_model_string()
