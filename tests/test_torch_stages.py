"""The port's pipeline stages (mmlspark_tpu_torch.stages) against the JAX
package's: every class of ``stages/basic.py`` and ``stages/batching.py`` and
the two column helpers, on the same seeded tables (object columns holding
None, NaN and numpy scalars among them). Output columns, partition bounds,
``transform_schema`` and the ``BatchFormed`` events the batchers publish
equal the reference's with no tolerance (host numpy on both sides).
"""

import logging
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

from mmlspark_tpu_torch import stages as ts
from mmlspark_tpu_torch.core.pipeline import Estimator, PipelineStage
from mmlspark_tpu_torch.core.schema import schema_of_table
from mmlspark_tpu_torch.data.table import Table
from mmlspark_tpu_torch.observability import events as tevents


@pytest.fixture(scope="module")
def ref():
    import mmlspark_tpu.core.pipeline as jpipeline
    import mmlspark_tpu.observability.events as jevents
    import mmlspark_tpu.stages as js
    from mmlspark_tpu.core.schema import schema_of_table as jschema
    from mmlspark_tpu.data.table import Table as JTable

    return types.SimpleNamespace(stages=js, Table=JTable, schema=jschema, pipeline=jpipeline,
                                 events=jevents)


def _cols(n=48, seed=0):
    rng = np.random.default_rng(seed)
    words = np.empty(n, dtype=object)
    pool = ["guitars", "drums", "bass", None, float("nan"), np.int64(4), "Ça va", "ﬁne", "İx"]
    words[:] = [pool[i] for i in rng.integers(0, len(pool), n)]
    lists = np.empty(n, dtype=object)
    lists[:] = [list(rng.integers(0, 9, rng.integers(0, 4))) for _ in range(n)]
    vecs = np.empty(n, dtype=object)
    vecs[:] = [rng.normal(size=2) for _ in range(n)]
    return {
        "numbers": np.arange(n),
        "doubles": np.round(rng.normal(size=n), 3),
        "with_nan": np.where(rng.random(n) < 0.2, np.nan, rng.normal(size=n)),
        "label": rng.integers(0, 3, n) * (rng.random(n) < 0.8),
        "key": np.array([f"k{i}" for i in rng.integers(0, 5, n)], dtype=object),
        "key2": rng.integers(0, 2, n),
        "words": words,
        "text": np.array([f"The Happy {i} sad JE T'aime İstanbul" for i in range(n)],
                         dtype=object),
        "vec": rng.normal(size=(n, 3)),
        "objvec": vecs,
        "lists": lists,
        "ts": np.cumsum(rng.integers(0, 700, n)).astype(np.int64),
    }


def _same(got, want):
    assert got.columns == want.columns and got.num_rows == want.num_rows
    assert got.num_partitions == want.num_partitions
    assert got.partition_bounds() == want.partition_bounds()
    for name in want.columns:
        a, b = got[name], want[name]
        assert a.dtype == b.dtype and a.shape == b.shape, name
        if a.dtype == object:
            assert [repr(v) for v in a] == [repr(v) for v in b], name
        else:
            np.testing.assert_array_equal(a, b, err_msg=name)
        assert got.metadata(name) == want.metadata(name), name


def _schema(s):
    return {k: (getattr(v, "dtype", None), getattr(v, "shape", None)) for k, v in s.items()}


def _run(ref, make, cols, partitions=1):
    """``make(stages module)`` in both packages on ``cols``: outputs,
    schemas and published events must equal the reference's."""
    outs = {}
    for key, mod, T, schema, bus in (
            ("port", ts, Table, schema_of_table, tevents.get_bus()),
            ("ref", ref.stages, ref.Table, ref.schema, ref.events.get_bus())):
        stage = make(mod)
        table = T(cols, num_partitions=partitions)
        seen = []
        bus.add_listener(seen.append)
        try:
            fitted = stage.fit(table) if isinstance(stage, (Estimator, ref.pipeline.Estimator)) \
                and not isinstance(stage, (mod.MultiColumnAdapter,)) else stage
            out = fitted.transform(table)
        finally:
            bus.remove_listener(seen.append)
        events = [(type(e).__name__, e.epoch, e.size) for e in seen
                  if type(e).__name__ == "BatchFormed"]
        outs[key] = (out, _schema(stage.transform_schema(schema(table))), events)
    _same(outs["port"][0], outs["ref"][0])
    assert outs["port"][1] == outs["ref"][1]
    assert outs["port"][2] == outs["ref"][2]
    return outs["port"][0]


def _double(c):
    return c.astype(np.float64) * 10


_CASES = {
    "cacher": lambda m: m.Cacher(),
    "drop": lambda m: m.DropColumns(cols=["doubles", "vec"]),
    "select": lambda m: m.SelectColumns(cols=["words", "numbers"]),
    "rename": lambda m: m.RenameColumn(inputCol="words", outputCol="instruments"),
    "repartition": lambda m: m.Repartition(n=3),
    "repartition_disabled": lambda m: m.Repartition(n=3, disable=True),
    "stratified_mixed": lambda m: m.StratifiedRepartition(labelCol="label", seed=3),
    "stratified_original": lambda m: m.StratifiedRepartition(labelCol="label", mode="original"),
    "stratified_equal": lambda m: m.StratifiedRepartition(labelCol="label", mode="equal"),
    "stratified_strings": lambda m: m.StratifiedRepartition(labelCol="key", seed=1),
    "class_balancer": lambda m: m.ClassBalancer(inputCol="label"),
    "class_balancer_strings": lambda m: m.ClassBalancer(inputCol="words", outputCol="w"),
    "explode": lambda m: m.Explode(inputCol="lists"),
    "explode_to": lambda m: m.Explode(inputCol="lists", outputCol="item"),
    "lambda": lambda m: m.Lambda(transformFunc=lambda t: t.with_column("twice",
                                                                       t["numbers"] * 2)),
    "udf": lambda m: m.UDFTransformer(inputCol="doubles", outputCol="plus1", udf=lambda c: c + 1),
    "udf_many": lambda m: m.UDFTransformer(inputCols=["numbers", "doubles"], outputCol="sum",
                                           udf=lambda a, b: a + b),
    "multi_column_adapter": lambda m: m.MultiColumnAdapter(
        baseStage=m.UDFTransformer(udf=_double), inputCols=["numbers", "doubles"],
        outputCols=["n10", "d10"]),
    "text_preprocessor": lambda m: m.TextPreprocessor(
        inputCol="text", outputCol="out", normFunc="lowerCase",
        map={"Happy": "glad", "sad": "blue", "je t'aime": "i love you", "big": "huge"}),
    "text_preprocessor_upper": lambda m: m.TextPreprocessor(
        inputCol="words", outputCol="words", normFunc="upperCase", map={"DRUMS": "beats"}),
    "text_preprocessor_identity": lambda m: m.TextPreprocessor(inputCol="text",
                                                               outputCol="o"),
    "unicode_nfkd": lambda m: m.UnicodeNormalize(inputCol="words", outputCol="out"),
    "unicode_nfc": lambda m: m.UnicodeNormalize(inputCol="text", outputCol="text", form="NFC",
                                                lower=False),
    "timer_transformer": lambda m: m.Timer(stage=m.UDFTransformer(
        inputCol="numbers", outputCol="n2", udf=lambda c: c * 2)),
    "timer_estimator": lambda m: m.Timer(stage=m.ClassBalancer(inputCol="label")),
    "ensemble_by_key": lambda m: m.EnsembleByKey(keys=["key"], cols=["doubles", "vec",
                                                                     "objvec"]),
    "ensemble_two_keys": lambda m: m.EnsembleByKey(keys=["key", "key2"], cols=["doubles"],
                                                   colNames=["avg"], collapseGroup=False),
    "summarize": lambda m: m.SummarizeData(),
    "summarize_some": lambda m: m.SummarizeData(sample=False, percentiles=False),
    "fixed_batches": lambda m: m.FixedMiniBatchTransformer(batchSize=5),
    "dynamic_batches": lambda m: m.DynamicMiniBatchTransformer(maxBatchSize=7),
    "dynamic_batches_whole": lambda m: m.DynamicMiniBatchTransformer(),
    "interval_batches": lambda m: m.TimeIntervalMiniBatchTransformer(
        millisToWait=1000, maxBatchSize=6, timestampCol="ts"),
    "interval_batches_partitions": lambda m: m.TimeIntervalMiniBatchTransformer(maxBatchSize=9),
}


@pytest.mark.parametrize("partitions", [1, 4])
@pytest.mark.parametrize("case", sorted(_CASES))
def test_stage_equals_the_reference(ref, case, partitions):
    cols = _cols()
    if case == "summarize":
        cols = {k: v for k, v in cols.items() if k not in ("vec", "objvec", "lists")}
    elif case == "summarize_some":
        cols = {k: cols[k] for k in ("numbers", "doubles", "with_nan", "words")}
    _run(ref, _CASES[case], cols, partitions)


@pytest.mark.parametrize("batcher", ["fixed_batches", "dynamic_batches", "interval_batches"])
def test_flatten_batch_inverts_the_batchers(ref, batcher):
    cols = {k: v for k, v in _cols().items() if k not in ("lists",)}
    batched = {"port": _CASES[batcher](ts).transform(Table(cols, num_partitions=2)),
               "ref": _CASES[batcher](ref.stages).transform(ref.Table(cols, num_partitions=2))}
    flat = ts.FlattenBatch().transform(batched["port"])
    _same(flat, ref.stages.FlattenBatch().transform(batched["ref"]))
    np.testing.assert_array_equal(flat["vec"], cols["vec"])
    assert _schema(ts.FlattenBatch().transform_schema(schema_of_table(batched["port"]))) == \
        _schema(ref.stages.FlattenBatch().transform_schema(ref.schema(batched["ref"])))
    with pytest.raises(ValueError, match="no batched"):
        ts.FlattenBatch().transform(Table({"x": np.arange(3)}))


def test_errors_udfs_and_timer_log(ref, caplog):
    cols = _cols()
    with pytest.raises(KeyError):
        ts.DropColumns(cols=["nope"]).transform(Table(cols))
    with pytest.raises(ValueError, match="must align"):
        ts.MultiColumnAdapter(baseStage=ts.UDFTransformer(udf=_double), inputCols=["numbers"],
                              outputCols=[]).transform(Table(cols))
    for col in (cols["vec"], cols["objvec"]):
        np.testing.assert_array_equal(ts.get_value_at(col, 1), ref.stages.get_value_at(col, 1))
    np.testing.assert_array_equal(ts.to_vector(cols["objvec"]), ref.stages.to_vector(cols["objvec"]))
    with caplog.at_level(logging.INFO, logger="mmlspark_tpu_torch.stages"):
        ts.Timer(stage=ts.ClassBalancer(inputCol="label")).fit(Table(cols)).transform(Table(cols))
    assert any("fit took" in r.message for r in caplog.records)
    assert any("transform took" in r.message for r in caplog.records)
    assert "torch.profiler" in ts.Timer.__doc__ and "jax" not in ts.Timer.__doc__


def test_stages_move_between_the_packages(ref, tmp_path):
    """Stages saved by either package load in the other and transform alike."""
    cols = _cols()
    makers = [_CASES[c] for c in ("select", "fixed_batches", "unicode_nfkd", "text_preprocessor",
                                  "ensemble_by_key", "stratified_mixed", "repartition")]
    for i, make in enumerate(makers):
        port, jref = make(ts), make(ref.stages)
        port.save(str(tmp_path / f"p{i}"))
        jref.save(str(tmp_path / f"r{i}"))
        from_ref = PipelineStage.load(str(tmp_path / f"r{i}"))
        from_port = ref.pipeline.PipelineStage.load(str(tmp_path / f"p{i}"))
        assert type(from_ref).__name__ == type(jref).__name__
        _same(from_ref.transform(Table(cols)), jref.transform(ref.Table(cols)))
        _same(port.transform(Table(cols)), from_port.transform(ref.Table(cols)))
    model = ts.ClassBalancer(inputCol="label").fit(Table(cols))
    model.save(str(tmp_path / "cb"))
    _same(model.transform(Table(cols)),
          ref.pipeline.PipelineStage.load(str(tmp_path / "cb")).transform(ref.Table(cols)))
