"""The port's Pipeline, schema validation, params API and fit guards against
the JAX package: the same stages, tables and calls go through both, and
reports, tables, errors and events must agree.

Stage classes of the reference are built inside fixtures (the card machine
imports this file without jax); fits are small and run on the CPU.
"""

import dataclasses

import numpy as np
import pytest

from test_torch_gbdt import _import_reference

# At import, so that every pytest worker has the JAX package's fit path
# before it collects the JAX package's own test files (see
# tests/test_torch_gbdt.py); the card machine has no jax.
try:
    _import_reference()
except ModuleNotFoundError as err:
    if err.name != "jax":
        raise

from mmlspark_tpu_torch.core import params as tparams
from mmlspark_tpu_torch.core import pipeline as tpipe
from mmlspark_tpu_torch.core import schema as tschema
from mmlspark_tpu_torch.data.table import Table
from mmlspark_tpu_torch.dataguard import guards as tguards
from mmlspark_tpu_torch.dataguard.modes import BadRecordsError
from mmlspark_tpu_torch.lightgbm import LightGBMClassifier
from mmlspark_tpu_torch.observability import events as tevents
from mmlspark_tpu_torch.observability.registry import get_registry
from mmlspark_tpu_torch.observability.tracing import get_tracer

# a gain floor: leaves of one class leave gains at float32 noise, and the
# packages sum in different orders
PARAMS = dict(numIterations=4, numLeaves=7, minDataInLeaf=10, minGainToSplit=1e-3)


def _stage_classes(params_mod, pipeline_mod, schema_mod):
    """A scaler (numeric input, new output column) and a column copier,
    declared the same way over either package's modules."""

    class Scale(params_mod.HasInputCol, params_mod.HasOutputCol, pipeline_mod.Transformer):
        factor = params_mod.Param("Multiplier", default=2.0, converter=params_mod.to_float)

        def transform(self, table):
            return table.with_column(self.getOutputCol(),
                                     table.column(self.getInputCol()) * self.getFactor())

        def transform_schema(self, schema):
            name = type(self).__name__
            col = schema_mod.require_column(schema, self.getInputCol(), name, numeric=True)
            return schema_mod.add_column(schema, self.getOutputCol(), col, name)

    class Cast(params_mod.HasInputCol, params_mod.HasOutputCol, pipeline_mod.Transformer):
        def transform(self, table):
            return table.with_column(self.getOutputCol(),
                                     table.column(self.getInputCol()).astype(np.int32))

        def transform_schema(self, schema):
            name = type(self).__name__
            schema_mod.require_column(schema, self.getInputCol(), name, dtype=np.float32)
            return schema_mod.add_column(schema, self.getOutputCol(),
                                         schema_mod.ColType(np.dtype(np.int32), ()), name)

    return Scale, Cast


@pytest.fixture(scope="module")
def ref():
    from mmlspark_tpu.core import params as jparams
    from mmlspark_tpu.core import pipeline as jpipe
    from mmlspark_tpu.core import schema as jschema
    from mmlspark_tpu.data.table import Table as JTable
    from mmlspark_tpu.dataguard import guards as jguards
    from mmlspark_tpu.dataguard.modes import BadRecordsError as JBad
    from mmlspark_tpu.lightgbm import LightGBMClassifier as JC
    from mmlspark_tpu.lightgbm.procfit import model_texts_close
    from mmlspark_tpu.observability import events as jevents
    from mmlspark_tpu.observability.registry import get_registry as jreg

    scale, cast = _stage_classes(jparams, jpipe, jschema)
    return dict(params=jparams, pipe=jpipe, schema=jschema, Table=JTable, guards=jguards,
                Bad=JBad, Classifier=JC, texts_close=model_texts_close, events=jevents,
                registry=jreg, Scale=scale, Cast=cast)


PScale, PCast = _stage_classes(tparams, tpipe, tschema)


def _dirty(n=600, seed=7):
    """Features with NaN and Inf cells, a float column with NaN, an int
    column, and labels with NaN, negatives and fractions."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, 3))
    X[rng.choice(n, 12, replace=False), 0] = np.nan
    X[rng.choice(n, 5, replace=False), 2] = np.inf
    y = (X[:, 1] + 0.3 * rng.normal(size=n) > 0).astype(np.float64)
    y[rng.choice(n, 4, replace=False)] = np.nan
    y[rng.choice(n, 3, replace=False)] = -1.0
    y[rng.choice(n, 2, replace=False)] = 0.5
    extra = rng.normal(size=n)
    extra[rng.choice(n, 6, replace=False)] = -np.inf
    return {"features": X, "label": y, "extra": extra, "ids": np.arange(n, dtype=np.int64),
            "w": rng.uniform(0.5, 2.0, n)}


def _assert_tables_equal(a, b):
    assert a.columns == b.columns and a.num_rows == b.num_rows
    for c in a.columns:
        assert a[c].dtype == b[c].dtype and a[c].tobytes() == b[c].tobytes(), c


# -- params and tables ------------------------------------------------------------


def test_params_api_matches_the_reference(ref):
    p = PScale(inputCol="a", outputCol="b")
    j = ref["Scale"](inputCol="a", outputCol="b")
    for s in (p, j):
        s.setFactor(3.0)
        s.clear("outputCol")
    assert p.explainParams() == j.explainParams()
    assert p.extractParamMap() == j.extractParamMap()
    for name in ("inputCol", "outputCol", "factor"):
        assert p.isDefined(name) == j.isDefined(name) and p.isSet(name) == j.isSet(name)
    assert p.get("factor") == j.get("factor") == 3.0
    with pytest.raises(KeyError):
        p.get("outputCol")
    assert sorted(p.params) == sorted(j.params) and p.hasParam("factor")
    assert tparams.HasBatchSize().getBatchSize() == ref["params"].HasBatchSize().getBatchSize()
    assert tparams.HasInputCols(inputCols=["a"]).getInputCols() == ["a"]
    assert tparams.HasOutputCols(outputCols=["b"]).getOutputCols() == ["b"]


def test_table_keeps_metadata_and_partitions_through_derivations():
    t = Table({"a": np.arange(6.0), "b": np.arange(6)}, metadata={"a": {"k": 1}},
              num_partitions=3)
    d = t.filter(t["a"] > 1).with_column("c", np.zeros(4), metadata={"u": "s"})
    assert d.columns == ["a", "b", "c"] and d.num_partitions == 3
    assert d.metadata("a") == {"k": 1} and d.metadata("c") == {"u": "s"}
    assert d.metadata("b") == {} and set(d.to_dict()) == {"a", "b", "c"}
    assert t.sort_by("a", ascending=False).metadata("a") == {"k": 1}
    w = t.with_columns({"a": np.ones(6), "z": np.ones(6)})
    assert w.columns == ["a", "b", "z"] and w.num_partitions == 3
    both = Table.concat([t, t])
    assert both.num_rows == 12 and both.metadata("a") == {"k": 1} and both.num_partitions == 3


# -- schema validation --------------------------------------------------------------


def _graphs(pkg):
    """Three mis-wired graphs and one sound one, as stage lists."""
    scale, cast = pkg
    return {
        "missing-input-col": [scale(inputCol="a", outputCol="b"), scale(inputCol="q", outputCol="c")],
        "dtype-mismatch": [scale(inputCol="a", outputCol="b"), cast(inputCol="i", outputCol="c")],
        "duplicate-output-col": [scale(inputCol="a", outputCol="b"),
                                 scale(inputCol="b", outputCol="a")],
        "ok": [scale(inputCol="a", outputCol="b"), cast(inputCol="f32", outputCol="c")],
    }


def _schema_table(T):
    return T({"a": np.arange(4.0), "s": np.array(list("wxyz"), dtype=object),
              "i": np.arange(4, dtype=np.int64), "f32": np.arange(4, dtype=np.float32)})


@pytest.mark.parametrize("kind", ["missing-input-col", "dtype-mismatch", "duplicate-output-col"])
def test_validate_names_the_stage_like_the_reference(ref, kind):
    port = tpipe.Pipeline(stages=_graphs((PScale, PCast))[kind])
    jref = ref["pipe"].Pipeline(stages=_graphs((ref["Scale"], ref["Cast"]))[kind])
    with pytest.raises(tschema.SchemaError) as pe:
        port.validate(_schema_table(Table))
    with pytest.raises(ref["schema"].SchemaError) as je:
        jref.validate(_schema_table(ref["Table"]))
    assert pe.value.kind == je.value.kind == kind
    assert pe.value.stage == je.value.stage and pe.value.stage.startswith("1 (")
    assert pe.value.column == je.value.column and str(pe.value) == str(je.value)
    with pytest.raises(tschema.SchemaError):  # fit validates before any stage runs
        port.fit(_schema_table(Table))


def test_validate_propagates_the_schema_like_the_reference(ref):
    port = tpipe.Pipeline(stages=_graphs((PScale, PCast))["ok"])
    jref = ref["pipe"].Pipeline(stages=_graphs((ref["Scale"], ref["Cast"]))["ok"])
    assert repr(port.validate(_schema_table(Table))) == repr(jref.validate(
        _schema_table(ref["Table"])))
    assert repr(port.validate({"a": np.float64, "f32": np.float32, "x": None})) == repr(
        jref.validate({"a": np.float64, "f32": np.float32, "x": None}))
    out = port.fit(_schema_table(Table)).transform(_schema_table(Table))
    assert out["c"].dtype == np.int32 and list(out["b"]) == [0.0, 2.0, 4.0, 6.0]
    assert tpipe.ml_transform(_schema_table(Table), PScale(inputCol="a", outputCol="b"))[
        "b"].tobytes() == out["b"].tobytes()


# -- fit guards ------------------------------------------------------------------------


def _counter_values(reg):
    return {k: (reg.get(k).value if reg.get(k) is not None else 0.0)
            for k in ("dataguard_fit_rows_dropped_total", "dataguard_fit_values_imputed_total")}


@pytest.mark.parametrize("policy", ["drop", "impute"])
@pytest.mark.parametrize("domain", ["classifier", None])
def test_guard_table_matches_the_reference(ref, policy, domain):
    d = _dirty()
    before_p, before_j = _counter_values(get_registry()), _counter_values(ref["registry"]())
    tp, rp = tguards.guard_table(Table(d), policy=policy, label_col="label", label_domain=domain)
    tj, rj = ref["guards"].guard_table(ref["Table"](d), policy=policy, label_col="label",
                                       label_domain=domain)
    assert dataclasses.asdict(rp) == dataclasses.asdict(rj) and rp.summary() == rj.summary()
    assert rp.rows_dropped > 0
    _assert_tables_equal(tp, tj)
    after_p, after_j = _counter_values(get_registry()), _counter_values(ref["registry"]())
    assert {k: after_p[k] - before_p[k] for k in after_p} == \
        {k: after_j[k] - before_j[k] for k in after_j}


def test_guard_table_fail_raises_like_the_reference(ref):
    d = _dirty()
    with pytest.raises(BadRecordsError) as pe:
        tguards.guard_table(Table(d), policy="FAIL", label_col="label",
                            label_domain="classifier", name="fit:7")
    with pytest.raises(ref["Bad"]) as je:
        ref["guards"].guard_table(ref["Table"](d), policy="FAIL", label_col="label",
                                  label_domain="classifier", name="fit:7")
    assert str(pe.value) == str(je.value)
    assert [r.to_record() for r in pe.value.records] == [r.to_record() for r in je.value.records]
    clean = {k: v for k, v in d.items() if k not in ("features", "extra", "label")}
    t, report = tguards.guard_table(Table(clean), policy="fail")
    assert report.clean and t.num_rows == len(clean["ids"])
    with pytest.raises(ValueError, match="unknown invalid-data policy"):
        tguards.normalize_policy("skip")


@pytest.mark.parametrize("policy", ["fail", "drop", "impute"])
def test_guard_arrays_matches_the_reference(ref, policy):
    d = _dirty()
    w = d["w"].copy()
    w[3] = np.nan
    args = (d["features"], d["label"], w)
    if policy == "fail":
        with pytest.raises(BadRecordsError) as pe:
            tguards.guard_arrays(*args, policy=policy, label_domain="classifier")
        with pytest.raises(ref["Bad"]) as je:
            ref["guards"].guard_arrays(*args, policy=policy, label_domain="classifier")
        assert str(pe.value) == str(je.value)
        return
    out_p = tguards.guard_arrays(*args, policy=policy, label_domain="classifier")
    out_j = ref["guards"].guard_arrays(*args, policy=policy, label_domain="classifier")
    for a, b in zip(out_p[:3], out_j[:3]):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    assert dataclasses.asdict(out_p[3]) == dataclasses.asdict(out_j[3])


# -- Pipeline fits ------------------------------------------------------------------------


def _events_without_timing(evs):
    return [(type(e).__name__, {k: v for k, v in dataclasses.asdict(e).items()
                                if k not in ("t", "duration", "job_id", "epoch", "version",
                                             "start", "wall_start")})
            for e in evs]


def test_pipeline_drop_fits_the_clean_complement(ref):
    d = _dirty()
    d["features"][:, 2] = np.where(np.isinf(d["features"][:, 2]), np.nan, d["features"][:, 2])
    got, jgot = [], []
    bus, jbus = tevents.get_bus(), ref["events"].get_bus()
    bus.add_listener(got.append)
    jbus.add_listener(jgot.append)
    try:
        pm = tpipe.Pipeline(stages=[LightGBMClassifier(device="cpu", weightCol="w", **PARAMS)],
                            invalidDataPolicy="drop").fit(Table(d))
        jpm = ref["pipe"].Pipeline(
            stages=[ref["Classifier"](parallelism="serial", weightCol="w", **PARAMS)],
            invalidDataPolicy="drop").fit(ref["Table"](d))
    finally:
        bus.remove_listener(got.append)
        jbus.remove_listener(jgot.append)
    clean, _ = tguards.guard_table(Table(d), policy="drop", label_col="label",
                                   label_domain="classifier")
    plain = LightGBMClassifier(device="cpu", weightCol="w", **PARAMS).fit(clean)
    text = pm.getStages()[0].get_model_string()
    assert text == plain.get_model_string()
    assert ref["texts_close"](text, jpm.getStages()[0].get_model_string())
    # events: the same types and fields, timings and process-global ids aside
    got = [e for e in got if not isinstance(e, tevents.SpanRecorded)]
    jgot = [e for e in jgot if not isinstance(e, ref["events"].SpanRecorded)]
    assert [type(e).__name__ for e in got] == ["RecordsDeadLettered", "StageStarted",
                                               "HistogramSubtracted", "ModelCommitted",
                                               "StageCompleted", "ModelCommitted"]
    assert _events_without_timing(got) == _events_without_timing(jgot)
    assert len({e.job_id for e in got if hasattr(e, "job_id")}) == 1


def test_pipeline_impute_and_fail_policies(ref):
    d = _dirty()
    d["label"] = np.nan_to_num(np.abs(np.round(d["label"])), nan=0.0)
    est = dict(device="cpu", **PARAMS)
    pm = tpipe.Pipeline(stages=[LightGBMClassifier(**est)], invalidDataPolicy="impute").fit(
        Table(d))
    jpm = ref["pipe"].Pipeline(stages=[ref["Classifier"](parallelism="serial", **PARAMS)],
                               invalidDataPolicy="impute").fit(ref["Table"](d))
    assert ref["texts_close"](pm.getStages()[0].get_model_string(),
                              jpm.getStages()[0].get_model_string())
    with pytest.raises(BadRecordsError, match="invalidDataPolicy"):
        tpipe.Pipeline(stages=[LightGBMClassifier(**est)], invalidDataPolicy="fail").fit(Table(d))


def test_pipeline_spans_and_stage_transform_spans():
    tracer = get_tracer()
    tracer.clear()
    d = {k: v for k, v in _dirty().items() if k in ("ids", "w")}
    pm = tpipe.Pipeline(stages=[PScale(inputCol="w", outputCol="w2"),
                                PScale(inputCol="w2", outputCol="w3")]).fit(Table(d))
    names = [s["name"] for s in tracer.export()]
    assert names == ["fit:Scale", "fit:Scale"]
    assert [s["tags"]["stage"] for s in tracer.export()] == [0, 1]
    pm.transform(Table(d))  # no ambient span: no stage spans
    assert len(tracer.export()) == 2
    with tracer.span("request") as root:
        out = pm.transform(Table(d))
    tree = tracer.span_tree(root.trace_id)
    assert [c["name"] for c in tree["roots"][0]["children"]] == ["transform:Scale"] * 2
    assert out["w3"].tobytes() == (d["w"] * 4.0).tobytes()
