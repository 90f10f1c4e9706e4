"""The port's quality plane (sketches, reference profiles, the drift
monitor, the incident recorder and the Pipeline's hooks) against the JAX
package's. Sketch state is exact (integer counts, Fraction moments), so the
port's column-at-a-time numpy paths must equal the reference's
value-by-value state bit for bit: the same compactions, edges and JSON.

Reference modules are imported inside fixtures (the card machine imports
this file without jax).
"""

import json
import os

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
from mmlspark_tpu_torch.observability import events as tevents
from mmlspark_tpu_torch.observability import incidents as tincidents
from mmlspark_tpu_torch.observability import quality as tquality
from mmlspark_tpu_torch.observability import registry as tregistry
from mmlspark_tpu_torch.observability import sketches as tsketches
from mmlspark_tpu_torch.runtime import journal as tjournal

TIMING = {"t", "wt"}


@pytest.fixture(scope="module")
def ref():
    from mmlspark_tpu.core import params as jparams
    from mmlspark_tpu.core import pipeline as jpipe
    from mmlspark_tpu.core import schema as jschema
    from mmlspark_tpu.data.table import Table as JTable
    from mmlspark_tpu.observability import events as jevents
    from mmlspark_tpu.observability import incidents as jincidents
    from mmlspark_tpu.observability import quality as jquality
    from mmlspark_tpu.observability import registry as jregistry
    from mmlspark_tpu.observability import sketches as jsketches
    from mmlspark_tpu.runtime import journal as jjournal

    return dict(params=jparams, pipe=jpipe, schema=jschema, Table=JTable, events=jevents,
                incidents=jincidents, quality=jquality, registry=jregistry,
                sketches=jsketches, journal=jjournal)


def _stream(name, rng):
    """A seeded column of each kind the sketches meet."""
    if name == "normal":
        return rng.normal(size=5000)
    if name == "nan":
        x = rng.normal(size=3000) * 50.0
        x[rng.random(3000) < 0.2] = np.nan
        return x
    if name == "ints":
        return rng.integers(-40, 40, size=4000)
    if name == "signed_zeros":
        x = np.round(rng.normal(size=3000))
        x[rng.random(3000) < 0.3] = -0.0
        return x
    if name == "constant":
        return np.full(700, 3.25)
    if name == "empty":
        return np.zeros(0)
    if name == "long":
        return rng.lognormal(size=70_000)
    if name == "wide":
        return rng.normal(size=4000) * 2.0 ** rng.integers(-1000, 1000, size=4000)
    if name == "subnormal":
        return rng.normal(size=2000) * 1e-310
    if name == "float32":
        return rng.normal(size=4000).astype(np.float32)
    if name == "bool":
        return rng.random(3000) < 0.3
    raise KeyError(name)


STREAMS = ("normal", "nan", "ints", "signed_zeros", "constant", "empty", "long", "wide",
           "subnormal", "float32", "bool")


def _levels(c):
    return [[float(v).hex() for v in level] for level in c._levels]


@pytest.mark.parametrize("k", [8, 256])
@pytest.mark.parametrize("name", STREAMS)
def test_compactor_equals_the_references(ref, name, k):
    rng = np.random.default_rng(STREAMS.index(name))
    x = _stream(name, rng)
    split = len(x) // 3
    port, jref = tsketches.QuantileCompactor(k), ref["sketches"].QuantileCompactor(k)
    for part in (x[:split], x[split:]):
        port.extend(part)
        jref.extend(list(part))
    assert _levels(port) == _levels(jref)
    assert (port._compactions, port.count) == (jref._compactions, jref.count)
    assert (float(port._min).hex(), float(port._max).hex()) == \
        (float(jref._min).hex(), float(jref._max).hex())
    for bins in (10, 4):
        assert json.dumps(port.edges(bins)) == json.dumps(jref.edges(bins))


@pytest.mark.parametrize("name", STREAMS)
def test_column_sketch_equals_the_references(ref, name):
    rng = np.random.default_rng(100 + STREAMS.index(name))
    x = _stream(name, rng)
    c = ref["sketches"].QuantileCompactor()
    c.extend(list(x))
    edges = c.edges(10)
    port, jref = tsketches.ColumnSketch(edges), ref["sketches"].ColumnSketch(edges)
    half = len(x) // 2
    port.observe_many(x[:half])
    port.observe_many(x[half:])
    jref.observe_many(list(x))
    assert port.to_json() == jref.to_json()
    if name != "wide":  # the wide stream's variance overflows a float in both packages
        assert port.mean() == jref.mean() and port.variance() == jref.variance()


def test_sketch_merges_and_drift_statistics_equal_the_references(ref):
    rng = np.random.default_rng(7)
    edges = [-3.0, -1.0, -0.25, 0.0, 0.5, 1.5, 4.0]
    parts = [rng.normal(size=900), rng.normal(0.4, 1.2, size=600), rng.normal(size=300)]
    ports, refs = [], []
    for p in parts:
        a, b = tsketches.ColumnSketch(edges), ref["sketches"].ColumnSketch(edges)
        a.observe_many(p)
        b.observe_many(list(p))
        ports.append(a)
        refs.append(b)
    left = ports[0].merge(ports[1]).merge(ports[2])
    right = ports[0].merge(ports[1].merge(ports[2]))
    assert left.to_json() == right.to_json() == tsketches.merge_all(ports).to_json() == \
        ref["sketches"].merge_all(refs).to_json()
    assert tsketches.psi(ports[0], ports[1]) == ref["sketches"].psi(refs[0], refs[1])
    assert tsketches.ks_statistic(ports[0], ports[1]) == \
        ref["sketches"].ks_statistic(refs[0], refs[1])
    back = tsketches.ColumnSketch.from_dict(json.loads(left.to_json()))
    assert back.to_json() == left.to_json()


def _columns(rng, n=1500):
    X = rng.normal(size=(n, 3))
    X[rng.random(n) < 0.05, 1] = np.nan
    return {"features": X, "ids": rng.integers(0, 9, size=n),
            "score": rng.random((n, 2)).astype(np.float32), "flag": rng.random(n) < 0.5}


def test_reference_profile_capture_equals_the_references(ref):
    cols = _columns(np.random.default_rng(11))
    port = tquality.ReferenceProfile.capture("m", 3, cols)
    # the reference's fit hook hands the capture list(column)
    jref = ref["quality"].ReferenceProfile.capture("m", 3, {k: list(v) for k, v in cols.items()})
    assert json.dumps(port.to_dict(), sort_keys=True) == json.dumps(jref.to_dict(), sort_keys=True)
    assert sorted(port.features) == ["features[0]", "features[1]", "features[2]", "flag", "ids",
                                     "score[0]", "score[1]"]


def _monitor_run(quality_mod, registry_mod, events_mod, profile_dict, batches):
    """Drive one monitor over ``batches``; the published drift records, the
    registry text and the final snapshot."""
    reg = registry_mod.MetricsRegistry()
    profile = quality_mod.ReferenceProfile.from_dict(profile_dict)
    mon = quality_mod.QualityMonitor(profile=profile, registry=reg, window=64, eval_every=16,
                                     min_window=16)
    bus = events_mod.get_bus()
    seen = []
    bus.add_listener(seen.append)
    try:
        tables = [mon.evaluate()]
        for cols in batches:
            mon.observe_columns(cols)
        tables.append(mon.evaluate())
    finally:
        bus.remove_listener(seen.append)
    records = [{k: v for k, v in e.to_record().items() if k not in TIMING} for e in seen]
    return records, reg.exposition(), mon.snapshot(), tables, mon.drifted_features()


def test_monitor_windows_gauges_and_events_equal_the_references(ref):
    rng = np.random.default_rng(12)
    base = _columns(rng, 2000)
    profile = tquality.ReferenceProfile.capture("m", 1, base).to_dict()
    shifted = dict(base, features=base["features"] + np.array([2.0, 0.0, 0.0]))
    batches = []
    for cols, lo, hi in ((base, 0, 10), (base, 10, 40), (shifted, 0, 300), (shifted, 300, 305),
                         (base, 500, 900), ({"unprofiled": np.ones(5)}, 0, 5)):
        batches.append({k: v[lo:hi] for k, v in cols.items()})
    port = _monitor_run(tquality, tregistry, tevents, profile, batches)
    jref = _monitor_run(ref["quality"], ref["registry"], ref["events"], profile,
                        [{k: list(v) for k, v in b.items()} for b in batches])
    assert port == jref
    kinds = [(r["event"], r["feature"]) for r in port[0]]
    assert ("DriftDetected", "features[0]") in kinds and ("DriftCleared", "features[0]") in kinds


@pytest.fixture
def no_monitors(ref):
    """Neither package's process-global monitor nor recorder survives a test."""
    yield
    for q in (tquality, ref["quality"]):
        q.install_monitor(None)
    for inc in (tincidents, ref["incidents"]):
        if inc._RECORDER is not None:
            inc._RECORDER.uninstall()
            inc._RECORDER = None


def _stage_classes(params_mod, pipeline_mod, schema_mod):
    class Scale(params_mod.HasInputCol, params_mod.HasOutputCol, pipeline_mod.Transformer):
        factor = params_mod.Param("Multiplier", default=2.0, converter=params_mod.to_float)

        def transform(self, table):
            return table.with_column(self.getOutputCol(),
                                     table.column(self.getInputCol()) * self.getFactor())

        def transform_schema(self, schema):
            name = type(self).__name__
            col = schema_mod.require_column(schema, self.getInputCol(), name, numeric=True)
            return schema_mod.add_column(schema, self.getOutputCol(), col, name)

    return Scale


def _pipeline_quality(pipe_mod, params_mod, schema_mod, Tab, events_mod, quality_mod, root,
                      monkeypatch):
    """Fit a two-stage Pipeline under a quality store, then transform the
    training rows and the same rows with column 0 shifted; the committed
    profile (its version is the process's fit count, so it is left out),
    the drift records and the outputs."""
    Scale = _stage_classes(params_mod, pipe_mod, schema_mod)
    rng = np.random.default_rng(21)
    X = rng.normal(size=(800, 3))
    d = {"x": X, "w": rng.uniform(0.5, 2.0, 800)}
    monkeypatch.setenv("MMLSPARK_TPU_QUALITY_STORE", root)
    pm = pipe_mod.Pipeline(stages=[Scale(inputCol="x", outputCol="x2"),
                                   Scale(inputCol="w", outputCol="w2", factor=0.5)]).fit(Tab(d))
    (name,) = [f for f in os.listdir(root) if f.endswith(".quality.json")]
    assert os.path.exists(os.path.join(root, name + ".crc32"))
    with open(os.path.join(root, name), encoding="utf-8") as fh:
        artifact = json.load(fh)
    version = artifact.pop("version")
    assert name == f"model-{version:06d}.quality.json"
    bus = events_mod.get_bus()
    seen = []
    bus.add_listener(seen.append)
    outs = []
    try:
        for rows in (X, X + np.array([1.0, 0.0, 0.0])):
            outs.append(pm.transform(Tab({"x": rows, "w": d["w"]})))
    finally:
        bus.remove_listener(seen.append)
    drift = [{k: v for k, v in e.to_record().items() if k not in TIMING | {"version"}}
             for e in seen if type(e).__name__ in ("DriftDetected", "DriftCleared")]
    monitor = quality_mod.get_monitor()
    assert monitor.version == version
    return artifact, drift, [o["x2"].tobytes() for o in outs], monitor.drifted_features()


def test_pipeline_quality_plane_equals_the_references(ref, tmp_path, monkeypatch, no_monitors):
    for k, v in (("WINDOW", "256"), ("MIN_WINDOW", "64"), ("EVAL_EVERY", "64")):
        monkeypatch.setenv(f"MMLSPARK_TPU_QUALITY_{k}", v)
    port = _pipeline_quality(tpipe, tparams, tschema, Table, tevents, tquality,
                             str(tmp_path / "port"), monkeypatch)
    jref = _pipeline_quality(ref["pipe"], ref["params"], ref["schema"], ref["Table"],
                             ref["events"], ref["quality"], str(tmp_path / "ref"), monkeypatch)
    assert port == jref
    assert sorted(port[0]["features"]) == ["w", "w2", "x2[0]", "x2[1]", "x2[2]", "x[0]", "x[1]",
                                           "x[2]"]
    assert sorted((r["event"], r["feature"]) for r in port[1]) == [("DriftDetected", "x2[0]"),
                                                                    ("DriftDetected", "x[0]")]
    assert port[3] == ["x2[0]", "x[0]"]


@pytest.mark.parametrize("direction", ["port_to_ref", "ref_to_port"])
def test_quality_artifacts_read_across_packages(ref, tmp_path, direction):
    w_q, w_j, r_q, r_j = (tquality, tjournal, ref["quality"], ref["journal"])
    if direction == "ref_to_port":
        w_q, w_j, r_q, r_j = r_q, r_j, w_q, w_j
    cols = _columns(np.random.default_rng(31), 400)
    profile = w_q.ReferenceProfile.capture("model", 4, {k: list(v) for k, v in cols.items()})
    fname = profile.commit(w_j.ModelStore(str(tmp_path)))
    assert fname == "model-000004.quality.json"
    back = r_q.load_profile(r_j.ModelStore(str(tmp_path)), "model", 4)
    assert back.to_dict() == profile.to_dict()
    path = tmp_path / fname
    path.write_bytes(path.read_bytes().replace(b'"bins": 10', b'"bins": 11'))
    assert r_q.load_profile(r_j.ModelStore(str(tmp_path)), "model", 4) is None  # torn: CRC


def test_drift_trips_the_incident_recorder(ref, tmp_path, monkeypatch, no_monitors):
    """With MMLSPARK_TPU_INCIDENT_DIR set, a drift onset writes one bundle
    (the reference's files, quality.json among them) and books it."""
    def run(quality_mod, registry_mod, events_mod, incidents_mod, root):
        monkeypatch.setenv("MMLSPARK_TPU_INCIDENT_DIR", root)
        rng = np.random.default_rng(41)
        X = rng.normal(size=(600, 2))
        profile = quality_mod.ReferenceProfile.capture("m", 1, {"x": list(X)})
        mon = quality_mod.QualityMonitor(profile=profile, registry=registry_mod.MetricsRegistry(),
                                         window=64, eval_every=16, min_window=16)
        quality_mod.install_monitor(mon)
        bus = events_mod.get_bus()
        seen = []
        bus.add_listener(seen.append)
        try:
            mon.observe_columns({"x": list(X[:100] + np.array([3.0, 0.0]))})
        finally:
            bus.remove_listener(seen.append)
        booked = [e for e in seen if type(e).__name__ == "IncidentRecorded"]
        assert len(booked) == 1 and booked[0].trigger == "drift_detected"
        with open(os.path.join(booked[0].path, "quality.json"), encoding="utf-8") as fh:
            table = json.load(fh)
        with open(os.path.join(booked[0].path, "manifest.json"), encoding="utf-8") as fh:
            manifest = json.load(fh)
        return (sorted(os.listdir(booked[0].path)), table, booked[0].detail,
                sorted(manifest), manifest["trigger"])

    port = run(tquality, tregistry, tevents, tincidents, str(tmp_path / "port"))
    jref = run(ref["quality"], ref["registry"], ref["events"], ref["incidents"],
               str(tmp_path / "ref"))
    assert port == jref
    assert "quality.json" in port[0] and port[1]["drift"][0]["feature"] == "x[0]"
