"""The port's fuzzing meta-suite — the copy of ``tests/test_fuzzing.py``
over ``mmlspark_tpu_torch``.

Every concrete public ``PipelineStage`` of the port (``cognitive`` aside,
as in the reference) has a fixture in ``tests/_torch_fuzzing_objects.py``,
is the ``fit_produces`` model of a fixtured estimator, or carries the
reference's exemption with its reason; the discovered names are the
reference's, with the package mapped. Every fixture fits and transforms on
``device="cpu"`` (ExperimentFuzzing) and survives save and load with equal
params and equal output (SerializationFuzzing). A loaded stage has
``device`` at its default, the card: the suite puts it and every stage
among its params back on the CPU before comparing.
"""

import importlib
import inspect
import pkgutil

import numpy as np
import pytest

import _torch_reference  # noqa: F401  (the reference's import shim)
import mmlspark_tpu_torch
from mmlspark_tpu_torch.core.pipeline import Estimator, PipelineStage

from _torch_fuzzing_objects import EXEMPT, TEST_OBJECTS, on_cpu

_SKIP_MODULES = ("mmlspark_tpu_torch.cognitive",)  # service stubs, fuzzed in their own tests


def discover_stage_classes():
    """Every concrete public PipelineStage subclass in the port."""
    found = {}
    for m in pkgutil.walk_packages(mmlspark_tpu_torch.__path__, "mmlspark_tpu_torch."):
        if m.name.startswith(_SKIP_MODULES):
            continue
        mod = importlib.import_module(m.name)
        for name, obj in vars(mod).items():
            if (
                inspect.isclass(obj)
                and issubclass(obj, PipelineStage)
                and obj.__module__ == m.name
                and not name.startswith("_")
                and not inspect.isabstract(obj)
            ):
                found[f"{obj.__module__}.{name}"] = obj
    return found


DISCOVERED = discover_stage_classes()


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """torch on one thread for this file: its fits and networks are tiny,
    and thread pools only stall when the test workers share the cores."""
    import torch

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _produced_model_names():
    names = set()
    for maker in TEST_OBJECTS.values():
        obj = maker()
        if obj.fit_produces:
            names.add(obj.fit_produces)
    return names


def test_discovered_stages_are_the_references():
    """The reference's discovery (``tests/test_fuzzing.py`` walks the JAX
    package the same way, less ``cognitive``), read through its apigen's
    walk, which is the same one."""
    from mmlspark_tpu.core import apigen as japigen

    ref = {q for q in japigen.discover_stages() if not q.startswith("mmlspark_tpu.cognitive")}
    mapped = {"mmlspark_tpu." + q[len("mmlspark_tpu_torch."):] for q in DISCOVERED}
    assert mapped == ref
    assert len(DISCOVERED) == 101


def test_fixtures_and_exemptions_are_the_references():
    import fuzzing_objects as ref

    def port(q):
        return "mmlspark_tpu_torch." + q[len("mmlspark_tpu."):]

    assert sorted(TEST_OBJECTS) == sorted(port(q) for q in ref.TEST_OBJECTS)
    assert sorted(EXEMPT) == sorted(port(q) for q in ref.EXEMPT)


def test_every_stage_is_covered():
    produced = _produced_model_names()
    missing = []
    for qual in sorted(DISCOVERED):
        if qual in TEST_OBJECTS or qual in EXEMPT or qual in produced:
            continue
        missing.append(qual)
    assert not missing, (
        "stages without fuzzing coverage (add a fixture to "
        f"tests/_torch_fuzzing_objects.py or an EXEMPT reason): {missing}"
    )


def test_no_stale_entries():
    stale = [q for q in list(TEST_OBJECTS) + list(EXEMPT) if q not in DISCOVERED]
    assert not stale, f"fixtures/exemptions for classes that no longer exist: {stale}"


def _approx_equal(x, y):
    """Recursive tolerant equality over scalars/arrays/dicts/sequences —
    serde may turn np.float64 into float, tuples into lists, etc."""
    if isinstance(x, dict) and isinstance(y, dict):
        assert set(x) == set(y), (x, y)
        for k in x:
            _approx_equal(x[k], y[k])
        return
    if isinstance(x, (list, tuple)) and isinstance(y, (list, tuple)):
        assert len(x) == len(y), (x, y)
        for xi, yi in zip(x, y):
            _approx_equal(xi, yi)
        return
    if isinstance(x, PipelineStage) and isinstance(y, PipelineStage):
        assert type(x) is type(y)
        _approx_equal(x.extractParamMap(), y.extractParamMap())
        return
    xa, ya = np.asarray(x), np.asarray(y)
    if xa.dtype.kind in "fc" and xa.shape == ya.shape:
        np.testing.assert_allclose(xa, ya, rtol=1e-5, atol=1e-6)
    elif xa.dtype.kind in "iub" and ya.dtype.kind in "iubfc":
        np.testing.assert_allclose(
            xa.astype(np.float64), ya.astype(np.float64), rtol=1e-5
        )
    else:
        assert str(x) == str(y)


def _tables_close(a, b):
    assert set(a.columns) == set(b.columns), (a.columns, b.columns)
    for c in a.columns:
        ca, cb = a.column(c), b.column(c)
        if ca.dtype == object or cb.dtype == object:
            assert len(ca) == len(cb)
            for x, y in zip(ca, cb):
                _approx_equal(x, y)
        elif ca.dtype.kind in "fc":
            np.testing.assert_allclose(ca, cb, rtol=1e-5, atol=1e-6)
        else:
            np.testing.assert_array_equal(ca, cb)


@pytest.fixture(params=sorted(TEST_OBJECTS), ids=lambda q: q.rsplit(".", 1)[-1])
def test_object(request):
    return TEST_OBJECTS[request.param]()


def test_experiment_fuzzing(test_object):
    """Fit/transform executes without error (ExperimentFuzzing,
    Fuzzing.scala:75-103)."""
    stage = test_object.stage
    table = test_object.table
    tt = test_object.transform_table or table
    if isinstance(stage, Estimator):
        model = stage.fit(table)
        if test_object.fit_produces:
            got = f"{type(model).__module__}.{type(model).__qualname__}"
            assert got == test_object.fit_produces, got
        if test_object.check_transform:
            out = model.transform(tt)
            assert out.num_rows >= 0
    elif test_object.check_transform:
        out = stage.transform(tt)
        assert out.num_rows >= 0


def test_serialization_fuzzing(test_object, tmp_path):
    """Save/load roundtrip of the stage (and fitted model) preserves its
    params and its transform (SerializationFuzzing,
    Fuzzing.scala:105-181)."""
    stage = test_object.stage
    table = test_object.table
    tt = test_object.transform_table or table

    p1 = str(tmp_path / "stage")
    stage.save(p1)
    reloaded = on_cpu(type(stage).load(p1))
    assert type(reloaded) is type(stage)
    _approx_equal(reloaded.extractParamMap(), stage.extractParamMap())

    if isinstance(stage, Estimator):
        model = stage.fit(table)
        p2 = str(tmp_path / "model")
        model.save(p2)
        model2 = on_cpu(type(model).load(p2))
        assert type(model2) is type(model)
        _approx_equal(model2.extractParamMap(), model.extractParamMap())
        if test_object.check_transform:
            _tables_close(model.transform(tt), model2.transform(tt))
    elif test_object.check_transform:
        _tables_close(stage.transform(tt), reloaded.transform(tt))
