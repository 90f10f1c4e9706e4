"""The port's VW featurizer, interactions and padded-batch helpers
(``mmlspark_tpu_torch.vw.featurizer``, ``vw.interactions``, the
``SparseBatch`` half of ``data/sparse.py``) against the JAX package's.

The port always takes the reference's numpy split-and-hash path; its columns
must equal the reference's bit for bit (no tolerance) whether the reference
runs its host C++ library (``murmur3_split_hash_native``) or its numpy
fallback (``MMLSPARK_TPU_NATIVE=off``), and must reproduce
``tests/fixtures/golden_matrix_vw.csv``. When the in-tree library is not
built, the fixture compiles it into a temp directory, so the ``native``
cases run in a fresh checkout.
"""

import csv
import os
import subprocess

import numpy as np
import pytest


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

from mmlspark_tpu_torch.data import sparse as tsparse
from mmlspark_tpu_torch.data.table import Table
from mmlspark_tpu_torch.vw import VowpalWabbitFeaturizer, VowpalWabbitInteractions

GOLDEN = os.path.join(os.path.dirname(__file__), "fixtures", "golden_matrix_vw.csv")


def _build_native_library(tmp_path_factory):
    """The reference's host library: the in-tree build when one exists,
    else ``native/mmlspark_native.cpp`` compiled with the Makefile's flags
    into this process's temp directory (never ``make -C native``, which
    another test worker may be running). None without ``g++``."""
    import shutil

    import mmlspark_tpu.native as native

    lib = native.load_library()
    if lib is not None:
        return lib
    if shutil.which("g++") is None:
        return None
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = str(tmp_path_factory.mktemp("native") / "libmmlspark_native.so")
    subprocess.run(["g++", "-O3", "-fPIC", "-std=c++17", "-Wall", "-Wextra", "-shared", "-o",
                    out, os.path.join(root, "native", "mmlspark_native.cpp")],
                   check=True, capture_output=True, timeout=300)
    return native.load_library(out)


@pytest.fixture(scope="session")
def native_library(tmp_path_factory):
    return _build_native_library(tmp_path_factory)


@pytest.fixture(params=["native", "off"])
def ref(request, monkeypatch, native_library):
    """The reference's VW modules under one of its two hashing paths; the
    library reads ``MMLSPARK_TPU_NATIVE`` at each load."""
    import mmlspark_tpu.native as native
    import mmlspark_tpu.vw as jvw
    from mmlspark_tpu.data import sparse as jsparse
    from mmlspark_tpu.data.table import Table as JTable

    if request.param == "off":
        monkeypatch.setenv("MMLSPARK_TPU_NATIVE", "off")
        assert native.load_library() is None
    elif native_library is None:
        pytest.skip("no g++ to build the reference's host library")
    else:
        assert native.load_library() is not None
    return dict(vw=jvw, sparse=jsparse, Table=JTable)


@pytest.fixture(scope="module")
def golden():
    from test_vw_featurizer_golden import GOLDEN_CONFIGS, golden_table

    jt = golden_table()
    return {c: jt.column(c) for c in jt.columns}, GOLDEN_CONFIGS


def _corpus(n=300, seed=0):
    """Every column type: text with repeated tokens, unicode, non-ASCII
    whitespace (the Python-split fallback), empty and None rows; string
    arrays; maps; numbers; bools; dense vectors."""
    rng = np.random.default_rng(seed)
    words = np.array(["a", "bb", "ccc", "dddd", "eeeeeee", "héllo", "漢字", "x" * 70, "™"])
    seps = [" ", "  ", "\t", "\n", " ", "　", " "]
    text = np.empty(n, dtype=object)
    tags = np.empty(n, dtype=object)
    kv = np.empty(n, dtype=object)
    for i in range(n):
        k = rng.integers(0, 8)
        toks = list(words[rng.integers(0, len(words), size=k)])
        text[i] = None if i % 37 == 5 else "".join(
            t + seps[rng.integers(0, 4 if i % 3 else len(seps))] for t in toks)
        tags[i] = None if i % 29 == 3 else list(words[rng.integers(0, len(words), size=k % 4)])
        kv[i] = {f"k{j}": float(rng.normal()) for j in rng.integers(0, 6, size=k % 3)}
    return {
        "text": text, "tags": tags, "kv": kv,
        "num": rng.normal(size=n), "count": rng.integers(-5, 5, size=n).astype(np.int32),
        "flag": rng.random(n) > 0.5, "vec": rng.normal(size=(n, 4)),
    }


def _same_column(got, want):
    assert isinstance(got, tsparse.SparseRows)
    assert got.dim == want.dim
    for a in ("indices", "values", "indptr"):
        g, w = getattr(got, a), getattr(want, a)
        assert g.dtype == w.dtype and g.tobytes() == w.tobytes(), a


CONFIGS = {
    "split": dict(inputCols=["text"], stringSplit=True, numBits=18),
    "nosplit": dict(inputCols=["text"], stringSplit=False, numBits=18),
    "array": dict(inputCols=["tags"], numBits=18),
    "map": dict(inputCols=["kv"], numBits=10),
    "noprefix_seed": dict(inputCols=["text"], stringSplit=True, numBits=12,
                          prefixStringsWithColumnName=False, hashSeed=7),
    "nosum": dict(inputCols=["text", "tags"], stringSplit=True, numBits=6, sumCollisions=False),
    "lowbits_sum": dict(inputCols=["text", "tags"], stringSplit=True, numBits=4),
    "mixed": dict(inputCols=["num", "text", "vec", "flag", "kv", "count"], stringSplit=True,
                  numBits=18, hashSeed=3),
}


@pytest.mark.parametrize("cfg", sorted(CONFIGS))
def test_featurizer_columns_equal_the_references(ref, cfg):
    cols = _corpus()
    kw = dict(outputCol="features", **CONFIGS[cfg])
    got = VowpalWabbitFeaturizer(**kw).transform(Table(cols))
    want = ref["vw"].VowpalWabbitFeaturizer(**kw).transform(ref["Table"](cols))
    _same_column(got.column("features"), want.column("features"))
    assert got.metadata("features") == want.metadata("features") == {
        "sparse_dim": 1 << kw["numBits"]}


def test_featurizer_golden_configs_equal_the_references(ref, golden):
    cols, configs = golden
    for cfg, kw in configs.items():
        got = VowpalWabbitFeaturizer(outputCol="f", **kw).transform(Table(cols))
        want = ref["vw"].VowpalWabbitFeaturizer(outputCol="f", **kw).transform(ref["Table"](cols))
        _same_column(got.column("f"), want.column("f"))


def test_featurizer_reproduces_the_golden_fixture(golden):
    cols, configs = golden
    with open(GOLDEN, newline="") as f:
        rows = list(csv.DictReader(f))
    computed = []
    for cfg, kw in configs.items():
        col = VowpalWabbitFeaturizer(outputCol="f", **kw).transform(Table(cols)).column("f")
        for i in range(len(col)):
            idx, val = col[i]
            computed.append((cfg, str(i), " ".join(str(int(x)) for x in idx),
                             " ".join("%.9g" % float(v) for v in val)))
    assert [(r["cfg"], r["row"], r["indices"], r["values"]) for r in rows] == computed


def _featurized_pair(ref, cols, names, bits):
    t, jt = Table(cols), ref["Table"](cols)
    for name in names:
        kw = dict(inputCols=[name], outputCol="f_" + name, stringSplit=True, numBits=bits)
        t = VowpalWabbitFeaturizer(**kw).transform(t)
        jt = ref["vw"].VowpalWabbitFeaturizer(**kw).transform(jt)
    return t, jt


@pytest.mark.parametrize("names,sum_collisions", [(("text", "tags"), True),
                                                  (("text", "tags", "kv"), True),
                                                  (("text", "tags"), False)])
def test_interactions_equal_the_references(ref, names, sum_collisions):
    t, jt = _featurized_pair(ref, _corpus(n=120, seed=1), names, 8)
    kw = dict(inputCols=["f_" + n for n in names], outputCol="x", numBits=8,
              sumCollisions=sum_collisions)
    got = VowpalWabbitInteractions(**kw).transform(t)
    want = ref["vw"].VowpalWabbitInteractions(**kw).transform(jt)
    _same_column(got.column("x"), want.column("x"))
    assert got.metadata("x") == {"sparse_dim": 256}


def test_interactions_of_tuple_columns_and_their_errors(ref):
    rng = np.random.default_rng(2)
    cols = {}
    for name in ("a", "b"):
        col = np.empty(40, dtype=object)
        for i in range(40):
            k = rng.integers(0, 5)
            col[i] = (rng.integers(0, 64, size=k), rng.normal(size=k).astype(np.float32))
        cols[name] = col
    kw = dict(inputCols=["a", "b"], outputCol="x", numBits=6)
    got = VowpalWabbitInteractions(**kw).transform(Table(cols))
    want = ref["vw"].VowpalWabbitInteractions(**kw).transform(ref["Table"](cols))
    _same_column(got.column("x"), want.column("x"))
    with pytest.raises(ValueError, match="at least two"):
        VowpalWabbitInteractions(inputCols=["a"], outputCol="x").transform(Table(cols))


# -- the padded batch and its converters --------------------------------------------


def _csr(n, seed, ones, dup):
    rng = np.random.default_rng(seed)
    counts = rng.integers(0, 9, size=n)
    indptr = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
    idx = rng.integers(0, 24 if dup else 1 << 20, size=indptr[-1])
    val = (np.ones(indptr[-1]) if ones
           else rng.choice([0.0, 1.5, -1.5, 2.0], size=indptr[-1])).astype(np.float32)
    return idx, val, indptr


@pytest.mark.parametrize("ones,dup,sum_collisions", [
    (True, True, True), (True, True, False), (False, True, True), (False, True, False),
    (True, False, True), (False, False, True)])
def test_combine_csr_and_batches_equal_the_references(ref, ones, dup, sum_collisions):
    js = ref["sparse"]
    idx, val, indptr = _csr(200, seed=int(ones) * 2 + int(dup), ones=ones, dup=dup)
    got = tsparse.combine_csr(idx, val, indptr, sum_collisions)
    want = js.combine_csr(idx, val, indptr, sum_collisions)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.tobytes() == w.tobytes()
    lists = [idx[indptr[i]:indptr[i + 1]] for i in range(200)]
    vals = [val[indptr[i]:indptr[i + 1]] for i in range(200)]
    a = tsparse.from_lists(lists, vals, 1 << 20, sum_collisions, pad_to=3)
    b = js.from_lists(lists, vals, 1 << 20, sum_collisions, pad_to=3)
    assert a.indices.tobytes() == b.indices.tobytes() and a.values.tobytes() == b.values.tobytes()
    a = tsparse.SparseBatch.from_csr(*got, dim=1 << 20)
    b = js.SparseBatch.from_csr(*want, dim=1 << 20)
    assert a.indices.tobytes() == b.indices.tobytes() and a.values.tobytes() == b.values.tobytes()
    assert (a.num_rows, a.max_active) == (b.num_rows, b.max_active)
    col = tsparse.batch_to_column(a)
    jcol = js.batch_to_column(b)
    for (gi, gv), (wi, wv) in zip(col, jcol):
        assert gi.tobytes() == wi.tobytes() and gv.tobytes() == wv.tobytes()
    c = tsparse.column_to_batch(col, 1 << 20)
    assert c.indices.tobytes() == js.column_to_batch(jcol, 1 << 20).indices.tobytes()


def test_dense_batches_equal_the_references(ref):
    js = ref["sparse"]
    dense = np.random.default_rng(3).normal(size=(7, 5)).astype(np.float32)
    a, b = tsparse.dense_to_batch(dense, 8), js.dense_to_batch(dense, 8)
    assert a.indices.tobytes() == b.indices.tobytes() and a.values.tobytes() == b.values.tobytes()
    assert a.to_dense().tobytes() == b.to_dense().tobytes()
    with pytest.raises(ValueError, match="must exceed"):
        tsparse.dense_to_batch(dense, 5)
    rows = tsparse.SparseRows(*tsparse.combine_csr(*_csr(30, 4, True, True)), dim=24)
    jrows = js.SparseRows(rows.indices, rows.values, rows.indptr, 24)
    a, b = tsparse.column_to_batch(rows, 24), js.column_to_batch(jrows, 24)
    assert a.indices.tobytes() == b.indices.tobytes() and a.to_dense().tobytes() == \
        b.to_dense().tobytes()
