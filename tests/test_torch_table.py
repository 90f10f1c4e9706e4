"""The port's Table (mmlspark_tpu_torch.data.table) against the JAX
package's: every public method and function of the reference's, on the same
seeded columns, with no tolerance (host numpy on both sides).
"""

import inspect

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

import mmlspark_tpu_torch.data.table as ttable
from mmlspark_tpu_torch.data.table import Table, find_unused_column_name, row_as_json_dict


@pytest.fixture(scope="module")
def ref():
    import mmlspark_tpu.data.table as jtable

    return jtable


def _cols(n=40, seed=0):
    """Numeric, vector, string (with None), object-scalar and ragged columns."""
    rng = np.random.default_rng(seed)
    words = np.array([f"w{i}" for i in rng.integers(0, 6, n)], dtype=object)
    words[::7] = None
    mixed = np.empty(n, dtype=object)
    mixed[:] = [np.float64(v) if i % 3 else np.int64(i) for i, v in enumerate(rng.normal(size=n))]
    ragged = np.empty(n, dtype=object)
    ragged[:] = [list(range(int(k))) for k in rng.integers(0, 4, n)]
    return {"x": rng.normal(size=n), "i": np.arange(n), "vec": rng.normal(size=(n, 3)),
            "words": words, "mixed": mixed, "ragged": ragged}


def _pair(ref, **kw):
    cols = _cols(**kw)
    return Table(cols), ref.Table(cols)


def assert_same(got, want):
    assert type(got).__name__ == type(want).__name__ == "Table"
    assert got.columns == want.columns and got.num_rows == want.num_rows
    assert got.num_partitions == want.num_partitions
    assert got.partition_bounds() == want.partition_bounds()
    for name in want.columns:
        a, b = got[name], want[name]
        assert a.dtype == b.dtype and a.shape == b.shape, name
        if a.dtype == object:
            assert [repr(v) for v in a] == [repr(v) for v in b], name
        else:
            np.testing.assert_array_equal(a, b)
        assert got.metadata(name) == want.metadata(name)


def test_every_public_name_of_the_reference_is_ported(ref):
    want = {n for n, v in vars(ref.Table).items() if not n.startswith("_")}
    assert want <= {n for n in vars(Table) if not n.startswith("_")}
    funcs = {n for n, v in vars(ref).items() if inspect.isfunction(v) and not n.startswith("_")
             and v.__module__ == ref.__name__}
    assert funcs == {"row_as_json_dict", "find_unused_column_name"}
    assert all(callable(getattr(ttable, f)) for f in funcs)


_OPS = [
    ("select", lambda t: t.select("words", "x")),
    ("drop", lambda t: t.drop("vec", "ragged")),
    ("rename", lambda t: t.rename("words", "w").rename("x", "y")),
    ("take", lambda t: t.take([5, 0, 3, 3, 39])),
    ("head", lambda t: t.head()),
    ("head11", lambda t: t.head(11)),
    ("slice", lambda t: t.slice(4, 19)),
    ("filter", lambda t: t.filter(t["x"] > 0)),
    ("sort_desc", lambda t: t.sort_by("x", ascending=False)),
    ("sort_asc", lambda t: t.sort_by("i")),
    ("sample", lambda t: t.sample(0.3, seed=5)),
    ("sample_default_seed", lambda t: t.sample(0.9)),
    ("repartition", lambda t: t.repartition(3)),
    ("coalesce_down", lambda t: t.repartition(4).coalesce(2)),
    ("coalesce_up", lambda t: t.repartition(2).coalesce(8)),
    ("partition_sizes", lambda t: t.with_partition_sizes([10, 0, 30])),
    ("sizes_kept_by_with_column", lambda t: t.with_partition_sizes([10, 30]).with_column("z", np.zeros(40))),
    ("sizes_dropped_by_take", lambda t: t.with_partition_sizes([10, 30]).take(np.arange(39))),
    ("sizes_dropped_by_repartition", lambda t: t.with_partition_sizes([10, 30]).repartition(3)),
    ("metadata_rename", lambda t: t.with_metadata("words", {"categorical": True, "levels": ["a"]}).rename("words", "v")),
    ("metadata_select", lambda t: t.with_metadata("words", {"categorical": True}).select("words")),
    ("with_columns", lambda t: t.with_columns({"a": np.ones(40),
                                                "b": [str(i) for i in range(40)]})),
]


@pytest.mark.parametrize("op", [f for _, f in _OPS], ids=[n for n, _ in _OPS])
def test_derived_tables_equal_the_references(ref, op):
    got, want = _pair(ref)
    assert_same(op(got), op(want))


@pytest.mark.parametrize("weights,seed", [([0.5, 0.5], 1), ([1, 2, 3], 7), ([0.1, 0.9], 0)])
def test_random_split_gives_the_references_rows(ref, weights, seed):
    got, want = _pair(ref, n=200, seed=3)
    a, b = got.random_split(weights, seed=seed), want.random_split(weights, seed=seed)
    assert len(a) == len(b) == len(weights)
    for x, y in zip(a, b):
        assert_same(x, y)
    assert_same(Table.concat(a), ref.Table.concat(b))


def test_partitions_schema_rows_and_json(ref):
    got, want = _pair(ref)
    for g, w in ((got, want), (got.repartition(3), want.repartition(3)),
                 (got.with_partition_sizes([7, 33]), want.with_partition_sizes([7, 33]))):
        gp, wp = list(g.partitions()), list(w.partitions())
        assert len(gp) == len(wp)
        for x, y in zip(gp, wp):
            assert_same(x, y)
    assert got.schema == want.schema
    for gr, wr in zip(got.rows(), want.rows()):
        assert list(gr) == list(wr) and [repr(v) for v in gr.values()] == \
            [repr(v) for v in wr.values()]
    for row in (0, 7, 13, 39):
        assert row_as_json_dict(got, row, exclude=("ragged",)) == \
            ref.row_as_json_dict(want, row, exclude=("ragged",))
    import json

    json.dumps(row_as_json_dict(got, 3))
    assert find_unused_column_name("words", got) == "words_1"
    with pytest.raises(ValueError, match="sum to"):
        got.with_partition_sizes([1, 2])
    with pytest.raises(KeyError):
        got.select("nope")
    with pytest.raises(KeyError):
        got.rename("nope", "x")


def test_pandas_round_trip_equals_the_references(ref):
    pd = pytest.importorskip("pandas")
    got, want = _pair(ref)
    gdf, wdf = got.to_pandas(), want.to_pandas()
    pd.testing.assert_frame_equal(gdf, wdf)
    assert_same(Table.from_pandas(gdf, num_partitions=2),
                ref.Table.from_pandas(wdf, num_partitions=2))
