"""The port's featurizers (mmlspark_tpu_torch.featurize) against the JAX
package's: ValueIndexer, IndexToValue, CleanMissingData, DataConversion,
AssembleFeatures, Featurize, TextFeaturizer, MultiNGram, PageSplitter and
hashing_tf on the same seeded tables, object columns holding None, NaN and
numpy scalars among them. Output columns, metadata and ``transform_schema``
equal the reference's with no tolerance (host numpy on both sides); a
fitted PipelineModel of featurizers moves between the packages.
"""

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

from mmlspark_tpu_torch import featurize as tf
from mmlspark_tpu_torch.core.pipeline import Estimator, PipelineModel, PipelineStage
from mmlspark_tpu_torch.core.schema import schema_of_table
from mmlspark_tpu_torch.data.table import Table


@pytest.fixture(scope="module")
def ref():
    import mmlspark_tpu.core.pipeline as jpipeline
    import mmlspark_tpu.featurize as jf
    from mmlspark_tpu.core.schema import schema_of_table as jschema
    from mmlspark_tpu.data.table import Table as JTable

    return types.SimpleNamespace(featurize=jf, Table=JTable, schema=jschema,
                                 pipeline=jpipeline)


def _objects(rng, n, pool):
    out = np.empty(n, dtype=object)
    out[:] = [pool[i] for i in rng.integers(0, len(pool), n)]
    return out


def _mixed(n=60, seed=0):
    rng = np.random.default_rng(seed)
    pool = ["red", "green", "blue", None, float("nan"), np.float64(2.5), np.int64(3), 7, "ünï",
            "", "Red"]
    text = np.empty(n, dtype=object)
    text[:] = [None if i % 11 == 0 else f"Word{i % 37} common Tokens {i % 7} x{rng.integers(9)}"
               for i in range(n)]
    ragged = np.empty(n, dtype=object)
    ragged[:] = [rng.normal(size=3) for _ in range(n)]
    tokens = np.empty(n, dtype=object)
    tokens[:] = [[f"t{j}" for j in rng.integers(0, 9, rng.integers(0, 5))] for _ in range(n)]
    return {
        "num": rng.normal(size=n),
        "with_nan": np.where(rng.random(n) < 0.2, np.nan, rng.normal(size=n)),
        "ints": rng.integers(0, 5, n),
        "flag": rng.random(n) < 0.5,
        "f32": rng.normal(size=n).astype(np.float32),
        "cat": _objects(rng, n, pool),
        "text": text,
        "vec": rng.normal(size=(n, 3)),
        "objvec": ragged,
        "tokens": tokens,
        "dates": np.array([f"2020-01-{d:02d}" for d in rng.integers(1, 29, n)], dtype=object),
    }


def _same(got, want):
    assert got.columns == want.columns and got.num_rows == want.num_rows
    for name in want.columns:
        a, b = got[name], want[name]
        assert a.dtype == b.dtype and a.shape == b.shape, name
        if a.dtype == object:
            assert [repr(v) for v in a] == [repr(v) for v in b], name
        else:
            np.testing.assert_array_equal(a, b, err_msg=name)
        assert got.metadata(name) == want.metadata(name), name


def _schema(s):
    return {k: (v.dtype, v.shape) for k, v in s.items()}


def _parity(ref, make, fit_cols, apply_cols=None):
    """``make(featurize module)`` in both packages: fit on ``fit_cols`` (an
    estimator), transform ``apply_cols``; outputs, metadata and both
    stages' ``transform_schema`` must equal the reference's."""
    apply_cols = fit_cols if apply_cols is None else apply_cols
    stages = {}
    for key, mod, T, schema in (("port", tf, Table, schema_of_table),
                                ("ref", ref.featurize, ref.Table, ref.schema)):
        stage = make(mod)
        fitted = stage.fit(T(fit_cols)) if isinstance(stage, (Estimator, ref.pipeline.Estimator)) \
            else stage
        src = schema(T(apply_cols))
        stages[key] = (fitted.transform(T(apply_cols)), _schema(stage.transform_schema(src)),
                       _schema(fitted.transform_schema(src)), fitted)
    _same(stages["port"][0], stages["ref"][0])
    assert stages["port"][1] == stages["ref"][1]
    assert stages["port"][2] == stages["ref"][2]
    return stages["port"][3], stages["ref"][3]


_CASES = {
    "indexer_objects": lambda m: m.ValueIndexer(inputCol="cat", outputCol="idx"),
    "indexer_in_place": lambda m: m.ValueIndexer(inputCol="cat", outputCol="cat"),
    "indexer_ints": lambda m: m.ValueIndexer(inputCol="ints", outputCol="idx"),
    "indexer_nan_floats": lambda m: m.ValueIndexer(inputCol="with_nan", outputCol="idx"),
    "indexer_bools": lambda m: m.ValueIndexer(inputCol="flag", outputCol="idx"),
    "indexer_float32": lambda m: m.ValueIndexer(inputCol="f32", outputCol="idx"),
    "clean_mean": lambda m: m.CleanMissingData(inputCols=["with_nan", "num"]),
    "clean_median": lambda m: m.CleanMissingData(inputCols=["with_nan"], outputCols=["c"],
                                                 cleaningMode="Median"),
    "clean_custom": lambda m: m.CleanMissingData(inputCols=["with_nan", "cat", "ints"],
                                                 cleaningMode="Custom", customValue=-1),
    "assemble": lambda m: m.AssembleFeatures(inputCols=["num", "vec", "flag", "ints", "objvec"]),
    "featurize": lambda m: m.Featurize(
        inputCols=["num", "with_nan", "ints", "flag", "cat", "text", "vec", "objvec"],
        numberOfFeatures=64),
    "featurize_indexed": lambda m: m.Featurize(inputCols=["cat", "text", "num"],
                                               oneHotEncodeCategoricals=False, outputCol="f"),
    "featurize_replaces": lambda m: m.Featurize(inputCols=["num", "cat"], outputCol="num"),
    "text_idf": lambda m: m.TextFeaturizer(inputCol="text", outputCol="tf", numFeatures=128),
    "text_ngrams_binary": lambda m: m.TextFeaturizer(
        inputCol="text", outputCol="tf", numFeatures=64, useNGram=True, nGramLength=3,
        binary=True, useIDF=False, minTokenLength=2),
    "text_min_doc_freq": lambda m: m.TextFeaturizer(
        inputCol="text", outputCol="tf", numFeatures=32, minDocFreq=3, toLowercase=False,
        tokenizerPattern=r"[\s\d]+"),
    "text_token_lists": lambda m: m.TextFeaturizer(inputCol="tokens", outputCol="tf",
                                                   numFeatures=16),
    "text_no_tokenizer": lambda m: m.TextFeaturizer(inputCol="cat", outputCol="tf",
                                                    numFeatures=16, useTokenizer=False),
    "multi_ngram": lambda m: m.MultiNGram(inputCol="tokens", outputCol="g", lengths=[1, 2, 3]),
    "page_splitter": lambda m: m.PageSplitter(inputCol="text", outputCol="pages",
                                              maximumPageLength=12, minimumPageLength=8),
}


@pytest.mark.parametrize("case", sorted(_CASES))
def test_stage_equals_the_reference(ref, case):
    """Fitted on one table, applied to another with unseen values."""
    _parity(ref, _CASES[case], _mixed(seed=0), _mixed(n=45, seed=1))


@pytest.mark.parametrize("target", ["boolean", "byte", "short", "integer", "long", "float",
                                    "double", "string", "toCategorical", "date"])
def test_data_conversion_equals_the_reference(ref, target):
    cols = _mixed()
    col = {"toCategorical": "cat", "string": "cat", "date": "dates"}.get(target, "num")
    make = lambda m: m.DataConversion(inputCols=[col, "ints"] if target != "date" else [col],  # noqa: E731
                                      convertTo=target)
    _parity(ref, make, cols)
    fmt = lambda m: m.DataConversion(inputCols=["dates"], convertTo="date",  # noqa: E731
                                     dateTimeFormat="%Y-%m-%d")
    _parity(ref, fmt, cols)


def test_index_round_trip_and_clear_categorical(ref):
    cols = _mixed()
    for T, mod in ((Table, tf), (ref.Table, ref.featurize)):
        out = mod.ValueIndexer(inputCol="cat", outputCol="idx").fit(T(cols)).transform(T(cols))
        back = mod.IndexToValue(inputCol="idx", outputCol="orig").transform(out)
        cleared = mod.DataConversion(inputCols=["idx"], convertTo="clearCategorical"
                                     ).transform(out)
        numeric = mod.ValueIndexer(inputCol="ints", outputCol="i").fit(T(cols)).transform(T(cols))
        decoded = mod.IndexToValue(inputCol="i", outputCol="v").transform(numeric)
        if mod is tf:
            got = (back, cleared, decoded)
        else:
            want = (back, cleared, decoded)
    for g, w in zip(got, want):
        _same(g, w)
    assert tf.decode_levels(np.array([-1, 0, 1, 5]), ["a", "b"]).tolist() == [None, "a", "b", None]
    np.testing.assert_array_equal(tf.decode_levels(np.array([0, 3]), [2.5, 4.0]), [2.5, np.nan])
    with pytest.raises(ValueError, match="levels metadata"):
        tf.IndexToValue(inputCol="num", outputCol="v").transform(Table(cols))


@pytest.mark.parametrize("distinct,repeats", [(100, 2), (101, 2), (30, 1), (3, 1), (1, 1)])
def test_featurize_plan_rule_is_the_references(ref, distinct, repeats):
    """Categorical up to 100 distinct strings that repeat, text beyond."""
    values = np.array([f"v{i % distinct}" for i in range(distinct * repeats)], dtype=object)
    cols = {"s": values}
    port, want = _parity(ref, lambda m: m.Featurize(inputCols=["s"], numberOfFeatures=16), cols)
    assert port.getPlans() == want.getPlans()


@pytest.mark.parametrize("docs", [[["a", "b", "a"], [], ["é™", "", "🎉", "a"]], [[], []],
                                  [[f"t{i}" for i in range(300)]]])
@pytest.mark.parametrize("binary", [False, True])
def test_hashing_tf_equals_the_reference(ref, docs, binary):
    from mmlspark_tpu.featurize.text import hashing_tf as jhashing_tf

    np.testing.assert_array_equal(tf.hashing_tf(docs, 64, binary), jhashing_tf(docs, 64, binary))
    with pytest.raises(ValueError, match="power of two"):
        tf.hashing_tf(docs, 48)


def test_pipeline_of_featurizers_moves_between_the_packages(ref, tmp_path):
    """A fitted PipelineModel of featurizers saved by either package loads
    and scores in the other."""
    cols = _mixed()
    stages = lambda m: [m.CleanMissingData(inputCols=["with_nan"], outputCols=["clean"]),  # noqa: E731
                        m.ValueIndexer(inputCol="cat", outputCol="idx"),
                        m.TextFeaturizer(inputCol="text", outputCol="tf", numFeatures=32),
                        m.Featurize(inputCols=["clean", "idx", "cat", "text"], outputCol="f",
                                    numberOfFeatures=32)]

    def fit(pipeline_mod, mod, T):
        model, t = [], T(cols)
        for st in stages(mod):
            m = st.fit(t)
            t = m.transform(t)
            model.append(m)
        return pipeline_mod.PipelineModel(stages=model)

    port = fit(__import__("mmlspark_tpu_torch.core.pipeline", fromlist=["x"]), tf, Table)
    jref = fit(ref.pipeline, ref.featurize, ref.Table)
    port.save(str(tmp_path / "port"))
    jref.save(str(tmp_path / "ref"))
    from_ref = PipelineStage.load(str(tmp_path / "ref"))
    from_port = ref.pipeline.PipelineStage.load(str(tmp_path / "port"))
    assert isinstance(from_ref, PipelineModel)
    _same(from_ref.transform(Table(cols)), jref.transform(ref.Table(cols)))
    _same(port.transform(Table(cols)), from_port.transform(ref.Table(cols)))
