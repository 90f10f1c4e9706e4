"""Sparse (CSR) input of the port (mmlspark_tpu_torch) against the JAX package.

The same rows, made from numpy seeds, go through both packages on the CPU:
CSR matrices and sparse columns, the CSR bin mapper and bins (bit for bit),
and estimator fits on a sparse features column, whose quantized model text
must be the reference's byte for byte and whose default-path text must
equal the port's own dense fit on the same rows.
"""

import numpy as np
import pytest
import torch

from mmlspark_tpu_torch.data import sparse as tsparse
from mmlspark_tpu_torch.data.sparse import CSRMatrix, SparseRows
from mmlspark_tpu_torch.data.table import Table
from mmlspark_tpu_torch.lightgbm import (
    LightGBMClassifier,
    LightGBMRanker,
    LightGBMRegressor,
)
from mmlspark_tpu_torch.lightgbm import binning as tbinning
from mmlspark_tpu_torch.lightgbm import objectives
from mmlspark_tpu_torch.lightgbm.base import extract_features
from mmlspark_tpu_torch.lightgbm.convert import bin_mapper_from_jax


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

QUANT = {"histogram_method": "u", "use_quantized_grad": True}


@pytest.fixture(scope="module")
def ref():
    import mmlspark_tpu.data.sparse as jsparse
    import mmlspark_tpu.lightgbm.binning as jbinning
    from mmlspark_tpu.data.table import Table as JTable
    from mmlspark_tpu.lightgbm import LightGBMClassifier as JClassifier
    from mmlspark_tpu.lightgbm.procfit import model_texts_close

    return dict(sparse=jsparse, binning=jbinning, Table=JTable, Classifier=JClassifier,
                texts_close=model_texts_close)


def _sparse_dense(seed, n, f, density=0.3, nan_frac=0.02):
    """A mostly-zero matrix: normal values at ``density``, NaN cells."""
    rng = np.random.default_rng(seed)
    dense = np.zeros((n, f))
    mask = rng.random((n, f)) < density
    dense[mask] = np.round(rng.normal(size=int(mask.sum())), 2)
    dense[rng.random((n, f)) < nan_frac] = np.nan
    return dense


def _one_hot(seed, n):
    """One-hot blocks that bundle without conflicts, a column whose default
    bin is not its zero's, a rare numeric, a NaN-or-zero column and a dense
    numeric."""
    rng = np.random.default_rng(seed)
    cat = rng.integers(0, 6, n)
    d = np.zeros((n, 10))
    d[np.arange(n), cat] = 1.0
    d[:, 6] = np.where(cat == 1, 0.0, 2.0)
    d[:, 7] = np.where(cat == 2, rng.normal(size=n), 0.0)
    d[:, 8] = rng.normal(size=n)
    d[:, 9] = np.where(cat == 3, np.nan, 0.0)
    return d


def _sparse_column(dense):
    """``dense`` as a SparseRows column (float32 values) and the dense
    matrix it stands for."""
    c = CSRMatrix.from_dense(dense)
    col = SparseRows(c.indices, c.data, c.indptr, dense.shape[1])
    return col, CSRMatrix(col.values, col.indices, col.indptr, c.shape).to_dense()


def _tuple_column(dense):
    col = np.empty(len(dense), dtype=object)
    for i, row in enumerate(dense):
        nz = np.flatnonzero((row != 0) | np.isnan(row))
        col[i] = (nz, row[nz])
    return col


def _classifier_case(seed, n=2000, f=12):
    rng = np.random.default_rng(seed + 100)
    dense = _sparse_dense(seed, n, f, density=0.35, nan_frac=0.0)
    y = (np.nan_to_num(dense[:, 0]) + np.nan_to_num(dense[:, 1] * dense[:, 2])
         + 0.5 * rng.normal(size=n) > 0).astype(np.float64)
    w = rng.uniform(0.5, 2.0, n)
    return dense, y, w


# -- CSR matrices and sparse columns -----------------------------------------------


def test_csr_round_trips_and_csc_equal_the_reference(ref):
    dense = _sparse_dense(0, 60, 7)
    t, j = CSRMatrix.from_dense(dense), ref["sparse"].CSRMatrix.from_dense(dense)
    for a, b in ((t.data, j.data), (t.indices, j.indices), (t.indptr, j.indptr)):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    np.testing.assert_array_equal(t.to_dense(), dense)
    for a, b in zip(t.to_csc(), j.to_csc()):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    idx = np.array([3, 1, 59, 7, 7])
    mask = np.random.default_rng(1).random(60) < 0.5
    for got, want in ((t.take_rows(idx), j.take_rows(idx)), (t.take_rows(mask), j.take_rows(mask)),
                      (t.row_slice(10, 25), j.row_slice(10, 25))):
        np.testing.assert_array_equal(got.to_dense(), want.to_dense())
        assert got.indptr.tolist() == want.indptr.tolist() and got.shape == want.shape
    import scipy.sparse

    sp = scipy.sparse.csr_matrix(np.nan_to_num(dense))
    np.testing.assert_array_equal(CSRMatrix.from_scipy(sp).to_dense(), sp.toarray())
    rows = [(np.array([0, 3]), np.array([1.0, 2.0])), (np.array([], np.int64), np.array([])),
            (np.array([1]), np.array([-4.0]))]
    assert CSRMatrix.from_rows(rows, 5).to_dense().tolist() == \
        ref["sparse"].CSRMatrix.from_rows(rows, 5).to_dense().tolist()
    with pytest.raises(ValueError, match="out of range"):
        CSRMatrix.from_rows(rows, num_features=3)


def test_sparse_rows_column_matches_the_reference(ref):
    dense = _sparse_dense(2, 40, 9, nan_frac=0.0)
    c = CSRMatrix.from_dense(dense)
    t = SparseRows(c.indices, c.data, c.indptr, 9)
    j = ref["sparse"].SparseRows(c.indices, c.data, c.indptr, 9)
    for key in (5, -1, slice(3, 17), slice(1, 30, 4), np.array([9, 2, 2, 31]),
                np.random.default_rng(3).random(40) < 0.4):
        got, want = t[key], j[key]
        if isinstance(got, tuple):
            assert got[0].tolist() == want[0].tolist() and got[1].tolist() == want[1].tolist()
        else:
            assert isinstance(got, SparseRows)
            assert got.indptr.tolist() == want.indptr.tolist()
            assert got.indices.tolist() == want.indices.tolist()
    both = SparseRows.concat([t[:10], t[10:]])
    assert both.indptr.tolist() == t.indptr.tolist() and both.values.tolist() == t.values.tolist()
    assert tsparse.is_sparse_column(t) and tsparse.is_sparse_column(_tuple_column(dense))
    assert not tsparse.is_sparse_column(np.zeros(3))
    np.testing.assert_array_equal(tsparse.csr_column_to_matrix(_tuple_column(dense), 9).to_dense(),
                                  dense)
    with pytest.raises(ValueError, match="out of range"):
        tsparse.csr_column_to_matrix(t, num_features=4)


def test_table_keeps_sparse_rows_through_filter_sort_and_concat(ref):
    dense = _sparse_dense(5, 30, 6, nan_frac=0.0)
    col, _ = _sparse_column(dense)
    key = np.random.default_rng(6).integers(0, 4, 30)
    t = Table({"features": col, "key": key})
    j = ref["Table"]({"features": ref["sparse"].SparseRows(col.indices, col.values, col.indptr, 6),
                      "key": key})
    for got, want in ((t.filter(key > 1), j.filter(key > 1)),
                      (t.sort_by("key"), j.sort_by("key")),
                      (Table.concat([t, t.filter(key == 0)]),
                       ref["Table"].concat([j, j.filter(key == 0)]))):
        assert isinstance(got["features"], SparseRows)
        assert got["features"].indptr.tolist() == want["features"].indptr.tolist()
        assert got["features"].indices.tolist() == want["features"].indices.tolist()
        assert got["key"].tolist() == want["key"].tolist()
    mixed = Table.concat([t, Table({"features": _tuple_column(dense), "key": key})])
    assert mixed["features"].dtype == object and len(mixed["features"]) == 60
    listed = Table({"features": list(_tuple_column(dense))})
    assert tsparse.is_sparse_column(listed["features"])


# -- binning ------------------------------------------------------------------------


@pytest.mark.parametrize("max_bin", [15, 63, 255])
@pytest.mark.parametrize("sampled", [False, True])
def test_csr_mapper_is_bit_equal(ref, max_bin, sampled):
    n = 3000
    dense = _sparse_dense(7 + max_bin, n, 8, density=0.45)
    rng = np.random.default_rng(max_bin)
    dense[:, 5] = rng.choice([0.0, 1.0, 2.5, -3.0], size=n)  # one bin per value
    dense[:, 6] = np.where(rng.random(n) < 0.5, 0.0, rng.integers(1, 40, n))  # categorical
    dense[rng.random(n) < 0.05, 6] = np.nan
    dense[:4, 7] = np.nan  # a NaN-only-or-zero column
    dense[4:, 7] = 0.0
    csr = CSRMatrix.from_dense(dense)
    csr.data[::11] = 0.0  # explicit zeros
    dense = csr.to_dense()
    kw = dict(max_bin=max_bin, sample_cnt=1000 if sampled else 200_000, seed=3,
              categorical_features=[6])
    mt = tbinning.fit_bin_mapper_csr(csr, **kw)
    mj = ref["binning"].fit_bin_mapper_csr(ref["sparse"].CSRMatrix.from_dense(dense), **kw)
    md = tbinning.fit_bin_mapper(dense, **kw)
    for m in (mj, md):
        assert mt.edges.tobytes() == m.edges.tobytes()
        assert mt.num_bins.tolist() == m.num_bins.tolist()
        assert sorted(mt.cat_values) == sorted(m.cat_values)
        assert all(mt.cat_values[k].tobytes() == m.cat_values[k].tobytes() for k in mt.cat_values)


@pytest.mark.parametrize("case", ["sparse", "one_hot", "duplicates"])
@pytest.mark.parametrize("bundled", [False, True])
def test_csr_bins_are_bit_equal(ref, case, bundled):
    if case == "duplicates":  # two explicit entries in one cell: the later one wins
        rows = [(np.array([0, 0, 3]), np.array([1.0, 0.0, 2.0])),
                (np.array([1, 1]), np.array([0.0, 5.0])), (np.array([2]), np.array([1.0]))] * 300
        t, j = CSRMatrix.from_rows(rows, 5), ref["sparse"].CSRMatrix.from_rows(rows, 5)
        dense = None
    else:
        dense = _sparse_dense(8, 2500, 9) if case == "sparse" else _one_hot(9, 2500)
        t, j = CSRMatrix.from_dense(dense), ref["sparse"].CSRMatrix.from_dense(dense)
    kw = dict(max_bin=31, sample_cnt=1500, feature_bundling=bundled,
              categorical_features=[8] if case == "one_hot" else None)
    bt, mt = tbinning.bin_dataset(t, **kw)
    bj, mj = ref["binning"].bin_dataset(j, **kw)
    assert bt.shape == np.asarray(bj).shape and bt.tobytes() == np.asarray(bj).tobytes()
    assert (mt.bundles is None) == (mj.bundles is None)
    if bundled and case != "sparse":
        assert mt.bundles is not None and mt.bundles.num_columns < t.num_features
    assert tbinning.apply_bins_csr(t, mt).tobytes() == bt.tobytes()
    carried = bin_mapper_from_jax(mj.edges, mj.num_bins, mj.max_bin, mj.cat_values, mj.bundles)
    assert tbinning.apply_bins_csr(t, carried).tobytes() == bt.tobytes()
    if dense is not None:
        bd, _ = tbinning.bin_dataset(dense, **kw)
        assert bd.tobytes() == bt.tobytes()


def test_csr_refuses_max_bin_by_feature():
    with pytest.raises(ValueError, match="maxBinByFeature"):
        tbinning.bin_dataset(CSRMatrix.from_dense(np.eye(3)), max_bin=15,
                             max_bin_by_feature=[4, 4, 4])


# -- estimator fits on sparse columns --------------------------------------------


class QuantizedClassifier(LightGBMClassifier):
    """The classifier on the quantized U path (not an estimator param)."""

    def _extra_train_options(self):
        return dict(QUANT)


def test_sparse_fit_writes_the_reference_and_the_dense_model_text(ref):
    dense, y, w = _classifier_case(10)
    col, dense32 = _sparse_column(dense)
    params = dict(numIterations=5, numLeaves=15, maxBin=63, weightCol="w", featureBundling=True)
    sparse_t = Table({"features": col, "label": y, "w": w})
    port = LightGBMClassifier(device="cpu", **params).fit(sparse_t).get_model_string()
    dense_port = LightGBMClassifier(device="cpu", **params).fit(
        Table({"features": dense32, "label": y, "w": w})).get_model_string()
    assert port == dense_port
    jcol = ref["sparse"].SparseRows(col.indices, col.values, col.indptr, col.dim)
    jt = ref["Table"]({"features": jcol, "label": y, "w": w})
    want = ref["Classifier"](parallelism="serial", **params).fit(jt).get_model_string()
    assert ref["texts_close"](port, want)

    class JQuantized(ref["Classifier"]):
        def _extra_train_options(self):
            return dict(QUANT)

    quant = QuantizedClassifier(device="cpu", **params).fit(sparse_t).get_model_string()
    assert quant == JQuantized(parallelism="serial", **params).fit(jt).get_model_string()


def test_sparse_regressor_and_ranker_equal_their_dense_fits():
    dense, y, w = _classifier_case(11, n=1500)
    col, dense32 = _sparse_column(dense)
    target = np.nan_to_num(dense32[:, 0]) * 3 + np.nan_to_num(dense32[:, 3]) + y
    group = np.repeat(np.arange(75), 20)[np.random.default_rng(12).permutation(1500)]
    for est, extra in ((LightGBMRegressor(objective="huber", device="cpu", numIterations=4,
                                          numLeaves=7, maxBin=31), {"label": target}),
                       (LightGBMRanker(groupCol="g", device="cpu", numIterations=4, numLeaves=7,
                                       maxBin=31, minDataInLeaf=5),
                        {"label": np.minimum(y * 2 + (dense32[:, 1] > 0), 3), "g": group})):
        sparse_m = est.fit(Table({"features": col, **extra}))
        dense_m = est.fit(Table({"features": dense32, **extra}))
        assert sparse_m.get_model_string() == dense_m.get_model_string()
        got = sparse_m.transform(Table({"features": col}))["prediction"]
        assert np.array_equal(got, dense_m.transform(Table({"features": dense32}))["prediction"])


def test_sparse_validation_and_warm_start_equal_their_dense_fits():
    dense, y, w = _classifier_case(13, n=1800)
    col, dense32 = _sparse_column(dense)
    valid = np.random.default_rng(14).random(1800) < 0.25
    params = dict(device="cpu", numIterations=6, numLeaves=7, maxBin=31,
                  validationIndicatorCol="v", earlyStoppingRound=2, metric="auc")
    texts = []
    for feats in (col, dense32):
        first = LightGBMClassifier(**params).fit(Table({"features": feats, "label": y, "v": valid}))
        more = LightGBMClassifier(device="cpu", numIterations=3, numLeaves=7, maxBin=31,
                                  modelString=first.get_model_string())
        texts.append((first.get_model_string(), first._train_evals,
                      more.fit(Table({"features": feats, "label": y})).get_model_string()))
    assert texts[0] == texts[1]
    # a warm start from a model trained wider than the new batch's explicit columns
    narrow = SparseRows(col.indices[col.indices < 5], col.values[col.indices < 5],
                        np.concatenate([[0], np.cumsum([np.sum(col[i][0] < 5)
                                                        for i in range(len(col))])]), 5)
    more = LightGBMClassifier(device="cpu", numIterations=2, numLeaves=7, maxBin=31,
                              modelString=texts[0][0])
    assert more.fit(Table({"features": narrow, "label": y})).booster.num_features == 12


def test_sparse_predict_leaf_and_shap_equal_the_dense_input():
    dense, y, w = _classifier_case(15, n=1200, f=10)
    dense[:, 9] = np.where(dense[:, 9] != 0, np.random.default_rng(16).integers(1, 9, 1200), 0)
    dense[::50, 9] = 2.0**25 + 1  # a category id float32 cannot hold
    y = ((dense[:, 0] > 0) ^ np.isin(dense[:, 9], [2, 5, 7, 2.0**25 + 1])).astype(np.float64)
    col, dense32 = _sparse_column(dense)
    dense64 = dense.copy()
    rows = [(np.flatnonzero(r != 0), r[r != 0]) for r in dense64]
    for cats, feats, X in (([], col, dense32), ([9], _tuple_column(dense64), dense64)):
        model = LightGBMClassifier(device="cpu", numIterations=4, numLeaves=7, maxBin=31,
                                   categoricalSlotIndexes=cats, leafPredictionCol="leaf",
                                   featuresShapCol="shap").fit(
            Table({"features": feats, "label": y}))
        b = model.booster
        got = model.transform(Table({"features": feats}))
        want = model.transform(Table({"features": X}))
        for name in ("probability", "leaf", "shap"):
            assert np.array_equal(got[name], want[name]), name
        assert b.has_categorical == bool(cats)
        csr = CSRMatrix.from_rows(rows, 10)
        assert np.array_equal(b.raw_margin(csr, device="cpu"), b.raw_margin(dense64, device="cpu"))
        # chunked densify: many chunks give the one-shot result
        chunks = list(b._csr_chunks(csr, np.float64, target_bytes=800))
        assert len(chunks) == 120 and np.array_equal(np.concatenate(chunks), dense64)


def test_narrow_batch_keeps_the_trained_width_and_wide_indices_raise():
    dense, y, _ = _classifier_case(17, n=1000, f=8)
    col, dense32 = _sparse_column(dense)
    model = LightGBMClassifier(device="cpu", numIterations=3, numLeaves=7, maxBin=31).fit(
        Table({"features": col, "label": y}))
    keep = col.indices < 3
    counts = [int(np.sum(col[i][0] < 3)) for i in range(len(col))]
    narrow = SparseRows(col.indices[keep], col.values[keep],
                        np.concatenate([[0], np.cumsum(counts)]), 3)
    X = extract_features(Table({"features": narrow}), "features", model.booster.num_features)
    assert X.shape == (1000, 8)
    cut = dense32.copy()
    cut[:, 3:] = 0.0
    got = model.transform(Table({"features": narrow}))["probability"]
    assert np.array_equal(got, model.transform(Table({"features": cut}))["probability"])
    wide = SparseRows(np.array([0, 9]), np.array([1.0, 1.0]), np.array([0, 1, 2]), 10)
    with pytest.raises(ValueError, match="out of range"):
        model.transform(Table({"features": wide}))
    with pytest.raises(ValueError, match="out of range"):
        model.booster.raw_margin(CSRMatrix([1.0], [9], [0, 1], (1, 10)), device="cpu")


# -- the card -----------------------------------------------------------------------


@pytest.mark.cuda
def test_sparse_bins_through_histogram_cu_equal_the_plain_version():
    """Packed one-hot CSR bins (the shape of the sparse airline fit, cut)
    through histogram.cu at k = 1 and 8: bit-equal to the plain version.
    The sparse fit on the card writes the dense fit's model text, and the
    CPU's fit's text on the default and the quantized path."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from mmlspark_tpu_torch.ops import hopper_histogram as hh

    dense = _one_hot(18, 200_000)
    bins, mapper = tbinning.bin_dataset(CSRMatrix.from_dense(dense), max_bin=255,
                                        feature_bundling=True)
    bins_t = torch.as_tensor(bins, device="cuda").t().contiguous()
    gen = torch.Generator(device="cuda").manual_seed(0)
    n = bins.shape[0]
    g = torch.randn(n, device="cuda", generator=gen)
    h = torch.rand(n, device="cuda", generator=gen)
    c = torch.ones(n, device="cuda")
    for k, entry in ((1, hh.build_histograms_combined_cuda), (8, hh.build_histograms_cuda)):
        node = torch.randint(0, k + 1, (n,), device="cuda", generator=gen, dtype=torch.int32)
        args = (bins_t, g, h, c, node, k, 256)
        assert torch.equal(entry(*args), hh.build_histograms_plain(*args))
    y = (dense[:, 8] + dense[:, 0] > 0.3).astype(np.float64)
    col, dense32 = _sparse_column(dense[:20_000])
    sparse_t = Table({"features": col, "label": y[:20_000]})
    params = dict(numIterations=3, numLeaves=15, maxBin=63, featureBundling=True)
    card = LightGBMClassifier(device="cuda", **params).fit(sparse_t)
    assert card.get_model_string() == LightGBMClassifier(device="cuda", **params).fit(
        Table({"features": dense32, "label": y[:20_000]})).get_model_string()
    # against the CPU: the same model text on both paths. The binary
    # gradients are the CPU's bits, the histogram sums are exact integers,
    # and the default path's float32 reductions over the bins (the split
    # search's prefix, each node's total, a bundle's default bin) are one
    # chain in bin order on both devices.
    obj = objectives.get_objective("binary")
    m = torch.from_numpy(np.random.default_rng(1).normal(size=(20_000, 1)).astype(np.float32))
    yw = (torch.from_numpy(y[:20_000].astype(np.float32)), torch.ones(20_000))
    for a, b in zip(obj.grad_hess(m.cuda(), *(v.cuda() for v in yw)), obj.grad_hess(m, *yw)):
        assert torch.equal(a.cpu(), b)
    cpu = LightGBMClassifier(device="cpu", **params).fit(sparse_t)
    assert card.get_model_string() == cpu.get_model_string()
    assert (QuantizedClassifier(device="cuda", **params).fit(sparse_t).get_model_string()
            == QuantizedClassifier(device="cpu", **params).fit(sparse_t).get_model_string())
