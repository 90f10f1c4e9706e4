"""Out-of-core sharded ingest of the port (mmlspark_tpu_torch) against the JAX
package.

Six ``.npz`` shards of 2,000 rows, made from a numpy seed, are read by both
packages' ShardedDataset on the CPU: CRC sidecars, the sampled mapper, the
streamed bins, labels and weights, and the out-of-core fit's model text must
be the reference's; the read modes must keep the reference's survivors and
quarantine records on a truncated and on a byte-flipped shard.
"""

import os
import pathlib
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from mmlspark_tpu_torch.data.sharded import (
    ShardedDataset,
    _file_crc32,
    fit_gbdt_sharded,
    write_shard_sidecar,
)
from mmlspark_tpu_torch.dataguard.modes import BadRecordsError, normalize_mode
from mmlspark_tpu_torch.lightgbm import LightGBMClassifier
from mmlspark_tpu_torch.lightgbm import train as ttrain
from mmlspark_tpu_torch.parallel import MeshConfig, make_mesh


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

REPO = pathlib.Path(__file__).resolve().parents[1]
N_SHARDS, ROWS = 6, 2000
PARAMS = dict(numIterations=4, numLeaves=15, maxBin=63)
SAMPLE = 500
QUANT = {"histogram_method": "u", "use_quantized_grad": True}


class QuantizedClassifier(LightGBMClassifier):
    """The classifier on the quantized U path (not an estimator param)."""

    def _extra_train_options(self):
        return dict(QUANT)


@pytest.fixture(scope="module")
def ref():
    from mmlspark_tpu.data import sharded as jsharded
    from mmlspark_tpu.lightgbm import LightGBMClassifier as JClassifier
    from mmlspark_tpu.lightgbm.procfit import model_texts_close

    class JQuantized(JClassifier):
        def _extra_train_options(self):
            return dict(QUANT)

    return dict(sharded=jsharded, Classifier=JClassifier, Quantized=JQuantized,
                texts_close=model_texts_close)


@pytest.fixture(scope="module")
def shards(tmp_path_factory):
    """Six shards of HIGGS-like rows (float32 X, float64 y and w)."""
    rng = np.random.default_rng(0)
    n = N_SHARDS * ROWS
    X = rng.normal(size=(n, 6)).astype(np.float32)
    y = (X[:, 0] + X[:, 1] * X[:, 2] + 0.5 * rng.normal(size=n) > 0).astype(np.float64)
    w = rng.uniform(0.5, 2.0, n)
    ds = ShardedDataset.write_shards(str(tmp_path_factory.mktemp("shards")), X, y, w,
                                     rows_per_shard=ROWS)
    return ds.paths, X, y, w


def _corrupt_copy(paths, tmp_path, kind):
    """A copy of the shards with shard 2 truncated (and its sidecar gone,
    so the zip decode finds it) or one byte of its data flipped (its
    sidecar then disagrees)."""
    out = []
    for p in paths:
        q = str(tmp_path / os.path.basename(p))
        shutil.copy(p, q)
        shutil.copy(p + ".crc32", q + ".crc32")
        out.append(q)
    with open(out[2], "r+b") as fh:
        if kind == "truncated":
            fh.truncate(os.path.getsize(out[2]) // 2)
            os.remove(out[2] + ".crc32")
        else:
            fh.seek(os.path.getsize(out[2]) // 2)
            b = fh.read(1)
            fh.seek(-1, 1)
            fh.write(bytes([b[0] ^ 0xFF]))
    return out


def test_sidecars_mapper_and_streamed_bins_equal_the_reference(ref, shards, tmp_path):
    paths, X, y, w = shards
    for p in paths:
        with open(p + ".crc32") as fh:
            assert fh.read() == f"{ref['sharded']._file_crc32(p):08x}"
    tds, jds = ShardedDataset(paths), ref["sharded"].ShardedDataset(paths)
    assert (tds.num_rows, tds.num_features) == (jds.num_rows, jds.num_features) == (12000, 6)
    mt, mj = tds.fit_mapper(max_bin=63, sample_per_shard=SAMPLE, seed=3), \
        jds.fit_mapper(max_bin=63, sample_per_shard=SAMPLE, seed=3)
    assert mt.edges.tobytes() == mj.edges.tobytes()
    assert mt.num_bins.tolist() == mj.num_bins.tolist()
    bt, yt, wt = tds.bin_to_memmap(mt, out_path=str(tmp_path / "t.u8"))
    bj, yj, wj = jds.bin_to_memmap(mj, out_path=str(tmp_path / "j.u8"))
    assert isinstance(bt, np.memmap) and bt.shape == (12000, 6)
    assert np.asarray(bt).tobytes() == np.asarray(bj).tobytes()
    assert yt.tobytes() == yj.tobytes() == y.tobytes() and wt.tobytes() == wj.tobytes()
    side = write_shard_sidecar(paths[0])
    assert open(side).read() == f"{_file_crc32(paths[0]):08x}"


def test_memmap_upload_in_blocks_equals_the_in_memory_layout(shards, tmp_path, monkeypatch):
    paths = shards[0]
    ds = ShardedDataset(paths)
    bins, _, _ = ds.bin_to_memmap(ds.fit_mapper(63, SAMPLE), out_path=str(tmp_path / "b.u8"))
    want = torch.as_tensor(np.asarray(bins)).t().contiguous()
    monkeypatch.setattr(ttrain, "UPLOAD_BLOCK_BYTES", 6 * 777)  # 16 blocks, a short last one
    for src in (bins, np.asarray(bins).copy(), bins[100:]):
        got = ttrain.upload_bins(src, torch.device("cpu"))
        assert torch.equal(got, want[:, 12000 - src.shape[0]:])


@pytest.mark.parametrize("case", ["whole", "row_slice", "framed", "copy_on_write",
                                  "column_slice"])
def test_upload_reads_a_memmap_through_its_file(tmp_path, monkeypatch, case):
    """A memmap's rows, a row slice's too, and a map that starts past the
    first page of its file are read through the file at the right byte
    offset; a copy-on-write map and a column slice take the block loop."""
    rng = np.random.default_rng(7)
    host = rng.integers(0, 256, (3001, 6), dtype=np.uint8)
    head = 4099 if case == "framed" else 0
    path = tmp_path / "bins.u8"
    path.write_bytes(b"x" * head + host.tobytes())
    mm = np.memmap(path, dtype=np.uint8, mode="c" if case == "copy_on_write" else "r",
                   offset=head, shape=host.shape)
    src, want, offset = {"whole": (mm, host, 0), "row_slice": (mm[100:], host[100:], 600),
                         "framed": (mm[5:], host[5:], head + 30),
                         "copy_on_write": (mm, host, None),
                         "column_slice": (mm[:, 1:4], host[:, 1:4], None)}[case]
    span = ttrain._file_rows(src)
    assert (span is None) if offset is None else (span[1] == offset)
    monkeypatch.setattr(ttrain, "UPLOAD_BLOCK_BYTES", 6 * 250)  # 13 blocks, a short last one
    got = ttrain.upload_bins(src, torch.device("cpu"))
    assert torch.equal(got, torch.from_numpy(np.ascontiguousarray(want.T)))


@pytest.mark.parametrize("quantized", [True, False])
def test_out_of_core_fit_writes_the_reference_model_text(ref, shards, tmp_path, quantized):
    paths = shards[0]
    est = (QuantizedClassifier if quantized else LightGBMClassifier)(device="cuda", **PARAMS)
    port = fit_gbdt_sharded(est, ShardedDataset(paths), sample_per_shard=SAMPLE,
                            bins_path=str(tmp_path / "t.u8"), device="cpu")
    assert port.fit_stats.trees == 4 and port.fit_stats.binning_seconds > 0
    if not quantized:  # the default path: the reference's within float32 sum order, and
        # the port's in-memory fit of the same bins exactly
        want = ref["sharded"].fit_gbdt_sharded(
            ref["Classifier"](parallelism="serial", **PARAMS),
            ref["sharded"].ShardedDataset(paths), mesh=None, sample_per_shard=SAMPLE,
            bins_path=str(tmp_path / "j.u8"))
        assert ref["texts_close"](port.get_model_string(), want.get_model_string())
        ds = ShardedDataset(paths)
        mapper = ds.fit_mapper(63, SAMPLE)
        bins, y, w = ds.bin_to_memmap(mapper, out_path=str(tmp_path / "m.u8"))
        opts = LightGBMClassifier(**PARAMS)._make_options(2)
        res = ttrain.train(np.asarray(bins).copy(), y, opts, w=w, mapper=mapper, device="cpu",
                           feature_names=[f"f{i}" for i in range(6)])
        assert port.get_model_string() == res.booster.model_to_string()
        return
    want = ref["sharded"].fit_gbdt_sharded(
        ref["Quantized"](parallelism="serial", **PARAMS), ref["sharded"].ShardedDataset(paths),
        mesh=None, sample_per_shard=SAMPLE, bins_path=str(tmp_path / "j.u8"))
    assert port.get_model_string() == want.get_model_string()


@pytest.mark.parametrize("kind", ["truncated", "flipped"])
def test_read_modes_keep_the_reference_survivors(ref, shards, tmp_path, kind):
    bad = _corrupt_copy(shards[0], tmp_path, kind)
    clean = [p for i, p in enumerate(bad) if i != 2]
    for mode, extra in (("PERMISSIVE", {}), ("dropmalformed", {}),
                        ("failfast", {"ignore_corrupt_files": True})):
        dlq_t, dlq_j = tmp_path / f"dlq_t_{mode}", tmp_path / f"dlq_j_{mode}"
        tds = ShardedDataset(bad, mode=mode, bad_records_path=str(dlq_t), **extra)
        jds = ref["sharded"].ShardedDataset(bad, mode=mode, bad_records_path=str(dlq_j), **extra)
        assert tds.num_rows == jds.num_rows == 10000
        assert tds.paths == jds.paths == clean
        assert [r.to_record() for r in tds.quarantined] == \
            [r.to_record() for r in jds.quarantined]
        assert tds.quarantined[0].reason == ("BadZipFile" if kind == "truncated"
                                             else "PartitionLostError")
        if normalize_mode(mode) == "permissive":
            for part in ("records/000000.jsonl", "records/000000.jsonl.crc32",
                         "manifest/000000.json"):
                assert (dlq_t / part).read_bytes() == (dlq_j / part).read_bytes()
        else:
            assert not dlq_t.exists()
    model = fit_gbdt_sharded(QuantizedClassifier(**PARAMS),
                             ShardedDataset(bad, mode="permissive"), sample_per_shard=SAMPLE,
                             bins_path=str(tmp_path / "p.u8"), device="cpu")
    want = fit_gbdt_sharded(QuantizedClassifier(**PARAMS), ShardedDataset(clean),
                            sample_per_shard=SAMPLE, bins_path=str(tmp_path / "c.u8"),
                            device="cpu")
    assert model.get_model_string() == want.get_model_string()
    failing = ShardedDataset(bad)
    with pytest.raises(Exception) as got:
        failing.fit_mapper(63, SAMPLE)
    with pytest.raises(Exception) as wanted:
        ref["sharded"].ShardedDataset(bad).fit_mapper(63, SAMPLE)
    assert type(got.value).__name__ == type(wanted.value).__name__
    assert str(got.value) == str(wanted.value)


def test_all_corrupt_and_inconsistent_shards_raise(shards, tmp_path):
    bad = _corrupt_copy(shards[0][:3], tmp_path, "truncated")
    with pytest.raises(BadRecordsError, match="all 1 shard"):
        ShardedDataset(bad[2:], mode="permissive").num_rows
    other = str(tmp_path / "other.npz")
    np.savez(other, X=np.zeros((5, 4)), y=np.zeros(5))
    with pytest.raises(ValueError, match="expected 6"):
        ShardedDataset(bad[:2] + [other]).num_rows
    dropped = ShardedDataset(bad[:2] + [other], mode="dropmalformed")
    assert dropped.num_rows == 4000 and dropped.quarantined[0].reason == "feature-count-mismatch"
    unlabeled = str(tmp_path / "x.npy")
    np.save(unlabeled, np.zeros((5, 6)))
    with pytest.raises(ValueError, match="no labels"):
        ShardedDataset([unlabeled]).bin_to_memmap(None)
    with pytest.raises(ValueError, match="no shard"):
        ShardedDataset([])
    with pytest.raises(ValueError, match="unknown read mode"):
        ShardedDataset(bad, mode="lenient")


def test_deferred_options_raise_not_implemented(ref, shards, tmp_path):
    """numProcesses and a mesh are ported: fit_gbdt_sharded reads no
    numProcesses (it fits in this process, as the reference's does), and a
    4-shard mesh of CPU slots fits within float32 sum order of the
    unmeshed fit. Parquet shards read through pandas as the reference's
    do: the same features, labels, weights and row ranges; an empty file
    is a corrupt record under permissive and raises under failfast."""
    paths = shards[0]
    plain = fit_gbdt_sharded(LightGBMClassifier(**PARAMS), ShardedDataset(paths),
                             sample_per_shard=SAMPLE, bins_path=str(tmp_path / "a.u8"),
                             device="cpu")
    procs = fit_gbdt_sharded(LightGBMClassifier(numProcesses=2, **PARAMS), ShardedDataset(paths),
                             sample_per_shard=SAMPLE, bins_path=str(tmp_path / "b.u8"),
                             device="cpu")
    assert procs.get_model_string() == plain.get_model_string()
    mesh = make_mesh(MeshConfig(data=4), devices=["cpu"] * 4)
    meshed = fit_gbdt_sharded(LightGBMClassifier(**PARAMS), ShardedDataset(paths), mesh=mesh,
                              sample_per_shard=SAMPLE, bins_path=str(tmp_path / "c.u8"))
    assert ref["texts_close"](meshed.get_model_string(), plain.get_model_string())
    import pandas as pd

    _, X, y, w = shards
    parquet = str(tmp_path / "s.parquet")
    frame = pd.DataFrame(X[:ROWS].astype(np.float64), columns=[f"f{j}" for j in range(X.shape[1])])
    frame["label"], frame["weight"] = y[:ROWS], w[:ROWS]
    frame.to_parquet(parquet)
    for got, want in ((ShardedDataset._load(parquet), ref["sharded"].ShardedDataset._load(parquet)),
                      (ShardedDataset.load_rows(parquet, 5, 17),
                       ref["sharded"].ShardedDataset.load_rows(parquet, 5, 17))):
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(ShardedDataset._load(parquet)[0], X[:ROWS].astype(np.float64))
    assert ShardedDataset([parquet]).num_rows == ROWS
    empty = str(tmp_path / "empty.parquet")
    open(empty, "wb").close()
    assert ShardedDataset([empty, parquet], mode="permissive").num_rows == ROWS
    with pytest.raises(ValueError):
        ShardedDataset([empty], mode="failfast").num_rows


@pytest.mark.parametrize("module", ["data.sparse", "data.sharded", "dataguard.modes",
                                    "dataguard.dlq", "runtime.lineage", "runtime.faults"])
def test_new_module_loads_neither_jax_nor_the_jax_package(module):
    code = (
        f"import sys, mmlspark_tpu_torch.{module}\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'mmlspark_tpu.'))"
        " or m == 'mmlspark_tpu']\n"
        "assert not bad, bad\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    subprocess.run([sys.executable, "-c", code], check=True, env=env, cwd=str(REPO),
                   timeout=120)


@pytest.mark.cuda
def test_memmap_bins_through_histogram_cu_equal_the_plain_version(shards, tmp_path):
    """Bins streamed to a memmap and uploaded in blocks (the out-of-core
    fit's path, cut) through histogram.cu at k = 1 and 8: bit-equal to the
    plain version; the out-of-core fit on the card writes the model text
    of the in-memory fit of the same bins on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from mmlspark_tpu_torch.ops import hopper_histogram as hh

    paths = shards[0]
    ds = ShardedDataset(paths)
    bins, y, _ = ds.bin_to_memmap(ds.fit_mapper(255, SAMPLE), out_path=str(tmp_path / "b.u8"))
    bins_t = ttrain.upload_bins(bins, torch.device("cuda"))
    assert torch.equal(bins_t.cpu(), torch.as_tensor(np.asarray(bins)).t().contiguous())
    gen = torch.Generator(device="cuda").manual_seed(0)
    n = bins.shape[0]
    g = torch.randn(n, device="cuda", generator=gen)
    h = torch.rand(n, device="cuda", generator=gen)
    c = torch.ones(n, device="cuda")
    for k, entry in ((1, hh.build_histograms_combined_cuda), (8, hh.build_histograms_cuda)):
        node = torch.randint(0, k + 1, (n,), device="cuda", generator=gen, dtype=torch.int32)
        args = (bins_t, g, h, c, node, k, 256)
        assert torch.equal(entry(*args), hh.build_histograms_plain(*args))
    card = fit_gbdt_sharded(LightGBMClassifier(**PARAMS), ShardedDataset(paths),
                            sample_per_shard=SAMPLE, bins_path=str(tmp_path / "c.u8"))
    mapper = ds.fit_mapper(63, SAMPLE)
    bins, y, w = ds.bin_to_memmap(mapper, out_path=str(tmp_path / "m.u8"))
    res = ttrain.train(np.asarray(bins).copy(), y, LightGBMClassifier(**PARAMS)._make_options(2),
                       w=w, mapper=mapper, feature_names=[f"f{i}" for i in range(6)])
    assert card.get_model_string() == res.booster.model_to_string()
