"""Sharded, out-of-core dataset ingest.

The port's copy of ``mmlspark_tpu/data/sharded.py``. GBDT training reads
binned uint8 features, 8x smaller than float64, and binning streams:

1. pass 1 streams a bounded sample of each shard to fit the quantile
   :class:`~mmlspark_tpu_torch.lightgbm.binning.BinMapper`;
2. pass 2 streams each shard through ``apply_bins`` into an on-disk uint8
   file (the float data of one shard at a time is in memory);
3. training uploads that file's memmap to the card in row blocks.

Shard files are ``.npz`` (keys ``X``/``y``/optional ``w``) or ``.npy``
(features only). Every written shard carries a ``<shard>.crc32`` sidecar;
a load verifies it when present, and a mismatch raises
:class:`~mmlspark_tpu_torch.runtime.lineage.PartitionLostError`.

Corrupt-shard read modes (Spark's ``mode`` option):
``ShardedDataset(paths, mode="permissive", bad_records_path=...)``
quarantines torn, CRC-mismatched or undecodable shards to a dead-letter
store and streams the survivors in path order, so a fit over the corrupted
input equals the fit over the clean complement byte for byte;
``dropmalformed`` drops and counts; ``failfast`` (the default) raises.
``ignore_corrupt_files=True`` (``spark.sql.files.ignoreCorruptFiles``)
skips corrupt files even under ``failfast``.

Every shard read passes the read gate
(:func:`~mmlspark_tpu_torch.runtime.faults.check_record`), so an injected
``FaultPlan.truncate_shard`` lands where a torn file would.

With a scheduler policy (explicit or an ambient ``runtime.policy()``),
:meth:`ShardedDataset.bin_to_memmap` bins shards, or row ranges of them,
as tasks on the fault-tolerant scheduler; each task reads its own rows
(:meth:`ShardedDataset.load_rows`) and writes its bins at its own offset
of the file.

:func:`fit_gbdt_sharded` trains on a mesh as ``fit`` does
(``mesh="auto"``: the estimator's ``parallelism`` and ``numTasks``), or on
the one it is given. Parquet shards (features, with ``label`` and
``weight`` columns when present) load through pandas, imported when one is
read; they have no streamable row access, so a range read decodes the
whole shard once.
"""

from __future__ import annotations

import dataclasses
import os
import tempfile
import time
import zipfile
import zlib
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np

from mmlspark_tpu_torch import runtime
from mmlspark_tpu_torch.dataguard.modes import (
    FAILFAST,
    PERMISSIVE,
    BadRecordsError,
    CorruptRecord,
    normalize_mode,
)
from mmlspark_tpu_torch.lightgbm.binning import BinMapper, apply_bins, fit_bin_mapper
from mmlspark_tpu_torch.runtime.faults import CorruptShardError, check_record
from mmlspark_tpu_torch.runtime.lineage import PartitionLostError
from mmlspark_tpu_torch.runtime.pressure import PressureLevel, current_pressure_level

#: error classes a corrupt shard file can surface as at decode time
_CORRUPT_ERRORS = (
    CorruptShardError,
    PartitionLostError,
    zipfile.BadZipFile,
    ValueError,
    KeyError,
    OSError,
)


def _file_crc32(path: str) -> int:
    """CRC32 of a file's bytes, read in 1 MiB blocks."""
    crc = 0
    with open(path, "rb") as fh:
        for chunk in iter(lambda: fh.read(1 << 20), b""):
            crc = zlib.crc32(chunk, crc)
    return crc & 0xFFFFFFFF


def write_shard_sidecar(path: str) -> str:
    """Write ``<path>.crc32`` holding the hex CRC32 of the shard's bytes;
    returns the sidecar's path."""
    sidecar = path + ".crc32"
    crc = _file_crc32(path)
    with open(sidecar, "w", encoding="utf-8") as fh:
        fh.write(f"{crc:08x}")
    return sidecar


def _verify_shard(path: str) -> None:
    """Check ``path`` against its ``.crc32`` sidecar (nothing to check when
    there is none); a mismatch raises PartitionLostError."""
    sidecar = path + ".crc32"
    try:
        with open(sidecar, "r", encoding="utf-8") as fh:
            want = fh.read().strip()
    except OSError:
        return
    got = f"{_file_crc32(path):08x}"
    if got != want:
        raise PartitionLostError(f"shard {path} failed CRC verification "
                                 f"(sidecar {want}, file {got})")


@dataclasses.dataclass
class ShardInfo:
    path: str
    num_rows: int
    num_features: int
    has_y: bool = False
    has_w: bool = False


def _npy_header_shape(fh) -> Tuple[int, ...]:
    version = np.lib.format.read_magic(fh)
    if version == (1, 0):
        shape, _, _ = np.lib.format.read_array_header_1_0(fh)
    else:
        shape, _, _ = np.lib.format.read_array_header_2_0(fh)
    return shape


class ShardedDataset:
    """Lazy view over shard files; the float data of at most one shard is
    in memory at a time.

    ``mode`` is Spark's corrupt-record option (``permissive``,
    ``dropmalformed`` or ``failfast``, any case). Under the first two the
    scan verifies every shard at once (CRC sidecar, header decode), so row
    offsets, samples and the memmap's extent all see the same survivors.
    ``bad_records_path`` dead-letters the quarantined shards (``permissive``
    only); ``ignore_corrupt_files`` skips corrupt files even under
    ``failfast``."""

    def __init__(self, shards: Sequence[str], mode: str = FAILFAST,
                 bad_records_path: Optional[str] = None, ignore_corrupt_files: bool = False):
        if not shards:
            raise ValueError("no shard files given")
        self.paths = list(shards)
        self.mode = normalize_mode(mode)
        if ignore_corrupt_files and self.mode == FAILFAST:
            # file-level tolerance whatever the mode; a shard is a file here
            self.mode = "dropmalformed"
        self.bad_records_path = bad_records_path
        #: CorruptRecords quarantined by the scan (non-failfast modes)
        self.quarantined: List[CorruptRecord] = []
        self._infos: Optional[List[ShardInfo]] = None
        self._num_features: Optional[int] = None

    # -- construction --------------------------------------------------------

    @staticmethod
    def write_shards(out_dir: str, X, y: Optional[np.ndarray] = None,
                     w: Optional[np.ndarray] = None,
                     rows_per_shard: int = 100_000) -> "ShardedDataset":
        """Split a matrix into ``.npz`` shards with CRC sidecars. ``X``,
        ``y`` and ``w`` need only ``len`` and row slices, so a generator
        that makes rows per slice writes data that is never in memory
        whole."""
        os.makedirs(out_dir, exist_ok=True)
        paths = []
        n = len(X)
        for si, lo in enumerate(range(0, n, rows_per_shard)):
            hi = min(lo + rows_per_shard, n)
            path = os.path.join(out_dir, f"shard_{si:05d}.npz")
            payload = {"X": np.asarray(X[lo:hi])}
            if y is not None:
                payload["y"] = np.asarray(y[lo:hi])
            if w is not None:
                payload["w"] = np.asarray(w[lo:hi])
            np.savez(path, **payload)
            write_shard_sidecar(path)
            paths.append(path)
        return ShardedDataset(paths)

    # -- shard access --------------------------------------------------------

    @staticmethod
    def _load(path: str) -> Tuple[np.ndarray, Optional[np.ndarray], Optional[np.ndarray]]:
        check_record(path)
        _verify_shard(path)
        if path.endswith(".npz"):
            with np.load(path, allow_pickle=False) as z:
                X = np.asarray(z["X"], dtype=np.float64)
                y = np.asarray(z["y"], dtype=np.float64) if "y" in z else None
                w = np.asarray(z["w"], dtype=np.float64) if "w" in z else None
            return X, y, w
        if path.endswith(".npy"):
            return np.asarray(np.load(path), dtype=np.float64), None, None
        if path.endswith(".parquet"):
            import pandas as pd

            df = pd.read_parquet(path)
            y = df.pop("label").to_numpy(np.float64) if "label" in df else None
            w = df.pop("weight").to_numpy(np.float64) if "weight" in df else None
            return df.to_numpy(np.float64), y, w
        raise ValueError(f"unsupported shard format: {path}")

    @staticmethod
    def load_rows(path: str, lo: int, hi: int
                  ) -> Tuple[np.ndarray, Optional[np.ndarray], Optional[np.ndarray]]:
        """Decode only rows ``[lo, hi)`` of a shard, the memory-bounded
        read. ``.npy`` slices a read-only memmap; ``.npz`` seeks within the
        zip member past the skipped rows (``np.savez`` stores members
        uncompressed, so the seek is a file seek) and reads the range;
        parquet decodes the shard, then slices."""
        check_record(path)
        _verify_shard(path)
        lo, hi = int(lo), int(hi)
        if path.endswith(".npy"):
            mm = np.load(path, mmap_mode="r")
            return np.asarray(mm[lo:hi], dtype=np.float64), None, None
        if not path.endswith(".npz"):
            X, y, w = ShardedDataset._load(path)
            return X[lo:hi], None if y is None else y[lo:hi], None if w is None else w[lo:hi]

        def member_rows(z, name):
            with z.open(name) as fh:
                version = np.lib.format.read_magic(fh)
                if version == (1, 0):
                    shape, fortran, dtype = np.lib.format.read_array_header_1_0(fh)
                else:
                    shape, fortran, dtype = np.lib.format.read_array_header_2_0(fh)
                if fortran:
                    # column-major rows are not contiguous in the stream
                    data = np.frombuffer(fh.read(), dtype=dtype)
                    return data.reshape(shape, order="F")[lo:hi].astype(np.float64)
                rowbytes = int(np.prod(shape[1:], dtype=np.int64)) * dtype.itemsize
                fh.seek(lo * rowbytes, 1)
                buf = fh.read((hi - lo) * rowbytes)
                arr = np.frombuffer(buf, dtype=dtype).reshape((hi - lo,) + tuple(shape[1:]))
                return arr.astype(np.float64)

        with zipfile.ZipFile(path) as z:
            names = set(z.namelist())
            X = member_rows(z, "X.npy")
            y = member_rows(z, "y.npy") if "y.npy" in names else None
            w = member_rows(z, "w.npy") if "w.npy" in names else None
        return X, y, w

    def iter_shards(self) -> Iterator[Tuple[np.ndarray, Optional[np.ndarray], Optional[np.ndarray]]]:
        # the scan first: under permissive and dropmalformed it prunes
        # self.paths to the survivors, so nothing after reads a corrupt shard
        self._scan()
        for p in self.paths:
            yield self._load(p)

    @staticmethod
    def _shard_info(path: str) -> ShardInfo:
        """Shape and keys from the ``.npy``/``.npz`` headers, without
        decoding the float data; a parquet shard is decoded once."""
        if path.endswith(".npy"):
            with open(path, "rb") as fh:
                shape = _npy_header_shape(fh)
            return ShardInfo(path, shape[0], shape[1])
        if path.endswith(".npz"):
            with zipfile.ZipFile(path) as z:
                names = set(z.namelist())
                with z.open("X.npy") as fh:
                    shape = _npy_header_shape(fh)
            return ShardInfo(path, shape[0], shape[1], has_y="y.npy" in names,
                             has_w="w.npy" in names)
        X, y, w = ShardedDataset._load(path)
        return ShardInfo(path, len(X), X.shape[1], has_y=y is not None, has_w=w is not None)

    def _scan(self) -> None:
        if self._infos is not None:
            return
        infos = []
        survivors = []
        bad: List[CorruptRecord] = []
        f = None
        for p in self.paths:
            if self.mode != FAILFAST:
                # verify now, so that every later size (row offsets, the
                # memmap's extent, samples) is taken over the survivors
                try:
                    check_record(p)
                    _verify_shard(p)
                    info = self._shard_info(p)
                except _CORRUPT_ERRORS as e:
                    bad.append(CorruptRecord.from_error(p, e))
                    continue
            else:
                info = self._shard_info(p)
            if f is None:
                f = info.num_features
            elif info.num_features != f:
                if self.mode != FAILFAST:
                    bad.append(CorruptRecord(
                        source=p, index=-1, reason="feature-count-mismatch",
                        detail=f"has {info.num_features} features, expected {f}"))
                    continue
                raise ValueError(f"shard {p} has {info.num_features} features, expected {f}")
            survivors.append(p)
            infos.append(info)
        if bad:
            self.quarantined = bad
            self.paths = survivors
            if not survivors:
                raise BadRecordsError(f"all {len(bad)} shard(s) are corrupt", records=bad)
            if self.mode == PERMISSIVE and self.bad_records_path:
                from mmlspark_tpu_torch.dataguard.dlq import DeadLetterStore

                DeadLetterStore(self.bad_records_path, name="sharded").letter(bad)
        # weights all or none: a shard without 'w' training unweighted
        # would lose data silently
        if len({i.has_w for i in infos}) > 1:
            raise ValueError("inconsistent shards: some carry weights ('w') and some do not")
        self._infos = infos
        self._num_features = int(f)

    @property
    def num_rows(self) -> int:
        self._scan()
        return sum(i.num_rows for i in self._infos)

    @property
    def num_features(self) -> int:
        self._scan()
        return self._num_features

    # -- streaming binning ---------------------------------------------------

    def sample_rows(self, per_shard: int, seed: int = 0) -> np.ndarray:
        """At most ``per_shard`` seeded rows of each shard, for the quantile fit."""
        rng = np.random.default_rng(seed)
        chunks = []
        for X, _, _ in self.iter_shards():
            if len(X) > per_shard:
                chunks.append(X[rng.choice(len(X), size=per_shard, replace=False)])
            else:
                chunks.append(X)
        return np.concatenate(chunks, axis=0)

    def fit_mapper(self, max_bin: int = 255, sample_per_shard: int = 50_000,
                   seed: int = 0) -> BinMapper:
        return fit_bin_mapper(self.sample_rows(sample_per_shard, seed), max_bin=max_bin)

    def bin_to_memmap(self, mapper: BinMapper, out_path: Optional[str] = None, policy=None,
                      metrics=None, rows_per_task: Optional[int] = None
                      ) -> Tuple[np.memmap, np.ndarray, Optional[np.ndarray]]:
        """Stream every shard through ``apply_bins`` into an on-disk uint8
        matrix, in path order. Returns (bins memmap (N, F) uint8, y (N,), w
        or None); labels and weights stay in memory. The bins are written
        through the file, not the mapping, so the pages the pass dirties
        are the page cache's and not the process's resident memory.

        With a :class:`~mmlspark_tpu_torch.runtime.SchedulerPolicy`
        (``policy``, else an ambient ``runtime.policy()``) each shard, or
        each range of ``rows_per_task`` rows of it, is one task on the
        fault-tolerant scheduler: tasks bin concurrently, each reading only
        its rows (:meth:`load_rows`, the shard file its lineage source) and
        writing its bins at its own offset of the file, so the bytes are the
        sequential pass's. Without ``rows_per_task``, whole shards make the
        tasks unless the ambient memory-pressure level says otherwise:
        halved ranges at WARN, quartered at CRITICAL. ``metrics`` (a
        :class:`~mmlspark_tpu_torch.runtime.RuntimeMetrics`) collects the
        scheduler's counts."""
        self._scan()
        n, f = self.num_rows, self.num_features
        # fail before the long binning pass; the scan read the keys already
        if not all(i.has_y for i in self._infos):
            raise ValueError("shards carry no labels ('y'); cannot train")
        have_w = all(i.has_w for i in self._infos)
        if out_path is None:
            fd, out_path = tempfile.mkstemp(suffix=".bins.u8")
            os.close(fd)
        y_all = np.empty(n, dtype=np.float64)
        w_all = np.empty(n, dtype=np.float64) if have_w else None
        pol = policy or runtime.current_policy()
        if pol is None:
            lo = 0
            with open(out_path, "wb") as fh:
                for X, y, w in self.iter_shards():
                    hi = lo + len(X)
                    fh.write(np.ascontiguousarray(apply_bins(X, mapper), dtype=np.uint8).data)
                    y_all[lo:hi] = y
                    if have_w:
                        w_all[lo:hi] = w
                    lo = hi
        else:
            self._bin_scheduled(mapper, out_path, pol, metrics, rows_per_task, y_all, w_all)
        bins = np.memmap(out_path, dtype=np.uint8, mode="r+", shape=(n, f))
        return bins, y_all, w_all

    def _bin_scheduled(self, mapper: BinMapper, out_path: str, pol, metrics,
                       rows_per_task: Optional[int], y_all: np.ndarray,
                       w_all: Optional[np.ndarray]) -> None:
        """The scheduler path of :meth:`bin_to_memmap`: one task per shard or
        row range, each writing its bins with positional writes at
        ``lo * F`` of ``out_path``."""
        f = self.num_features
        offsets = np.cumsum([0] + [i.num_rows for i in self._infos])
        split = rows_per_task
        if split is None:
            level = current_pressure_level("memory")
            if level >= PressureLevel.WARN:
                biggest = max(i.num_rows for i in self._infos)
                div = 4 if level >= PressureLevel.CRITICAL else 2
                split = max(1, -(-biggest // div))
        parts = []  # (shard index, row lo, row hi) within the shard
        for si, info in enumerate(self._infos):
            step = split if split is not None else max(info.num_rows, 1)
            for plo in range(0, info.num_rows, step):
                parts.append((si, plo, min(plo + step, info.num_rows)))
        lineage = runtime.Lineage()
        tasks = [lineage.record(pi, (lambda si=si, plo=plo, phi=phi, p=self.paths[si]:
                                     (si, plo, phi) + self.load_rows(p, plo, phi)),
                                describe=f"{self.paths[si]}[{plo}:{phi}]")
                 for pi, (si, plo, phi) in enumerate(parts)]
        fd = os.open(out_path, os.O_RDWR | os.O_CREAT | os.O_TRUNC, 0o644)
        try:
            os.ftruncate(fd, int(offsets[-1]) * f)

            def bin_part(payload):
                si, plo, phi, X, y, w = payload
                lo, hi = int(offsets[si]) + plo, int(offsets[si]) + phi
                data = memoryview(np.ascontiguousarray(apply_bins(X, mapper), dtype=np.uint8)
                                  ).cast("B")
                done = 0
                while done < len(data):  # a positional write may be short
                    done += os.pwrite(fd, data[done:], lo * f + done)
                y_all[lo:hi] = y
                if w_all is not None:
                    w_all[lo:hi] = w
                return hi - lo

            runtime.run_partitioned(bin_part, tasks, pol, lineage=lineage, metrics=metrics)
        finally:
            os.close(fd)


def fit_gbdt_sharded(estimator, dataset: ShardedDataset, mesh="auto",
                     sample_per_shard: int = 50_000, bins_path: Optional[str] = None,
                     device=None):
    """Out-of-core GBDT fit: stream-bin the dataset into a uint8 memmap,
    then train on ``device`` (None: the estimator's ``device``, the card by
    default) from that memmap; the float matrix never exists. ``estimator``
    is a LightGBM learner of the port; returns its fitted model.
    ``mesh="auto"`` takes the mesh ``fit`` would (the estimator's
    ``parallelism`` and ``numTasks``); pass a ``parallel.mesh.Mesh`` or
    None to override (a mesh's fit runs on its first slot, and ``device``
    is not read). ``numProcesses`` is not read here, as in the reference:
    the fit runs in this process."""
    from mmlspark_tpu_torch.lightgbm.train import train

    if mesh == "auto":
        mesh = estimator._select_mesh(device)
    opts = estimator._make_options(num_class=1)
    t0 = time.perf_counter()
    mapper = dataset.fit_mapper(max_bin=opts.max_bin, sample_per_shard=sample_per_shard,
                                seed=estimator.getSeed())
    bins, y, w = dataset.bin_to_memmap(mapper, out_path=bins_path)
    binning_seconds = time.perf_counter() - t0
    num_class = estimator._num_classes(y)
    if num_class != 1:
        opts = estimator._make_options(num_class=num_class)
    result = train(bins, y, opts, w=w, mapper=mapper,
                   feature_names=[f"f{i}" for i in range(dataset.num_features)],
                   device=estimator.getDevice() if device is None else device, mesh=mesh)
    result.stats.binning_seconds = binning_seconds
    model = estimator._make_model(result)
    model.parent = estimator
    model.fit_stats = result.stats
    return model
