"""Quantile feature binning — the ``max_bin`` dataset-construction stage.

Host numpy; the port's copy of ``mmlspark_tpu/lightgbm/binning.py`` and
byte-identical to it: the same seeded row sample, the same quantile edges
snapped to the float32 grid, and the same float32 ``searchsorted`` bin
assignment. Bin 0 is the NaN/missing bin. Categorical features bin by value
identity (:func:`cat_to_bins`), and a mapper that carries a fitted
:class:`~.bundling.BundleSpec` bins to the packed (N, C) columns of
Exclusive Feature Bundling. Sparse (CSR) input bins without densifying
(:func:`fit_bin_mapper_csr`, :func:`apply_bins_csr`) to the bins of its
dense matrix. :func:`bin_dataset_partitioned` runs the row pass as tasks
on the fault-tolerant scheduler (:mod:`mmlspark_tpu_torch.runtime`).
"""

from __future__ import annotations

import dataclasses
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Optional, Tuple

import numpy as np

from mmlspark_tpu_torch import runtime
from mmlspark_tpu_torch.data.sparse import CSRMatrix
from mmlspark_tpu_torch.lightgbm.bundling import BundleSpec, fit_feature_bundles, pack_bundles
from mmlspark_tpu_torch.observability import events

MISSING_BIN = 0


@dataclasses.dataclass
class BinMapper:
    """Per-feature quantile bin edges. ``edges[f]`` has shape (max_bin-1,),
    padded with +inf; value v maps to bin ``1 + searchsorted(edges[f], v,
    'left')`` (bin 0 = NaN).

    Categorical features bin by value identity instead: each of the up to
    ``max_bin - 1`` most frequent values owns one bin (``cat_values[f][b-1]``
    is bin b's raw value), and any other, unseen or NaN value maps to bin 0,
    which the categorical split search never sends left."""

    edges: np.ndarray  # (F, max_bin-1) float64, padded with +inf
    num_bins: np.ndarray  # (F,) actual bin count per feature (incl. missing bin)
    max_bin: int
    # feature index -> raw category values, most frequent first (bin i+1 <-> v[i])
    cat_values: Optional[dict] = None
    # Exclusive Feature Bundling layout: when set, apply_bins emits packed
    # (N, C) columns and the trainer expands histograms and decodes routing
    # back to original feature space.
    bundles: Optional[BundleSpec] = None

    @property
    def num_features(self) -> int:
        return self.edges.shape[0]

    @property
    def categorical_features(self):
        return sorted(self.cat_values) if self.cat_values else []

    def is_categorical(self, feature: int) -> bool:
        return bool(self.cat_values) and feature in self.cat_values


def fit_bin_mapper(
    X: np.ndarray, max_bin: int = 255, sample_cnt: int = 200_000, seed: int = 0,
    categorical_features=None, max_bin_by_feature=None,
) -> BinMapper:
    """Per-feature quantile edges from ``sample_cnt`` seeded sampled rows
    (LightGBM ``bin_construct_sample_cnt``); ``categorical_features``: the
    indices binned by value identity (one bin per frequent category);
    ``max_bin_by_feature``: a bin cap per feature (LightGBM
    maxBinByFeature; empty or None: ``max_bin`` everywhere), each in [2,
    max_bin] because the bins are uint8 of one width."""
    n, f = X.shape
    cat_set = set(int(c) for c in (categorical_features or []))
    caps = list(max_bin_by_feature or [])
    if caps:
        if len(caps) != f:
            raise ValueError(f"maxBinByFeature has {len(caps)} entries for {f} features")
        bad = [c for c in caps if not (2 <= int(c) <= max_bin)]
        if bad:
            raise ValueError(f"maxBinByFeature entries must be in [2, maxBin={max_bin}] "
                             f"(got {bad[:5]})")
    if n > sample_cnt:
        rng = np.random.default_rng(seed)
        idx = rng.choice(n, size=sample_cnt, replace=False)
        sample = X[idx]
    else:
        sample = X
    # max_bin usable value bins (bin 0 reserved for missing) -> max_bin-1 edges.
    edges = np.full((f, max_bin - 1), np.inf, dtype=np.float64)
    num_bins = np.zeros(f, dtype=np.int32)
    cat_values: dict = {}
    for j in range(f):
        mb = int(caps[j]) if caps else max_bin
        col = sample[:, j]
        col = col[~np.isnan(col)]
        if j in cat_set:
            u, counts = np.unique(col, return_counts=True)
            cat_values[j] = _cat_values_from_counts(u, counts, mb)
            num_bins[j] = len(cat_values[j]) + 1  # + missing bin
            continue
        if col.size == 0:
            num_bins[j] = 1
            continue
        u, counts = np.unique(col, return_counts=True)
        e = _edges_from_counts(u, counts, mb, np.linspace(0, 1, mb))
        edges[j, : len(e)] = e
        num_bins[j] = len(e) + 2  # +1 missing bin, +1 overflow bin above last edge
    return _snapped_mapper(edges, num_bins, max_bin, cat_values)


def _snapped_mapper(edges, num_bins, max_bin: int, cat_values: dict) -> BinMapper:
    """The mapper with its edges snapped to the float32 grid: prediction
    compares float32 values with float32 thresholds, so binning must use
    the same grid."""
    finite = np.isfinite(edges)
    edges[finite] = edges[finite].astype(np.float32).astype(np.float64)
    return BinMapper(edges=edges, num_bins=num_bins, max_bin=max_bin,
                     cat_values=cat_values or None)


def _cat_values_from_counts(u: np.ndarray, counts: np.ndarray, mb: int) -> np.ndarray:
    """Value-identity bin list of one categorical feature: most frequent
    first (ties by value), at most ``mb - 1`` values."""
    order = np.lexsort((u, -counts))
    return np.asarray(u[order][: mb - 1], dtype=np.float64)


def cat_to_bins(col: np.ndarray, values: np.ndarray) -> np.ndarray:
    """Raw category column -> bin ids: value ``values[i]`` -> bin ``i+1``;
    NaN, unseen and overflowed values -> the missing bin 0. The one rule that
    training and predict share."""
    order = np.argsort(values, kind="stable")
    sv = values[order]
    col = np.asarray(col, dtype=np.float64)
    pos = np.searchsorted(sv, col)
    pos = np.clip(pos, 0, len(sv) - 1) if len(sv) else np.zeros(len(col), np.int64)
    hit = len(sv) > 0
    match = (sv[pos] == col) if hit else np.zeros(len(col), bool)
    bins = np.where(match, (order[pos] + 1) if hit else 0, MISSING_BIN)
    return np.where(np.isnan(col), MISSING_BIN, bins).astype(np.int64)


def _edges_from_counts(
    u: np.ndarray, counts: np.ndarray, max_bin: int, qs: np.ndarray
) -> np.ndarray:
    """Edges for one feature from its sorted unique non-NaN values + counts."""
    if len(u) <= max_bin - 1:
        # One bin per distinct value; edge = the value itself ("<= v" left).
        return u
    qvals = _weighted_quantile(u, counts, qs)
    return np.unique(qvals)[:-1]  # drop max so the top quantile maps inside


def _weighted_quantile(u: np.ndarray, c: np.ndarray, qs: np.ndarray) -> np.ndarray:
    """Quantiles of the multiset {u[k] repeated c[k] times}, bitwise equal to
    ``np.quantile(..., method='linear')``."""
    w = int(c.sum())
    cum = np.cumsum(c)
    p = qs * (w - 1)
    i = np.floor(p).astype(np.int64)
    frac = p - i
    i2 = np.minimum(i + 1, w - 1)
    a_lo = u[np.searchsorted(cum, i, side="right")]
    a_hi = u[np.searchsorted(cum, i2, side="right")]
    # numpy's _lerp switches formula at t >= 0.5 for monotonicity.
    diff = a_hi - a_lo
    out = a_lo + frac * diff
    return np.where(frac >= 0.5, a_hi - diff * (1 - frac), out)


def apply_bins(X: np.ndarray, mapper: BinMapper) -> np.ndarray:
    """Raw features -> row-major (N, F) uint8 bin indices, or the packed
    (N, C) columns when the mapper carries a bundle spec."""
    out = _apply_bins_raw(X, mapper)
    if mapper.bundles is not None:
        out = pack_bundles(out, mapper.bundles)
    return out


def _apply_bins_raw(X: np.ndarray, mapper: BinMapper) -> np.ndarray:
    """Original-feature-space (N, F) bins. Columns are binned on a small
    thread pool: numpy releases the interpreter lock in the cast and
    ``searchsorted``, and each thread writes its own column."""
    n, f = X.shape
    out = np.zeros((n, f), dtype=np.uint8)

    def bin_column(j: int) -> None:
        if mapper.is_categorical(j):
            out[:, j] = cat_to_bins(X[:, j], mapper.cat_values[j]).astype(np.uint8)
            return
        col = X[:, j].astype(np.float32)
        # 'left' => v <= edge stays at that edge's bin; v > last edge -> overflow bin.
        b = 1 + np.searchsorted(mapper.edges[j].astype(np.float32), col, side="left")
        b = np.where(np.isnan(col), MISSING_BIN, b)
        out[:, j] = np.clip(b, 0, mapper.max_bin).astype(np.uint8)

    workers = max(1, min(f, os.cpu_count() or 1, 8))
    with ThreadPoolExecutor(max_workers=workers) as pool:
        for done in [pool.submit(bin_column, j) for j in range(f)]:
            done.result()
    return out


def fit_bundles_inplace(
    mapper: BinMapper,
    raw_bins: np.ndarray,
    max_conflict_rate: float = 0.0,
    sample_cnt: int = 200_000,
    seed: int = 0,
) -> Optional[BundleSpec]:
    """Fit Exclusive Feature Bundling over a seeded row sample of the
    original-space bins and attach the spec to the mapper. It stays None
    when no bundle gains a second member, and then every consumer is
    bit-identical to an unbundled fit. A fitted plan publishes
    ``FeatureBundled`` on the event bus, as the reference does."""
    rows = _bundle_sample_rows(raw_bins.shape[0], sample_cnt, seed)
    sample = raw_bins if rows is None else raw_bins[rows]
    spec = fit_feature_bundles(
        sample,
        mapper.num_bins,
        max_conflict_rate=max_conflict_rate,
        categorical_slots=mapper.categorical_features,
    )
    mapper.bundles = spec
    if spec is not None:
        bus = events.get_bus()
        if bus.active:
            bus.publish(events.FeatureBundled(
                num_features=spec.num_features,
                num_columns=spec.num_columns,
                k_before=int(sum(int(x) for x in mapper.num_bins)),
                k_after=spec.k_packed,
                conflicts=spec.conflict_count,
                sample_rows=spec.sample_rows,
            ))
    return spec


def _bundle_sample_rows(n: int, sample_cnt: int, seed: int = 0) -> Optional[np.ndarray]:
    """The rows the bundle plan is fitted on (None: all of them)."""
    if n <= sample_cnt:
        return None
    return np.random.default_rng(seed).choice(n, size=sample_cnt, replace=False)


def bin_dataset_to_device(
    X, max_bin: int = 255, mapper: Optional[BinMapper] = None,
    categorical_features=None, feature_bundling: bool = False,
    max_conflict_rate: float = 0.0, device=None,
):
    """Bin on the host (:func:`bin_dataset`), then upload the bins once to
    ``device`` (the card unless the CPU is named). Returns (the bins as
    ``train.upload_bins`` lays them out: a (C, N) feature-major uint8 tensor,
    C = F, or the packed columns under ``feature_bundling``; and the
    mapper). The JAX package's counterpart returns its (N, C) device array."""
    from mmlspark_tpu_torch.device import resolve_device
    from mmlspark_tpu_torch.lightgbm.train import upload_bins

    dev = resolve_device(device)
    bins, mapper = bin_dataset(
        X, max_bin=max_bin, mapper=mapper,
        categorical_features=categorical_features,
        feature_bundling=feature_bundling,
        max_conflict_rate=max_conflict_rate,
    )
    return upload_bins(bins, dev), mapper


def bin_dataset(
    X, max_bin: int = 255, mapper: Optional[BinMapper] = None,
    categorical_features=None, sample_cnt: int = 200_000, max_bin_by_feature=None,
    feature_bundling: bool = False, max_conflict_rate: float = 0.0,
) -> Tuple[np.ndarray, BinMapper]:
    """Fit a mapper (unless given) and bin ``X``, dense or a
    :class:`CSRMatrix`; returns ((N, F) uint8, or (N, C) packed columns
    under bundling, and the mapper). Bundles are fitted only with a fresh
    mapper and ``feature_bundling``. CSR input gives the bins of its dense
    matrix; it takes no ``max_bin_by_feature``."""
    fresh = mapper is None
    if isinstance(X, CSRMatrix):
        if max_bin_by_feature:
            raise ValueError("maxBinByFeature is not supported on sparse (CSR) input")
        if fresh:
            mapper = fit_bin_mapper_csr(X, max_bin=max_bin, sample_cnt=sample_cnt,
                                        categorical_features=categorical_features)
            if feature_bundling:
                # the plan's sample rows binned alone: binning is row-pure
                rows = _bundle_sample_rows(X.num_rows, sample_cnt)
                sample = X if rows is None else X.take_rows(rows)
                fit_bundles_inplace(mapper, _apply_bins_csr_raw(sample, mapper),
                                    max_conflict_rate=max_conflict_rate, sample_cnt=sample_cnt)
        return apply_bins_csr(X, mapper), mapper
    X = np.asarray(X, dtype=np.float64)
    if fresh:
        mapper = fit_bin_mapper(X, max_bin=max_bin, sample_cnt=sample_cnt,
                                categorical_features=categorical_features,
                                max_bin_by_feature=max_bin_by_feature)
    raw = _apply_bins_raw(X, mapper)
    if fresh and feature_bundling:
        fit_bundles_inplace(mapper, raw, max_conflict_rate=max_conflict_rate,
                            sample_cnt=sample_cnt)
    if mapper.bundles is not None:
        return pack_bundles(raw, mapper.bundles), mapper
    return raw, mapper


def bin_dataset_partitioned(
    X, max_bin: int = 255, mapper: Optional[BinMapper] = None, categorical_features=None,
    sample_cnt: int = 200_000, max_bin_by_feature=None, policy=None, metrics=None,
    journal_root: Optional[str] = None, journal_key: Optional[str] = None,
    feature_bundling: bool = False, max_conflict_rate: float = 0.0,
) -> Tuple[np.ndarray, BinMapper]:
    """:func:`bin_dataset` with the row pass run as partitioned tasks on the
    fault-tolerant scheduler, the reference's ``bin_dataset_partitioned``.
    The mapper (and bundle plan) are fitted inline; :func:`apply_bins` is
    row-pure, so the row slices binned in ``max_workers`` tasks and joined
    in task order are the inline bins byte for byte, whatever executor died
    or result was corrupted on the way. Each slice is recorded in a
    :class:`~mmlspark_tpu_torch.runtime.lineage.Lineage`, so a lost one is
    recomputed. CSR input takes the inline path.

    The bundle plan is fitted on the raw bins of ``sample_cnt`` rows drawn
    by ``default_rng(0)``, as the reference's partitioned path does.
    ``journal_root`` and ``journal_key`` make the pass durable: each
    slice's bins checkpoint to a
    :class:`~mmlspark_tpu_torch.runtime.journal.FitJournal` keyed
    ``<journal_key>-p<slices>``, and a rerun restores the finished ones."""
    if isinstance(X, CSRMatrix):
        return bin_dataset(X, max_bin=max_bin, mapper=mapper,
                           categorical_features=categorical_features, sample_cnt=sample_cnt,
                           max_bin_by_feature=max_bin_by_feature,
                           feature_bundling=feature_bundling,
                           max_conflict_rate=max_conflict_rate)
    X = np.asarray(X, dtype=np.float64)
    fresh = mapper is None
    if fresh:
        mapper = fit_bin_mapper(X, max_bin=max_bin, sample_cnt=sample_cnt,
                                categorical_features=categorical_features,
                                max_bin_by_feature=max_bin_by_feature)
    if fresh and feature_bundling:
        n_all = X.shape[0]
        rows = X
        if n_all > sample_cnt:
            rows = X[np.random.default_rng(0).choice(n_all, size=sample_cnt, replace=False)]
        fit_bundles_inplace(mapper, _apply_bins_raw(rows, mapper),
                            max_conflict_rate=max_conflict_rate, sample_cnt=sample_cnt)
    pol = policy or runtime.current_policy() or runtime.SchedulerPolicy()
    n = X.shape[0]
    if n == 0:
        return apply_bins(X, mapper), mapper
    num_parts = max(1, min(pol.max_workers, n))
    bounds = np.linspace(0, n, num_parts + 1).astype(np.int64)
    lineage = runtime.Lineage()
    shards = [lineage.record(i, (lambda lo=int(bounds[i]), hi=int(bounds[i + 1]): X[lo:hi]),
                             describe=f"rows[{bounds[i]}:{bounds[i + 1]}]")
              for i in range(num_parts)]
    journal = None
    if journal_root is not None and journal_key is not None:
        journal = runtime.FitJournal(journal_root, f"{journal_key}-p{num_parts}",
                                     num_tasks=num_parts)
    try:
        parts = runtime.run_partitioned(lambda rows: apply_bins(rows, mapper), shards, pol,
                                        lineage=lineage, metrics=metrics, journal=journal)
    finally:
        if journal is not None:
            journal.close()
    return np.concatenate(parts, axis=0), mapper


# -- sparse (CSR) input ---------------------------------------------------------
#
# The reference's LGBM_DatasetCreateFromCSRSpark analogue. Implicit entries
# are 0.0 and the dense float matrix never exists: the quantiles fold the
# implicit zero mass in, and each column's cells start at its zero's bin
# before its explicit entries scatter in.


def fit_bin_mapper_csr(csr: CSRMatrix, max_bin: int = 255, sample_cnt: int = 200_000,
                       seed: int = 0, categorical_features=None) -> BinMapper:
    """Per-feature quantile edges from CSR without densifying; the mapper of
    :func:`fit_bin_mapper` on the dense matrix, bit for bit (the same row
    sample, the same quantile arithmetic with the implicit zeros counted;
    a categorical feature counts them toward category 0.0)."""
    n, f = csr.shape
    if n > sample_cnt:
        rng = np.random.default_rng(seed)
        rows = np.sort(rng.choice(n, size=sample_cnt, replace=False))
        sample = csr.take_rows(rows)
        n_sample = sample_cnt
    else:
        sample = csr
        n_sample = n
    cols = sample.indices.astype(np.uint16) if f <= 1 << 16 else sample.indices
    order = np.argsort(cols, kind="stable")
    cols_s, vals_s = sample.indices[order], sample.data[order]
    col_starts = np.searchsorted(cols_s, np.arange(f + 1))

    cat_set = set(int(c) for c in (categorical_features or []))
    edges = np.full((f, max_bin - 1), np.inf, dtype=np.float64)
    num_bins = np.zeros(f, dtype=np.int32)
    cat_values: dict = {}
    qs = np.linspace(0, 1, max_bin)
    for j in range(f):
        explicit = vals_s[col_starts[j]: col_starts[j + 1]]
        n_zero = n_sample - len(explicit)  # implicit entries are 0.0
        explicit = explicit[~np.isnan(explicit)]
        if len(explicit) + n_zero == 0:
            num_bins[j] = 1
            continue
        # the implicit zeros folded into the (value, count) multiset
        u, counts = np.unique(explicit, return_counts=True)
        pos = np.searchsorted(u, 0.0)
        if pos < len(u) and u[pos] == 0.0:
            counts = counts.copy()
            counts[pos] += n_zero
        elif n_zero > 0:
            u = np.insert(u, pos, 0.0)
            counts = np.insert(counts, pos, n_zero)
        if j in cat_set:
            cat_values[j] = _cat_values_from_counts(u, counts, max_bin)
            num_bins[j] = len(cat_values[j]) + 1
            continue
        e = _edges_from_counts(u, counts, max_bin, qs)
        edges[j, : len(e)] = e
        num_bins[j] = len(e) + 2
    return _snapped_mapper(edges, num_bins, max_bin, cat_values)


def apply_bins_csr(csr: CSRMatrix, mapper: BinMapper) -> np.ndarray:
    """CSR -> row-major (N, F) uint8 bins, or the packed (N, C) columns when
    the mapper bundles: :func:`apply_bins` of the dense matrix, bit for
    bit. Bundled columns are packed straight from the entries, so the
    (N, F) original-space bins never exist."""
    return np.ascontiguousarray(_csr_columns(csr, mapper, mapper.bundles).T)


def _apply_bins_csr_raw(csr: CSRMatrix, mapper: BinMapper) -> np.ndarray:
    """Original-feature-space (N, F) bins of a CSR matrix."""
    return np.ascontiguousarray(_csr_columns(csr, mapper, None).T)


def _csr_columns(csr: CSRMatrix, mapper: BinMapper, spec: Optional[BundleSpec]) -> np.ndarray:
    """(C, N) bins of a CSR matrix, one row a column: the original features
    (``spec`` None) or the packed columns of ``spec``. A feature's column
    starts at the bin of 0.0 and its explicit entries scatter in (the
    later of two entries in one cell wins, as in the reference's scatter).
    A packed column starts at 0 ("all default") and each member, in
    packing order, writes the cells where it is not at its default bin,
    as :func:`~.bundling.pack_bundles` does on the dense bins. Packed
    columns are filled on a small thread pool, one column a task."""
    n, f = csr.shape
    edges32 = mapper.edges.astype(np.float32)
    cat_values = mapper.cat_values or {}
    zero = np.array([1 + np.searchsorted(edges32[j], np.float32(0.0), side="left")
                     for j in range(f)]).clip(0, mapper.max_bin).astype(np.uint8)
    for j, vals in cat_values.items():
        zero[j] = np.uint8(cat_to_bins(np.array([0.0]), vals)[0])  # category 0.0, or missing
    col_indptr, row_ids, values = csr.to_csc()
    # two entries in one cell: the rows of a column ascend, so they are neighbours
    same = row_ids[1:] == row_ids[:-1]
    bounds = col_indptr[1:-1]
    same[bounds[(bounds > 0) & (bounds < len(row_ids))] - 1] = False
    duplicates = bool(same.any())
    del same

    def explicit(j: int):
        lo, hi = col_indptr[j], col_indptr[j + 1]
        if j in cat_values:
            return row_ids[lo:hi], cat_to_bins(values[lo:hi], cat_values[j]).astype(np.uint8)
        v = values[lo:hi].astype(np.float32)
        b = 1 + np.searchsorted(edges32[j], v, side="left")
        b = np.where(np.isnan(v), MISSING_BIN, b)
        return row_ids[lo:hi], np.clip(b, 0, mapper.max_bin).astype(np.uint8)

    def feature_column(j: int, out_row: np.ndarray) -> None:
        out_row[:] = zero[j]
        rows, b = explicit(j)
        out_row[rows] = b

    if spec is None:
        out = np.empty((f, n), dtype=np.uint8)

        def fill(c: int) -> None:
            feature_column(c, out[c])
        num_columns = f
    else:
        out = np.zeros((spec.num_columns, n), dtype=np.uint8)

        def fill(c: int) -> None:
            mem = spec.members[c]
            if len(mem) == 1 and spec.identity[mem[0]]:
                feature_column(mem[0], out[c])
                return
            for j in mem:
                d, lo = spec.default_of[j], spec.lo_of[j]
                if duplicates or zero[j] != d:
                    col = np.empty(n, dtype=np.uint8)
                    feature_column(j, col)
                    rows = np.flatnonzero(col != d)
                    v = col[rows].astype(np.int64)
                else:  # only explicit entries can leave the default bin
                    rows, b = explicit(j)
                    keep = b != d
                    rows, v = rows[keep], b[keep].astype(np.int64)
                out[c, rows] = (lo + v - (v > d)).astype(np.uint8)
        num_columns = spec.num_columns

    workers = max(1, min(num_columns, os.cpu_count() or 1, 8))
    with ThreadPoolExecutor(max_workers=workers) as pool:
        for done in [pool.submit(fill, c) for c in range(num_columns)]:
            done.result()
    return out
