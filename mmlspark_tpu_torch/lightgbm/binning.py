"""Quantile feature binning — the ``max_bin`` dataset-construction stage.

Host numpy, dense input only; the port's copy of the dense path of
``mmlspark_tpu/lightgbm/binning.py`` and byte-identical to it: the same
seeded row sample, the same quantile edges snapped to the float32 grid, and
the same float32 ``searchsorted`` bin assignment. Bin 0 is the NaN/missing
bin. Categorical features bin by value identity (:func:`cat_to_bins`), and
a mapper that carries a fitted :class:`~.bundling.BundleSpec` bins to the
packed (N, C) columns of Exclusive Feature Bundling. Sparse input is not
ported yet.
"""

from __future__ import annotations

import dataclasses
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Optional, Tuple

import numpy as np

from mmlspark_tpu_torch.lightgbm.bundling import BundleSpec, fit_feature_bundles, pack_bundles

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
    # Snap edges to the float32 grid: prediction compares float32 values
    # with float32 thresholds, so binning must use the same grid.
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
    bit-identical to an unbundled fit."""
    n = raw_bins.shape[0]
    if n > sample_cnt:
        rng = np.random.default_rng(seed)
        sample = raw_bins[rng.choice(n, size=sample_cnt, replace=False)]
    else:
        sample = raw_bins
    spec = fit_feature_bundles(
        sample,
        mapper.num_bins,
        max_conflict_rate=max_conflict_rate,
        categorical_slots=mapper.categorical_features,
    )
    mapper.bundles = spec
    return spec


def bin_dataset(
    X, max_bin: int = 255, mapper: Optional[BinMapper] = None,
    categorical_features=None, sample_cnt: int = 200_000, max_bin_by_feature=None,
    feature_bundling: bool = False, max_conflict_rate: float = 0.0,
) -> Tuple[np.ndarray, BinMapper]:
    """Fit a mapper (unless given) and bin ``X``; returns ((N, F) uint8, or
    (N, C) packed columns under bundling, and the mapper). Bundles are
    fitted only with a fresh mapper and ``feature_bundling``."""
    X = np.asarray(X, dtype=np.float64)
    fresh = mapper is None
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
