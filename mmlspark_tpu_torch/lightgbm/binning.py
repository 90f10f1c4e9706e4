"""Quantile feature binning — the ``max_bin`` dataset-construction stage.

Host numpy, dense input only; the port's copy of the dense path of
``mmlspark_tpu/lightgbm/binning.py`` and byte-identical to it: the same
seeded row sample, the same quantile edges snapped to the float32 grid, and
the same float32 ``searchsorted`` bin assignment. Bin 0 is the NaN/missing
bin. Categorical features, feature bundling and sparse input are not ported
yet.
"""

from __future__ import annotations

import dataclasses
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Optional, Tuple

import numpy as np

MISSING_BIN = 0


@dataclasses.dataclass
class BinMapper:
    """Per-feature quantile bin edges. ``edges[f]`` has shape (max_bin-1,),
    padded with +inf; value v maps to bin ``1 + searchsorted(edges[f], v,
    'left')`` (bin 0 = NaN)."""

    edges: np.ndarray  # (F, max_bin-1) float64, padded with +inf
    num_bins: np.ndarray  # (F,) actual bin count per feature (incl. missing bin)
    max_bin: int

    @property
    def num_features(self) -> int:
        return self.edges.shape[0]


def fit_bin_mapper(
    X: np.ndarray, max_bin: int = 255, sample_cnt: int = 200_000, seed: int = 0,
) -> BinMapper:
    """Per-feature quantile edges from ``sample_cnt`` seeded sampled rows
    (LightGBM ``bin_construct_sample_cnt``)."""
    n, f = X.shape
    if n > sample_cnt:
        rng = np.random.default_rng(seed)
        idx = rng.choice(n, size=sample_cnt, replace=False)
        sample = X[idx]
    else:
        sample = X
    # max_bin usable value bins (bin 0 reserved for missing) -> max_bin-1 edges.
    edges = np.full((f, max_bin - 1), np.inf, dtype=np.float64)
    num_bins = np.zeros(f, dtype=np.int32)
    qs = np.linspace(0, 1, max_bin)
    for j in range(f):
        col = sample[:, j]
        col = col[~np.isnan(col)]
        if col.size == 0:
            num_bins[j] = 1
            continue
        u, counts = np.unique(col, return_counts=True)
        e = _edges_from_counts(u, counts, max_bin, qs)
        edges[j, : len(e)] = e
        num_bins[j] = len(e) + 2  # +1 missing bin, +1 overflow bin above last edge
    # Snap edges to the float32 grid: prediction compares float32 values
    # with float32 thresholds, so binning must use the same grid.
    finite = np.isfinite(edges)
    edges[finite] = edges[finite].astype(np.float32).astype(np.float64)
    return BinMapper(edges=edges, num_bins=num_bins, max_bin=max_bin)


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
    """Raw features -> row-major (N, F) uint8 bin indices. Columns are
    binned on a small thread pool: numpy releases the interpreter lock in
    the cast and ``searchsorted``, and each thread writes its own column."""
    n, f = X.shape
    out = np.zeros((n, f), dtype=np.uint8)

    def bin_column(j: int) -> None:
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


def bin_dataset(
    X, max_bin: int = 255, mapper: Optional[BinMapper] = None,
    sample_cnt: int = 200_000,
) -> Tuple[np.ndarray, BinMapper]:
    """Fit a mapper (unless given) and bin ``X``; returns ((N, F) uint8, mapper)."""
    X = np.asarray(X, dtype=np.float64)
    if mapper is None:
        mapper = fit_bin_mapper(X, max_bin=max_bin, sample_cnt=sample_cnt)
    return apply_bins(X, mapper), mapper
