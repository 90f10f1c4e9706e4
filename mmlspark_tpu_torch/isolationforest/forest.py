"""Isolation forest — anomaly detection; the port's copy of
``mmlspark_tpu/isolationforest/forest.py``.

The reference wraps LinkedIn's JVM ``isolation-forest`` estimator
(``isolationforest/IsolationForest.scala:9-58``; param surface from
``com.linkedin.relevance.isolationforest.IsolationForestParams``). Isolation
trees are built on the host on subsamples (cheap, O(numEstimators ×
maxSamples log maxSamples)) from the reference's ``default_rng`` stream, so
the packed arrays are its bits. Scoring, the per-row hot path, runs on the
model's ``device``: every tree descends in lockstep through ``max_depth``
rounds of gathers (no data-dependent control flow), over blocks of rows so
that the (trees, rows) node tensor stays bounded; the mean over trees adds
in XLA's order (:func:`_xla_sum`), so the scores are the reference's bits
on every device, but at 21-32 trees.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from mmlspark_tpu_torch.core.params import (
    HasFeaturesCol,
    HasPredictionCol,
    Param,
    gt,
    to_float,
    to_int,
    to_str,
)
from mmlspark_tpu_torch.core.pipeline import Estimator, Model
from mmlspark_tpu_torch.data.table import Table
from mmlspark_tpu_torch.device import DeviceLike, resolve_device

#: (trees x rows) node ids per descent block; 2^24 int64 ids are 128 MB
BLOCK_NODES = 1 << 24
#: XLA's CPU reduction splits a reduced axis longer than this into windows
XLA_WINDOW = 32


def _harmonic(n: float) -> float:
    return float(np.log(n) + 0.5772156649015329)


def c_factor(n: float) -> float:
    """Average unsuccessful-search path length in a BST of n nodes — the
    isolation-forest normalizer c(n)."""
    if n <= 1.0:
        return 0.0
    if n == 2.0:
        return 1.0
    return 2.0 * _harmonic(n - 1.0) - 2.0 * (n - 1.0) / n


class _TreeArrays:
    """One isolation tree as flat arrays (node-major)."""

    __slots__ = ("feature", "threshold", "left", "right", "path_adjust")

    def __init__(self, n_nodes: int):
        self.feature = np.zeros(n_nodes, dtype=np.int32)
        self.threshold = np.zeros(n_nodes, dtype=np.float32)
        self.left = np.zeros(n_nodes, dtype=np.int32)
        self.right = np.zeros(n_nodes, dtype=np.int32)
        # depth + c(leaf size) at leaves; 0 while internal
        self.path_adjust = np.zeros(n_nodes, dtype=np.float32)


def _build_tree(X: np.ndarray, rng: np.random.Generator, max_depth: int) -> _TreeArrays:
    """Grow one isolation tree: uniform random feature + uniform random split
    between node min/max, until isolation or the height cap."""
    nodes: List[Tuple] = []  # (feature, threshold, left, right, path_adjust)

    def grow(idx: np.ndarray, depth: int) -> int:
        me = len(nodes)
        nodes.append(None)
        n = len(idx)
        if depth >= max_depth or n <= 1:
            nodes[me] = (0, 0.0, -1, -1, depth + c_factor(float(n)))
            return me
        sub = X[idx]
        lo, hi = sub.min(axis=0), sub.max(axis=0)
        usable = np.where(hi > lo)[0]
        if len(usable) == 0:  # all duplicate rows: treated as isolated
            nodes[me] = (0, 0.0, -1, -1, depth + c_factor(float(n)))
            return me
        f = int(usable[rng.integers(len(usable))])
        thr = float(rng.uniform(lo[f], hi[f]))
        mask = sub[:, f] < thr
        li = grow(idx[mask], depth + 1)
        ri = grow(idx[~mask], depth + 1)
        nodes[me] = (f, thr, li, ri, 0.0)
        return me

    grow(np.arange(len(X)), 0)
    t = _TreeArrays(len(nodes))
    for i, (f, thr, li, ri, adj) in enumerate(nodes):
        t.feature[i] = f
        t.threshold[i] = thr
        # leaves self-loop so the fixed-depth descent is a no-op afterwards
        t.left[i] = li if li >= 0 else i
        t.right[i] = ri if ri >= 0 else i
        t.path_adjust[i] = adj
    return t


def _xla_sum(P: torch.Tensor) -> torch.Tensor:
    """(T, R) float32 -> (R,) sums over the trees in the order of XLA's CPU
    reduction, the reference's: one chain in tree order when T <=
    :data:`XLA_WINDOW`, else the axis zero-padded (half the padding in
    front) to windows of that length, each window one chain, then the
    window sums reduced the same way. Adds of whole rows, so every device
    gives the same bits. The reference's bits up to 20 trees and from 33
    on; at 21-32 trees XLA fuses the gather into the reduction and sums in
    8 vector lanes, and the mean can part in its last bit."""
    T, R = P.shape
    if T <= XLA_WINDOW:
        acc = P[0]
        for t in range(1, T):
            acc = acc + P[t]
        return acc
    nw = -(-T // XLA_WINDOW)
    pad = nw * XLA_WINDOW - T
    zeros = P.new_zeros
    Pw = torch.cat([zeros((pad // 2, R)), P, zeros((pad - pad // 2, R))]).view(
        nw, XLA_WINDOW, R)
    acc = Pw[:, 0]
    for t in range(1, XLA_WINDOW):
        acc = acc + Pw[:, t]
    return _xla_sum(acc)


def _path_lengths(trees, X: np.ndarray, max_depth: int, device: DeviceLike = None
                  ) -> np.ndarray:
    """Packed trees (each array (n_trees, n_nodes)) × (n_rows, d) rows ->
    (n_rows,) float32 mean path length over the trees, the reference's bits.
    Lockstep descent on ``device``: ``max_depth`` rounds of gathers over a
    block of rows at a time, every tree at once; then the mean as XLA
    computes it (:func:`_xla_sum`, times the float32 1/T)."""
    dev = resolve_device(device)
    feat, thr, left, right, adjust = (
        torch.as_tensor(np.asarray(trees[k]), device=dev)
        for k in ("feature", "threshold", "left", "right", "path_adjust"))
    feat, left, right = feat.long(), left.long(), right.long()
    n_trees = feat.shape[0]
    X = np.ascontiguousarray(X, dtype=np.float32)
    n, d = X.shape
    block = max(1, BLOCK_NODES // max(n_trees, 1))
    inv_trees = torch.tensor(np.float32(1.0 / n_trees), device=dev)
    out = torch.empty(n, dtype=torch.float32, device=dev)
    for lo in range(0, n, block):
        xb = torch.as_tensor(X[lo:lo + block], device=dev)
        rows = xb.shape[0]
        flat = xb.reshape(-1)
        base = (torch.arange(rows, device=dev) * d).expand(n_trees, rows)
        node = torch.zeros((n_trees, rows), dtype=torch.int64, device=dev)
        for _ in range(max_depth):
            f = feat.gather(1, node)
            go_left = flat[base + f] < thr.gather(1, node)
            node = torch.where(go_left, left.gather(1, node), right.gather(1, node))
        out[lo:lo + rows] = _xla_sum(adjust.gather(1, node)) * inv_trees
    return out.cpu().numpy()


class IsolationForest(HasFeaturesCol, HasPredictionCol, Estimator):
    """Param surface mirrors LinkedIn's ``IsolationForestParams``."""

    numEstimators = Param("Number of isolation trees", default=100,
                          converter=to_int, validator=gt(0))
    maxSamples = Param("Subsample size per tree (<=1.0: fraction of rows)",
                       default=256.0, converter=to_float, validator=gt(0))
    maxFeatures = Param("Feature subsample per tree (<=1.0: fraction)",
                        default=1.0, converter=to_float, validator=gt(0))
    bootstrap = Param("Sample with replacement", default=False)
    contamination = Param("Expected outlier fraction (0 = use scoreThreshold)",
                          default=0.0, converter=to_float)
    scoreThreshold = Param("Outlier score cut when contamination=0",
                           default=0.5, converter=to_float)
    scoreCol = Param("Output anomaly-score column", default="outlierScore",
                     converter=to_str)
    randomSeed = Param("RNG seed", default=1, converter=to_int)
    device = Param("Torch device the model scores on: 'cuda' (default) or 'cpu'",
                   default="cuda", converter=to_str, port_only=True)

    def __init__(self, **kwargs):
        kwargs.setdefault("predictionCol", "predictedLabel")
        super().__init__(**kwargs)

    def _fit(self, table: Table) -> "IsolationForestModel":
        resolve_device(self.getDevice())
        X = np.asarray(table.column(self.getFeaturesCol()), dtype=np.float32)
        n, d = X.shape
        rng = np.random.default_rng(self.getRandomSeed())
        ms = self.getMaxSamples()
        sample_n = int(round(ms * n)) if ms <= 1.0 else int(ms)
        sample_n = max(2, min(sample_n, n))
        mf = self.getMaxFeatures()
        feat_n = int(round(mf * d)) if mf <= 1.0 else int(mf)
        feat_n = max(1, min(feat_n, d))
        max_depth = int(np.ceil(np.log2(sample_n)))

        trees: List[_TreeArrays] = []
        for _ in range(self.getNumEstimators()):
            rows = (
                rng.integers(n, size=sample_n)
                if self.getBootstrap()
                else rng.choice(n, size=sample_n, replace=False)
            )
            feats = (
                np.arange(d)
                if feat_n == d
                else np.sort(rng.choice(d, size=feat_n, replace=False))
            )
            t = _build_tree(X[np.ix_(rows, feats)], rng, max_depth)
            # remap tree-local feature ids to global column ids
            t.feature = feats[t.feature].astype(np.int32)
            trees.append(t)

        model = IsolationForestModel(
            featuresCol=self.getFeaturesCol(),
            predictionCol=self.getPredictionCol(),
            scoreCol=self.getScoreCol(),
            trees=_pack_trees(trees),
            numSamples=sample_n,
            maxDepth=max_depth,
            outlierScoreThreshold=self.getScoreThreshold(),
            device=self.getDevice(),
        )
        if self.getContamination() > 0.0:
            scores = model._scores(X)
            thr = float(np.quantile(scores, 1.0 - self.getContamination()))
            model.set("outlierScoreThreshold", thr)
        model.parent = self
        return model


def _pack_trees(trees: List[_TreeArrays]):
    """Trees as (n_trees, max_nodes) arrays; leaf self-loops pad safely."""
    max_nodes = max(len(t.feature) for t in trees)
    packed = {
        "feature": np.zeros((len(trees), max_nodes), dtype=np.int32),
        "threshold": np.zeros((len(trees), max_nodes), dtype=np.float32),
        "left": np.zeros((len(trees), max_nodes), dtype=np.int32),
        "right": np.zeros((len(trees), max_nodes), dtype=np.int32),
        "path_adjust": np.zeros((len(trees), max_nodes), dtype=np.float32),
    }
    for i, t in enumerate(trees):
        m = len(t.feature)
        packed["feature"][i, :m] = t.feature
        packed["threshold"][i, :m] = t.threshold
        packed["left"][i, :m] = t.left
        packed["right"][i, :m] = t.right
        packed["path_adjust"][i, :m] = t.path_adjust
        # pad nodes self-loop at node m-1's adjust (never reached)
        packed["left"][i, m:] = np.arange(m, max_nodes)
        packed["right"][i, m:] = np.arange(m, max_nodes)
    return packed


class IsolationForestModel(HasFeaturesCol, HasPredictionCol, Model):
    trees = Param("Packed tree arrays", is_complex=True, default=None)
    numSamples = Param("Per-tree subsample size", default=256)
    maxDepth = Param("Tree height cap", default=8)
    outlierScoreThreshold = Param("Score cut for predictedLabel", default=0.5)
    scoreCol = Param("Output anomaly-score column", default="outlierScore",
                     converter=to_str)
    device = Param("Torch device the model scores on: 'cuda' (default) or 'cpu'",
                   default="cuda", converter=to_str, port_only=True)

    def _scores(self, X: np.ndarray) -> np.ndarray:
        mean_path = _path_lengths(self.getTrees(), X, self.getMaxDepth(), self.getDevice())
        cn = c_factor(float(self.getNumSamples()))
        return np.asarray(2.0 ** (-np.asarray(mean_path, dtype=np.float64) / cn))

    def transform(self, table: Table) -> Table:
        X = np.asarray(table.column(self.getFeaturesCol()), dtype=np.float32)
        scores = self._scores(X)
        labels = (scores >= self.getOutlierScoreThreshold()).astype(np.float64)
        return table.with_columns({
            self.getScoreCol(): scores,
            self.getPredictionCol(): labels,
        })
