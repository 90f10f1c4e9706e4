"""Host-side ball-tree for maximum-inner-product search (MIPS).

Re-design of the reference's Breeze ball tree (``nn/BallTree.scala:110`` and
``ConditionalBallTree`` ``nn/BallTree.scala:203`` with label-filtered queries
via ``ReverseIndex`` ``:182-201``). Construction and leaf scans are
numpy-vectorized; traversal prunes with the Cauchy–Schwarz upper bound
``query·mean + |query|·radius`` (``nn/BallTree.scala:53-55``).

The default query path is the brute-force product in
:mod:`mmlspark_tpu_torch.nn.knn` — the tree is the host structure used for
very large indices, for incremental queries, and for save/load parity with
the reference's hand-written ``ConditionalBallTree.py`` py4j wrapper.

The port's copy of ``mmlspark_tpu/nn/ball_tree.py`` (host numpy). ``load``
reads a tree pickled by either package: the JAX package's names map onto
this module's classes without importing that package.
"""

from __future__ import annotations

import heapq
import pickle
from dataclasses import dataclass, field
from typing import Any, Hashable, List, Optional, Sequence, Set, Tuple

import numpy as np


@dataclass
class _Node:
    mean: np.ndarray
    radius: float
    # leaf payload: row indices into the key matrix; None for inner nodes
    idx: Optional[np.ndarray] = None
    left: Optional["_Node"] = None
    right: Optional["_Node"] = None
    # labels present in this subtree (conditional tree only); used to skip
    # whole subtrees whose labels are disjoint from the conditioner — the
    # ReverseIndex role (``nn/BallTree.scala:182-201``).
    labels: Optional[frozenset] = None

    @property
    def is_leaf(self) -> bool:
        return self.idx is not None


@dataclass(order=True)
class BestMatch:
    """One query result: ``distance`` is the inner product (the reference
    returns inner products as 'distance', ``nn/KNN.scala:96-100``)."""

    distance: float
    index: int = field(compare=False)


def _make_split(keys: np.ndarray, idx: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Two-pivot split: pivot1 = furthest from idx[0], pivot2 = furthest from
    pivot1; points go to the nearer pivot (``nn/BallTree.scala:57-82``)."""
    pts = keys[idx]
    d0 = np.linalg.norm(pts - pts[0], axis=1)
    p1 = int(np.argmax(d0))
    d1 = np.linalg.norm(pts - pts[p1], axis=1)
    p2 = int(np.argmax(d1))
    d2 = np.linalg.norm(pts - pts[p2], axis=1)
    to_left = d1 <= d2
    # guard degenerate splits (all points identical)
    if to_left.all() or not to_left.any():
        half = len(idx) // 2
        return idx[:half], idx[half:]
    return idx[to_left], idx[~to_left]


def _build(keys: np.ndarray, idx: np.ndarray, leaf_size: int,
           labels: Optional[np.ndarray]) -> _Node:
    pts = keys[idx]
    mean = pts.mean(axis=0)
    radius = float(np.linalg.norm(pts - mean, axis=1).max()) if len(idx) else 0.0
    node_labels = frozenset(labels[idx].tolist()) if labels is not None else None
    if len(idx) <= leaf_size:
        return _Node(mean=mean, radius=radius, idx=idx, labels=node_labels)
    li, ri = _make_split(keys, idx)
    if len(li) == 0 or len(ri) == 0:  # pragma: no cover - guarded in _make_split
        return _Node(mean=mean, radius=radius, idx=idx, labels=node_labels)
    return _Node(
        mean=mean,
        radius=radius,
        left=_build(keys, li, leaf_size, labels),
        right=_build(keys, ri, leaf_size, labels),
        labels=node_labels,
    )


class BallTree:
    """MIPS ball tree over ``keys`` (n × d) carrying per-row ``values``.

    ``find_maximum_inner_products(q, k)`` returns the top-k
    :class:`BestMatch` sorted by descending inner product
    (``nn/BallTree.scala:146-152``).
    """

    def __init__(self, keys: np.ndarray, values: Sequence[Any], leaf_size: int = 50):
        self.keys = np.ascontiguousarray(np.asarray(keys, dtype=np.float64))
        if self.keys.ndim != 2:
            raise ValueError(f"keys must be 2-D, got shape {self.keys.shape}")
        if len(values) != len(self.keys):
            raise ValueError("values length must match keys")
        self.values = list(values)
        self.leaf_size = int(leaf_size)
        self.root = _build(self.keys, np.arange(len(self.keys)), self.leaf_size, self._label_array())

    def _label_array(self) -> Optional[np.ndarray]:
        return None

    # -- querying -----------------------------------------------------------

    def _upper_bound(self, q: np.ndarray, q_norm: float, node: _Node) -> float:
        # Cauchy–Schwarz MIP bound (``nn/BallTree.scala:53-55``)
        return float(q @ node.mean) + q_norm * node.radius

    def _leaf_scan(self, q: np.ndarray, node: _Node,
                   heap: List[Tuple[float, int]], k: int,
                   mask: Optional[np.ndarray]) -> None:
        idx = node.idx
        if mask is not None:
            idx = idx[mask[idx]]
            if len(idx) == 0:
                return
        scores = self.keys[idx] @ q
        for s, i in zip(scores, idx):
            if len(heap) < k:
                heapq.heappush(heap, (float(s), int(i)))
            elif s > heap[0][0]:
                heapq.heapreplace(heap, (float(s), int(i)))

    def _query(self, q: np.ndarray, k: int,
               conditioner: Optional[Set[Hashable]] = None,
               mask: Optional[np.ndarray] = None) -> List[BestMatch]:
        q = np.asarray(q, dtype=np.float64).ravel()
        q_norm = float(np.linalg.norm(q))
        heap: List[Tuple[float, int]] = []  # min-heap of (score, idx)
        stack = [self.root]
        while stack:
            node = stack.pop()
            if conditioner is not None and node.labels is not None \
                    and node.labels.isdisjoint(conditioner):
                continue
            if len(heap) >= k and self._upper_bound(q, q_norm, node) <= heap[0][0]:
                continue
            if node.is_leaf:
                self._leaf_scan(q, node, heap, k, mask)
            else:
                # visit the more promising child last so it is popped first
                ub_l = self._upper_bound(q, q_norm, node.left)
                ub_r = self._upper_bound(q, q_norm, node.right)
                children = (node.left, node.right) if ub_l <= ub_r else (node.right, node.left)
                stack.extend(children)
        return [BestMatch(distance=s, index=i)
                for s, i in sorted(heap, key=lambda t: -t[0])]

    def find_maximum_inner_products(self, query: np.ndarray, k: int = 1) -> List[BestMatch]:
        return self._query(query, k)

    # -- persistence (``ConditionalBallTree.save/load``, BallTree.scala:261) -

    def save(self, filename: str) -> None:
        with open(filename, "wb") as f:
            pickle.dump(self, f)

    @classmethod
    def load(cls, filename: str) -> "BallTree":
        from mmlspark_tpu_torch.core.serialize import load_pickle

        with open(filename, "rb") as f:
            tree = load_pickle(f)
        if not isinstance(tree, cls):
            raise TypeError(f"loaded {type(tree).__name__}, expected {cls.__name__}")
        return tree

    def __repr__(self) -> str:
        return f"{type(self).__name__}(n={len(self.keys)}, d={self.keys.shape[1]}, leaf_size={self.leaf_size})"


class ConditionalBallTree(BallTree):
    """Ball tree whose rows carry labels; queries pass a ``conditioner`` set
    of admissible labels (``nn/BallTree.scala:203-259``). Subtrees whose
    label sets are disjoint from the conditioner are pruned wholesale."""

    def __init__(self, keys: np.ndarray, values: Sequence[Any],
                 labels: Sequence[Hashable], leaf_size: int = 50):
        if len(labels) != len(values):
            raise ValueError("labels length must match values")
        self.labels = np.asarray(list(labels), dtype=object)
        super().__init__(keys, values, leaf_size)

    def _label_array(self) -> Optional[np.ndarray]:
        return self.labels

    def find_maximum_inner_products(self, query: np.ndarray, k: int = 1,
                                    conditioner: Optional[Set[Hashable]] = None
                                    ) -> List[BestMatch]:
        if conditioner is None:
            return self._query(query, k)
        conditioner = set(conditioner)
        mask = np.fromiter((l in conditioner for l in self.labels),
                           dtype=bool, count=len(self.labels))
        return self._query(query, k, conditioner=conditioner, mask=mask)
