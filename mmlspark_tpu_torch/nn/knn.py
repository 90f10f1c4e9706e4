"""KNN / ConditionalKNN — maximum-inner-product nearest neighbors; the
port's copy of ``mmlspark_tpu/nn/knn.py``.

Reference: ``nn/KNN.scala:45-115`` (fit collects the index onto one node,
builds a ball tree, broadcasts it, queries per row via UDF) and
``ConditionalKNN`` with label-filtered queries; optimized fit injection at
``org/apache/spark/sql/types/injections/OptimizedCKNNFitting.scala:74``.

The default query path is brute force on the model's ``device``: one
``queries @ keys.T`` float32 product (TF32 stays off, torch's default) and a top-k per batch of
:data:`_QUERY_BATCH` queries, in ``lax.top_k``'s order (ties to the lower
index; :mod:`mmlspark_tpu_torch.ops.topk`). The host ball tree
(:mod:`mmlspark_tpu_torch.nn.ball_tree`) remains available via
``method="balltree"``.

Conditional queries mask inadmissible index rows to ``-inf`` before the
top-k; rows are grouped by distinct conditioner so each group is one masked
product.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np
import torch

from mmlspark_tpu_torch.core.params import (
    HasFeaturesCol,
    HasOutputCol,
    Param,
    one_of,
    to_int,
    to_str,
)
from mmlspark_tpu_torch.core.pipeline import Estimator, Model
from mmlspark_tpu_torch.data.table import Table
from mmlspark_tpu_torch.device import DeviceLike, resolve_device
from mmlspark_tpu_torch.nn.ball_tree import BallTree, ConditionalBallTree
from mmlspark_tpu_torch.ops.topk import topk_ordered

_QUERY_BATCH = 4096


def _run_topk(K: torch.Tensor, Q: torch.Tensor, m: Optional[torch.Tensor], k: int):
    """(scores, indices) of the top ``k`` of ``Q @ K.T`` per query row;
    rows of ``K`` where ``m`` is False score ``-inf``."""
    scores = Q @ K.T  # (nq, n)
    if m is not None:
        scores = scores.masked_fill_(~m[None, :], -torch.inf)
    return topk_ordered(scores, k)


def _topk_inner_products(keys: np.ndarray, queries: np.ndarray, k: int,
                         mask: Optional[np.ndarray] = None, device: DeviceLike = None):
    """Batched MIPS on ``device``: scores = Q·Kᵀ in float32, then top-k per row.

    Returns (scores, indices) as host arrays, shapes (nq, k).
    ``mask``: optional bool (n_index,) — False rows are excluded. ``keys``
    may be a float32 tensor already on ``device`` (uploaded once for many
    calls).
    """
    dev = resolve_device(device)
    k = min(k, len(keys))
    K = _upload_keys(keys, dev)
    m = None if mask is None else torch.as_tensor(np.asarray(mask, dtype=bool), device=dev)
    out_s: List[np.ndarray] = []
    out_i: List[np.ndarray] = []
    for start in range(0, len(queries), _QUERY_BATCH):
        Q = torch.as_tensor(np.asarray(queries[start:start + _QUERY_BATCH], dtype=np.float32),
                            device=dev)
        s, i = _run_topk(K, Q, m, k)
        out_s.append(s.cpu().numpy())
        out_i.append(i.to(torch.int32).cpu().numpy())
    if not out_s:
        return np.zeros((0, k), np.float32), np.zeros((0, k), np.int32)
    return np.concatenate(out_s), np.concatenate(out_i)


def _upload_keys(keys, dev: torch.device) -> torch.Tensor:
    if isinstance(keys, torch.Tensor):
        return keys.to(device=dev, dtype=torch.float32)
    return torch.as_tensor(np.asarray(keys, dtype=np.float32), device=dev)


class _KNNParams(HasFeaturesCol, HasOutputCol):
    """Shared params (``nn/KNN.scala:21-44``)."""

    valuesCol = Param("Column of values returned for each match", default="values",
                      converter=to_str)
    k = Param("Number of matches to return", default=5, converter=to_int)
    leafSize = Param("Max leaf size of the ball tree", default=50, converter=to_int)
    method = Param("Query engine: 'brute' (matmul top-k on the device) or 'balltree' (host)",
                   default="brute", validator=one_of("brute", "balltree"))
    device = Param("Torch device brute-force queries run on: 'cuda' (default) or 'cpu'",
                   default="cuda", converter=to_str, port_only=True)


class KNN(_KNNParams, Estimator):
    """Fits a MIPS index over (featuresCol, valuesCol) rows."""

    def __init__(self, **kwargs):
        kwargs.setdefault("outputCol", None)
        super().__init__(**kwargs)

    def _fit(self, table: Table) -> "KNNModel":
        resolve_device(self.getDevice())
        keys = np.asarray(table.column(self.getFeaturesCol()), dtype=np.float64)
        values = list(table.column(self.getValuesCol()))
        model = KNNModel(
            featuresCol=self.getFeaturesCol(),
            valuesCol=self.getValuesCol(),
            outputCol=self.getOutputCol() or f"{self.uid}_output",
            k=self.getK(),
            leafSize=self.getLeafSize(),
            method=self.getMethod(),
            indexKeys=keys,
            indexValues=values,
            device=self.getDevice(),
        )
        model.parent = self
        return model


class KNNModel(_KNNParams, Model):
    indexKeys = Param("Index key matrix (n × d)", is_complex=True, default=None)
    indexValues = Param("Per-row values returned on match", is_complex=True, default=None)

    def _ball_tree(self) -> BallTree:
        if getattr(self, "_tree", None) is None:
            self._tree = BallTree(self.getIndexKeys(), self.getIndexValues(),
                                  leaf_size=self.getLeafSize())
        return self._tree

    def transform(self, table: Table) -> Table:
        queries = np.asarray(table.column(self.getFeaturesCol()), dtype=np.float64)
        k = self.getK()
        values = self.getIndexValues()
        out = np.empty(len(queries), dtype=object)
        if self.getMethod() == "brute":
            scores, idx = _topk_inner_products(self.getIndexKeys(), queries, k,
                                               device=self.getDevice())
            for r in range(len(queries)):
                out[r] = [{"value": values[idx[r, j]], "distance": float(scores[r, j])}
                          for j in range(idx.shape[1])]
        else:
            tree = self._ball_tree()
            for r in range(len(queries)):
                out[r] = [{"value": values[m.index], "distance": m.distance}
                          for m in tree.find_maximum_inner_products(queries[r], k)]
        return table.with_column(self.getOutputCol(), out)


class _ConditionalKNNParams(_KNNParams):
    labelCol = Param("Column of index labels for conditional queries",
                     default="labels", converter=to_str)
    conditionerCol = Param("Query column holding the set of admissible labels",
                           default="conditioner", converter=to_str)


class ConditionalKNN(_ConditionalKNNParams, Estimator):
    """KNN whose matches are restricted per query to a set of labels
    (``nn/BallTree.scala:203``; fit injection ``OptimizedCKNNFitting.scala:74``)."""

    def __init__(self, **kwargs):
        kwargs.setdefault("outputCol", None)
        super().__init__(**kwargs)

    def _fit(self, table: Table) -> "ConditionalKNNModel":
        resolve_device(self.getDevice())
        keys = np.asarray(table.column(self.getFeaturesCol()), dtype=np.float64)
        values = list(table.column(self.getValuesCol()))
        labels = list(table.column(self.getLabelCol()))
        model = ConditionalKNNModel(
            featuresCol=self.getFeaturesCol(),
            valuesCol=self.getValuesCol(),
            labelCol=self.getLabelCol(),
            conditionerCol=self.getConditionerCol(),
            outputCol=self.getOutputCol() or f"{self.uid}_output",
            k=self.getK(),
            leafSize=self.getLeafSize(),
            method=self.getMethod(),
            indexKeys=keys,
            indexValues=values,
            indexLabels=labels,
            device=self.getDevice(),
        )
        model.parent = self
        return model


class ConditionalKNNModel(_ConditionalKNNParams, Model):
    indexKeys = Param("Index key matrix (n × d)", is_complex=True, default=None)
    indexValues = Param("Per-row values returned on match", is_complex=True, default=None)
    indexLabels = Param("Per-row labels filtered by the conditioner", is_complex=True,
                        default=None)

    def _ball_tree(self) -> ConditionalBallTree:
        if getattr(self, "_tree", None) is None:
            self._tree = ConditionalBallTree(
                self.getIndexKeys(), self.getIndexValues(), self.getIndexLabels(),
                leaf_size=self.getLeafSize())
        return self._tree

    def transform(self, table: Table) -> Table:
        queries = np.asarray(table.column(self.getFeaturesCol()), dtype=np.float64)
        conditioners = table.column(self.getConditionerCol())
        k = self.getK()
        values = self.getIndexValues()
        labels = np.asarray(self.getIndexLabels(), dtype=object)
        out = np.empty(len(queries), dtype=object)
        if self.getMethod() == "brute":
            # group rows by distinct conditioner → one masked product per group,
            # over keys uploaded once
            dev = resolve_device(self.getDevice())
            keys = _upload_keys(self.getIndexKeys(), dev)
            groups: Dict[frozenset, List[int]] = {}
            for r, c in enumerate(conditioners):
                groups.setdefault(frozenset(c), []).append(r)
            # index rows by label once; a group's mask is the union of its
            # labels' rows (``l in cond`` over the index, one pass in all)
            rows_of: Dict[Any, List[int]] = {}
            for i, l in enumerate(labels):
                rows_of.setdefault(l, []).append(i)
            for cond, rows in groups.items():
                mask = np.zeros(len(labels), dtype=bool)
                for c in cond:
                    mask[rows_of.get(c, [])] = True
                kk = min(k, int(mask.sum()))
                if kk == 0:
                    for r in rows:
                        out[r] = []
                    continue
                scores, idx = _topk_inner_products(keys, queries[rows], kk, mask=mask,
                                                   device=dev)
                for n, r in enumerate(rows):
                    out[r] = [{"value": values[idx[n, j]],
                               "distance": float(scores[n, j]),
                               "label": labels[idx[n, j]]}
                              for j in range(kk)]
        else:
            tree = self._ball_tree()
            for r in range(len(queries)):
                matches = tree.find_maximum_inner_products(
                    queries[r], k, conditioner=set(conditioners[r]))
                out[r] = [{"value": values[m.index], "distance": m.distance,
                           "label": labels[m.index]} for m in matches]
        return table.with_column(self.getOutputCol(), out)
