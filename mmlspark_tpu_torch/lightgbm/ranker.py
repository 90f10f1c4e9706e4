"""LightGBMRanker: LambdaRank (NDCG-weighted pairwise) learning to rank.

The port's counterpart of ``mmlspark_tpu/lightgbm/ranker.py``: ``groupCol``
defines the query groups (rows are sorted by group before training), and the
lambdarank objective is built per fit over them and handed to ``train``
(nothing is registered in ``objectives.OBJECTIVES``).

The reference pads every query to the longest one and builds dense (Q, G, G)
pair tensors in one program. At MSLR-WEB10K's shape (6,000 queries padded
to about 1,000 documents) that is 6e9 cells a tensor, so the port computes
the same function in chunks: queries ordered by size (longest first) are cut
into chunks of at most :data:`PAIR_BUDGET` pair cells, each padded to its own
longest query. A row's lambdas depend only on its own query, and padded
cells add nothing, so the chunking changes no value; the pairwise sums run
in float64 and round once to float32.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from mmlspark_tpu_torch.core.params import HasGroupCol, Param, gt, to_float, to_int, to_str
from mmlspark_tpu_torch.data.table import Table
from mmlspark_tpu_torch.lightgbm.base import (
    LightGBMBase,
    LightGBMModelBase,
    extract_features,
)
from mmlspark_tpu_torch.lightgbm.objectives import Objective
from mmlspark_tpu_torch.lightgbm.train import TrainResult

#: Pair cells (queries x documents x documents) one lambdarank chunk holds;
#: a cell takes about 27 bytes across a chunk's temporaries (phase 20 of
#: chip_smoke.py measures the step's peak).
PAIR_BUDGET = 1 << 24


def group_structure(group: np.ndarray) -> Tuple[np.ndarray, int]:
    """Row indices per group, padded with N, for rows sorted by group:
    (index (Q, G) int32, largest group size G)."""
    n = len(group)
    starts = np.flatnonzero(np.concatenate([[True], group[1:] != group[:-1]]))
    sizes = np.diff(np.concatenate([starts, [n]]))
    g_max = int(sizes.max())
    offs = np.arange(g_max)[None, :]
    idx = np.where(offs < sizes[:, None], starts[:, None] + offs, n).astype(np.int32)
    return idx, g_max


def lambdarank_chunks(group_index: np.ndarray, n: int,
                      pair_budget: int = PAIR_BUDGET) -> List[np.ndarray]:
    """The (q, g) row-index blocks of the chunked lambdarank step over ``n``
    rows (``group_index`` padded with ``n``): queries ordered by size,
    longest first (ties in query order), each block as many queries as fit
    ``pair_budget`` cells at its longest query's size (one query at least),
    cut to that size."""
    sizes = (group_index < n).sum(axis=1)
    order = np.argsort(-sizes, kind="stable")
    chunks, i = [], 0
    while i < len(order):
        g = int(sizes[order[i]])
        take = max(1, min(len(order) - i, pair_budget // max(g * g, 1)))
        chunks.append(group_index[order[i:i + take], :g].astype(np.int64))
        i += take
    return chunks


def _gain_fn(label_gain):
    """Relevance -> gain: LightGBM's 2^i - 1 (``label_gain`` None), else the
    table indexed by the integer label."""
    if label_gain is None:
        return lambda yy: (torch.exp2(yy.double()) - 1.0).to(torch.float32)
    table = torch.as_tensor(np.asarray(label_gain, np.float32))

    def fn(yy):
        lg = table.to(yy.device)
        return lg[torch.clamp(yy.to(torch.int64), 0, lg.shape[0] - 1)]

    return fn


def _chunk_lambdas(m, yy, ww, mask, gain_of, discounts, sigma: float):
    """(q, g) float32 lambdas and hessian weights of one padded chunk: the
    reference's arithmetic, with its transcendentals (the sigmoid, the gain's
    2^y) in float64 rounded once to float32 and the pair sums in float64,
    so that no value depends on the chunk's shape. ``discounts[r]`` is
    ``1 / log2(2 + r)``."""
    g = m.shape[1]
    neg = torch.where(mask, m, torch.full_like(m, -float("inf")))
    order = torch.argsort(-neg, dim=1, stable=True)
    pos = torch.argsort(order, dim=1, stable=True)  # 0-based rank by margin, descending
    discount = discounts[pos]
    maskf = mask.to(torch.float32)
    gain = gain_of(yy) * maskf
    sorted_gain = -torch.sort(-gain, dim=1).values
    ideal_discount = discounts[:g]
    idcg = torch.clamp((sorted_gain * ideal_discount[None, :]).sum(1, dtype=torch.float64)
                       .to(torch.float32), min=1e-12)
    diff = m[:, :, None] - m[:, None, :]  # s_i - s_j
    better = (yy[:, :, None] > yy[:, None, :]) & mask[:, :, None] & mask[:, None, :]
    delta = torch.abs((gain[:, :, None] - gain[:, None, :])
                      * (discount[:, :, None] - discount[:, None, :])) / idcg[:, None, None]
    # P(i should beat j but does not)
    rho = torch.sigmoid((-sigma * diff).double()).to(torch.float32)
    del diff
    zero = torch.zeros((), dtype=torch.float32, device=m.device)
    lam = torch.where(better, -sigma * rho * delta, zero)
    hees = torch.where(better, sigma * sigma * rho * (1 - rho) * delta, zero)
    del rho, delta, better
    grad = (lam.sum(2, dtype=torch.float64) - lam.sum(1, dtype=torch.float64)).to(torch.float32)
    hess = (hees.sum(2, dtype=torch.float64) + hees.sum(1, dtype=torch.float64)).to(torch.float32)
    return grad * ww, torch.clamp(hess, min=1e-16) * ww


def make_lambdarank_objective(group_index: np.ndarray, sigma: float = 1.0, label_gain=None,
                              pair_budget: int = PAIR_BUDGET) -> Objective:
    """The lambdarank :class:`Objective` of one fit over ``group_index``
    (:func:`group_structure`): LambdaRank lambdas, computed in chunks of at
    most ``pair_budget`` pair cells (:func:`lambdarank_chunks`)."""
    group_index = np.asarray(group_index)
    gain_of = _gain_fn(label_gain)
    on_device: Dict[Tuple[torch.device, int], List[torch.Tensor]] = {}

    def grad_hess(margins, y, w, **kw):
        n, dev = margins.shape[0], margins.device
        if (dev, n) not in on_device:
            on_device[(dev, n)] = [torch.as_tensor(c, device=dev)
                                   for c in lambdarank_chunks(group_index, n, pair_budget)]
        discounts = (1.0 / torch.log2(2.0 + torch.arange(
            group_index.shape[1], dtype=torch.float64, device=dev))).to(torch.float32)
        pad = margins.new_zeros(1)
        m_all, y_all, w_all = (torch.cat([a, pad]) for a in (margins[:, 0], y, w))
        grad = margins.new_zeros(n + 1)
        hess = margins.new_zeros(n + 1)
        for idx in on_device[(dev, n)]:
            mask = idx < n
            g, h = _chunk_lambdas(m_all[idx], y_all[idx], w_all[idx], mask, gain_of, discounts,
                                  sigma)
            grad[idx] = g  # every row is in one query: a store, no sum
            hess[idx] = h
        return grad[:n, None], torch.clamp(hess[:n], min=1e-16)[:, None]

    def init_score(y, num_classes, w):
        return np.zeros(1, dtype=np.float32)

    return Objective("lambdarank", lambda c: 1, grad_hess, init_score, "ndcg@5")


def ndcg_at_k(y: np.ndarray, score: np.ndarray, group: np.ndarray, k: int,
              label_gain=None) -> float:
    """Host NDCG@k averaged over the contiguous groups with a positive ideal
    DCG; ``label_gain``: relevance -> gain table (default 2^i - 1)."""
    if label_gain is None:
        def gains_of(yy):
            return (2.0 ** yy) - 1
    else:
        lg = np.asarray(label_gain, np.float64)

        def gains_of(yy):
            return lg[np.clip(yy.astype(np.int64), 0, len(lg) - 1)]
    y, score, group = np.asarray(y), np.asarray(score), np.asarray(group)
    starts = np.flatnonzero(np.concatenate([[True], group[1:] != group[:-1]]))
    ends = np.concatenate([starts[1:], [len(y)]])
    total, q = 0.0, 0
    for i, j in zip(starts, ends):
        yy, ss = y[i:j], score[i:j]
        order = np.argsort(-ss, kind="stable")[:k]
        dcg = float((gains_of(yy[order]) / np.log2(2 + np.arange(len(order)))).sum())
        ideal_y = np.sort(yy)[::-1][:k]
        idcg = float((gains_of(ideal_y) / np.log2(2 + np.arange(len(ideal_y)))).sum())
        if idcg > 0:
            total += dcg / idcg
            q += 1
    return total / max(q, 1)


class LightGBMRanker(HasGroupCol, LightGBMBase):
    objective = Param("Ranking objective", default="lambdarank", converter=to_str)
    sigma = Param("LambdaRank sigmoid steepness", default=1.0, converter=to_float,
                  validator=gt(0))
    evalAt = Param("NDCG truncation for eval", default=5, converter=to_int, validator=gt(0))
    maxPosition = Param("Accepted for parity (NDCG optimization position)", default=20,
                        converter=to_int)
    labelGain = Param(
        "Relevance->gain table for the lambdarank objective and ndcg eval (empty = "
        "LightGBM's default 2^i - 1); indexed by the integer relevance label",
        default=[],
    )

    def _objective_name(self) -> str:
        return "lambdarank"

    def _fit(self, table: Table):
        return super()._fit(table.sort_by(self.getGroupCol()))

    def _train_objective(self, table: Table) -> Optional[Objective]:
        idx, _ = group_structure(np.asarray(table.column(self.getGroupCol())))
        lg = self.getLabelGain() or None
        if lg is not None:
            max_label = int(np.max(table.column(self.getLabelCol())))
            if max_label >= len(lg):
                raise ValueError(f"labelGain has {len(lg)} entries but labels reach {max_label}")
        return make_lambdarank_objective(idx, self.getSigma(), label_gain=lg)

    def _extra_train_options(self) -> dict:
        # ndcg needs the groups, which the eval loop does not carry: l2 on
        # the margins unless the user set a metric (the reference's rule)
        return {} if self.getMetric() else {"metric": "l2"}

    def _make_model(self, result: TrainResult) -> "LightGBMRankerModel":
        return LightGBMRankerModel(
            featuresCol=self.getFeaturesCol(),
            predictionCol=self.getPredictionCol(),
            leafPredictionCol=self.getLeafPredictionCol(),
            featuresShapCol=self.getFeaturesShapCol(),
            boosterData=result.booster.to_dict(),
            device=self.getDevice(),
        )


class LightGBMRankerModel(LightGBMModelBase):
    def transform(self, table: Table) -> Table:
        booster = self.booster
        X = extract_features(table, self.getFeaturesCol(), booster.num_features)
        margins = booster.raw_margin(X, device=self.getDevice())[:, 0]
        out = table.with_column(self.getPredictionCol(), margins.astype(np.float64))
        return self._with_leaf_col(out, X, booster)
