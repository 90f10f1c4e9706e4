"""SAR — Smart Adaptive Recommendations; the port's copy of
``mmlspark_tpu/recommendation/sar.py``.

Reference: ``recommendation/SAR.scala:38-208`` (user-item affinity with
exponential time decay, item-item similarity with jaccard/lift/co-occurrence
measures) and ``recommendation/SARModel.scala:23-169`` (recommendForAllUsers
via block-matrix product of user affinity × item similarity).

Affinity and the similarity's arithmetic are host numpy in float64, as in
the reference. Two products run on the ``device``:

- co-occurrence ``C = Uᵀ·U`` with U the binary user×item interaction matrix,
  a float32 product (TF32 stays off, torch's default): its counts are exact
  integers below 2^24, so every device gives the same matrix;
- scoring ``S = A·sim`` (user affinity × item similarity) in float32 and a
  top-k in ``lax.top_k``'s order (ties to the lower item;
  :mod:`mmlspark_tpu_torch.ops.topk`).

The model keeps its similarity's device copy per device, made at the first
product and dropped when ``itemSimilarity`` or ``device`` is set.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch

from mmlspark_tpu_torch.core.params import Param, gt, one_of, to_int, to_str
from mmlspark_tpu_torch.core.pipeline import Estimator, Model
from mmlspark_tpu_torch.data.table import Table
from mmlspark_tpu_torch.device import DeviceLike, resolve_device
from mmlspark_tpu_torch.ops.topk import topk_ordered


class _SARParams:
    userCol = Param("User id column (integer ids; see RecommendationIndexer)",
                    default="user", converter=to_str)
    itemCol = Param("Item id column (integer ids)", default="item", converter=to_str)
    ratingCol = Param("Rating column (optional)", default="rating", converter=to_str)
    timeCol = Param("Event-time column (optional)", default="timestamp", converter=to_str)
    timeDecayCoeff = Param("Half-life of the affinity decay, in days",
                           default=30, converter=to_int, validator=gt(0))
    startTime = Param("Reference time (ISO string); default = max event time",
                      default=None)
    supportThreshold = Param("Min co-occurrence count for a nonzero similarity",
                             default=4, converter=to_int, validator=gt(0))
    similarityFunction = Param(
        "jaccard | lift | cooccurrence (``SAR.scala:150-207``)",
        default="jaccard",
        converter=to_str,
        validator=one_of("jaccard", "lift", "cooccurrence"),
    )
    device = Param("Torch device the products run on: 'cuda' (default) or 'cpu'",
                   default="cuda", converter=to_str, port_only=True)


def _to_minutes(col: np.ndarray) -> np.ndarray:
    """Event times -> float minutes. Accepts numeric epoch-seconds,
    numpy datetime64, or ISO-8601 strings."""
    if col.dtype == object or col.dtype.kind == "U":
        col = np.array([np.datetime64(str(v)) for v in col])
    if np.issubdtype(col.dtype, np.datetime64):
        return col.astype("datetime64[s]").astype(np.float64) / 60.0
    return col.astype(np.float64) / 60.0


def _cooccurrence(U: np.ndarray, device: DeviceLike = None) -> np.ndarray:
    """C[i,j] = #users who interacted with both i and j — one float32
    product on ``device`` (exact: integer counts below 2^24)."""
    Ut = torch.as_tensor(U, device=resolve_device(device))
    return (Ut.T @ Ut).cpu().numpy()


class SAR(_SARParams, Estimator):
    """Fits user-affinity + item-similarity matrices from an event table."""

    def _affinities(self, table: Table, n_users: int, n_items: int) -> np.ndarray:
        """User×item affinity: sum over events of rating × 2^(-Δt/half-life)
        (``SAR.scala:84-120``). Missing rating → 1; missing time → no decay."""
        users = table.column(self.getUserCol()).astype(np.int64)
        items = table.column(self.getItemCol()).astype(np.int64)
        n = len(users)
        weights = np.ones(n, dtype=np.float64)
        if self.getRatingCol() in table:
            weights = table.column(self.getRatingCol()).astype(np.float64)
        if self.getTimeCol() in table:
            t_min = _to_minutes(table.column(self.getTimeCol()))
            start = self.getStartTime()
            ref = (
                _to_minutes(np.array([start], dtype=object))[0]
                if start is not None
                else t_min.max()
            )
            half_life_min = self.getTimeDecayCoeff() * 24.0 * 60.0
            decay = np.power(2.0, -(ref - t_min) / half_life_min)
            weights = weights * decay
        aff = np.zeros((n_users, n_items), dtype=np.float64)
        np.add.at(aff, (users, items), weights)
        return aff

    def _similarity(self, table: Table, n_users: int, n_items: int) -> np.ndarray:
        """Item×item similarity from binary distinct-user co-occurrence
        (``SAR.scala:150-207``)."""
        users = table.column(self.getUserCol()).astype(np.int64)
        items = table.column(self.getItemCol()).astype(np.int64)
        U = np.zeros((n_users, n_items), dtype=np.float32)
        U[users, items] = 1.0  # distinct users per item pair
        cooc = np.asarray(_cooccurrence(U, self.getDevice()), dtype=np.float64)
        occ = np.diag(cooc).copy()
        fn = self.getSimilarityFunction()
        with np.errstate(invalid="ignore", divide="ignore"):
            if fn == "jaccard":
                denom = occ[:, None] + occ[None, :] - cooc
                sim = np.where(denom > 0, cooc / denom, 0.0)
            elif fn == "lift":
                denom = occ[:, None] * occ[None, :]
                sim = np.where(denom > 0, cooc / denom, 0.0)
            else:
                sim = cooc
        sim = np.where(cooc >= self.getSupportThreshold(), sim, 0.0)
        return sim

    def _fit(self, table: Table) -> "SARModel":
        resolve_device(self.getDevice())
        users = table.column(self.getUserCol()).astype(np.int64)
        items = table.column(self.getItemCol()).astype(np.int64)
        if users.min(initial=0) < 0 or items.min(initial=0) < 0:
            raise ValueError("user/item ids must be non-negative integers")
        n_users = int(users.max()) + 1
        n_items = int(items.max()) + 1
        model = SARModel(
            userCol=self.getUserCol(),
            itemCol=self.getItemCol(),
            ratingCol=self.getRatingCol(),
            userAffinity=self._affinities(table, n_users, n_items),
            itemSimilarity=self._similarity(table, n_users, n_items),
            device=self.getDevice(),
        )
        model.parent = self
        return model


def _score_topk(A: torch.Tensor, S: torch.Tensor, k: int):
    """scores = A·S in float32, then per-user top-k."""
    return topk_ordered(A @ S, k)


class SARModel(_SARParams, Model):
    """Holds the dense affinity/similarity factors
    (``SARModel.userDataFrame``/``itemDataFrame`` analogues)."""

    userAffinity = Param("User×item affinity matrix", is_complex=True, default=None)
    itemSimilarity = Param("Item×item similarity matrix", is_complex=True, default=None)

    def set(self, param: Any, value: Any) -> "SARModel":
        if self._resolve(param) in ("itemSimilarity", "device"):
            self._sim_on = {}
        return super().set(param, value)

    def _similarity_on(self, dev: torch.device) -> torch.Tensor:
        """``itemSimilarity`` as float32 on ``dev``, uploaded once."""
        cache: Dict[str, torch.Tensor] = getattr(self, "_sim_on", None) or {}
        key = str(dev)
        if key not in cache:
            S = torch.as_tensor(np.asarray(self.getItemSimilarity(), dtype=np.float32),
                                device=dev)
            self._sim_on = cache = {**cache, key: S}
        return cache[key]

    def _recommend(self, affinity: np.ndarray, k: int) -> Tuple[np.ndarray, np.ndarray]:
        dev = resolve_device(self.getDevice())
        S = self._similarity_on(dev)
        k = min(k, S.shape[0])
        A = torch.as_tensor(np.asarray(affinity, dtype=np.float32), device=dev)
        scores, idx = _score_topk(A, S, k)
        return idx.to(torch.int32).cpu().numpy(), scores.cpu().numpy().astype(np.float64)

    def recommend_for_all_users(self, num_items: int) -> Table:
        """(user, recommendations=[item...], ratings=[score...])
        (``SARModel.recommendForAllUsers``, ``SARModel.scala:51``)."""
        A = self.getUserAffinity()
        idx, scores = self._recommend(A, num_items)
        return Table({
            self.getUserCol(): np.arange(A.shape[0], dtype=np.int64),
            "recommendations": idx.astype(np.int64),
            "ratings": scores,
        })

    def recommend_for_user_subset(self, table: Table, num_items: int) -> Table:
        """Top-k for the unique user ids in ``table``; ids unseen at fit time
        are dropped — the reference's left-semi join against the factor frame
        (``SARModel.recommendForUserSubset``/``getSourceFactorSubset``,
        ``SARModel.scala:65-88``)."""
        users = np.unique(table.column(self.getUserCol()).astype(np.int64))
        users = users[(users >= 0) & (users < self.getUserAffinity().shape[0])]
        A = self.getUserAffinity()[users]
        idx, scores = self._recommend(A, num_items)
        return Table({
            self.getUserCol(): users,
            "recommendations": idx.astype(np.int64),
            "ratings": scores,
        })

    def transform(self, table: Table) -> Table:
        """Scores each (user, item) row: affinity·similarity[:, item].
        Cold-start users/items unseen at fit time score 0.0."""
        users = table.column(self.getUserCol()).astype(np.int64)
        items = table.column(self.getItemCol()).astype(np.int64)
        A = self.getUserAffinity()
        S = self.getItemSimilarity()
        known = (
            (users >= 0) & (users < A.shape[0])
            & (items >= 0) & (items < S.shape[1])
        )
        u = np.where(known, users, 0)
        i = np.where(known, items, 0)
        scores = np.einsum("ij,ij->i", A[u], S[:, i].T)
        return table.with_column("prediction", np.where(known, scores, 0.0))
