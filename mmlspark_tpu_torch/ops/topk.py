"""Top-k of float32 score rows in the reference's order.

``jax.lax.top_k`` compiles to a stable descending sort under float32's
total order (XLA compares the sign-folded bit patterns): among equal
scores the lower index comes first, ``0.0`` ranks above ``-0.0`` and NaN
above every number. ``torch.topk`` promises no order among ties. SAR meets
ties on every user (a support threshold zeroes most similarities, and an
unseen item scores 0), and KNN on duplicate keys, so both take their
top-k from here.

Two forms give the same indices and values:

- ``"sort"``: a stable descending sort of each row's total-order keys;
- ``"select"``: ``torch.topk`` of the keys, the k chosen put in order
  (keys descending, index ascending), and a stable sort of only those rows
  where the k-th key has more holders in the row than in the choice.

The default is ``"select"`` for rows wider than :data:`SORT_MAX_WIDTH` and
``"sort"`` otherwise (timed on the card by ``chip_smoke.py`` phase 34).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

#: rows at most this wide take the full stable sort by default
SORT_MAX_WIDTH = 8192


def total_order_key(x: torch.Tensor) -> torch.Tensor:
    """int32 keys of float32 ``x`` that order as XLA's float comparator does:
    the bit pattern, with the magnitude bits of negatives flipped."""
    bits = x.contiguous().view(torch.int32)
    return torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)


def _canonical(keys: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``idx`` (rows, k) reordered by key descending, then index ascending."""
    idx, order = idx.sort(dim=1)
    k_by_idx = keys.gather(1, idx)
    _, order = k_by_idx.sort(dim=1, descending=True, stable=True)
    return idx.gather(1, order)


def topk_ordered(scores: torch.Tensor, k: int, method: Optional[str] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(values, int64 indices), each (rows, k), of float32 ``scores``
    (rows, n) in ``lax.top_k``'s order. ``method``: "sort", "select" or None
    (by the row width)."""
    if scores.dtype != torch.float32:
        raise TypeError(f"scores must be float32, got {scores.dtype}")
    n = scores.shape[1]
    k = min(int(k), n)
    if method is None:
        method = "sort" if n <= SORT_MAX_WIDTH else "select"
    keys = total_order_key(scores)
    if method == "sort":
        idx = keys.sort(dim=1, descending=True, stable=True)[1][:, :k]
    elif method == "select":
        idx = _canonical(keys, torch.topk(keys, k, dim=1, sorted=False)[1])
        if k > 0:
            kth = keys.gather(1, idx[:, k - 1:])
            in_row = (keys == kth).sum(dim=1)
            in_choice = (keys.gather(1, idx) == kth).sum(dim=1)
            redo = torch.nonzero(in_row > in_choice).flatten()
            if redo.numel():
                idx[redo] = keys[redo].sort(dim=1, descending=True, stable=True)[1][:, :k]
    else:
        raise ValueError(f"method must be 'sort' or 'select', got {method!r}")
    return scores.gather(1, idx), idx
