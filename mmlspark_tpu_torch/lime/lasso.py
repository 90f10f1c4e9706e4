"""Batched lasso via coordinate descent — LIME's per-row local fit; the
port's copy of ``mmlspark_tpu/lime/lasso.py``.

Reference: ``lime/BreezeUtils.scala`` (``LassoCalculator2``: cyclic
coordinate descent, per-column least-squares on the residual followed by
soft-thresholding with ``lambda``; ``lambda=0`` degrades to plain least
squares) invoked per row through ``fitLassoUDF`` (``lime/LIME.scala:157``).

The whole batch of per-instance problems advances together on the
``device``: ``X`` is (B, n, d) and ``w`` (B, d), and each of ``MAX_ITER`` ×
d sequential column steps updates column j of every problem at once. The
step keeps the reference's arithmetic form: the whole residual is
recomputed per column (``r = y - X @ w + X[:, j] * w[j]``), never updated
incrementally, which is a different algorithm in float32.
"""

from __future__ import annotations

import numpy as np
import torch

from mmlspark_tpu_torch.device import DeviceLike, resolve_device

MAX_ITER = 100


def _lasso_batch(X: torch.Tensor, y: torch.Tensor, lam: float, max_iter: int) -> torch.Tensor:
    """(B, n, d), (B, n) float32 -> (B, d) coordinate-descent lasso weights
    (matches LassoCalculator2: the unpenalized one-column LS coefficient is
    soft-thresholded by lam)."""
    B, _, d = X.shape
    cols = X.transpose(1, 2).contiguous()  # (B, d, n): column j of each problem contiguous
    col_sq = torch.clamp((X * X).sum(dim=1), min=1e-12)  # (B, d)
    w = torch.zeros((B, d), dtype=X.dtype, device=X.device)
    for _ in range(max_iter):
        for j in range(d):
            xj = cols[:, j]  # (B, n)
            wj = w[:, j:j + 1]  # (B, 1)
            # residual excluding column j
            r = y - torch.bmm(X, w.unsqueeze(2)).squeeze(2) + xj * wj
            c = (xj.unsqueeze(1) @ r.unsqueeze(2)).reshape(B) / col_sq[:, j]
            w[:, j] = torch.sign(c) * torch.clamp(c.abs() - lam, min=0.0)
    return w


def fit_lasso_batch(X: np.ndarray, y: np.ndarray, lam: float,
                    max_iter: int = MAX_ITER, device: DeviceLike = None) -> np.ndarray:
    """Solve ``n_rows`` independent lasso problems on ``device`` (the card
    unless the CPU is named).

    X: (n_rows, n_samples, d), y: (n_rows, n_samples) -> (n_rows, d).
    """
    dev = resolve_device(device)
    out = _lasso_batch(
        torch.as_tensor(np.asarray(X, dtype=np.float32), device=dev),
        torch.as_tensor(np.asarray(y, dtype=np.float32), device=dev),
        float(np.float32(lam)),
        max_iter,
    )
    return out.cpu().numpy().astype(np.float64)
