"""SLIC superpixel clustering + SuperpixelTransformer.

Reference: ``lime/Superpixel.scala:143+`` (grid-seeded cluster growth with
``cellSize`` / ``modifier`` params; ``SuperpixelData:26`` holds the cluster
pixel lists) and ``SuperpixelTransformer``. The reference's JVM algorithm
is a SLIC variant; here the standard SLIC iteration is fully vectorized in
numpy — host-side work, matching SURVEY.md §7 step 8 ("LIME: superpixels
host-side, perturbation batches are a natural vmap").

The port's copy of ``mmlspark_tpu/lime/superpixel.py`` (host numpy).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np

from mmlspark_tpu_torch.core.params import HasInputCol, HasOutputCol, Param, gt, to_float, to_int
from mmlspark_tpu_torch.core.pipeline import Transformer
from mmlspark_tpu_torch.data.table import Table


@dataclass
class SuperpixelData:
    """Cluster decomposition of one image: ``clusters[i]`` is an (n_i, 2)
    array of (row, col) pixel coordinates (``SuperpixelData`` schema)."""

    labels: np.ndarray  # (H, W) int cluster id per pixel
    clusters: List[np.ndarray]

    @property
    def num_clusters(self) -> int:
        return len(self.clusters)


def slic(image: np.ndarray, cell_size: int = 16, modifier: float = 130.0,
         n_iter: int = 10) -> SuperpixelData:
    """SLIC clustering: k-means over (color, position) with compactness
    ``modifier``, seeds on a ``cell_size`` grid."""
    img = np.asarray(image, dtype=np.float64)
    if img.ndim == 2:
        img = img[:, :, None]
    H, W, C = img.shape
    S = max(int(cell_size), 2)

    # grid seeds at cell centers
    ys = np.arange(S // 2, H, S)
    xs = np.arange(S // 2, W, S)
    cy, cx = np.meshgrid(ys, xs, indexing="ij")
    centers_pos = np.stack([cy.ravel(), cx.ravel()], axis=1).astype(np.float64)
    centers_col = img[centers_pos[:, 0].astype(int), centers_pos[:, 1].astype(int)]
    k = len(centers_pos)

    yy, xx = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    pos = np.stack([yy.ravel(), xx.ravel()], axis=1).astype(np.float64)  # (N, 2)
    colors = img.reshape(-1, C)
    # scale spatial distance so `modifier` plays SLIC compactness
    spatial_w = (modifier / 100.0) / S

    labels = np.zeros(len(pos), dtype=np.int64)
    for _ in range(n_iter):
        # full distance matrix in chunks to bound memory
        best = np.full(len(pos), np.inf)
        for start in range(0, k, 256):
            cp = centers_pos[start:start + 256]
            cc = centers_col[start:start + 256]
            d_col = ((colors[:, None, :] - cc[None, :, :]) ** 2).sum(-1)
            d_pos = ((pos[:, None, :] - cp[None, :, :]) ** 2).sum(-1)
            d = d_col + (spatial_w**2) * d_pos
            idx = d.argmin(axis=1)
            val = d[np.arange(len(pos)), idx]
            upd = val < best
            labels[upd] = idx[upd] + start
            best[upd] = val[upd]
        # recompute centers
        for j in range(k):
            m = labels == j
            if m.any():
                centers_pos[j] = pos[m].mean(axis=0)
                centers_col[j] = colors[m].mean(axis=0)

    # compact label ids (drop empty clusters)
    uniq, labels = np.unique(labels, return_inverse=True)
    label_img = labels.reshape(H, W)
    clusters = [np.argwhere(label_img == j) for j in range(len(uniq))]
    return SuperpixelData(labels=label_img, clusters=clusters)


def mask_image(image: np.ndarray, sp: SuperpixelData, states: np.ndarray) -> np.ndarray:
    """Keep clusters whose state is True; everything else black
    (``Superpixel.MaskImageUDF`` semantics)."""
    keep = np.zeros(sp.labels.shape, dtype=bool)
    for j, on in enumerate(states):
        if on:
            keep |= sp.labels == j
    out = np.asarray(image).copy()
    out[~keep] = 0
    return out


class SuperpixelTransformer(HasInputCol, HasOutputCol, Transformer):
    """Image column -> superpixel decomposition column
    (``lime/Superpixel.scala`` SuperpixelTransformer)."""

    cellSize = Param("Approximate superpixel grid size in pixels", default=16,
                     converter=to_int, validator=gt(1))
    modifier = Param("SLIC compactness", default=130.0, converter=to_float,
                     validator=gt(0))

    def __init__(self, **kwargs):
        kwargs.setdefault("outputCol", "superpixels")
        super().__init__(**kwargs)

    def transform(self, table: Table) -> Table:
        images = table.column(self.getInputCol())
        out = np.empty(len(images), dtype=object)
        for i, img in enumerate(images):
            out[i] = slic(img, self.getCellSize(), self.getModifier())
        return table.with_column(self.getOutputCol(), out)
