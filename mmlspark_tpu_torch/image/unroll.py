"""UnrollImage / roll — image ↔ flat CHW vector (``image/UnrollImage.scala:28-87``).

The port's copy of ``mmlspark_tpu/image/unroll.py`` (host numpy, as there).

The reference unrolls ImageSchema rows (BGR byte buffers) into CHW-ordered
DenseVectors for CNTK input, with an unsigned-byte fixup. Here images are
already numpy HWC arrays; unrolling is a transpose + ravel, vectorized over
the column.
"""

from __future__ import annotations

from typing import List

import numpy as np

from mmlspark_tpu_torch.core.params import HasInputCol, HasOutputCol, Param, to_str
from mmlspark_tpu_torch.core.pipeline import Transformer
from mmlspark_tpu_torch.data.table import Table


def unroll_image(image: np.ndarray) -> np.ndarray:
    """HWC (or HW) uint8/float image -> flat float64 CHW vector."""
    arr = np.asarray(image)
    if arr.ndim == 2:
        arr = arr[..., None]
    chw = np.transpose(arr, (2, 0, 1)).astype(np.float64)
    return chw.ravel()


def roll_image(vector: np.ndarray, height: int, width: int, channels: int = 3) -> np.ndarray:
    """Inverse of :func:`unroll_image` (the reference's ``roll``)."""
    chw = np.asarray(vector, dtype=np.float64).reshape(channels, height, width)
    return np.transpose(chw, (1, 2, 0))


class UnrollImage(HasInputCol, HasOutputCol, Transformer):
    inputCol = Param("Image column", default="image", converter=to_str)
    outputCol = Param("Unrolled vector column", default="unrolled", converter=to_str)

    def transform(self, table: Table) -> Table:
        col = table.column(self.getInputCol())
        shapes = {np.asarray(im).shape for im in col}
        if len(shapes) == 1:
            stacked = np.stack([np.asarray(im) for im in col])
            if stacked.ndim == 3:
                stacked = stacked[..., None]
            flat = np.transpose(stacked, (0, 3, 1, 2)).reshape(len(col), -1)
            return table.with_column(self.getOutputCol(), flat.astype(np.float64))
        out: List[np.ndarray] = [unroll_image(im) for im in col]
        return table.with_column(self.getOutputCol(), out)
