"""Model interpretability (reference ``lime/``, SURVEY.md §2.8); the port's
copy of ``mmlspark_tpu/lime/``."""

from mmlspark_tpu_torch.lime.lasso import fit_lasso_batch
from mmlspark_tpu_torch.lime.lime import ImageLIME, TabularLIME, TabularLIMEModel
from mmlspark_tpu_torch.lime.superpixel import (
    SuperpixelData,
    SuperpixelTransformer,
    mask_image,
    slic,
)

__all__ = [
    "ImageLIME",
    "SuperpixelData",
    "SuperpixelTransformer",
    "TabularLIME",
    "TabularLIMEModel",
    "fit_lasso_batch",
    "mask_image",
    "slic",
]
