"""Image pipeline: the port's copy of ``mmlspark_tpu/image/``.

The reference crosses every image row into OpenCV JNI mats
(``opencv/ImageTransformer.scala``); here images are numpy HWC arrays
batched by shape and transformed by torch ops on the device (resize, crop,
flip, blur, threshold on whole batches).
"""

from mmlspark_tpu_torch.image.featurizer import ImageFeaturizer
from mmlspark_tpu_torch.image.transforms import ImageSetAugmenter, ImageTransformer
from mmlspark_tpu_torch.image.unroll import UnrollImage, roll_image, unroll_image

__all__ = [
    "ImageFeaturizer",
    "ImageSetAugmenter",
    "ImageTransformer",
    "UnrollImage",
    "roll_image",
    "unroll_image",
]
