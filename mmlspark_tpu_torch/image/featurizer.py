"""ImageFeaturizer — transfer-learning featurization on the card.

The port's copy of ``mmlspark_tpu/image/featurizer.py``, a re-design of
``image/ImageFeaturizer.scala:40-86``: the reference wraps a downloaded
CNTK model, cuts ``cutOutputLayers`` layers off the top, and prepends
resize/unroll. Here the backbone is a PyTorch network (default: the
:mod:`mmlspark_tpu_torch.models.resnet` zoo) and the chain — resize
(:class:`ImageTransformer`, grouped by shape) → scale → NCHW layout →
backbone forward with ``cut`` — runs in fixed-shape device batches through
:class:`DNNModel`. The default backbone's weights go to the device once per
transform, as a :class:`~mmlspark_tpu_torch.models.resnet.ResNet` with its
BatchNorm affines folded.
"""

from __future__ import annotations

import torch

from mmlspark_tpu_torch.core.params import Param, gt, to_bool, to_int, to_str
from mmlspark_tpu_torch.core.pipeline import Model
from mmlspark_tpu_torch.data.table import Table
from mmlspark_tpu_torch.device import resolve_device
from mmlspark_tpu_torch.dnn.model import DNNModel
from mmlspark_tpu_torch.image.transforms import ImageTransformer


class ImageFeaturizer(Model):
    """Featurize an image column with a (cut) deep network."""

    inputCol = Param("Image column", default="image", converter=to_str)
    outputCol = Param("Feature vector column", default="features", converter=to_str)
    modelParams = Param(
        "Backbone parameter tree (mmlspark_tpu_torch.models zoo format)",
        default=None,
        is_complex=True,
    )
    applyFn = Param(
        "Backbone (params, x, cut) -> tensor; default resnet_apply",
        default=None,
        is_complex=True,
    )
    cutOutputLayers = Param(
        "Layers cut from the top: 0 = logits (headful), 1 = pooled features "
        "(reference default), 2 = feature map",
        default=1,
        converter=to_int,
    )
    inputHeight = Param("Model input height", default=32, converter=to_int, validator=gt(0))
    inputWidth = Param("Model input width", default=32, converter=to_int, validator=gt(0))
    autoResize = Param(
        "Resize images to the model input (ResizeImageTransformer analogue)",
        default=True,
        converter=to_bool,
    )
    scale = Param("Pixel scale applied before the backbone", default=1.0 / 255.0)
    batchSize = Param("Device batch size", default=64, converter=to_int, validator=gt(0))
    device = Param("Torch device the resize and the backbone run on: 'cuda' (default) "
                   "or 'cpu'", default="cuda", converter=to_str, port_only=True)

    def transform(self, table: Table) -> Table:
        params = self.getModelParams()
        if params is None:
            raise ValueError("modelParams must be set (see mmlspark_tpu_torch.models)")
        device = resolve_device(self.getDevice())
        work = table
        image_col = self.getInputCol()
        if self.getAutoResize():
            resized_col = "__resized__"
            work = ImageTransformer(
                inputCol=image_col,
                outputCol=resized_col,
                toFloat=True,
                device=self.getDevice(),
                stages=[
                    {
                        "op": "ResizeImage",
                        "height": self.getInputHeight(),
                        "width": self.getInputWidth(),
                    }
                ],
            ).transform(work)
            image_col = resized_col

        backbone = self.getApplyFn()
        if backbone is None:
            from mmlspark_tpu_torch.models.resnet import ResNet, resnet_apply

            backbone = resnet_apply
            if not isinstance(params, ResNet):
                params = ResNet(params, device=device)
        cut = self.getCutOutputLayers()
        scale = float(self.getScale())

        def apply_fn(p, inputs):
            x = inputs["input"].to(torch.float32) * scale
            x = x.permute(0, 3, 1, 2)  # NHWC -> NCHW
            return {"output": backbone(p, x, cut)}

        dnn = DNNModel(
            applyFn=apply_fn,
            modelParams=params,
            feedDict={"input": image_col},
            fetchDict={self.getOutputCol(): "output"},
            batchSize=self.getBatchSize(),
            device=self.getDevice(),
        )
        out = dnn.transform(work)
        if image_col != self.getInputCol():
            out = out.drop(image_col)
        return out

