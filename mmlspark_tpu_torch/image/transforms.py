"""ImageTransformer — a pipeline of image ops run on whole batches on the device.

The port's copy of ``mmlspark_tpu/image/transforms.py``, a re-design of
``opencv/ImageTransformer.scala:40-219``: the reference encodes each
OpenCV stage as a ``Map[String, Any]`` and runs a per-row UDF over JNI
mats. Here the same stage list drives an NHWC float32 pipeline of torch
ops: images are grouped by shape, stacked into batches, uploaded as they
are (uint8 stays uint8 on the wire) and transformed on the stage's
``device``.

Stage dict vocabulary mirrors the reference (``ResizeImage``, ``CropImage``,
``ColorFormat``, ``Flip``, ``Blur``, ``Threshold``, ``GaussianKernel``,
``Normalize``). Flip codes follow OpenCV: 0 = vertical (x-axis),
1 = horizontal, -1 = both.

Where the reference's jax ops have no PyTorch twin, the port copies their
arithmetic:

- **Resize** is ``jax.image.resize``: for every method but nearest, a
  weight matrix per spatial dimension (jax's ``scale_and_translate``:
  the triangle, Keys cubic or lanczos kernel, widened by the scale when
  downsampling (antialiasing), each output's weights normalised to sum 1,
  zero outside the input), built in numpy float32 (:func:`resize_weights`;
  the reference's compiled program fuses that arithmetic and parts in the
  last bits) and applied as one ``einsum`` per resized dimension; nearest takes
  jax's indices ``floor((i + 0.5) * in / out)`` in float32.
- **Blur and Gaussian** filter depthwise with jax's "SAME" padding (the
  odd cell behind for even kernel sizes).
- **Gray** is ``(x * w).sum(-1)`` over B, G, R in that order, with the
  fused multiply-adds of the reference's compiled CPU program
  (:func:`gray`), so its float bits are the reference's.
- **uint8 output** rounds half to even, then clips, as ``np.rint`` and
  ``np.clip`` do.
"""

from __future__ import annotations

import functools
from typing import Any, Callable, Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from mmlspark_tpu_torch.core.params import HasInputCol, HasOutputCol, Param, to_bool, to_str
from mmlspark_tpu_torch.core.pipeline import Transformer
from mmlspark_tpu_torch.data.table import Table
from mmlspark_tpu_torch.device import float32_exact, resolve_device
from mmlspark_tpu_torch.models.resnet import same_pads

_F32 = np.float32
_METHODS = {
    "nearest": "nearest",
    "linear": "linear", "bilinear": "linear", "trilinear": "linear", "triangle": "linear",
    "cubic": "cubic", "bicubic": "cubic", "tricubic": "cubic",
    "lanczos3": "lanczos3", "lanczos5": "lanczos5",
}


def _ensure_nhwc(batch: Any) -> Any:
    return batch if batch.ndim == 4 else batch[..., None]


def _triangle(x):
    return np.maximum(_F32(0), _F32(1) - np.abs(x))


def _keys_cubic(x):
    out = ((_F32(1.5) * x - _F32(2.5)) * x) * x + _F32(1.0)
    out = np.where(x >= 1.0, ((_F32(-0.5) * x + _F32(2.5)) * x - _F32(4.0)) * x + _F32(2.0), out)
    return np.where(x >= 2.0, _F32(0.0), out).astype(_F32)


def _lanczos(radius, x):
    r = _F32(radius)
    y = r * np.sin(_F32(np.pi) * x) * np.sin(_F32(np.pi) * x / r)
    denom = np.where(x != 0, _F32(np.pi ** 2) * (x * x), _F32(1))
    out = np.where(x > 1e-3, y / denom, _F32(1))
    return np.where(x > r, _F32(0.0), out).astype(_F32)


_KERNELS = {
    "linear": _triangle,
    "cubic": _keys_cubic,
    "lanczos3": lambda x: _lanczos(3.0, x),
    "lanczos5": lambda x: _lanczos(5.0, x),
}


def resolve_method(method: str) -> str:
    """The resize method's canonical name (jax's ``ResizeMethod`` names)."""
    if method not in _METHODS:
        raise ValueError(f'Unknown resize method "{method}"')
    return _METHODS[method]


@functools.lru_cache(maxsize=64)
def resize_weights(in_size: int, out_size: int, method: str) -> np.ndarray:
    """jax's ``compute_weight_mat`` for ``jax.image.resize`` (antialiased,
    no translation), in float32: an (in_size, out_size) matrix whose
    column j holds output j's weights over the input."""
    kernel = _KERNELS[resolve_method(method)]
    scale = out_size / in_size
    inv_scale = 1.0 / scale
    kernel_scale = _F32(max(inv_scale, 1.0))
    sample_f = (np.arange(out_size, dtype=_F32) + _F32(0.5)) * _F32(inv_scale) - _F32(0.5)
    x = np.abs(sample_f[None, :] - np.arange(in_size, dtype=_F32)[:, None]) / kernel_scale
    weights = kernel(x.astype(_F32)).astype(_F32)
    total = weights.sum(axis=0, keepdims=True, dtype=_F32)
    weights = np.where(np.abs(total) > _F32(1000.0 * np.finfo(np.float32).eps),
                       weights / np.where(total != 0, total, _F32(1)), _F32(0))
    inside = (sample_f >= -0.5) & (sample_f <= _F32(in_size - 0.5))
    return np.where(inside[None, :], weights, _F32(0)).astype(_F32)


@functools.lru_cache(maxsize=64)
def nearest_indices(in_size: int, out_size: int) -> np.ndarray:
    """jax's nearest-neighbour source index of each output cell:
    ``floor((i + 0.5) * in / out)`` in float32."""
    offsets = (np.arange(out_size, dtype=_F32) + _F32(0.5)) * _F32(in_size) / _F32(out_size)
    return np.floor(offsets.astype(_F32)).astype(np.int64)


def resize_nhwc(x: torch.Tensor, height: int, width: int, method: str = "linear"):
    """``jax.image.resize`` of an NHWC float32 batch to (height, width);
    dimensions whose size does not change are left as they are."""
    method = resolve_method(method)
    h, w = x.shape[1], x.shape[2]
    if method == "nearest":
        if h != height:
            x = x[:, torch.from_numpy(nearest_indices(h, height)).to(x.device)]
        if w != width:
            x = x[:, :, torch.from_numpy(nearest_indices(w, width)).to(x.device)]
        return x
    if h != height:
        wh = torch.from_numpy(resize_weights(h, height, method)).to(x.device, x.dtype)
        x = torch.einsum("nhwc,hk->nkwc", x, wh)
    if w != width:
        ww = torch.from_numpy(resize_weights(w, width, method)).to(x.device, x.dtype)
        x = torch.einsum("nhwc,wk->nhkc", x, ww)
    return x


def _op_resize(stage: Dict[str, Any]) -> Callable:
    h, w = int(stage["height"]), int(stage["width"])
    method = resolve_method(stage.get("method", "linear"))

    def run(x):
        return resize_nhwc(x, h, w, method)

    return run


def _op_crop(stage: Dict[str, Any]) -> Callable:
    x0, y0 = int(stage.get("x", 0)), int(stage.get("y", 0))
    h, w = int(stage["height"]), int(stage["width"])

    def run(x):
        return x[:, y0 : y0 + h, x0 : x0 + w, :]

    return run


# OpenCV BGR2GRAY luma weights, channel order B, G, R
GRAY_WEIGHTS = (0.114, 0.587, 0.299)


def gray(x: torch.Tensor) -> torch.Tensor:
    """The reference's ``(x * w).sum(-1)`` over B, G, R as its compiled
    CPU program computes it: ``x0 * w0``, then a fused multiply-add of each
    next channel in order. A float32 fused multiply-add is taken in float64
    (the product is exact there) and rounded once to float32."""
    w = torch.tensor(GRAY_WEIGHTS, dtype=torch.float32, device=x.device)
    acc = x[..., 0] * w[0]
    for c in (1, 2):
        acc = (x[..., c].double() * w[c].double() + acc.double()).to(x.dtype)
    return acc


def _op_color_format(stage: Dict[str, Any]) -> Callable:
    fmt = stage["format"]

    def run(x):
        if fmt == "gray":
            return gray(x)[..., None]
        if fmt in ("bgr2rgb", "rgb2bgr"):
            return torch.flip(x, dims=(-1,))
        raise ValueError(f"unknown color format {fmt!r}")

    return run


def _op_flip(stage: Dict[str, Any]) -> Callable:
    code = int(stage.get("flipCode", 1))

    def run(x):
        if code == 0:
            return torch.flip(x, dims=(1,))
        if code > 0:
            return torch.flip(x, dims=(2,))
        return torch.flip(x, dims=(1, 2))

    return run


def depthwise_filter(x: torch.Tensor, kernel2d: np.ndarray) -> torch.Tensor:
    """Same-padding depthwise conv of an NHWC batch with one 2-D kernel
    (jax's "SAME": the odd padding cell behind)."""
    c = x.shape[-1]
    k = torch.as_tensor(np.asarray(kernel2d), dtype=x.dtype, device=x.device)
    w = k[None, None].repeat(c, 1, 1, 1)  # OIHW, O=C, I=1
    xt = x.permute(0, 3, 1, 2)
    ph = same_pads(xt.shape[2], k.shape[0], 1)
    pw = same_pads(xt.shape[3], k.shape[1], 1)
    out = F.conv2d(F.pad(xt, (pw[0], pw[1], ph[0], ph[1])), w, groups=c)
    return out.permute(0, 2, 3, 1)


def _op_blur(stage: Dict[str, Any]) -> Callable:
    kh, kw = int(stage["height"]), int(stage["width"])
    kernel = np.full((kh, kw), 1.0 / (kh * kw))

    def run(x):
        return depthwise_filter(x, kernel)

    return run


def _op_threshold(stage: Dict[str, Any]) -> Callable:
    thresh = float(stage["threshold"])
    max_val = float(stage.get("maxVal", 255.0))

    def run(x):
        return torch.where(x > thresh, max_val, 0.0).to(x.dtype)

    return run


def _op_gaussian(stage: Dict[str, Any]) -> Callable:
    size = int(stage["apertureSize"])
    sigma = float(stage.get("sigma", 0.0))
    if sigma <= 0:  # OpenCV's default sigma rule
        sigma = 0.3 * ((size - 1) * 0.5 - 1) + 0.8
    ax = np.arange(size) - (size - 1) / 2.0
    g = np.exp(-(ax**2) / (2 * sigma**2))
    kernel = np.outer(g, g)
    kernel /= kernel.sum()

    def run(x):
        return depthwise_filter(x, kernel)

    return run


def _op_normalize(stage: Dict[str, Any]) -> Callable:
    mean = np.asarray(stage.get("mean", 0.0), dtype=np.float32)
    std = np.asarray(stage.get("std", 1.0), dtype=np.float32)
    scale = float(stage.get("scale", 1.0))

    def run(x):
        m = torch.as_tensor(mean, device=x.device)
        s = torch.as_tensor(std, device=x.device)
        return (x * scale - m) / s

    return run


_OPS: Dict[str, Callable[[Dict[str, Any]], Callable]] = {
    "ResizeImage": _op_resize,
    "CropImage": _op_crop,
    "ColorFormat": _op_color_format,
    "Flip": _op_flip,
    "Blur": _op_blur,
    "Threshold": _op_threshold,
    "GaussianKernel": _op_gaussian,
    "Normalize": _op_normalize,
}


def to_uint8(x: torch.Tensor) -> torch.Tensor:
    """Round half to even, clip to [0, 255], uint8 (the reference's
    ``np.clip(np.rint(x), 0, 255).astype(np.uint8)``)."""
    return torch.clamp(torch.round(x), 0, 255).to(torch.uint8)


class ImageTransformer(HasInputCol, HasOutputCol, Transformer):
    """Applies a list of image stages to an image column."""

    stages = Param("List of {'op': name, ...} stage dicts", default=[])
    toFloat = Param(
        "Emit float32 images (skip uint8 round-trip)", default=False, converter=to_bool
    )

    inputCol = Param("Image column", default="image", converter=to_str)
    outputCol = Param("Output image column", default="image_out", converter=to_str)
    device = Param("Torch device the stages run on: 'cuda' (default) or 'cpu'",
                   default="cuda", converter=to_str, port_only=True)

    # -- fluent stage builders (ImageTransformer.scala:70-219) ---------------

    def _add(self, stage: Dict[str, Any]) -> "ImageTransformer":
        self.set("stages", list(self.getStages()) + [stage])
        return self

    def resize(self, height: int, width: int) -> "ImageTransformer":
        return self._add({"op": "ResizeImage", "height": height, "width": width})

    def crop(self, x: int, y: int, height: int, width: int) -> "ImageTransformer":
        return self._add(
            {"op": "CropImage", "x": x, "y": y, "height": height, "width": width}
        )

    def color_format(self, fmt: str) -> "ImageTransformer":
        return self._add({"op": "ColorFormat", "format": fmt})

    def flip(self, flip_code: int = 1) -> "ImageTransformer":
        return self._add({"op": "Flip", "flipCode": flip_code})

    def blur(self, height: int, width: int) -> "ImageTransformer":
        return self._add({"op": "Blur", "height": height, "width": width})

    def threshold(self, threshold: float, max_val: float = 255.0) -> "ImageTransformer":
        return self._add(
            {"op": "Threshold", "threshold": threshold, "maxVal": max_val}
        )

    def gaussian_kernel(self, aperture_size: int, sigma: float = 0.0) -> "ImageTransformer":
        return self._add(
            {"op": "GaussianKernel", "apertureSize": aperture_size, "sigma": sigma}
        )

    def normalize(self, mean: Any, std: Any, scale: float = 1.0) -> "ImageTransformer":
        return self._add({"op": "Normalize", "mean": mean, "std": std, "scale": scale})

    # -- execution -----------------------------------------------------------

    def _pipeline(self) -> Callable:
        ops = []
        for stage in self.getStages():
            op_name = stage["op"]
            if op_name not in _OPS:
                raise ValueError(f"unknown image op {op_name!r}; have {sorted(_OPS)}")
            ops.append(_OPS[op_name](stage))

        def run(batch: torch.Tensor) -> torch.Tensor:
            x = batch.to(torch.float32)
            for op in ops:
                x = op(x)
            return x

        return run

    def transform(self, table: Table) -> Table:
        device = resolve_device(self.getDevice())
        col = table.column(self.getInputCol())
        run = self._pipeline()
        images = [np.asarray(im) for im in col]
        # equal-shape images go to the device as one batch each
        by_shape: Dict[Tuple[int, ...], List[int]] = {}
        for i, im in enumerate(images):
            by_shape.setdefault(im.shape, []).append(i)
        out: List[Any] = [None] * len(images)
        with float32_exact(), torch.no_grad():
            for shape, idxs in by_shape.items():
                batch = torch.from_numpy(_ensure_nhwc(np.stack([images[i] for i in idxs])))
                result = run(batch.to(device))
                if not self.getToFloat():
                    result = to_uint8(result)
                result = result.cpu().numpy()
                if result.shape[-1] == 1 and len(shape) == 2:
                    result = result[..., 0]
                for j, i in enumerate(idxs):
                    out[i] = result[j]
        return table.with_column(self.getOutputCol(), out)


class ImageSetAugmenter(HasInputCol, HasOutputCol, Transformer):
    """Flip-based dataset augmentation (``image/ImageSetAugmenter.scala``):
    emits the original rows plus a flipped copy per enabled axis."""

    inputCol = Param("Image column", default="image", converter=to_str)
    outputCol = Param("Output image column", default="image", converter=to_str)
    flipLeftRight = Param("Mirror horizontally", default=True, converter=to_bool)
    flipUpDown = Param("Mirror vertically", default=False, converter=to_bool)
    device = Param("Torch device the flips run on: 'cuda' (default) or 'cpu'",
                   default="cuda", converter=to_str, port_only=True)

    def transform(self, table: Table) -> Table:
        in_col, out_col = self.getInputCol(), self.getOutputCol()
        base = table if in_col == out_col else table.with_column(
            out_col, table.column(in_col)
        )
        results = [base]
        for enabled, code in ((self.getFlipLeftRight(), 1), (self.getFlipUpDown(), 0)):
            if enabled:
                results.append(ImageTransformer(
                    inputCol=in_col, outputCol=out_col, device=self.getDevice(),
                    stages=[{"op": "Flip", "flipCode": code}],
                ).transform(table))
        return Table.concat(results)
