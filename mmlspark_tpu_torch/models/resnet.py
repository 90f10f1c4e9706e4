"""Functional ResNet in PyTorch: the ImageFeaturizer backbone.

The port's copy of ``mmlspark_tpu/models/resnet.py``. ``init_resnet`` makes
the reference's parameter tree with the same numpy draws, so the weights
are its bits. ``resnet_apply(params, x, cut, dtype)`` keeps its contract:
``cut`` 0 gives logits, 1 pooled features, 2 the last feature map. The
convolutions are ``F.conv2d`` (cuDNN on the card).

Three points follow the reference's arithmetic rather than PyTorch's
habits:

- "SAME" padding is jax's: ``total // 2`` in front and the rest behind, so
  a strided map starts where the reference's does (the 7x7/2 stem on 224
  pads 2 and 3, a 3x3/2 conv on 56 pads 0 and 1);
- BatchNorm is the folded affine ``x * (gamma * inv) + (beta - mean *
  gamma * inv)`` with ``inv = (var + 1e-5) ** -0.5``, not
  ``F.batch_norm``;
- the stem's max pool is 3/2 with one cell of ``-inf`` on each side.

:class:`ResNet` holds one parameter tree on a device with its BatchNorm
affines folded once; ``resnet_apply`` accepts it in place of the tree.
Layout NCHW; weights are float32 at rest and cast to ``dtype`` (for
example ``torch.bfloat16``) only when it is asked for.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from mmlspark_tpu_torch.core.pytree import to_device
from mmlspark_tpu_torch.device import DeviceLike, resolve_device

VARIANTS: Dict[str, Tuple[Tuple[int, ...], bool]] = {
    # name -> (blocks per stage, bottleneck?)
    "resnet18": ((2, 2, 2, 2), False),
    "resnet34": ((3, 4, 6, 3), False),
    "resnet50": ((3, 4, 6, 3), True),
}

_STAGE_WIDTHS = (64, 128, 256, 512)
BN_EPS = 1e-5


def _he(rng: np.random.Generator, shape: Tuple[int, ...]) -> np.ndarray:
    fan_in = int(np.prod(shape[1:])) if len(shape) > 1 else shape[0]
    return (rng.standard_normal(shape) * np.sqrt(2.0 / fan_in)).astype(np.float32)


def _conv_params(rng, c_out, c_in, k) -> Dict[str, np.ndarray]:
    return {"w": _he(rng, (c_out, c_in, k, k))}


def _bn_params(c) -> Dict[str, np.ndarray]:
    return {
        "gamma": np.ones(c, np.float32),
        "beta": np.zeros(c, np.float32),
        "mean": np.zeros(c, np.float32),
        "var": np.ones(c, np.float32),
    }


def init_resnet(
    seed: int = 0,
    variant: str = "resnet18",
    num_classes: int = 1000,
    in_channels: int = 3,
    small_inputs: bool = False,
) -> Dict[str, Any]:
    """Random-init parameter tree of numpy arrays, the reference's bit for
    bit. ``small_inputs`` uses the CIFAR stem (3x3 stride-1 conv, no
    maxpool) instead of the ImageNet 7x7 stride-2."""
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}; choose from {sorted(VARIANTS)}")
    blocks, bottleneck = VARIANTS[variant]
    rng = np.random.default_rng(seed)
    expansion = 4 if bottleneck else 1
    # the architecture is the tree's structure (stem kernel size: small
    # inputs; conv3 present: bottleneck), so the tree holds arrays only
    params: Dict[str, Any] = {
        "stem": {
            "conv": _conv_params(rng, 64, in_channels, 3 if small_inputs else 7),
            "bn": _bn_params(64),
        },
    }
    c_in = 64
    stages: List[List[Dict[str, Any]]] = []
    for stage_i, (n_blocks, width) in enumerate(zip(blocks, _STAGE_WIDTHS)):
        stage: List[Dict[str, Any]] = []
        for block_i in range(n_blocks):
            stride = 2 if (stage_i > 0 and block_i == 0) else 1
            c_out = width * expansion
            block: Dict[str, Any] = {}
            if bottleneck:
                block["conv1"] = _conv_params(rng, width, c_in, 1)
                block["bn1"] = _bn_params(width)
                block["conv2"] = _conv_params(rng, width, width, 3)
                block["bn2"] = _bn_params(width)
                block["conv3"] = _conv_params(rng, c_out, width, 1)
                block["bn3"] = _bn_params(c_out)
            else:
                block["conv1"] = _conv_params(rng, width, c_in, 3)
                block["bn1"] = _bn_params(width)
                block["conv2"] = _conv_params(rng, width, width, 3)
                block["bn2"] = _bn_params(width)
            if stride != 1 or c_in != c_out:
                block["down_conv"] = _conv_params(rng, c_out, c_in, 1)
                block["down_bn"] = _bn_params(c_out)
            stage.append(block)
            c_in = c_out
        stages.append(stage)
    params["stages"] = stages
    params["fc"] = {
        "w": _he(rng, (num_classes, c_in)),
        "b": np.zeros(num_classes, np.float32),
    }
    return params


def same_pads(size: int, k: int, stride: int, dilation: int = 1) -> Tuple[int, int]:
    """jax's "SAME" padding of one spatial dimension: the output has
    ``ceil(size / stride)`` cells and the padding's odd cell goes behind."""
    k_eff = (k - 1) * dilation + 1
    out = -(-size // stride)
    total = max((out - 1) * stride + k_eff - size, 0)
    return total // 2, total - total // 2


def conv2d_same(x: torch.Tensor, w: torch.Tensor, stride: int = 1, groups: int = 1,
                dilation: int = 1) -> torch.Tensor:
    """``F.conv2d`` with jax's "SAME" padding (asymmetric where the total is
    odd: then padded with ``F.pad`` first)."""
    ph = same_pads(x.shape[2], w.shape[2], stride, dilation)
    pw = same_pads(x.shape[3], w.shape[3], stride, dilation)
    if ph[0] == ph[1] and pw[0] == pw[1]:
        return F.conv2d(x, w, stride=stride, padding=(ph[0], pw[0]), dilation=dilation,
                        groups=groups)
    return F.conv2d(F.pad(x, (pw[0], pw[1], ph[0], ph[1])), w, stride=stride,
                    dilation=dilation, groups=groups)


def fold_bn(p: Dict[str, torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
    """A BatchNorm's folded scale and shift, float32, in the reference's
    order of operations."""
    inv = (p["var"] + BN_EPS) ** -0.5
    return p["gamma"] * inv, p["beta"] - p["mean"] * p["gamma"] * inv


def _bn(x, p, folded):
    scale, shift = folded[id(p)] if folded is not None else fold_bn(p)
    return x * scale.to(x.dtype).reshape(1, -1, 1, 1) + shift.to(x.dtype).reshape(1, -1, 1, 1)


def _conv(x, p, stride=1):
    return conv2d_same(x, p["w"].to(x.dtype), stride)


def _block(x, p, stride, bottleneck, folded):
    identity = x
    if bottleneck:
        out = torch.relu(_bn(_conv(x, p["conv1"], 1), p["bn1"], folded))
        out = torch.relu(_bn(_conv(out, p["conv2"], stride), p["bn2"], folded))
        out = _bn(_conv(out, p["conv3"], 1), p["bn3"], folded)
    else:
        out = torch.relu(_bn(_conv(x, p["conv1"], stride), p["bn1"], folded))
        out = _bn(_conv(out, p["conv2"], 1), p["bn2"], folded)
    if "down_conv" in p:
        identity = _bn(_conv(x, p["down_conv"], stride), p["down_bn"], folded)
    return torch.relu(out + identity)


def _forward(params, x, cut, dtype, folded):
    small_inputs = params["stem"]["conv"]["w"].shape[-1] == 3
    bottleneck = "conv3" in params["stages"][0][0]
    if dtype is not None:
        x = x.to(dtype)
    stride = 1 if small_inputs else 2
    x = torch.relu(_bn(_conv(x, params["stem"]["conv"], stride), params["stem"]["bn"], folded))
    if not small_inputs:
        x = F.max_pool2d(x, kernel_size=3, stride=2, padding=1)
    for stage_i, stage in enumerate(params["stages"]):
        for block_i, block in enumerate(stage):
            s = 2 if (stage_i > 0 and block_i == 0) else 1
            x = _block(x, block, s, bottleneck, folded)
    if cut >= 2:
        return x
    feats = x.mean(dim=(2, 3))
    if cut >= 1:
        return feats
    fc = params["fc"]
    return feats @ fc["w"].to(feats.dtype).T + fc["b"].to(feats.dtype)


def resnet_apply(params: Any, x, cut: int = 0, dtype: Optional[torch.dtype] = None):
    """Forward pass. ``cut=0`` gives logits; ``cut=1`` pooled features (the
    reference's ``cutOutputLayers=1`` transfer-learning default); ``cut=2``
    the pre-pool feature map. ``params`` is a tree of tensors (numpy leaves
    are copied to ``x``'s device) or a :class:`ResNet`; ``x`` a tensor or
    array, NCHW."""
    if isinstance(params, ResNet):
        return params(x, cut=cut, dtype=dtype)
    if not isinstance(x, torch.Tensor):
        x = torch.as_tensor(np.asarray(x))
    return _forward(to_device(params, x.device), x, cut, dtype, None)


def _device_of(device: DeviceLike) -> torch.device:
    """``resolve_device``'s device with the card's index filled in, the
    device its tensors report."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


class ResNet(torch.nn.Module):
    """A ResNet parameter tree held on one device (the card unless
    ``device='cpu'``), with every BatchNorm's scale and shift folded once
    (:func:`fold_bn`, the bits ``resnet_apply`` computes per call). The
    tree is a plain dict, not registered parameters, so ``nn.Module.to``
    leaves it where it is: :meth:`on` gives the network on another
    device, and ``forward`` raises on an input held elsewhere. The tree is
    read-only here: build a new module for new weights."""

    def __init__(self, params: Dict[str, Any], device: DeviceLike = None):
        super().__init__()
        self.device = _device_of(device)
        self.tree = to_device(params, self.device)
        self._folded: Dict[int, Tuple[torch.Tensor, torch.Tensor]] = {}
        self._fold(self.tree)

    def _fold(self, node):
        if isinstance(node, dict):
            if "gamma" in node and "var" in node:
                self._folded[id(node)] = fold_bn(node)
                return
            for v in node.values():
                self._fold(v)
        elif isinstance(node, list):
            for v in node:
                self._fold(v)

    def on(self, device: DeviceLike) -> "ResNet":
        """This network on ``device``: itself when it is held there, else a
        copy of its tree built there."""
        dev = _device_of(device)
        return self if dev == self.device else ResNet(self.tree, dev)

    @property
    def num_classes(self) -> int:
        return int(self.tree["fc"]["w"].shape[0])

    @property
    def feature_width(self) -> int:
        return int(self.tree["fc"]["w"].shape[1])

    def forward(self, x, cut: int = 0, dtype: Optional[torch.dtype] = None):
        if not isinstance(x, torch.Tensor):
            x = torch.as_tensor(np.asarray(x), device=self.device)
        if x.device != self.device:
            raise ValueError(
                f"input on {x.device} but the ResNet's weights on {self.device}: "
                f"move the input, or take the network's copy there with .on()"
            )
        return _forward(self.tree, x, cut, dtype, self._folded)
