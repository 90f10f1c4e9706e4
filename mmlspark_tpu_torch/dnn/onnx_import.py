"""ONNX → PyTorch import: protobuf walk + op lowering, no ``onnx`` package.

The port's copy of ``mmlspark_tpu/dnn/onnx_import.py``. The wire format is
decoded by the vendored reader in :mod:`onnx_proto`, and each NodeProto is
lowered to torch ops, producing the pure ``(apply_fn, params)`` contract
of :func:`mmlspark_tpu_torch.dnn.from_torch`:

    fn, params = from_onnx("model.onnx")
    DNNModel(applyFn=fn, modelParams=params, inputCol=..., outputCol=...)

The op set, the ``auto_pad``/``pads`` handling and the errors are the
reference's: shape-producing ops (Reshape / Squeeze / Flatten / Transpose)
take static attribute or initializer operands, ``SAME_LOWER`` and "SAME"
pooling are refused, unsupported ops and multi-output nodes raise with the
op name. ``SAME_UPPER`` pads as jax's "SAME" does (the odd cell behind).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from mmlspark_tpu_torch.core.pytree import to_tensor
from mmlspark_tpu_torch.dnn.onnx_proto import decode_model
from mmlspark_tpu_torch.models.resnet import same_pads


def onnx_available() -> bool:
    """The vendored decoder is always available (kept for API compat)."""
    return True


def _pads_to_pairs(pads: List[int], spatial: int):
    # ONNX pads = [b1..bn, e1..en]
    return [(pads[i], pads[i + spatial]) for i in range(spatial)]


def _auto_pad(attrs, spatial):
    ap = attrs.get("auto_pad", b"NOTSET")
    ap = ap.decode() if isinstance(ap, bytes) else ap
    if ap in ("NOTSET", ""):
        pads = attrs.get("pads", [0] * (2 * spatial))
        return _pads_to_pairs(pads, spatial)
    if ap == "VALID":
        return "VALID"
    if ap == "SAME_UPPER":
        return "SAME"
    # SAME_LOWER puts the extra pad at the START; "SAME" pads at the end,
    # which would silently shift every window — refuse instead.
    raise ValueError(f"unsupported auto_pad {ap}; re-export with explicit pads")


def _pad_spatial(x, pairs, value=0.0):
    """``x`` padded on its trailing spatial dims by ``pairs`` (front, back)."""
    if all(p == (0, 0) for p in pairs):
        return x
    flat = []
    for lo, hi in reversed(pairs):  # F.pad lists the last dimension first
        flat += [lo, hi]
    return F.pad(x, flat, value=value)


def _conv(x, w, b, attrs):
    spatial = x.ndim - 2
    strides = tuple(attrs.get("strides", [1] * spatial))
    dilations = tuple(attrs.get("dilations", [1] * spatial))
    groups = int(attrs.get("group", 1))
    pad = _auto_pad(attrs, spatial)
    if pad == "VALID":
        pad = [(0, 0)] * spatial
    elif pad == "SAME":
        pad = [same_pads(x.shape[2 + i], w.shape[2 + i], strides[i], dilations[i])
               for i in range(spatial)]
    conv = F.conv2d if spatial == 2 else F.conv1d
    out = conv(_pad_spatial(x, pad), w, stride=strides, dilation=dilations, groups=groups)
    if b is not None:
        out = out + b.reshape((1, -1) + (1,) * spatial)
    return out


def _window_sum(x, ks, strides):
    """Sums over each window (no padding), 1-D or 2-D."""
    if len(ks) == 1:
        return F.avg_pool2d(x[:, :, None], (1, ks[0]), (1, strides[0]),
                            divisor_override=1)[:, :, 0]
    return F.avg_pool2d(x, ks, strides, divisor_override=1)


def _pool(x, attrs, kind):
    spatial = x.ndim - 2
    ks = tuple(attrs["kernel_shape"])
    strides = tuple(attrs.get("strides", [1] * spatial))
    pad = _auto_pad(attrs, spatial)
    if pad == "VALID":
        pad = [(0, 0)] * spatial
    elif pad == "SAME":
        raise ValueError("SAME pooling unsupported; export with explicit pads")
    if kind == "max":
        xp = _pad_spatial(x, pad, value=-float("inf"))
        if spatial == 1:
            return F.max_pool1d(xp, ks, strides)
        return F.max_pool2d(xp, ks, strides)
    s = _window_sum(_pad_spatial(x, pad), ks, strides)
    if attrs.get("count_include_pad", 0) or all(p == (0, 0) for p in pad):
        return s / float(np.prod(ks))
    cnt = _window_sum(_pad_spatial(torch.ones_like(x), pad), ks, strides)
    return s / cnt


def _gemm(a, b, c, attrs):
    alpha = attrs.get("alpha", 1.0)
    beta = attrs.get("beta", 1.0)
    if attrs.get("transA", 0):
        a = a.T
    if attrs.get("transB", 0):
        b = b.T
    out = alpha * (a @ b)
    if c is not None:
        out = out + beta * c
    return out


def _softmax(x, attrs, opset, log=False):
    axis = int(attrs.get("axis", -1 if opset >= 13 else 1))
    if opset < 13 and x.ndim > 2:
        # Pre-13 ONNX Softmax is the flatten-to-2D variant: normalize
        # jointly over ALL dims from `axis` onward, not per-axis.
        axis = axis % x.ndim
        lead = int(np.prod(x.shape[:axis])) if axis else 1
        flat = x.reshape(lead, -1)
        return _softmax(flat, {"axis": 1}, 13, log=log).reshape(x.shape)
    m = x - x.amax(dim=axis, keepdim=True)
    if log:
        return m - torch.log(torch.exp(m).sum(dim=axis, keepdim=True))
    e = torch.exp(m)
    return e / e.sum(dim=axis, keepdim=True)


def _ints(v) -> List[int]:
    if isinstance(v, torch.Tensor):
        return [int(s) for s in v.reshape(-1).tolist()]
    return [int(s) for s in np.asarray(v).reshape(-1).tolist()]


def _reshape(x, shape_arr, attrs):
    shape = _ints(shape_arr)
    shape = [x.shape[i] if s == 0 and attrs.get("allowzero", 0) == 0 else s
             for i, s in enumerate(shape)]
    return x.reshape(shape)


def _gather(x, idx, axis):
    idx = idx.long()
    axis = axis % x.ndim
    idx = torch.where(idx < 0, idx + x.shape[axis], idx)  # numpy's wrap of negatives
    out = torch.index_select(x, axis, idx.reshape(-1))
    return out.reshape(x.shape[:axis] + idx.shape + x.shape[axis + 1:])


def _lower(op, ins, attrs, opset, node):
    if op == "Conv":
        return _conv(ins[0], ins[1], ins[2] if len(ins) > 2 else None, attrs)
    if op == "MatMul":
        return ins[0] @ ins[1]
    if op == "Gemm":
        return _gemm(ins[0], ins[1], ins[2] if len(ins) > 2 else None, attrs)
    if op == "Add":
        return ins[0] + ins[1]
    if op == "Sub":
        return ins[0] - ins[1]
    if op == "Mul":
        return ins[0] * ins[1]
    if op == "Div":
        return ins[0] / ins[1]
    if op == "Pow":
        return ins[0] ** ins[1]
    if op == "Sqrt":
        return torch.sqrt(ins[0])
    if op == "Exp":
        return torch.exp(ins[0])
    if op == "Neg":
        return -ins[0]
    if op == "Relu":
        return torch.clamp_min(ins[0], 0)
    if op == "LeakyRelu":
        alpha = attrs.get("alpha", 0.01)
        return torch.where(ins[0] >= 0, ins[0], alpha * ins[0])
    if op == "Sigmoid":
        return 1.0 / (1.0 + torch.exp(-ins[0]))
    if op == "Tanh":
        return torch.tanh(ins[0])
    if op == "Erf":
        return torch.erf(ins[0])
    if op == "Softmax":
        return _softmax(ins[0], attrs, opset)
    if op == "LogSoftmax":
        return _softmax(ins[0], attrs, opset, log=True)
    if op == "MaxPool":
        return _pool(ins[0], attrs, "max")
    if op == "AveragePool":
        return _pool(ins[0], attrs, "avg")
    if op == "GlobalAveragePool":
        return ins[0].mean(dim=tuple(range(2, ins[0].ndim)), keepdim=True)
    if op == "BatchNormalization":
        x, scale, bias, mean, var = ins[:5]
        eps = attrs.get("epsilon", 1e-5)
        shape = (1, -1) + (1,) * (x.ndim - 2)
        out = (x - mean.reshape(shape)) / torch.sqrt(var.reshape(shape) + eps)
        return out * scale.reshape(shape) + bias.reshape(shape)
    if op == "Flatten":
        axis = int(attrs.get("axis", 1))
        lead = int(np.prod(ins[0].shape[:axis])) if axis else 1
        return ins[0].reshape(lead, -1)
    if op == "Reshape":
        return _reshape(ins[0], ins[1], attrs)
    if op == "Transpose":
        perm = attrs.get("perm")
        return ins[0].permute(*(perm if perm is not None else reversed(range(ins[0].ndim))))
    if op == "Concat":
        return torch.cat(ins, dim=int(attrs["axis"]))
    if op == "Squeeze":
        axes = attrs.get("axes")
        if axes is None and len(ins) > 1:
            axes = _ints(ins[1])
        if not axes:
            return ins[0].squeeze()
        return ins[0].squeeze(tuple(a % ins[0].ndim for a in axes))
    if op == "Unsqueeze":
        axes = attrs.get("axes")
        if axes is None and len(ins) > 1:
            axes = _ints(ins[1])
        # ONNX axes refer to the OUTPUT rank: normalize negatives against it
        # before applying in ascending order (a raw sort would apply
        # negatives against the not-yet-expanded rank and misplace dims for
        # mixed lists like [-3, 1] on 1-D input).
        out_rank = ins[0].ndim + len(axes)
        out = ins[0]
        for ax in sorted(a % out_rank for a in axes):
            out = out.unsqueeze(ax)
        return out
    if op == "Clip":
        lo = ins[1] if len(ins) > 1 and ins[1] is not None else attrs.get("min")
        hi = ins[2] if len(ins) > 2 and ins[2] is not None else attrs.get("max")
        return torch.clamp(ins[0], lo, hi) if lo is not None or hi is not None else ins[0]
    if op in ("Identity", "Dropout"):
        return ins[0]
    if op == "Gather":
        return _gather(ins[0], ins[1], int(attrs.get("axis", 0)))
    if op == "ReduceMean":
        axes = attrs.get("axes")
        kd = bool(attrs.get("keepdims", 1))
        if not axes:
            return ins[0].mean().reshape((1,) * ins[0].ndim if kd else ())
        return ins[0].mean(dim=tuple(axes), keepdim=kd)
    raise NotImplementedError(
        f"ONNX op {op!r} not in the lowering table "
        f"(node {node['name']!r})"
    )


def from_onnx(path_or_bytes) -> Tuple[Callable, Dict[str, Any]]:
    """Load an ONNX model into ``(apply_fn, params)`` for DNNModel.

    ``apply_fn(params, {input_name: tensor}) -> {output_name: tensor}``
    runs on the inputs' device; ``params`` is the initializer dict (numpy
    arrays, the reference's), so either package's params serve either."""
    if isinstance(path_or_bytes, (bytes, bytearray)):
        buf = bytes(path_or_bytes)
    else:
        with open(path_or_bytes, "rb") as fh:
            buf = fh.read()
    model = decode_model(buf)
    graph = model["graph"]
    opset = model["opset"] or 13
    inits: Dict[str, np.ndarray] = dict(graph["initializers"])
    # Constant nodes fold into the initializer set.
    nodes = []
    for node in graph["nodes"]:
        if node["op_type"] == "Constant":
            inits[node["output"][0]] = np.asarray(node["attrs"]["value"])
        else:
            nodes.append(node)
    graph_inputs = [i for i in graph["inputs"] if i not in inits]
    outputs = list(graph["outputs"])

    params = {k: np.asarray(v) for k, v in inits.items()}

    def apply_fn(params, inputs):
        if not isinstance(inputs, dict):
            inputs = {graph_inputs[0]: inputs}
        first = next(iter(inputs.values()), None)
        device = first.device if isinstance(first, torch.Tensor) else torch.device("cpu")
        env: Dict[str, Any] = {}
        env.update({k: to_tensor(v, device) for k, v in params.items()})
        env.update({k: to_tensor(v, device) for k, v in inputs.items()})

        def get(name):
            if name == "":
                return None
            if name not in env:
                raise KeyError(
                    f"ONNX value {name!r} undefined (graph not topo-sorted?)"
                )
            return env[name]

        for node in nodes:
            op = node["op_type"]
            out = _lower(op, [get(n) for n in node["input"]], node["attrs"], opset, node)
            outs = node["output"]
            if len(outs) > 1:
                if op in ("Dropout", "BatchNormalization"):
                    outs = outs[:1]  # extra outputs are training-mode only
                else:
                    raise NotImplementedError(
                        f"ONNX op {op!r} with {len(outs)} outputs unsupported "
                        f"(node {node['name']!r})"
                    )
            env[outs[0]] = out

        return {o: env[o] for o in outputs}

    return apply_fn, params
