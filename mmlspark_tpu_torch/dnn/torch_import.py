"""torch.fx graph import: a module evaluated node by node over an explicit
params dict.

The port's copy of ``mmlspark_tpu/dnn/torch_import.py``. A
``torch.nn.Module`` is symbolically traced with ``torch.fx`` and each node
is evaluated through ``torch.nn.functional`` (``F.conv2d``, ``F.linear``,
...) with weights read from a plain params dict, producing a pure
``apply(params, inputs)`` function. The module itself never runs: its
weights leave it once, as numpy arrays keyed ``module path -> {param:
array}``, the reference's keys, so a params dict from the reference's
``from_torch`` loads here and the other way round.

Covered op set (the reference's): Conv2d (incl. groups/dilation), Linear,
BatchNorm1d/2d (eval), LayerNorm, ReLU/GELU/SiLU/Sigmoid/Tanh/Softmax,
MaxPool2d, AvgPool2d, AdaptiveAvgPool2d, Flatten/Dropout/Identity,
residual adds, cat, mul, and the common tensor methods (view/reshape/
flatten/mean/permute/transpose). Anything else raises
``NotImplementedError`` with the reference's text.
"""

from __future__ import annotations

import operator
from typing import Any, Callable, Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from mmlspark_tpu_torch.core.pytree import to_tensor
from mmlspark_tpu_torch.models.resnet import same_pads


def _pair(v: Any) -> Tuple[int, int]:
    if isinstance(v, (tuple, list)):
        return int(v[0]), int(v[1])
    return int(v), int(v)


def _conv2d(x, w, b, stride, padding, dilation, groups):
    sh, sw = _pair(stride)
    dh, dw = _pair(dilation)
    if isinstance(padding, str):
        if padding.upper() == "VALID":
            pads = ((0, 0), (0, 0))
        else:  # 'same', as jax's "SAME" pads it
            pads = (same_pads(x.shape[2], w.shape[2], sh, dh),
                    same_pads(x.shape[3], w.shape[3], sw, dw))
    else:
        ph, pw = _pair(padding)
        pads = ((ph, ph), (pw, pw))
    if pads[0][0] == pads[0][1] and pads[1][0] == pads[1][1]:
        out = F.conv2d(x, w, stride=(sh, sw), padding=(pads[0][0], pads[1][0]),
                       dilation=(dh, dw), groups=int(groups))
    else:
        out = F.conv2d(F.pad(x, (pads[1][0], pads[1][1], pads[0][0], pads[0][1])), w,
                       stride=(sh, sw), dilation=(dh, dw), groups=int(groups))
    if b is not None:
        out = out + b.reshape(1, -1, 1, 1)
    return out


def _linear(x, w, b=None):
    return F.linear(x, w, b)


def _batch_norm(x, gamma, beta, mean, var, eps):
    shape = (1, -1) + (1,) * (x.ndim - 2)
    inv = (var + eps) ** -0.5
    out = (x - mean.reshape(shape)) * inv.reshape(shape)
    if gamma is not None:
        out = out * gamma.reshape(shape)
    if beta is not None:
        out = out + beta.reshape(shape)
    return out


def _layer_norm(x, normalized_shape, gamma, beta, eps):
    axes = tuple(range(x.ndim - len(normalized_shape), x.ndim))
    mean = x.mean(dim=axes, keepdim=True)
    var = ((x - mean) ** 2).mean(dim=axes, keepdim=True)
    out = (x - mean) / torch.sqrt(var + eps)
    if gamma is not None:
        out = out * gamma
    if beta is not None:
        out = out + beta
    return out


def _pool2d(x, kernel, stride, padding, average: bool):
    kh, kw = _pair(kernel)
    sh, sw = _pair(stride if stride is not None else kernel)
    ph, pw = _pair(padding)
    if average:
        # the window's sum over zero padding, divided by the full window
        s = F.avg_pool2d(F.pad(x, (pw, pw, ph, ph)), (kh, kw), (sh, sw), divisor_override=1)
        return s / float(kh * kw)
    return F.max_pool2d(F.pad(x, (pw, pw, ph, ph), value=-float("inf")), (kh, kw), (sh, sw))


def _max_pool2d(x, kernel, stride=None, padding=0):
    return _pool2d(x, kernel, stride, padding, average=False)


def _avg_pool2d(x, kernel, stride=None, padding=0):
    return _pool2d(x, kernel, stride, padding, average=True)


def _adaptive_avg_pool2d(x, output_size):
    oh, ow = _pair(output_size)
    h, w = x.shape[2], x.shape[3]
    if (oh, ow) == (1, 1):
        return x.mean(dim=(2, 3), keepdim=True)
    if h % oh or w % ow:
        raise NotImplementedError(
            f"adaptive_avg_pool2d: input {h}x{w} not divisible by output {oh}x{ow}"
        )
    x = x.reshape(x.shape[0], x.shape[1], oh, h // oh, ow, w // ow)
    return x.mean(dim=(3, 5))


def _softmax(x, dim=-1, **_):
    return torch.softmax(x, dim=dim)


def _flatten(x, start_dim=0, end_dim=-1):
    if end_dim in (-1, x.ndim - 1):
        return x.reshape(tuple(x.shape[:start_dim]) + (-1,))
    return x


def _gelu(x, approximate="none"):
    return F.gelu(x, approximate="tanh" if approximate != "none" else "none")


_FUNCTIONS: Dict[Any, Callable] = {
    operator.add: lambda a, b: a + b,
    operator.sub: lambda a, b: a - b,
    operator.mul: lambda a, b: a * b,
    operator.truediv: lambda a, b: a / b,
    operator.matmul: lambda a, b: a @ b,
    torch.add: lambda a, b: a + b,
    torch.mul: lambda a, b: a * b,
    torch.relu: torch.relu,
    F.relu: lambda x, inplace=False: torch.relu(x),
    F.gelu: _gelu,
    F.silu: lambda x, inplace=False: F.silu(x),
    torch.sigmoid: torch.sigmoid,
    F.sigmoid: torch.sigmoid,
    torch.tanh: torch.tanh,
    F.softmax: _softmax,
    F.max_pool2d: _max_pool2d,
    F.avg_pool2d: _avg_pool2d,
    F.adaptive_avg_pool2d: _adaptive_avg_pool2d,
    F.linear: _linear,
    torch.flatten: _flatten,
    torch.cat: lambda ts, dim=0: torch.cat(ts, dim=dim),
    torch.mean: lambda x, dim=None, keepdim=False: (
        x.mean() if dim is None else x.mean(dim=dim, keepdim=keepdim)),
}


class _TorchGraph:
    """A traced torch graph evaluated node by node at call time."""

    def __init__(self, graph_module: Any):
        self.nodes = list(graph_module.graph.nodes)
        self.modules = dict(graph_module.named_modules())
        # every parameter and buffer leaves torch once, as numpy: the
        # resulting dict is the DNNModel ``modelParams``
        self.params: Dict[str, Dict[str, np.ndarray]] = {}
        for name, mod in self.modules.items():
            entry: Dict[str, np.ndarray] = {}
            for p_name, p in mod.named_parameters(recurse=False):
                entry[p_name] = p.detach().cpu().numpy()
            for b_name, b in mod.named_buffers(recurse=False):
                entry[b_name] = b.detach().cpu().numpy()
            if entry:
                self.params[name] = entry
        self.attr_consts: Dict[str, np.ndarray] = {}
        for node in self.nodes:
            if node.op == "get_attr":
                obj = graph_module
                for part in node.target.split("."):
                    obj = getattr(obj, part)
                self.attr_consts[node.target] = obj.detach().cpu().numpy()
        self.input_names = [n.name for n in self.nodes if n.op == "placeholder"]

    # -- node evaluation -----------------------------------------------------

    # The NotImplementedError texts are the reference's, word for word, so a
    # caller matching on them sees the same message from either package.

    def _lower_module(self, mod: Any, p: Dict[str, Any], args: list, kwargs: dict):
        nn = torch.nn
        x = args[0]
        if isinstance(mod, nn.Conv2d):
            return _conv2d(
                x, p["weight"], p.get("bias"), mod.stride, mod.padding,
                mod.dilation, mod.groups,
            )
        if isinstance(mod, nn.Linear):
            return _linear(x, p["weight"], p.get("bias"))
        if isinstance(mod, (nn.BatchNorm1d, nn.BatchNorm2d, nn.BatchNorm3d)):
            return _batch_norm(
                x, p.get("weight"), p.get("bias"), p["running_mean"],
                p["running_var"], mod.eps,
            )
        if isinstance(mod, nn.LayerNorm):
            return _layer_norm(
                x, tuple(mod.normalized_shape), p.get("weight"), p.get("bias"),
                mod.eps,
            )
        if isinstance(mod, nn.ReLU):
            return torch.relu(x)
        if isinstance(mod, nn.GELU):
            return _gelu(x, mod.approximate)
        if isinstance(mod, nn.SiLU):
            return F.silu(x)
        if isinstance(mod, nn.Sigmoid):
            return torch.sigmoid(x)
        if isinstance(mod, nn.Tanh):
            return torch.tanh(x)
        if isinstance(mod, nn.Softmax):
            return _softmax(x, mod.dim if mod.dim is not None else -1)
        if isinstance(mod, nn.MaxPool2d):
            return _max_pool2d(x, mod.kernel_size, mod.stride, mod.padding)
        if isinstance(mod, nn.AvgPool2d):
            return _avg_pool2d(x, mod.kernel_size, mod.stride, mod.padding)
        if isinstance(mod, nn.AdaptiveAvgPool2d):
            return _adaptive_avg_pool2d(x, mod.output_size)
        if isinstance(mod, nn.Flatten):
            lo = mod.start_dim
            hi = mod.end_dim if mod.end_dim != -1 else x.ndim - 1
            shape = tuple(x.shape[:lo]) + (-1,) + tuple(x.shape[hi + 1:])
            return x.reshape(shape)
        if isinstance(mod, (nn.Dropout, nn.Identity)):
            return x
        raise NotImplementedError(
            f"torch module {type(mod).__name__} has no JAX lowering"
        )

    def _lower_function(self, target: Any, args: list, kwargs: dict):
        if target in _FUNCTIONS:
            return _FUNCTIONS[target](*args, **kwargs)
        raise NotImplementedError(f"torch function {target} has no JAX lowering")

    def _lower_method(self, name: str, args: list, kwargs: dict):
        x = args[0]
        rest = args[1:]
        if name in ("view", "reshape"):
            shape = rest[0] if len(rest) == 1 and isinstance(rest[0], (tuple, list)) else rest
            return x.reshape(tuple(int(s) for s in shape))
        if name == "flatten":
            start = rest[0] if rest else 0
            return x.reshape(tuple(x.shape[:start]) + (-1,))
        if name == "mean":
            dim = rest[0] if rest else kwargs.pop("dim", None)
            keepdim = kwargs.pop("keepdim", kwargs.pop("keepdims", False))
            return x.mean() if dim is None else x.mean(dim=dim, keepdim=keepdim)
        if name == "permute":
            perm = rest[0] if len(rest) == 1 and isinstance(rest[0], (tuple, list)) else rest
            return x.permute(*perm)
        if name == "transpose":
            return x.transpose(rest[0], rest[1])
        if name == "contiguous":
            return x
        if name == "size":
            return x.shape[rest[0]] if rest else tuple(x.shape)
        if name == "add":
            return x + rest[0]
        if name == "mul":
            return x * rest[0]
        raise NotImplementedError(f"tensor method .{name}() has no JAX lowering")

    # -- execution -----------------------------------------------------------

    def __call__(self, params: Dict[str, Dict[str, Any]], inputs: Dict[str, Any]):
        import torch.fx as fx

        env: Dict[Any, Any] = {}
        first = next(iter(inputs.values()), None)
        device = first.device if isinstance(first, torch.Tensor) else torch.device("cpu")

        def resolve(v: Any) -> Any:
            if isinstance(v, fx.Node):
                return env[v]
            if isinstance(v, (list, tuple)):
                return type(v)(resolve(x) for x in v)
            return v

        out = None
        for node in self.nodes:
            if node.op == "placeholder":
                if node.name not in inputs:
                    raise KeyError(
                        f"missing model input {node.name!r}; have {sorted(inputs)}"
                    )
                env[node] = to_tensor(inputs[node.name], device)
            elif node.op == "get_attr":
                env[node] = to_tensor(self.attr_consts[node.target], device)
            elif node.op == "call_module":
                mod = self.modules[node.target]
                p = {k: to_tensor(v, device) for k, v in params.get(node.target, {}).items()}
                env[node] = self._lower_module(
                    mod, p, [resolve(a) for a in node.args],
                    {k: resolve(v) for k, v in node.kwargs.items()},
                )
            elif node.op == "call_function":
                env[node] = self._lower_function(
                    node.target, [resolve(a) for a in node.args],
                    {k: resolve(v) for k, v in node.kwargs.items()},
                )
            elif node.op == "call_method":
                env[node] = self._lower_method(
                    node.target, [resolve(a) for a in node.args],
                    {k: resolve(v) for k, v in node.kwargs.items()},
                )
            elif node.op == "output":
                out = resolve(node.args[0])
            else:  # pragma: no cover
                raise NotImplementedError(f"fx op {node.op}")
        return out


def from_torch(
    module: Any, single_input_name: str = "input", single_output_name: str = "output"
) -> Tuple[Callable, Dict[str, Dict[str, np.ndarray]]]:
    """Trace a ``torch.nn.Module`` and return ``(apply_fn, params)``.

    ``apply_fn(params, {input_name: tensor}) -> {output_name: tensor}`` is
    pure and runs on the inputs' device; ``params`` is a plain dict of
    numpy arrays. Feed both straight into
    :class:`~mmlspark_tpu_torch.dnn.model.DNNModel`:

        fn, params = from_torch(net.eval())
        DNNModel(applyFn=fn, modelParams=params,
                 feedDict={"input": "images"}, fetchDict={"scores": "output"})
    """
    import torch.fx as fx

    module = module.eval()
    graph_module = fx.symbolic_trace(module)
    lowered = _TorchGraph(graph_module)

    names = lowered.input_names
    if len(names) == 1 and names[0] != single_input_name:
        rename = {single_input_name: names[0]}
    else:
        rename = {}

    def apply_fn(params, inputs):
        mapped = {rename.get(k, k): v for k, v in inputs.items()}
        result = lowered(params, mapped)
        if isinstance(result, dict):
            return result
        if isinstance(result, (list, tuple)):
            return {f"{single_output_name}_{i}": r for i, r in enumerate(result)}
        return {single_output_name: result}

    return apply_fn, lowered.params
