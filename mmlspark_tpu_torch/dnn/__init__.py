"""Deep-network inference: the port's copy of ``mmlspark_tpu/dnn/``.

The reference evaluates serialized CNTK graphs per-partition over JNI
(``cntk/CNTKModel.scala``). Here the model is a torch callable + params
tree evaluated in fixed-shape device batches; external graphs arrive via
:mod:`torch_import` (torch.fx, evaluated node by node) or
:mod:`onnx_import` (vendored protobuf decoder — no ``onnx`` package).
"""

from mmlspark_tpu_torch.dnn.model import DNNModel
from mmlspark_tpu_torch.dnn.onnx_import import from_onnx
from mmlspark_tpu_torch.dnn.torch_import import from_torch

__all__ = ["DNNModel", "from_onnx", "from_torch"]
