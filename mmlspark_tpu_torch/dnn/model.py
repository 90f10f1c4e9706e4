"""DNNModel — batched deep-network inference transformer.

The port's copy of ``mmlspark_tpu/dnn/model.py``, a re-design of
``CNTKModel`` (``cntk/CNTKModel.scala:145-531``):

- the serialized network becomes a torch callable ``applyFn(params,
  inputs) -> outputs`` plus a ``params`` tree placed on the device once per
  transform (the ``rebroadcastCNTKModel`` analogue);
- mini-batching is ON by default, and every batch is right-padded to one
  static shape (``batchSize`` rows), as the reference pads for XLA;
- ``feedDict``/``fetchDict`` map model input/output names to columns; the
  single-input/single-output setters mirror ``setInputCol``/``setOutputCol``;
- inputs are cast to ``inputDtype`` on the host batch.

Exactly one of three modes: ``applyFn``; pipeline (``pipelineStageFn``,
GPipe over the mesh's ``pipe`` axis, ``ops/pipeline_parallel.py``); MoE
(``expertFn``, top-1 masked-dense over the ``expert`` axis,
``ops/expert_parallel.py``). ``shardOverMesh`` splits each batch over the
mesh's ``data`` slots (the reference's SPMD batch sharding), and
``paramShardings`` splits named params over the ``model`` slots and
gathers them where a data slot applies the network.

Precision is explicit: float32 runs with cuDNN's and cuBLAS's TF32 off for
the transform's duration (``device.float32_exact``), since cuDNN allows TF32
by default and the reference computes in float32. Lower precision runs only
where the network asks for it (``resnet_apply``'s ``dtype``).
"""

from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch

from mmlspark_tpu_torch.core.params import Param, gt, to_bool, to_int, to_str
from mmlspark_tpu_torch.core.pipeline import Model
from mmlspark_tpu_torch.core.pytree import to_device
from mmlspark_tpu_torch.data.table import Table
from mmlspark_tpu_torch.device import float32_exact, resolve_device

_TORCH_ONLY_DTYPES = {"bfloat16": torch.bfloat16}


def _stack_batch(col: np.ndarray, pad_to: int, dtype: Any) -> np.ndarray:
    """Rows of a column -> one padded [pad_to, ...] host batch."""
    rows = [np.asarray(v) for v in col]
    batch = np.stack(rows).astype(dtype)
    if len(rows) < pad_to:
        pad = np.zeros((pad_to - len(rows),) + batch.shape[1:], dtype=batch.dtype)
        batch = np.concatenate([batch, pad])
    return batch


def _place(params: Any, device: torch.device) -> Any:
    """A params tree (or an ``nn.Module``) on ``device``. A
    :class:`~mmlspark_tpu_torch.models.resnet.ResNet` keeps its tree in a
    plain dict, which ``Module.to`` does not move: one held elsewhere is
    rebuilt on ``device``."""
    from mmlspark_tpu_torch.models.resnet import ResNet

    if isinstance(params, ResNet):
        return params.on(device)
    if isinstance(params, torch.nn.Module):
        return params.to(device)
    return to_device(params, device)


class DNNModel(Model):
    """Applies a torch network to feature columns in device batches."""

    applyFn = Param(
        "Torch callable (params, {name: tensor}) -> {name: tensor} | tensor",
        default=None, is_complex=True,
    )
    modelParams = Param("Model parameter tree", default=None, is_complex=True)
    feedDict = Param(
        "model input name -> feature column name", default={},
    )
    fetchDict = Param(
        "output column name -> model output name", default={},
    )
    batchSize = Param(
        "Rows per device batch (static shape; last batch padded)",
        default=64,
        converter=to_int,
        validator=gt(0),
    )
    miniBatcher = Param(
        "Batch rows before eval (CNTKModel batches by default)",
        default=True,
        converter=to_bool,
    )
    inputDtype = Param("Cast inputs to this dtype", default="float32", converter=to_str)
    paramShardings = Param(
        "Tensor-parallel map: param key -> axis index sharded over the mesh "
        "'model' axis (None = fully replicated params)",
        default=None, is_complex=True,
    )
    meshConfig = Param(
        "MeshConfig (or a Mesh of logical slots) for shardOverMesh and the "
        "pipeline/MoE modes (None = all devices on the data axis)",
        default=None, is_complex=True,
    )
    shardOverMesh = Param(
        "Shard each batch over the mesh 'data' axis", default=False, converter=to_bool
    )
    pipelineStageFn = Param(
        "Pipeline mode: torch callable (stage_params, h) -> h applying ONE "
        "stage; modelParams must carry a leading stage axis, one stage per "
        "mesh 'pipe' slot (GPipe microbatch schedule, ops/pipeline_parallel.py)",
        default=None, is_complex=True,
    )
    numMicrobatches = Param(
        "Pipeline mode: microbatches per batch (bubble fraction "
        "(p-1)/(m+p-1))",
        default=4, converter=to_int, validator=gt(0),
    )
    expertFn = Param(
        "MoE mode: torch callable (expert_params, x) -> y applying ONE expert; "
        "modelParams must be {'experts': tree with leading E axis, "
        "'gate': (D, E) array} — top-1 masked-dense dispatch over the mesh "
        "'expert' axis (ops/expert_parallel.py)",
        default=None, is_complex=True,
    )
    device = Param("Torch device the network runs on: 'cuda' (default) or 'cpu'",
                   default="cuda", converter=to_str, port_only=True)

    # -- convenience single input/output API (CNTKModel.scala:302-367) -------

    def setInputCol(self, value: str) -> "DNNModel":
        feeds = dict(self.getFeedDict())
        feeds["input"] = value
        return self.setFeedDict(feeds)

    def setOutputCol(self, value: str) -> "DNNModel":
        fetches = dict(self.getFetchDict())
        fetches[value] = "output"
        return self.setFetchDict(fetches)

    def getInputCol(self) -> str:
        return next(iter(self.getFeedDict().values()))

    def getOutputCol(self) -> str:
        return next(iter(self.getFetchDict().keys()))

    # -- evaluation ----------------------------------------------------------

    def _mesh(self):
        from mmlspark_tpu_torch.parallel.mesh import Mesh, devices, make_mesh

        config = self.getMeshConfig()
        if isinstance(config, Mesh):
            return config
        return make_mesh(config, devices=devices(resolve_device(self.getDevice()).type))

    def _program(self):
        """``(run, mesh, place_params)``: the batch function, the mesh
        (None without one) and the one-time placement of the params. Raises
        unless exactly one mode is set."""
        modes = [
            name for name, v in [
                ("applyFn", self.getApplyFn()),
                ("pipelineStageFn", self.getPipelineStageFn()),
                ("expertFn", self.getExpertFn()),
            ] if v is not None
        ]
        if len(modes) != 1:
            raise ValueError(
                "exactly one of applyFn / pipelineStageFn / expertFn must be "
                f"set (got {modes or 'none'})"
            )
        if self.getPipelineStageFn() is not None:
            return self._pipeline_program()
        if self.getExpertFn() is not None:
            return self._moe_program()

        apply_fn = self.getApplyFn()
        device = resolve_device(self.getDevice())
        if not self.getShardOverMesh():
            return apply_fn, None, lambda params: _place(params, device)
        from mmlspark_tpu_torch.parallel.mesh import AXIS_DATA, AXIS_MODEL

        mesh = self._mesh()
        # Tensor parallelism: paramShardings maps a param key to the axis
        # split over the mesh "model" axis. Each model slot holds its block;
        # a data slot gathers the blocks (the all-gather the reference's
        # compiler places) before it applies the network.
        tp: Dict[str, int] = self.getParamShardings() or {}
        params0 = self.getModelParams()
        if tp and not isinstance(params0, dict):
            raise ValueError(
                "paramShardings requires modelParams to be a flat dict "
                f"of arrays (got {type(params0).__name__})"
            )
        for key, axis in tp.items():
            val = params0.get(key)
            if val is None:
                raise ValueError(f"paramShardings key {key!r} not in modelParams")
            if np.ndim(val) <= axis:
                raise ValueError(
                    f"paramShardings[{key!r}]={axis} out of range for a "
                    f"{np.ndim(val)}-d param"
                )
        from mmlspark_tpu_torch.ops.pipeline_parallel import axis_devices

        data_devs = axis_devices(mesh, AXIS_DATA)
        model_devs = axis_devices(mesh, AXIS_MODEL)

        def place_params(params):
            """Each data slot's params, placed once: replicated params
            copied, sharded ones split into model-slot blocks and gathered
            on the data slot's device."""
            if not isinstance(params, dict):
                return [_place(params, dev) for dev in data_devs]
            blocks = {
                k: [b.to(dev) for b, dev in zip(
                    torch.chunk(torch.as_tensor(np.asarray(v)), len(model_devs), dim=tp[k]),
                    model_devs)]
                for k, v in params.items() if k in tp
            }
            return [
                {k: (torch.cat([b.to(dev) for b in blocks[k]], dim=tp[k]) if k in tp
                     else _place(v, dev))
                 for k, v in params.items()}
                for dev in data_devs
            ]

        def run(placed, inputs):
            """The batch split into equal contiguous shards, one a data
            slot, their outputs concatenated in slot order."""
            shards = len(data_devs)
            outs = []
            for s, dev in enumerate(data_devs):
                part = {k: v.chunk(shards, dim=0)[s].to(dev) for k, v in inputs.items()}
                outs.append(apply_fn(placed[s], part))
            home = next(iter(inputs.values())).device
            if isinstance(outs[0], dict):
                return {k: torch.cat([o[k].to(home) for o in outs]) for k in outs[0]}
            return torch.cat([o.to(home) for o in outs])

        return run, mesh, place_params

    def _single_feed(self, inputs: Dict[str, Any]):
        if len(inputs) != 1:
            raise ValueError(
                "pipeline/MoE modes take exactly one feed column "
                f"(got {sorted(inputs)})"
            )
        return next(iter(inputs.values()))

    def _pipeline_program(self):
        """Pipeline mode: the batch flows through p stages, one per slot on
        the mesh 'pipe' axis (GPipe microbatch schedule); a sequential pass
        over the stages when the pipe axis is 1."""
        from mmlspark_tpu_torch.ops.pipeline_parallel import pipeline_apply, place_slices
        from mmlspark_tpu_torch.parallel.mesh import AXIS_PIPE

        stage_fn = self.getPipelineStageFn()
        m = self.getNumMicrobatches()
        mesh = self._mesh()

        def place_params(params):
            # one slice of the stage axis per pipe slot, once
            return place_slices(params, mesh, AXIS_PIPE)

        def run(params, inputs):
            x = self._single_feed(inputs)
            return {"output": pipeline_apply(stage_fn, params, x, mesh, m)}

        return run, mesh, place_params

    def _moe_program(self):
        """MoE mode: top-1 gated experts, one per slot on the mesh 'expert'
        axis (masked-dense dispatch, summed in expert order)."""
        from mmlspark_tpu_torch.ops.expert_parallel import moe_apply
        from mmlspark_tpu_torch.ops.pipeline_parallel import axis_devices, place_slices
        from mmlspark_tpu_torch.parallel.mesh import AXIS_EXPERT

        expert_fn = self.getExpertFn()
        mesh = self._mesh()

        def place_params(params):
            if not isinstance(params, dict) or "experts" not in params or "gate" not in params:
                raise ValueError(
                    "MoE mode needs modelParams = {'experts': pytree with a "
                    "leading expert axis, 'gate': (D, E) array}"
                )
            return {
                "experts": place_slices(params["experts"], mesh, AXIS_EXPERT),
                "gate": _place(params["gate"], axis_devices(mesh, AXIS_EXPERT)[0]),
            }

        def run(params, inputs):
            x = self._single_feed(inputs)
            gate_logits = x @ params["gate"].to(x.device)
            return {
                "output": moe_apply(expert_fn, params["experts"], x, gate_logits, mesh)
            }

        return run, mesh, place_params

    def transform(self, table: Table) -> Table:
        feeds: Dict[str, str] = self.getFeedDict()
        fetches: Dict[str, str] = self.getFetchDict()
        if not feeds or not fetches:
            raise ValueError("feedDict and fetchDict must both be set")
        device = resolve_device(self.getDevice())
        batch_size = self.getBatchSize()
        if self.getShardOverMesh():
            n_dev = self._mesh().shape.get("data", 1)
            batch_size = max(batch_size, n_dev)
            batch_size += (-batch_size) % n_dev
        if self.getPipelineStageFn() is not None:
            # the GPipe schedule splits each batch into numMicrobatches
            m = self.getNumMicrobatches()
            batch_size = max(batch_size, m)
            batch_size += (-batch_size) % m
        name = self.getInputDtype()
        host_dtype = np.dtype("float32") if name in _TORCH_ONLY_DTYPES else np.dtype(name)
        n = table.num_rows
        fn, _, place_params = self._program()
        with float32_exact(), torch.no_grad():
            # weights go to the device ONCE, in their final layout
            params = place_params(self.getModelParams())
            out_cols: Dict[str, List[np.ndarray]] = {col: [] for col in fetches}
            bounds = (
                [(lo, min(lo + batch_size, n)) for lo in range(0, n, batch_size)]
                if self.getMiniBatcher()
                else [(0, n)]
            )
            for lo, hi in bounds:
                pad_to = batch_size if self.getMiniBatcher() else n
                if self.getPipelineStageFn() is not None:
                    # GPipe needs batch % microbatches == 0 even un-minibatched
                    pad_to += (-pad_to) % self.getNumMicrobatches()
                inputs = {}
                for model_in, col in feeds.items():
                    batch = torch.from_numpy(
                        _stack_batch(table.column(col)[lo:hi], pad_to, host_dtype))
                    batch = batch.to(device, non_blocking=True)
                    if name in _TORCH_ONLY_DTYPES:
                        batch = batch.to(_TORCH_ONLY_DTYPES[name])
                    inputs[model_in] = batch
                outputs = fn(params, inputs)
                if not isinstance(outputs, dict):
                    outputs = {"output": outputs}
                for col_name, model_out in fetches.items():
                    if model_out not in outputs:
                        raise KeyError(
                            f"model returned {sorted(outputs)}, no output {model_out!r}"
                        )
                    out = outputs[model_out]
                    if isinstance(out, torch.Tensor):
                        if out.dtype == torch.bfloat16:
                            out = out.float()
                        arr = out.detach().cpu().numpy()
                    else:
                        arr = np.asarray(out)
                    out_cols[col_name].append(arr[: hi - lo])
        result = table
        for col_name, parts in out_cols.items():
            result = result.with_column(col_name, np.concatenate(parts))
        return result

