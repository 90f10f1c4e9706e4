"""Pipeline parallelism over the mesh ``pipe`` axis (GPipe schedule).

The port's copy of ``mmlspark_tpu/ops/pipeline_parallel.py``. A stack of
layers is split into contiguous stages, one stage per slot of the ``pipe``
axis; a batch is split into microbatches that flow through the stages in
the GPipe bubble schedule: at step t, stage s processes microbatch t - s,
and its output hops to the device of stage s + 1. With M microbatches and
p stages the bubble is the standard (p-1)/(M+p-1) fraction of the steps.

The port's mesh is logical (``parallel/mesh.py``): each slot names a
device, and on one card every slot is that card. The steps run in order
from this process, each stage on its slot's device, so the result is the
schedule's; with one card it shows the schedule's arithmetic, not an
overlap of stages.

API: :func:`pipeline_apply` — stage params stacked on a leading axis of
size p (or placed per stage by :func:`place_slices`); each stage maps
(mb, d) -> (mb, d); the output lies on ``x``'s device.
"""

from __future__ import annotations

from typing import Any, Callable, List

import numpy as np
import torch

from mmlspark_tpu_torch.core.pytree import to_tensor, tree_leaves, tree_map
from mmlspark_tpu_torch.parallel.mesh import AXIS_PIPE, Mesh


def axis_devices(mesh: Mesh, axis: str) -> List[torch.device]:
    """The device of each slot along ``axis`` (every other axis at 0)."""
    if axis not in mesh.axis_names:
        return [mesh.devices.flat[0]]
    k = mesh.axis_names.index(axis)
    coord = [0] * len(mesh.axis_names)
    out = []
    for i in range(mesh.devices.shape[k]):
        coord[k] = i
        out.append(mesh.devices[tuple(coord)])
    return out


class SlotParams(list):
    """Per-slot parameter trees, each on its slot's device
    (:func:`place_slices`); ``pipeline_apply`` and the MoE forms take it in
    place of the stacked tree, so the weights move once."""


def place_slices(params: Any, mesh: Mesh, axis: str) -> SlotParams:
    """Slice the leading axis of every leaf and put slice i on the device of
    slot i of ``axis`` (all on the first slot's device when the axis is 1
    or shorter than the slices)."""
    if isinstance(params, SlotParams):
        return params
    n = int(np.shape(tree_leaves(params)[0])[0])
    devs = axis_devices(mesh, axis)
    out = SlotParams()
    for i in range(n):
        dev = devs[i] if len(devs) > 1 and i < len(devs) else devs[0]
        out.append(tree_map(lambda a: to_tensor(a[i], dev), params))
    return out


def pipeline_apply(
    stage_fn: Callable,
    stage_params: Any,
    x: torch.Tensor,
    mesh: Mesh,
    num_microbatches: int,
) -> torch.Tensor:
    """Run ``x`` through ``p`` pipeline stages.

    ``stage_fn(params_one_stage, h) -> h`` applies ONE stage;
    ``stage_params`` is a tree whose leaves have a leading axis of size
    ``p`` (one slice per stage), or the :class:`SlotParams` of
    :func:`place_slices`; ``x`` is (B, D) with B divisible by
    ``num_microbatches``. Returns the (B, D_out) result on ``x``'s device.
    Falls back to a sequential pass over the stages when the pipe axis is
    1."""
    p = int(mesh.shape.get(AXIS_PIPE, 1))
    stages = place_slices(stage_params, mesh, AXIS_PIPE)
    n_stages = len(stages)
    if p > 1 and n_stages != p:
        raise ValueError(
            f"{n_stages} stages but pipe axis of {p} — the schedule places "
            "exactly one stage per device; fold layers into stages so the "
            "leading params axis equals the pipe size"
        )
    if p <= 1:
        h = x
        for params_s in stages:
            h = stage_fn(params_s, h)
        return h

    b = x.shape[0]
    m = num_microbatches
    if b % m != 0:
        raise ValueError(f"batch {b} not divisible by {m} microbatches")
    mb = b // m
    xs = list(x.reshape(m, mb, *x.shape[1:]).unbind(0))
    devs = axis_devices(mesh, AXIS_PIPE)
    outputs: List[Any] = [None] * m
    # in flight: the microbatch each stage received on the previous step
    inbox: List[Any] = [None] * p
    for t in range(m + p - 1):
        sent: List[Any] = [None] * p
        for s in range(p):
            i = t - s  # the microbatch stage s processes at step t
            if not 0 <= i < m:
                continue
            inp = xs[i].to(devs[0]) if s == 0 else inbox[s]
            out = stage_fn(stages[s], inp)
            if s == p - 1:
                outputs[i] = out.to(x.device)
            else:
                sent[s + 1] = out.to(devs[s + 1])  # the hop to the next stage
        inbox = sent
    return torch.cat(outputs, dim=0)

