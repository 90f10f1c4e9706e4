"""Expert parallelism over the mesh ``expert`` axis (MoE dispatch).

The port's copy of ``mmlspark_tpu/ops/expert_parallel.py``. Experts sit
one per slot of the ``expert`` axis (the port's mesh is logical: each slot
names a device, on one card all the same one). Two top-1 dispatch forms,
both static-shape:

- :func:`moe_apply` — masked-dense: every expert runs on the full token
  batch on its slot's device, the tokens routed elsewhere are masked to
  zero, and the experts' outputs are summed in expert order (the
  reference's ``psum``; each token has one non-zero term).
- :func:`moe_apply_a2a` — capacity-based all-to-all (the GShard layout):
  tokens shard over the expert axis, each source shard packs its tokens
  into fixed-capacity per-expert send buffers, the buffers move to the
  owning expert's device, the expert runs once on E*C slots, and the
  outputs move back to their sources. Tokens beyond an expert's capacity
  are dropped (output zero), the capacity-factor contract.

:func:`~mmlspark_tpu_torch.ops.pipeline_parallel.place_slices` puts each
expert's slice of the stacked params on its slot's device once; both forms
take its result in place of the stacked tree.
"""

from __future__ import annotations

import math
from typing import Any, Callable, List

import torch

from mmlspark_tpu_torch.core.pytree import tree_leaves
from mmlspark_tpu_torch.ops.pipeline_parallel import place_slices
from mmlspark_tpu_torch.parallel.mesh import AXIS_EXPERT, Mesh


def _route(gate_logits: torch.Tensor):
    """Top-1 routing: the softmax, the argmax (first index on ties) and the
    chosen expert's probability, (B, 1)."""
    probs = torch.softmax(gate_logits, dim=1)
    assign = torch.argmax(gate_logits, dim=1)
    chosen_p = torch.gather(probs, 1, assign[:, None])
    return assign, chosen_p


def moe_apply(
    expert_fn: Callable,
    expert_params: Any,
    x: torch.Tensor,
    gate_logits: torch.Tensor,
    mesh: Mesh,
) -> torch.Tensor:
    """Top-1 mixture of experts.

    ``expert_fn(params_one_expert, x) -> y`` applies one expert to a token
    batch; ``expert_params`` leaves carry a leading axis of size E (or are
    the ``SlotParams`` of ``place_slices``); ``x`` is (B, D);
    ``gate_logits`` is (B, E). Returns (B, D_out) = gate_prob[chosen] *
    expert_chosen(x) on ``x``'s device."""
    e_mesh = int(mesh.shape.get(AXIS_EXPERT, 1))
    experts = place_slices(expert_params, mesh, AXIS_EXPERT)
    e_total = len(experts)
    if e_mesh > 1 and e_total != e_mesh:
        raise ValueError(
            f"{e_total} experts but expert axis of {e_mesh} — the masked "
            "dispatch places exactly one expert per device"
        )
    assign, chosen_p = _route(gate_logits)
    out = None
    for e, params_e in enumerate(experts):
        dev = tree_leaves(params_e)[0].device
        mask = (assign == e)[:, None].to(dev)
        y = (expert_fn(params_e, x.to(dev)) * mask * chosen_p.to(dev)).to(x.device)
        out = y if out is None else out + y
    return out


def moe_apply_a2a(
    expert_fn: Callable,
    expert_params: Any,
    x: torch.Tensor,
    gate_logits: torch.Tensor,
    mesh: Mesh,
    capacity_factor: float = 1.25,
) -> torch.Tensor:
    """Top-1 MoE via capacity-based all-to-all dispatch.

    ``x`` (B, D) and ``gate_logits`` (B, E) shard their batch over the
    ``expert`` axis (B divisible by E); expert e lives on slot e. Each
    source shard packs its B/E tokens into (E, C) send slots with ``C =
    max(1, ceil(B/E/E * capacity_factor))`` per destination, ranked within
    a destination by position; expert e receives its (E, C) slots from
    every source, runs once on E*C tokens, and the outputs go back to their
    sources. Tokens that overflow an expert's capacity at their source are
    DROPPED (zero output). Falls back to the masked-dense form when the
    expert axis is 1."""
    e_mesh = int(mesh.shape.get(AXIS_EXPERT, 1))
    if e_mesh <= 1:
        return moe_apply(expert_fn, expert_params, x, gate_logits, mesh)
    experts = place_slices(expert_params, mesh, AXIS_EXPERT)
    if len(experts) != e_mesh:
        raise ValueError(
            f"{len(experts)} experts but expert axis of {e_mesh} — one expert "
            "per device"
        )
    b, d = x.shape
    if b % e_mesh != 0:
        raise ValueError(f"batch {b} not divisible by expert axis {e_mesh}")
    b_local = b // e_mesh
    cap = max(1, math.ceil(b_local / e_mesh * capacity_factor))
    keep, slot, chosen_p = a2a_slots(gate_logits, e_mesh, cap)

    # send[j, e, c]: the c-th kept token of source shard j bound for expert e
    src = torch.arange(b, device=x.device) // b_local
    send = torch.zeros((e_mesh, e_mesh * cap + 1, d), dtype=x.dtype, device=x.device)
    send[src, torch.where(keep, slot, e_mesh * cap)] = x  # drops land in the spare slot
    send = send[:, : e_mesh * cap].reshape(e_mesh, e_mesh, cap, d)

    back: List[torch.Tensor] = []
    for e, params_e in enumerate(experts):
        dev = tree_leaves(params_e)[0].device
        recv = send[:, e].to(dev).reshape(e_mesh * cap, d)  # from every source
        back.append(expert_fn(params_e, recv).reshape(e_mesh, cap, -1).to(x.device))
    # back_j: source j's slots of every expert, (E, C, D_out) flattened
    home = torch.stack(back, dim=1).reshape(e_mesh, e_mesh * cap, -1)
    y = home[src, torch.where(keep, slot, 0)]
    return y * keep[:, None] * chosen_p


def a2a_slots(gate_logits: torch.Tensor, num_experts: int, cap: int):
    """The a2a dispatch's routing: for each token whether it is kept, its
    slot ``expert * cap + rank`` in its source shard's send buffer (rank
    among the shard's tokens bound for that expert, by position), and the
    chosen expert's probability. Integer arithmetic: the drop mask is the
    reference's bit for bit."""
    assign, chosen_p = _route(gate_logits)
    b = gate_logits.shape[0]
    b_local = b // num_experts
    dest = torch.nn.functional.one_hot(assign, num_experts).to(torch.int32)
    pos = torch.cumsum(dest.reshape(num_experts, b_local, num_experts), dim=1) - 1
    my_pos = torch.gather(pos.reshape(b, num_experts), 1, assign[:, None])[:, 0]
    keep = my_pos < cap
    slot = assign * cap + my_pos
    return keep, slot, chosen_p
