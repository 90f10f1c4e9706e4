"""Gradient/hessian/count histograms over (node, feature, bin).

Counterpart of ``mmlspark_tpu/ops/histogram.py``. CUDA tensors go to the
Hopper kernel (``ops/hopper_histogram.py``): the root pass (one node) through
the combined-id entry, frontier passes through the node-panel entry, as the
JAX package routes them to its two Pallas entry points. CPU tensors take the
kernel's plain version. The plain version never runs on a CUDA tensor here.
"""

from __future__ import annotations

import torch

from mmlspark_tpu_torch.ops.hopper_histogram import (
    build_histograms_combined_cuda,
    build_histograms_cuda,
)


def build_histograms(bins_t, grad, hess, count, node, num_nodes: int,
                     num_bins: int) -> torch.Tensor:
    """(num_nodes, F, num_bins, 3) float32 ``[sum_g, sum_h, count]``.

    ``bins_t`` is the feature-major ``(F, N)`` uint8 bin matrix; ``node`` the
    (N,) int32 node key. Rows keyed outside ``[0, num_nodes)`` add nothing,
    so the key doubles as the in-leaf mask. Any ``num_nodes``: on the card a
    pass wider than one launch holds runs in node groups
    (``hopper_histogram.node_groups``)."""
    if num_nodes == 1:
        return build_histograms_combined_cuda(
            bins_t, grad, hess, count, node, num_nodes, num_bins
        )
    return build_histograms_cuda(bins_t, grad, hess, count, node, num_nodes, num_bins)


def build_node_panel(grad, hess, count, node, num_nodes: int) -> torch.Tensor:
    """(N, 3*num_nodes) stat-major panel ``[g*nodes | h*nodes | c*nodes]``:
    row i carries its (g, h, c) in the node[i]-keyed columns and zeros
    elsewhere; an out-of-range key zeroes the row. The layout of
    ``mmlspark_tpu.ops.pallas_histogram.build_node_panel``."""
    nodes = torch.arange(num_nodes, dtype=torch.int32, device=node.device)
    nodeoh = (node.to(torch.int32)[:, None] == nodes[None, :]).to(torch.float32)
    data = torch.stack(
        [grad.float(), hess.float(), count.float()], dim=-1
    )  # (N, 3)
    return (data[:, :, None] * nodeoh[:, None, :]).reshape(node.shape[0], 3 * num_nodes)
