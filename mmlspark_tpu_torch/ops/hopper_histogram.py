"""Hopper histogram kernel entry points and their plain PyTorch version.

Counterpart of ``mmlspark_tpu/ops/pallas_histogram.py``. The JAX package has
one TPU kernel body (``_hist_kernel``) behind two entry points with one
contract; so does the port: ``kernels/csrc/histogram.cu`` behind

- :func:`build_histograms_cuda` — the node-panel contract of
  ``build_histograms_panel_pallas`` (the leafwise frontier passes, k > 1);
- :func:`build_histograms_combined_cuda` — the combined ``node*B + bin``
  contract of ``build_histograms_pallas`` (the root pass, k = 1).

Both return ``(num_nodes, F, num_bins, 3)`` float32 ``[sum_g, sum_h, count]``
and drop rows whose node key lies outside ``[0, num_nodes)``. Bins come
feature-major, ``(F, N)`` uint8, laid out once per fit (the JAX kernel's
``ids.T``), so each block's row reads are coalesced.

g and h are summed in 64-bit fixed point (:func:`fixed_point_scales`), so
the sums do not depend on the order of the rows: a launch is bit-identical to
the next and to the plain version, and a fit grows the same trees every time.

On a CUDA tensor an entry point launches the kernel or raises. On a CPU
tensor it computes :func:`build_histograms_plain`, the same function as one
``index_add_`` (the JAX ``segment`` formulation, ``ops/histogram.py``) in the
kernel's integer arithmetic.

:func:`build_histograms_bin_scatter` is the counterpart of the JAX
package's fused bin + scatter-add pass (``_bin_scatter_kernel``): the U
pass's packed-space histogram (``ops/u_histogram.py``) computed straight
from the bins by ``kernels/csrc/bin_scatter.cu`` (:func:`bin_scatter`),
with :func:`bin_scatter_plain` beside it.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

#: Node budget of one pass: the leafwise grower's subtraction cap
#: (``mmlspark_tpu/lightgbm/train.py`` keys at most 42 nodes per pass).
MAX_NODES = 42
#: The bins are uint8.
MAX_BINS = 256
#: Threads per block.
THREADS = 1024
#: Dynamic shared memory one block may take: half an SM's 228 KB, so two
#: 1024-thread blocks share an SM. A single feature's cells may exceed it
#: (42 nodes x 256 bins = 210 KB); such passes run one block per SM.
SMEM_BUDGET = 112 * 1024
#: Largest dynamic shared memory a Hopper block may opt into.
SMEM_MAX = 232_448
#: Grid size in waves of resident blocks.
WAVES = 2
#: Shared-memory bytes of one (node, bin) cell: int64 g, int64 h, float32 c.
CELL_BYTES = 20
#: Fixed-point headroom: the scaled sum of all N rows stays below 2**62.
FIXED_POINT_BITS = 62


@dataclasses.dataclass(frozen=True)
class LaunchPlan:
    fg: int  # features per block (one shared-memory histogram each)
    grid_x: int  # row blocks
    grid_y: int  # feature groups
    rows_per_block: int
    smem_bytes: int


def launch_plan(n: int, f: int, num_nodes: int, num_bins: int,
                num_sms: int) -> LaunchPlan:
    """Grid and shared-memory layout of one launch: as many features per
    block as fit :data:`SMEM_BUDGET` (each feature re-reads the row stats,
    so grouping cuts those reads by the group size), and enough row blocks
    for :data:`WAVES` waves of resident blocks."""
    per_feature = num_nodes * num_bins * CELL_BYTES
    if per_feature > SMEM_MAX:
        raise ValueError(
            f"{num_nodes} nodes x {num_bins} bins need {per_feature} bytes of "
            f"shared memory per feature; a block has {SMEM_MAX}"
        )
    fg = max(1, min(f, SMEM_BUDGET // per_feature))
    grid_y = -(-f // fg)
    smem = fg * per_feature
    resident = max(1, min(2048 // THREADS, 233_472 // (smem + 1024)))
    target = max(1, WAVES * num_sms * resident // grid_y)
    grid_x = max(1, min(target, -(-n // THREADS)))
    rows_per_block = -(-n // grid_x)
    grid_x = -(-n // rows_per_block)
    return LaunchPlan(fg, grid_x, grid_y, rows_per_block, smem)


def fixed_point_scales(*cols) -> torch.Tensor:
    """One float64 power of two ``2**s`` per (N,) column (g and h here; g, h
    and c on the U path): the largest with ``N * max|x| * 2**s <= 2**62``, so
    ``round(x * 2**s)`` summed over all N rows fits an int64 whatever the
    order. Built from the exponent bits, so kernel and plain version share
    them exactly; computed on the tensors' device, with no host sync."""
    n = cols[0].shape[0]
    top = torch.stack([c.abs().amax() for c in cols]) if n else torch.zeros(
        len(cols), device=cols[0].device)
    exponent = torch.frexp(top.float()).exponent.long()  # top < 2**exponent
    s = (FIXED_POINT_BITS - max(n, 1).bit_length() - exponent).clamp(-1000, 1000)
    return ((s + 1023) << 52).view(torch.float64)


def build_histograms_plain(bins_t, grad, hess, count, node, num_nodes: int,
                           num_bins: int) -> torch.Tensor:
    """Plain PyTorch version of the kernel: drop out-of-range node keys,
    then ONE ``index_add_`` over the flat cell id ``((node*F + f)*B + bin)``.

    float32 inputs take the kernel's arithmetic: g and h as int64
    ``round(x * 2**s)`` (:func:`fixed_point_scales`), summed exactly and
    turned back into float32; counts summed in float32. float64 inputs sum
    in float64 (the oracle the kernel is held to within a tolerance)."""
    f, n = bins_t.shape
    keep = (node >= 0) & (node < num_nodes)
    rows = keep.nonzero().squeeze(1)
    nd = node[rows].long()
    feats = torch.arange(f, device=bins_t.device)
    ids = ((nd[None, :] * f + feats[:, None]) * num_bins + bins_t[:, rows].long()).reshape(-1)
    cells = num_nodes * f * num_bins
    if grad.dtype == torch.float64:
        data = torch.stack([grad[rows], hess[rows], count[rows].to(grad.dtype)], dim=1)
        out = torch.zeros(cells, 3, dtype=grad.dtype, device=grad.device)
        out.index_add_(0, ids, data.repeat(f, 1))
        return out.reshape(num_nodes, f, num_bins, 3)
    scale = fixed_point_scales(grad, hess)
    q = torch.round(torch.stack([grad[rows], hess[rows]], dim=1).double() * scale).long()
    acc = torch.zeros(cells, 2, dtype=torch.int64, device=grad.device)
    acc.index_add_(0, ids, q.repeat(f, 1))
    cnt = torch.zeros(cells, dtype=torch.float32, device=grad.device)
    cnt.index_add_(0, ids, count[rows].repeat(f))
    out = torch.cat([(acc.double() / scale).float(), cnt[:, None]], dim=1)
    return out.reshape(num_nodes, f, num_bins, 3)


def _check(bins_t, grad, hess, count, node, num_nodes, num_bins):
    if bins_t.dim() != 2 or bins_t.dtype != torch.uint8:
        raise TypeError(f"bins_t must be (F, N) uint8, got {tuple(bins_t.shape)} {bins_t.dtype}")
    f, n = bins_t.shape
    for name, t, dt in (("grad", grad, torch.float32), ("hess", hess, torch.float32),
                        ("count", count, torch.float32), ("node", node, torch.int32)):
        if t.shape != (n,) or t.dtype != dt:
            raise TypeError(f"{name} must be ({n},) {dt}, got {tuple(t.shape)} {t.dtype}")
        if t.device != bins_t.device:
            raise ValueError(f"{name} is on {t.device}, bins_t on {bins_t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if not bins_t.is_contiguous():
        raise ValueError("bins_t must be contiguous (F, N)")
    if not 1 <= num_nodes <= MAX_NODES:
        raise ValueError(f"num_nodes={num_nodes} outside [1, {MAX_NODES}]")
    if not 1 <= num_bins <= MAX_BINS:
        raise ValueError(f"num_bins={num_bins} outside [1, {MAX_BINS}]")


def _launch(bins_t, grad, hess, count, node, num_nodes, num_bins):
    from mmlspark_tpu_torch.kernels.build import histogram_extension

    f, n = bins_t.shape
    out = torch.zeros((num_nodes, f, num_bins, 3), dtype=torch.float32,
                      device=bins_t.device)
    if n == 0 or f == 0:
        return out
    acc = torch.zeros((num_nodes, f, num_bins, 2), dtype=torch.int64, device=bins_t.device)
    scale = fixed_point_scales(grad, hess)
    props = torch.cuda.get_device_properties(bins_t.device)
    plan = launch_plan(n, f, num_nodes, num_bins, props.multi_processor_count)
    with torch.cuda.device(bins_t.device):
        stream = torch.cuda.current_stream(bins_t.device).cuda_stream
        histogram_extension().histogram(
            bins_t.data_ptr(), grad.data_ptr(), hess.data_ptr(), count.data_ptr(),
            node.data_ptr(), scale.data_ptr(), n, f, num_nodes, num_bins, plan.fg,
            plan.grid_x, plan.rows_per_block, THREADS, plan.smem_bytes, acc.data_ptr(),
            out.data_ptr(), stream,
        )
    return out


def build_histograms_cuda(bins_t, grad, hess, count, node, num_nodes: int,
                          num_bins: int) -> torch.Tensor:
    """Node-panel contract (``build_histograms_panel_pallas``): the frontier
    pass of the leafwise grower, ``num_nodes`` keyed nodes at once."""
    _check(bins_t, grad, hess, count, node, num_nodes, num_bins)
    if not bins_t.is_cuda:
        return build_histograms_plain(bins_t, grad, hess, count, node, num_nodes, num_bins)
    out = _launch(bins_t, grad, hess, count, node, num_nodes, num_bins)
    build_histograms_cuda.launches += 1
    return out


def build_histograms_combined_cuda(bins_t, grad, hess, count, node, num_nodes: int,
                                   num_bins: int) -> torch.Tensor:
    """Combined-id contract (``build_histograms_pallas``): the one-hot of
    ``node*B + bin`` against ``[g, h, c]``; a node outside ``[0, num_nodes)``
    matches no id. The root pass of the leafwise grower (one node)."""
    _check(bins_t, grad, hess, count, node, num_nodes, num_bins)
    if not bins_t.is_cuda:
        return build_histograms_plain(bins_t, grad, hess, count, node, num_nodes, num_bins)
    out = _launch(bins_t, grad, hess, count, node, num_nodes, num_bins)
    build_histograms_combined_cuda.launches += 1
    return out


build_histograms_cuda.launches = 0
build_histograms_combined_cuda.launches = 0


def bytes_needed(n: int, f: int, n_in: int, num_nodes: int, num_bins: int) -> int:
    """Least bytes one pass must move: every node key (4 B/row), the bins and
    (g, h, c) of the ``n_in`` rows keyed into range, and the output once."""
    return 4 * n + n_in * (f + 12) + num_nodes * f * num_bins * 3 * 4


def adds_needed(f: int, n_in: int) -> int:
    """Additions the pass does on these inputs: three per keyed row and
    feature (two int64, one float32)."""
    return 3 * f * n_in



# -- fused bin + scatter-add into the packed (U) space -------------------------


@dataclasses.dataclass(frozen=True)
class BinScatterPlan:
    chunk_rows: int  # packed rows per block (its shared-memory accumulator)
    grid_x: int  # packed-row chunks
    grid_y: int  # row blocks
    rows_per_block: int
    smem_bytes: int
    features: tuple  # per chunk: (first, last) feature whose rows it holds


def bin_scatter_plan(n: int, spec, num_nodes: int, quant: bool, num_sms: int) -> BinScatterPlan:
    """The port's fit gate for :func:`bin_scatter` (in place of the TPU's
    VMEM gate ``bin_scatter_fits_vmem``) and its launch layout. A block owns
    ``chunk_rows`` packed rows, whose (chunk_rows, 3k) accumulator fills
    :data:`SMEM_BUDGET` (int32 quantized, int64 fixed point otherwise): many
    features per block at few nodes, a part of one feature at 42 nodes.
    Raises ``ValueError`` for a shape it cannot take: a panel wider than 128
    (3k) or bins wider than uint8."""
    if not 1 <= 3 * num_nodes <= 128:
        raise ValueError(f"panel width 3*{num_nodes} exceeds one lane group")
    if spec.num_bins > MAX_BINS or max(spec.widths, default=1) > MAX_BINS:
        raise ValueError(f"bins wider than {MAX_BINS} do not fit uint8")
    acc_bytes = 4 if quant else 8
    chunk = max(1, min(spec.k, SMEM_BUDGET // (3 * num_nodes * acc_bytes)))
    grid_x = -(-spec.k // chunk)
    offsets = np.asarray(spec.offsets, np.int64)
    ends = offsets + np.asarray(spec.widths, np.int64)
    c0 = np.arange(grid_x, dtype=np.int64) * chunk
    first = np.searchsorted(ends, c0, side="right")
    last = np.searchsorted(offsets, np.minimum(c0 + chunk, spec.k), side="left") - 1
    smem = chunk * 3 * num_nodes * acc_bytes
    resident = max(1, min(2048 // THREADS, 233_472 // (smem + 1024)))
    target = max(1, WAVES * num_sms * resident // grid_x)
    grid_y = max(1, min(target, -(-n // THREADS)))
    rows_per_block = max(1, -(-n // grid_y))
    grid_y = max(1, -(-n // rows_per_block))
    features = tuple(int(v) for pair in zip(first, last) for v in pair)
    return BinScatterPlan(chunk, grid_x, grid_y, rows_per_block, smem, features)


def bin_scatter_plain(bins_t, stats, node, num_nodes: int, spec, scale=None) -> torch.Tensor:
    """Plain PyTorch version of :func:`bin_scatter`: per feature, the packed
    row ``off_f + bin`` of every keyed row whose bin is inside the feature's
    width, then one int64 ``index_add_`` per stat, in the kernel's integer
    arithmetic."""
    f, n = bins_t.shape
    width = 3 * num_nodes
    keep = (node >= 0) & (node < num_nodes)
    rows = keep.nonzero().squeeze(1)
    nd = node[rows].long()
    if scale is None:
        q = stats[:, rows].long()
    else:
        q = torch.round(stats[:, rows].double() * scale[:, None]).long()
    acc = torch.zeros(spec.k_pad * width, dtype=torch.int64, device=bins_t.device)
    for j, (off, w) in enumerate(zip(spec.offsets, spec.widths)):
        b = bins_t[j, rows].long()
        inside = b < w
        ids = (off + b[inside]) * width + nd[inside]
        for s in range(3):
            acc.index_add_(0, ids + s * num_nodes, q[s][inside])
    acc = acc.reshape(spec.k_pad, width)
    return acc.int() if scale is None else acc


def bin_scatter(bins_t, stats, node, num_nodes: int, spec, scale=None) -> torch.Tensor:
    """The packed-space histogram straight from the raw feature-major (F, N)
    uint8 bins: ``acc[off_f + bins[f, i], s*k + node_i] += q_s[i]``, the
    accumulator :func:`~mmlspark_tpu_torch.ops.u_histogram.fused_panel_dot`
    returns for the one-hot of the same bins (int32 for int8 ``stats``,
    int64 fixed point for bf16 ``stats`` with their ``scale``). Rows keyed
    outside ``[0, num_nodes)`` and bins at or past their feature's width add
    nothing.

    On a CUDA tensor it launches ``kernels/csrc/bin_scatter.cu``; on a CPU
    tensor it computes :func:`bin_scatter_plain`."""
    if bins_t.dim() != 2 or bins_t.dtype != torch.uint8 or not bins_t.is_contiguous():
        raise TypeError(f"bins_t must be a contiguous (F, N) uint8 tensor, got "
                        f"{tuple(bins_t.shape)} {bins_t.dtype}")
    f, n = bins_t.shape
    if f != spec.num_features:
        raise ValueError(f"{f} features of bins for a spec of {spec.num_features}")
    quant = stats.dtype == torch.int8
    if stats.shape != (3, n) or stats.dtype not in (torch.int8, torch.bfloat16):
        raise TypeError(f"stats must be (3, {n}) int8 or bfloat16, got {tuple(stats.shape)} "
                        f"{stats.dtype}")
    if node.shape != (n,) or node.dtype != torch.int32:
        raise TypeError(f"node must be ({n},) int32, got {tuple(node.shape)} {node.dtype}")
    if quant != (scale is None):
        raise ValueError("bf16 stats take (3,) float64 fixed-point scales; int8 stats none")
    if scale is not None and (scale.shape != (3,) or scale.dtype != torch.float64):
        raise TypeError(f"scale must be (3,) float64, got {tuple(scale.shape)} {scale.dtype}")
    for name, t in (("stats", stats), ("node", node), ("scale", scale)):
        if t is None:
            continue
        if t.device != bins_t.device:
            raise ValueError(f"{name} is on {t.device}, bins_t on {bins_t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    num_sms = (torch.cuda.get_device_properties(bins_t.device).multi_processor_count
               if bins_t.is_cuda else 1)
    plan = bin_scatter_plan(n, spec, num_nodes, quant, num_sms)
    if not bins_t.is_cuda:
        return bin_scatter_plain(bins_t, stats, node, num_nodes, spec, scale)
    from mmlspark_tpu_torch.kernels.build import histogram_extension

    out = torch.zeros((spec.k_pad, 3 * num_nodes), dtype=torch.int32 if quant else torch.int64,
                      device=bins_t.device)
    if n == 0:
        return out
    layout = torch.tensor(list(spec.offsets) + list(spec.widths) + list(plan.features),
                          dtype=torch.int32).to(bins_t.device)
    with torch.cuda.device(bins_t.device):
        stream = torch.cuda.current_stream(bins_t.device).cuda_stream
        histogram_extension().bin_scatter(
            bins_t.data_ptr(), stats.data_ptr(), node.data_ptr(),
            0 if scale is None else scale.data_ptr(), layout.data_ptr(), int(quant), n, f,
            spec.k_pad, num_nodes, plan.chunk_rows, plan.grid_x, plan.grid_y,
            plan.rows_per_block, THREADS, plan.smem_bytes, out.data_ptr(), stream,
        )
    bin_scatter.launches += 1
    return out


bin_scatter.launches = 0


def build_histograms_bin_scatter(
    bins_t,  # (F, N) uint8, the bins themselves (no U)
    grad, hess, count,  # (N,); ignored when stats is given
    node,  # (N,) int32; out-of-range keys add nothing
    num_nodes: int,
    spec,  # ops.u_histogram.USpec (packed row layout)
    *,
    stats=None,  # (3, N) bf16 stat rows, or (int8 stats, scales)
    dequant: bool = True,
) -> torch.Tensor:
    """Same contract as ``ops.u_histogram.build_histograms_u``, fed by the
    raw bins instead of U: per row it reads F bytes of bins and the stats
    instead of the K_pad-byte column of U. Counterpart of the JAX package's
    ``build_histograms_bin_scatter``; no training path takes it (nor the
    reference's), so it is an ops-level entry point."""
    from mmlspark_tpu_torch.ops.u_histogram import (
        _expand_packed,
        _finish,
        _split_stats,
        stat_scales,
    )

    stats, scales = _split_stats(stats, grad, hess, count)
    scale = None if scales is not None else stat_scales(stats)
    acc = bin_scatter(bins_t, stats, node.to(torch.int32).contiguous(), num_nodes, spec, scale)
    packed = _finish(acc, scale, node.shape[0], num_nodes)
    return _expand_packed(packed, scales, spec, num_nodes, dequant=dequant)


def bin_scatter_bytes(n: int, f: int, n_in: int, k_pad: int, num_nodes: int,
                      quant: bool) -> int:
    """Least bytes one bin-scatter pass must move: every node key (4 B/row),
    the bins and stats of the ``n_in`` keyed rows, and the accumulator once."""
    return 4 * n + n_in * (f + 3 * (1 if quant else 2)) + k_pad * 3 * num_nodes * (
        4 if quant else 8)
