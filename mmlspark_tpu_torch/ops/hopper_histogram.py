"""Hopper histogram kernel entry points and their plain PyTorch version.

Counterpart of ``mmlspark_tpu/ops/pallas_histogram.py``. The JAX package has
one TPU kernel body (``_hist_kernel``) behind two entry points with one
contract; so does the port: ``kernels/csrc/histogram.cu`` behind

- :func:`build_histograms_cuda` — the node-panel contract of
  ``build_histograms_panel_pallas`` (the leafwise frontier passes, k > 1);
- :func:`build_histograms_combined_cuda` — the combined ``node*B + bin``
  contract of ``build_histograms_pallas`` (the root pass, k = 1).

Both return ``(num_nodes, F, num_bins, 3)`` float32 ``[sum_g, sum_h, count]``
and drop rows whose node key lies outside ``[0, num_nodes)``. The node-panel
entry takes any node count: a level wider than one launch holds (a deep
depthwise level) runs as :func:`node_groups`, one launch per group with the
keys shifted by the group's first node, and the groups' histograms are
concatenated. Bins come
feature-major, ``(F, N)`` uint8, laid out once per fit (the JAX kernel's
``ids.T``), so each block's row reads are coalesced.

g and h are summed in 64-bit fixed point (:func:`fixed_point_scales`), so
the sums do not depend on the order of the rows: a launch is bit-identical to
the next and to the plain version, and a fit grows the same trees every time.
Counts must be non-negative integers whose sum in any one cell stays below
2**24 (the grower passes ones): the kernel sums them as uint32, the plain
version in float32, and the two agree exactly only there.

On a CUDA tensor an entry point launches the kernel or raises. On a CPU
tensor it computes :func:`build_histograms_plain`, the same function as one
``index_add_`` (the JAX ``segment`` formulation, ``ops/histogram.py``) in the
kernel's integer arithmetic.

:func:`build_histograms_bin_scatter` is the counterpart of the JAX
package's fused bin + scatter-add pass (``_bin_scatter_kernel``): the U
pass's packed-space histogram (``ops/u_histogram.py``) computed straight
from the bins by ``kernels/csrc/bin_scatter.cu`` (:func:`bin_scatter`),
with :func:`bin_scatter_plain` beside it. The kernel also takes the chunked
U pass's stack of row chunks, so that pass reads each chunk's bins instead
of rebuilding its one-hot.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict

import numpy as np
import torch

#: Node budget of one launch: the leafwise grower's subtraction cap
#: (``mmlspark_tpu/lightgbm/train.py`` keys at most 42 nodes per pass).
MAX_NODES = 42
#: The bins are uint8.
MAX_BINS = 256
#: Threads per block of the U pass kernel (``u_histogram.cu``).
THREADS = 1024
#: Largest dynamic shared memory a Hopper block may opt into.
SMEM_MAX = 232_448
#: Dynamic shared memory a U pass block takes on int8 stats: half an SM's
#: 228 KB.
SMEM_BUDGET = 112 * 1024
#: The same on bf16 stats, whose 64-bit cells and panel take twice the
#: bytes: the most a block may opt into (the kernel's bf16 form takes 50
#: registers a thread, so an SM holds one 1024-thread block anyway).
SMEM_BUDGET_BF16 = SMEM_MAX
#: Shared memory of one SM that blocks can split, with 1 KB reserved a block.
SMEM_PER_SM = 233_472
#: Grid size of the U pass kernel in waves of resident blocks.
WAVES = 2
#: Threads per block of the histogram kernel (``histogram.cu``).
HIST_THREADS = 1024
#: Threads one SM holds for the histogram kernel: its ``__launch_bounds__
#: (1024)`` lets it use up to 64 registers a thread, and an SM has 65,536.
HIST_THREADS_PER_SM = 1024
#: Dynamic shared memory one histogram block may take: the most a block may
#: opt into, so a block holds as many features as fit (one block per SM).
HIST_SMEM_BUDGET = SMEM_MAX
#: Grid size of the histogram kernel in waves of resident blocks.
HIST_WAVES = 2
#: Consecutive rows a thread of the histogram and bin-scatter kernels takes
#: per step (vector loads of the stats): every block's row range starts at
#: a multiple of it.
ROWS_PER_THREAD = 4
#: Shared-memory bytes of one (node, bin) cell: int64 g, int64 h, uint32 c.
CELL_BYTES = 20
#: Fixed-point headroom: the scaled sum of all N rows stays below 2**62.
FIXED_POINT_BITS = 62


@dataclasses.dataclass(frozen=True)
class LaunchPlan:
    fg: int  # features per block (one shared-memory histogram each)
    groups: int  # feature groups, the grid's fastest index
    row_blocks: int  # row ranges
    rows_per_block: int  # a multiple of ROWS_PER_THREAD
    smem_bytes: int


def launch_plan(n: int, f: int, num_nodes: int, num_bins: int,
                num_sms: int) -> LaunchPlan:
    """Grid and shared-memory layout of one histogram launch: as few
    feature groups as :data:`HIST_SMEM_BUDGET` allows (every group reads the
    row stats again, from L2 when the groups of a row range run together),
    the features spread evenly over them, and enough row blocks for
    :data:`HIST_WAVES` waves of resident blocks. Row ranges start at
    multiples of :data:`ROWS_PER_THREAD`, so the kernel's vector loads are
    aligned."""
    per_feature = num_nodes * num_bins * CELL_BYTES
    if per_feature > SMEM_MAX:
        raise ValueError(
            f"{num_nodes} nodes x {num_bins} bins need {per_feature} bytes of "
            f"shared memory per feature; a block has {SMEM_MAX}"
        )
    groups = -(-f // max(1, min(f, HIST_SMEM_BUDGET // per_feature)))
    fg = -(-f // groups)
    smem = fg * per_feature
    resident = max(1, min(HIST_THREADS_PER_SM // HIST_THREADS, SMEM_PER_SM // (smem + 1024)))
    target = max(1, HIST_WAVES * num_sms * resident // groups)
    step = HIST_THREADS * ROWS_PER_THREAD
    row_blocks = max(1, min(target, -(-n // step)))
    rows_per_block = -(-max(n, 1) // row_blocks)
    rows_per_block = -(-rows_per_block // ROWS_PER_THREAD) * ROWS_PER_THREAD
    row_blocks = -(-max(n, 1) // rows_per_block)
    return LaunchPlan(fg, groups, row_blocks, rows_per_block, smem)


def fixed_point_scales(*cols) -> torch.Tensor:
    """One float64 power of two ``2**s`` per (N,) column (g and h here; g, h
    and c on the U path): the largest with ``N * max|x| * 2**s <= 2**62``, so
    ``round(x * 2**s)`` summed over all N rows fits an int64 whatever the
    order. Built from the exponent bits, so kernel and plain version share
    them exactly; computed on the tensors' device, with no host sync, and
    ``max|x|`` in one read of each column."""
    n = cols[0].shape[0]
    top = torch.stack([torch.linalg.vector_norm(c, float("inf")) for c in cols]) if n else (
        torch.zeros(len(cols), device=cols[0].device))
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
    if num_nodes < 1:
        raise ValueError(f"num_nodes={num_nodes} must be at least 1")
    if not 1 <= num_bins <= MAX_BINS:
        raise ValueError(f"num_bins={num_bins} outside [1, {MAX_BINS}]")


def _aligned(t, nbytes):
    """``t``, or a copy of it at a fresh (aligned) address when its data does
    not start on an ``nbytes`` boundary: the kernel loads four rows at once."""
    return t if t.data_ptr() % nbytes == 0 else t.clone()


def _launch(bins_t, grad, hess, count, node, num_nodes, num_bins):
    from mmlspark_tpu_torch.kernels.build import histogram_extension

    if num_nodes > MAX_NODES:
        raise ValueError(f"num_nodes={num_nodes} exceeds one launch's {MAX_NODES}")
    f, n = bins_t.shape
    out = torch.zeros((num_nodes, f, num_bins, 3), dtype=torch.float32,
                      device=bins_t.device)
    if n == 0 or f == 0:
        return out
    acc = torch.zeros((num_nodes, f, num_bins, 2), dtype=torch.int64, device=bins_t.device)
    scale = fixed_point_scales(grad, hess)
    bins_t = _aligned(bins_t, 4)
    grad, hess, count, node = (_aligned(t, 16) for t in (grad, hess, count, node))
    props = torch.cuda.get_device_properties(bins_t.device)
    plan = launch_plan(n, f, num_nodes, num_bins, props.multi_processor_count)
    with torch.cuda.device(bins_t.device):
        stream = torch.cuda.current_stream(bins_t.device).cuda_stream
        histogram_extension().histogram(
            bins_t.data_ptr(), grad.data_ptr(), hess.data_ptr(), count.data_ptr(),
            node.data_ptr(), scale.data_ptr(), n, f, num_nodes, num_bins, plan.fg,
            plan.row_blocks, plan.rows_per_block, HIST_THREADS, plan.smem_bytes,
            acc.data_ptr(), out.data_ptr(), stream,
        )
    return out


def node_groups(num_nodes: int, num_bins: int) -> list:
    """(first node, node count) of each launch of a ``num_nodes`` pass: as
    few groups as hold at most ``min(MAX_NODES, SMEM_MAX // (num_bins *
    CELL_BYTES))`` nodes each (one feature's cells must fit a block), the
    nodes spread evenly over them. At 256 bins a 64-node level takes two
    launches of 32, a 128-node level four of 32."""
    cap = max(1, min(MAX_NODES, SMEM_MAX // (num_bins * CELL_BYTES)))
    groups = -(-num_nodes // cap)
    size = -(-num_nodes // groups)
    return [(lo, min(size, num_nodes - lo)) for lo in range(0, num_nodes, size)]


def grouped(launch, bins_t, grad, hess, count, node, num_nodes: int,
            num_bins: int) -> torch.Tensor:
    """``launch`` (a per-launch histogram function of this module's
    contract) over :func:`node_groups`: one call per group with the keys
    shifted by the group's first node, so that the group's rows key
    ``[0, size)`` and every other row falls out of range and adds nothing;
    the results concatenated along the node axis. Every group sums with the
    fixed-point scales of all N rows, so the result is the one-call result
    bit for bit."""
    groups = node_groups(num_nodes, num_bins)
    if len(groups) == 1:
        return launch(bins_t, grad, hess, count, node, num_nodes, num_bins)
    return torch.cat([launch(bins_t, grad, hess, count, node - lo, size, num_bins)
                      for lo, size in groups])


def _launch_counted(bins_t, grad, hess, count, node, num_nodes, num_bins):
    out = _launch(bins_t, grad, hess, count, node, num_nodes, num_bins)
    build_histograms_cuda.launches += 1
    return out


def build_histograms_cuda(bins_t, grad, hess, count, node, num_nodes: int,
                          num_bins: int) -> torch.Tensor:
    """Node-panel contract (``build_histograms_panel_pallas``): a frontier
    pass of the leafwise grower or a level of the depthwise grower,
    ``num_nodes`` keyed nodes at once, in one launch per :func:`node_groups`
    group. ``count`` holds non-negative integers whose sum in a cell stays
    below 2**24."""
    _check(bins_t, grad, hess, count, node, num_nodes, num_bins)
    if not bins_t.is_cuda:
        return build_histograms_plain(bins_t, grad, hess, count, node, num_nodes, num_bins)
    return grouped(_launch_counted, bins_t, grad, hess, count, node, num_nodes, num_bins)


def build_histograms_combined_cuda(bins_t, grad, hess, count, node, num_nodes: int,
                                   num_bins: int) -> torch.Tensor:
    """Combined-id contract (``build_histograms_pallas``): the one-hot of
    ``node*B + bin`` against ``[g, h, c]``; a node outside ``[0, num_nodes)``
    matches no id. The root pass of the leafwise grower (one node).
    ``count`` holds non-negative integers whose sum in a cell stays below
    2**24."""
    _check(bins_t, grad, hess, count, node, num_nodes, num_bins)
    if num_nodes > MAX_NODES:
        raise ValueError(f"num_nodes={num_nodes} exceeds one launch's {MAX_NODES}")
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


def histogram_cost(bins_t, grad, hess, count, node, num_nodes: int,
                   num_bins: int) -> Dict[str, float]:
    """One pass's cost on these inputs, for ``DeviceProfiler.wrap(cost=...)``
    around either entry: :func:`adds_needed` and :func:`bytes_needed` of
    the rows keyed into range (one count, which syncs with the card)."""
    f, n = bins_t.shape
    n_in = int((node < num_nodes).sum())
    return {"flops": float(adds_needed(f, n_in)),
            "bytes_accessed": float(bytes_needed(n, f, n_in, num_nodes, num_bins))}



# -- fused bin + scatter-add into the packed (U) space -------------------------

#: Dynamic shared memory one bin-scatter block may take: the most a block may
#: opt into, so a block holds as many packed rows as fit and the fewest
#: packed-row chunks re-read each row's key and stats.
BIN_SCATTER_SMEM_BUDGET = SMEM_MAX
#: Threads per bin-scatter block.
BIN_SCATTER_THREADS = 1024
#: Threads one SM holds for the bin-scatter kernel: its ``__launch_bounds__
#: (1024)`` lets it use up to 64 registers a thread, and an SM has 65,536.
BIN_SCATTER_THREADS_PER_SM = 1024
#: Grid size of the bin-scatter kernel in waves of resident blocks.
BIN_SCATTER_WAVES = 4


@dataclasses.dataclass(frozen=True)
class BinScatterPlan:
    chunk_rows: int  # packed rows per block (its shared-memory accumulator)
    grid_x: int  # packed-row chunks, the grid's fastest index
    grid_y: int  # row blocks
    rows_per_block: int  # a multiple of ROWS_PER_THREAD
    smem_bytes: int
    features: tuple  # per chunk: (first, last) feature whose rows it holds


def bin_scatter_plan(n: int, spec, num_nodes: int, quant: bool, num_sms: int) -> BinScatterPlan:
    """The port's fit gate for :func:`bin_scatter` (in place of the TPU's
    VMEM gate ``bin_scatter_fits_vmem``) and its launch layout. A block owns
    ``chunk_rows`` packed rows, whose (chunk_rows, 3k) cells (4 bytes
    quantized, 8 in fixed point) fit :data:`BIN_SCATTER_SMEM_BUDGET`: as
    few packed-row chunks as fit (each reads every row's key and stats
    again, from L2 when the chunks of a row range run together), the packed
    rows spread evenly over them, and enough row blocks for
    :data:`BIN_SCATTER_WAVES` waves of resident blocks. Row ranges start at
    multiples of :data:`ROWS_PER_THREAD`, so the kernel's vector loads are
    aligned. Raises ``ValueError`` for a shape it cannot take: a panel wider
    than 128 (3k) or bins wider than uint8."""
    if not 1 <= 3 * num_nodes <= 128:
        raise ValueError(f"panel width 3*{num_nodes} exceeds one lane group")
    if spec.num_bins > MAX_BINS or max(spec.widths, default=1) > MAX_BINS:
        raise ValueError(f"bins wider than {MAX_BINS} do not fit uint8")
    row_bytes = 3 * num_nodes * (4 if quant else 8)
    grid_x = -(-spec.k // max(1, min(spec.k, BIN_SCATTER_SMEM_BUDGET // row_bytes)))
    chunk = -(-spec.k // grid_x)
    offsets = np.asarray(spec.offsets, np.int64)
    ends = offsets + np.asarray(spec.widths, np.int64)
    c0 = np.arange(grid_x, dtype=np.int64) * chunk
    first = np.searchsorted(ends, c0, side="right")
    last = np.searchsorted(offsets, np.minimum(c0 + chunk, spec.k), side="left") - 1
    smem = chunk * row_bytes
    resident = max(1, min(BIN_SCATTER_THREADS_PER_SM // BIN_SCATTER_THREADS,
                          SMEM_PER_SM // (smem + 1024)))
    target = max(1, BIN_SCATTER_WAVES * num_sms * resident // grid_x)
    step = BIN_SCATTER_THREADS * ROWS_PER_THREAD
    grid_y = max(1, min(target, -(-n // step)))
    rows_per_block = -(-max(n, 1) // grid_y)
    rows_per_block = -(-rows_per_block // ROWS_PER_THREAD) * ROWS_PER_THREAD
    grid_y = -(-max(n, 1) // rows_per_block)
    features = tuple(int(v) for pair in zip(first, last) for v in pair)
    return BinScatterPlan(chunk, grid_x, grid_y, rows_per_block, smem, features)


@functools.lru_cache(maxsize=64)
def _bin_scatter_layout(spec, features: tuple, device: torch.device) -> torch.Tensor:
    """The kernel's int32 ``layout`` on ``device``: the features' packed
    offsets and widths, then each chunk's (first, last) feature. Made once
    per (spec, plan features, device), so a launch copies nothing from the
    host."""
    return torch.tensor(list(spec.offsets) + list(spec.widths) + list(features),
                        dtype=torch.int32, device=device)


def _as_stack(bins):
    """``bins`` as a (m, F, chunk) stack of row chunks: the (F, N) bins are
    the stack of one chunk."""
    return bins if bins.dim() == 3 else bins[None]


def bin_scatter_plain(bins, stats, node, num_nodes: int, spec, scale=None) -> torch.Tensor:
    """Plain PyTorch version of :func:`bin_scatter`: chunk by chunk of the
    stack (one chunk for (F, N) bins) and feature by feature, the packed row
    ``off_f + bin`` of every keyed row whose bin is inside the feature's
    width, then one int64 ``index_add_`` per stat, in the kernel's integer
    arithmetic."""
    stack = _as_stack(bins)
    chunk = stack.shape[2]
    n = node.shape[0]
    width = 3 * num_nodes
    acc = torch.zeros(spec.k_pad * width, dtype=torch.int64, device=stack.device)
    for j in range(-(-n // chunk) if chunk else 0):
        lo, hi = j * chunk, min(n, (j + 1) * chunk)
        nd = node[lo:hi]
        rows = ((nd >= 0) & (nd < num_nodes)).nonzero().squeeze(1)
        key = nd[rows].long()
        if scale is None:
            q = stats[:, lo:hi][:, rows].long()
        else:
            q = torch.round(stats[:, lo:hi][:, rows].double() * scale[:, None]).long()
        for f, (off, w) in enumerate(zip(spec.offsets, spec.widths)):
            b = stack[j, f, rows].long()
            inside = b < w
            ids = (off + b[inside]) * width + key[inside]
            for s in range(3):
                acc.index_add_(0, ids + s * num_nodes, q[s][inside])
    acc = acc.reshape(spec.k_pad, width)
    return acc.int() if scale is None else acc


def bin_scatter(bins, stats, node, num_nodes: int, spec, scale=None) -> torch.Tensor:
    """The packed-space histogram straight from the raw uint8 bins:
    ``acc[off_f + bins[f, i], s*k + node_i] += q_s[i]``, the accumulator
    :func:`~mmlspark_tpu_torch.ops.u_histogram.fused_panel_dot` returns for
    the one-hot of the same bins (int32 for int8 ``stats``, int64 fixed
    point for bf16 ``stats`` with their ``scale``). Rows keyed outside
    ``[0, num_nodes)`` and bins at or past their feature's width add
    nothing.

    ``bins`` is feature-major (F, N), or the (m, F, chunk) stack of row
    chunks from ``prepare_chunked_bins`` (row i at column ``i % chunk`` of
    chunk ``i // chunk``; the stack's rows at or past N are not read). The
    (3, N) ``stats`` and (N,) ``node`` are read in place.

    On a CUDA tensor it launches ``kernels/csrc/bin_scatter.cu``, one
    launch for the whole stack; on a CPU tensor it computes
    :func:`bin_scatter_plain`."""
    if bins.dim() not in (2, 3) or bins.dtype != torch.uint8 or not bins.is_contiguous():
        raise TypeError(f"bins must be a contiguous (F, N) or (m, F, chunk) uint8 tensor, got "
                        f"{tuple(bins.shape)} {bins.dtype}")
    if stats.dim() != 2 or stats.shape[0] != 3 or stats.dtype not in (torch.int8, torch.bfloat16):
        raise TypeError(f"stats must be (3, N) int8 or bfloat16, got {tuple(stats.shape)} "
                        f"{stats.dtype}")
    stack = _as_stack(bins)
    m, f, chunk = stack.shape
    n = stats.shape[1]
    if f != spec.num_features:
        raise ValueError(f"{f} features of bins for a spec of {spec.num_features}")
    if (n != chunk) if bins.dim() == 2 else (n > m * chunk):
        raise ValueError(f"{n} stat rows for bins of {tuple(bins.shape)}")
    quant = stats.dtype == torch.int8
    if node.shape != (n,) or node.dtype != torch.int32:
        raise TypeError(f"node must be ({n},) int32, got {tuple(node.shape)} {node.dtype}")
    if quant != (scale is None):
        raise ValueError("bf16 stats take (3,) float64 fixed-point scales; int8 stats none")
    if scale is not None and (scale.shape != (3,) or scale.dtype != torch.float64):
        raise TypeError(f"scale must be (3,) float64, got {tuple(scale.shape)} {scale.dtype}")
    for name, t in (("stats", stats), ("node", node), ("scale", scale)):
        if t is None:
            continue
        if t.device != bins.device:
            raise ValueError(f"{name} is on {t.device}, bins on {bins.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    num_sms = (torch.cuda.get_device_properties(bins.device).multi_processor_count
               if bins.is_cuda else 1)
    plan = bin_scatter_plan(n, spec, num_nodes, quant, num_sms)
    if not bins.is_cuda:
        return bin_scatter_plain(bins, stats, node, num_nodes, spec, scale)
    from mmlspark_tpu_torch.kernels.build import histogram_extension

    out = torch.zeros((spec.k_pad, 3 * num_nodes), dtype=torch.int32 if quant else torch.int64,
                      device=bins.device)
    if n == 0:
        return out
    layout = _bin_scatter_layout(spec, plan.features, bins.device)
    with torch.cuda.device(bins.device):
        stream = torch.cuda.current_stream(bins.device).cuda_stream
        histogram_extension().bin_scatter(
            stack.data_ptr(), stats.data_ptr(), node.data_ptr(),
            0 if scale is None else scale.data_ptr(), layout.data_ptr(), int(quant), n, chunk,
            f, spec.k, num_nodes, plan.chunk_rows, plan.grid_x, plan.grid_y,
            plan.rows_per_block, BIN_SCATTER_THREADS, plan.smem_bytes, out.data_ptr(), stream,
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
    ``build_histograms_bin_scatter``, an ops-level entry point: no training
    path calls it (nor the reference's). The chunked U pass
    (``ops.u_histogram.build_histograms_u_chunked``) calls :func:`bin_scatter`
    on its stack of row chunks."""
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
