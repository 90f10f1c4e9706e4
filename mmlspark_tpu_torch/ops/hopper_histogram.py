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
"""

from __future__ import annotations

import dataclasses

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


def fixed_point_scales(grad, hess) -> torch.Tensor:
    """(2,) float64 powers of two ``2**s`` for g and h: the largest with
    ``N * max|x| * 2**s <= 2**62``, so ``round(x * 2**s)`` summed over all N
    rows fits an int64 whatever the order. Built from the exponent bits, so
    kernel and plain version share them exactly; computed on the tensors'
    device, with no host sync."""
    n = grad.shape[0]
    top = torch.stack([grad.abs().amax(), hess.abs().amax()]) if n else torch.zeros(
        2, device=grad.device)
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

