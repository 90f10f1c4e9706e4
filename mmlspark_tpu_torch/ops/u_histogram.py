"""Precomputed-U histogram pass: the packed one-hot of the bins, built once.

Counterpart of ``mmlspark_tpu/ops/u_histogram.py``. Bins are fixed for a
whole fit, so the one-hot ``U[off_f + b, i] = (bins[f, i] == b)`` is built
once (uint8, packed rows leading) and every histogram pass is one
contraction of U against the node-keyed stat panel:

    hist[c, s*k + j] = sum_i U[c, i] * stat_s[i] * (node_i == j)

Feature f owns the packed rows ``[off_f, off_f + width_f)``, ``width_f``
its actual bin count, so K = sum of widths (K_pad: K rounded up to 128).

The contraction is ``kernels/csrc/u_histogram.cu`` (:func:`fused_panel_dot`),
the Hopper counterpart of the Pallas ``_fused_panel_dot``: it builds each
row tile's panel in shared memory and adds it into the packed rows whose U
byte is set. Its plain version, :func:`fused_panel_dot_plain`, is the
reference's two-op formulation (:func:`_stat_panel_t`, then one exact
contraction). Both sum in integers, so they agree bit for bit and do not
depend on row order:

- quantized stats (int8, :func:`stat_rows_quant`) in int32, narrowed
  losslessly to :func:`histogram_acc_dtype`;
- bf16 stats (:func:`stat_rows`) in 64-bit fixed point
  (``ops.hopper_histogram.fixed_point_scales``), turned into float32 at the
  end. The reference sums the same bf16 values in float32.

Past the U budget (``MMLSPARK_TPU_U_BUDGET``, default 8 GB) the pass streams
row chunks: each chunk's one-hot is rebuilt from the pre-laid-out bins and
contracted by the same kernel into one accumulator
(:func:`build_histograms_u_chunked`), so chunked and resident passes agree
bit for bit.
"""

from __future__ import annotations

import dataclasses
import functools
import logging
import os
from typing import Optional, Tuple

import numpy as np
import torch

from mmlspark_tpu_torch.ops.hopper_histogram import (
    MAX_NODES,
    SMEM_BUDGET,
    THREADS,
    WAVES,
    fixed_point_scales,
)

_LANE = 128
_N_ALIGN = 512  # row padding granularity of U
#: Default U budget in bytes (``MMLSPARK_TPU_U_BUDGET``).
DEFAULT_U_BUDGET = 8 << 30
#: Rows of U per shared-memory panel tile of the kernel.
TILE_ROWS = 2048

_log = logging.getLogger("mmlspark_tpu_torch.lightgbm")


@dataclasses.dataclass(frozen=True)
class USpec:
    """Host description of the packed one-hot layout."""

    widths: Tuple[int, ...]  # per-feature bin count (incl. missing bin)
    offsets: Tuple[int, ...]  # per-feature first packed row of U
    k: int  # sum of widths
    k_pad: int  # k rounded up to 128
    num_bins: int  # dense histogram width B the caller expects
    # 0 = fit-resident U; > 0 = row-chunked passes of this many rows, each
    # rebuilding its chunk's one-hot from prepare_chunked_bins' layout.
    chunk_rows: int = 0

    @property
    def num_features(self) -> int:
        return len(self.widths)


def make_u_spec(num_bins: int, num_features: int, per_feature=None) -> USpec:
    """``per_feature`` = ``BinMapper.num_bins`` (actual per-feature widths);
    None = uniform ``num_bins``."""
    if per_feature is None:
        widths = [num_bins] * num_features
    else:
        widths = [int(min(max(w, 1), num_bins)) for w in per_feature]
    offsets = np.concatenate([[0], np.cumsum(widths[:-1])]).astype(int)
    k = int(np.sum(widths))
    k_pad = ((k + _LANE - 1) // _LANE) * _LANE
    return USpec(
        widths=tuple(widths), offsets=tuple(int(o) for o in offsets),
        k=k, k_pad=k_pad, num_bins=num_bins,
    )


def u_bytes(n_rows: int, spec: USpec) -> int:
    """Resident device bytes of the uint8 U for ``n_rows`` (pre-padding)."""
    n_pad = ((n_rows + _N_ALIGN - 1) // _N_ALIGN) * _N_ALIGN
    return n_pad * spec.k_pad


def chunked_u_spec(n_rows: int, spec: USpec, budget: int) -> USpec:
    """The row-chunked variant of ``spec`` for ``budget`` bytes: a chunk's
    one-hot (chunk_rows x k_pad bytes) takes at most half the budget (the
    reference keeps the next chunk in flight beside it), and chunk_rows is
    a multiple of the row-alignment block."""
    per_row = max(1, spec.k_pad)
    target = max(budget // 2, per_row * _N_ALIGN)
    chunk = max(_N_ALIGN, (target // per_row) // _N_ALIGN * _N_ALIGN)
    n_pad = ((n_rows + _N_ALIGN - 1) // _N_ALIGN) * _N_ALIGN
    chunk = min(chunk, n_pad)
    return dataclasses.replace(spec, chunk_rows=int(chunk))


def num_u_chunks(n_rows: int, spec: USpec) -> int:
    """Chunk count of one histogram pass for a chunked spec."""
    if not spec.chunk_rows:
        return 1
    return -(-n_rows // spec.chunk_rows)


def u_budget() -> int:
    """The U budget in bytes: ``MMLSPARK_TPU_U_BUDGET``, else 8 GB (a value
    that is not an integer warns and takes the default)."""
    raw = os.environ.get("MMLSPARK_TPU_U_BUDGET", str(DEFAULT_U_BUDGET))
    try:
        return int(raw)
    except ValueError:
        _log.warning(
            "MMLSPARK_TPU_U_BUDGET=%r is not an integer byte count; using the "
            "default 8 GB budget", raw,
        )
        return DEFAULT_U_BUDGET


@functools.lru_cache(maxsize=64)
def _dense_maps_cached(spec: USpec) -> Tuple[np.ndarray, np.ndarray]:
    """(F, B) packed-row gather map + validity mask for expanding the packed
    (K, D) result into the dense (F, B, D) histogram."""
    f, b = spec.num_features, spec.num_bins
    idx = np.zeros((f, b), np.int32)
    mask = np.zeros((f, b), np.float32)
    for j in range(f):
        w = spec.widths[j]
        idx[j, :w] = spec.offsets[j] + np.arange(w)
        mask[j, :w] = 1.0
    return idx, mask


def _onehot(bins_t: torch.Tensor, spec: USpec, n_pad: int, out=None) -> torch.Tensor:
    """(K_pad, n_pad) uint8 one-hot of the (F, n) bins; columns n..n_pad-1
    and the k..k_pad tail stay zero, and a bin >= its feature's width
    matches nothing. ``out``, a one-hot of other bins of the same shape, is
    overwritten in place (its zero regions stay zero)."""
    f, n = bins_t.shape
    dev = bins_t.device
    if out is None:
        u = torch.zeros((spec.k_pad, n_pad), dtype=torch.uint8, device=dev)
    else:
        u = out.zero_()
    # One scatter of the F set bytes of each row. A bin past its feature's
    # width writes a 0 into the feature's first row instead, a byte no other
    # (feature, row) pair writes, so the writes never collide.
    offsets = torch.tensor(spec.offsets, dtype=torch.int64, device=dev)[:, None]
    widths = torch.tensor(spec.widths, dtype=torch.int64, device=dev)[:, None]
    b = bins_t.to(torch.int64)
    inside = b < widths
    rows = offsets + torch.where(inside, b, 0)
    pos = rows * n_pad + torch.arange(n, dtype=torch.int64, device=dev)[None, :]
    u.view(-1)[pos.view(-1)] = inside.view(-1).to(torch.uint8)
    return u


def build_u(bins_t: torch.Tensor, spec: USpec) -> torch.Tensor:
    """(K_pad, N_pad) uint8 one-hot of the feature-major (F, N) uint8 bins,
    rows padded to a multiple of 512 with zero columns. Built once per fit."""
    n = bins_t.shape[1]
    return _onehot(bins_t, spec, n + (-n) % _N_ALIGN)


def prepare_chunked_bins(bins_t: torch.Tensor, spec: USpec) -> torch.Tensor:
    """One-time per-fit layout for the chunked pass: (F, N) bins ->
    (num_chunks, F, chunk_rows) uint8. Pad rows hold bin 0; the pass keys
    them to no node, so they add nothing."""
    f, n = bins_t.shape
    chunk = spec.chunk_rows
    if not chunk:
        raise ValueError("prepare_chunked_bins needs a chunked spec")
    m = -(-n // chunk)
    x = torch.zeros((f, m * chunk), dtype=torch.uint8, device=bins_t.device)
    x[:, :n] = bins_t
    return x.reshape(f, m, chunk).permute(1, 0, 2).contiguous()


def stat_rows(grad, hess, count) -> torch.Tensor:
    """(3, N) bf16 stat stack [g; h; c], built once per tree."""
    return torch.stack([grad, hess, count], dim=0).to(torch.bfloat16)


def stat_rows_quant(grad, hess, count, noise) -> Tuple[torch.Tensor, torch.Tensor]:
    """8-bit stochastically rounded stat rows + dequant scales (LightGBM's
    ``use_quantized_grad``): ``x_q = floor(x * 127/max|x| + u)`` clipped to
    [-127, 127], with ``u`` the (2, N) float32 uniforms in ``noise`` (row 0
    for g, row 1 for h; the reference draws them with ``jax.random``).
    Counts are 0/1 and stay exact. Returns ((3, N) int8 [g_q; h_q; c],
    (3,) float32 scales [gs/127, hs/127, 1])."""
    g = grad.to(torch.float32)
    h = hess.to(torch.float32)
    tiny = torch.tensor(1e-30, dtype=torch.float32, device=g.device)
    gs = torch.maximum(g.abs().amax(), tiny)
    hs = torch.maximum(h.abs().amax(), tiny)

    def q(x, s, u):
        return torch.clamp(torch.floor(x * (127.0 / s) + u), -127, 127).to(torch.int8)

    stats = torch.stack([q(g, gs, noise[0]), q(h, hs, noise[1]), count.to(torch.int8)])
    scales = torch.stack([gs / 127.0, hs / 127.0, torch.ones_like(gs)])
    return stats, scales


def histogram_acc_dtype(n_rows: int, quant: bool) -> torch.dtype:
    """Narrowest overflow-free accumulator dtype for ``n_rows``: quantized
    stats are within [-127, 127], so a bin's sum is bounded by 127 * n_rows
    (int16 while that fits, else int32); float32 when not quantized."""
    if not quant:
        return torch.float32
    if 127 * n_rows <= np.iinfo(np.int16).max:
        return torch.int16
    return torch.int32


def dequant_hist(h: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """Apply the deferred per-stat scales to a histogram built with
    ``dequant=False`` (last axis = [g, h, c])."""
    return h.to(torch.float32) * scales


def _stat_panel_t(stats: torch.Tensor, node: torch.Tensor, k: int, n_pad: int) -> torch.Tensor:
    """(3k, n_pad) stat-major panel: row s*k+j carries stat s for rows whose
    node key is j, 0 elsewhere (and on the pad columns)."""
    n = node.shape[0]
    key = torch.arange(k, dtype=torch.int32, device=node.device).repeat(3)[:, None]
    mask = key == node.to(torch.int32)[None, :]
    panel = torch.where(mask, stats.repeat_interleave(k, dim=0),
                        torch.zeros((), dtype=stats.dtype, device=stats.device))
    if n_pad != n:
        panel = torch.nn.functional.pad(panel, (0, n_pad - n))
    return panel


def _expand_packed(packed: torch.Tensor, scales, spec: USpec, k: int,
                   dequant: bool = True) -> torch.Tensor:
    """Dequantize (quant path, ``dequant=True``) and expand the packed
    (K_pad, 3k) result to the dense (k, F, B, 3) histogram. ``dequant=False``
    keeps the integer dtype so the caller can subtract siblings exactly and
    apply the scales once, after subtraction."""
    if scales is not None and dequant:
        packed = (packed.reshape(-1, 3, k).to(torch.float32)
                  * scales[None, :, None]).reshape(-1, 3 * k)
    f, b = spec.num_features, spec.num_bins
    idx, mask = _dense_maps_cached(spec)
    dev = packed.device
    dense = packed[torch.as_tensor(idx.reshape(-1), dtype=torch.long, device=dev)]
    dense = dense.reshape(f, b, 3 * k)
    dense = dense * torch.as_tensor(mask, device=dev).to(dense.dtype)[:, :, None]
    return dense.reshape(f, b, 3, k).permute(3, 0, 1, 2)


def stat_scales(stats: torch.Tensor) -> torch.Tensor:
    """(3,) float64 fixed-point scales of bf16 stat rows: one power of two per
    stat, so the sum of all N rows fits an int64 (``fixed_point_scales``)."""
    return fixed_point_scales(*stats.to(torch.float32))


def _finish(acc: torch.Tensor, scale, n_rows: int, k: int) -> torch.Tensor:
    """The kernel's accumulator as the pass result: quantized int32 sums
    narrowed to :func:`histogram_acc_dtype` (lossless), or int64 fixed-point
    sums turned into float32 (int64 -> float64 -> float32, each rounding to
    nearest)."""
    if scale is None:
        return acc.to(histogram_acc_dtype(n_rows, True))
    cols = scale.repeat_interleave(k)
    return (acc.to(torch.float64) / cols).to(torch.float32)


# -- the contraction: Hopper kernel and plain version ------------------------


@dataclasses.dataclass(frozen=True)
class PanelDotPlan:
    chunk_rows: int  # packed rows of U per block (its shared accumulator)
    grid_x: int  # packed-row chunks
    grid_y: int  # row groups
    rows_per_block: int  # a multiple of TILE_ROWS
    smem_bytes: int


def panel_dot_plan(k_pad: int, n_pad: int, num_nodes: int, quant: bool,
                   num_sms: int) -> PanelDotPlan:
    """Launch layout: each block owns ``chunk_rows`` packed rows, whose
    (chunk_rows, 3k) accumulator and a (3 + 1, TILE_ROWS) panel tile fill
    :data:`SMEM_BUDGET`, and walks a range of row tiles; enough row groups
    for :data:`WAVES` waves of resident blocks."""
    acc_bytes = 4 if quant else 8
    tile = TILE_ROWS * (3 * acc_bytes + 4)
    chunk = max(1, min(k_pad, (SMEM_BUDGET - tile) // (3 * num_nodes * acc_bytes)))
    grid_x = -(-k_pad // chunk)
    tiles = max(1, -(-n_pad // TILE_ROWS))
    target = max(1, WAVES * num_sms * (2048 // THREADS) // grid_x)
    grid_y = max(1, min(tiles, target))
    rows_per_block = -(-tiles // grid_y) * TILE_ROWS
    grid_y = max(1, -(-n_pad // rows_per_block))
    smem = chunk * 3 * num_nodes * acc_bytes + tile
    return PanelDotPlan(chunk, grid_x, grid_y, rows_per_block, smem)


def _exact_contract(u: torch.Tensor, panel_t: torch.Tensor, limbs: int,
                    rows: int = 1 << 16) -> torch.Tensor:
    """(K, P) int64 ``u @ panel_t.T`` for a 0/1 ``u`` (K, N) and an int64
    ``panel_t`` (P, N), exactly: the panel is cut into signed 21-bit limbs,
    each contracted in float64 over row chunks of ``rows`` (every partial sum
    is an integer below 2**53, so any summation order is exact)."""
    k_rows, n = u.shape
    out = torch.zeros((k_rows, panel_t.shape[0]), dtype=torch.int64, device=u.device)
    for r0 in range(0, n, rows):
        uc = u[:, r0 : r0 + rows].to(torch.float64)
        rest = panel_t[:, r0 : r0 + rows]
        for limb in range(limbs):
            part = rest if limb == limbs - 1 else rest & ((1 << 21) - 1)
            rest = rest >> 21
            prod = (uc @ part.to(torch.float64).T).to(torch.int64)
            out += prod << (21 * limb)
    return out


def fused_panel_dot_plain(u, stats, node, num_nodes: int, scale=None, out=None):
    """Plain PyTorch version of :func:`fused_panel_dot`: the reference's
    two-op formulation, the (3k, N_pad) panel (:func:`_stat_panel_t`) then
    one contraction, in the kernel's integer arithmetic."""
    n_pad = u.shape[1]
    if scale is None:
        q = stats.to(torch.int64)
        limbs = 1  # |q| <= 127
    else:
        q = torch.round(stats.to(torch.float64) * scale[:, None]).to(torch.int64)
        limbs = 3  # |q| < 2**62
    acc = _exact_contract(u, _stat_panel_t(q, node, num_nodes, n_pad), limbs)
    acc = acc.to(torch.int32 if scale is None else torch.int64)
    if out is None:
        return acc
    out += acc
    return out


def _check_panel_dot(u, stats, node, num_nodes, scale, out):
    if u.dim() != 2 or u.dtype != torch.uint8 or not u.is_contiguous():
        raise TypeError(f"u must be a contiguous (K_pad, N_pad) uint8 tensor, got "
                        f"{tuple(u.shape)} {u.dtype}")
    k_pad, n_pad = u.shape
    if n_pad % 16:
        raise ValueError(f"U's row length {n_pad} must be a multiple of 16")
    quant = stats.dtype == torch.int8
    if stats.dtype not in (torch.int8, torch.bfloat16) or stats.dim() != 2 or stats.shape[0] != 3:
        raise TypeError(f"stats must be (3, N) int8 or bfloat16, got {tuple(stats.shape)} "
                        f"{stats.dtype}")
    n = stats.shape[1]
    if n > n_pad:
        raise ValueError(f"{n} stat rows for a U of {n_pad} rows")
    if node.shape != (n,) or node.dtype != torch.int32:
        raise TypeError(f"node must be ({n},) int32, got {tuple(node.shape)} {node.dtype}")
    if quant != (scale is None):
        raise ValueError("bf16 stats take (3,) float64 fixed-point scales; int8 stats none")
    if scale is not None and (scale.shape != (3,) or scale.dtype != torch.float64):
        raise TypeError(f"scale must be (3,) float64, got {tuple(scale.shape)} {scale.dtype}")
    if not 1 <= num_nodes <= MAX_NODES:
        raise ValueError(f"num_nodes={num_nodes} outside [1, {MAX_NODES}]")
    acc_dtype = torch.int32 if quant else torch.int64
    if out is not None and (out.shape != (k_pad, 3 * num_nodes) or out.dtype != acc_dtype
                            or not out.is_contiguous()):
        raise TypeError(f"out must be a contiguous ({k_pad}, {3 * num_nodes}) {acc_dtype}")
    for name, t in (("stats", stats), ("node", node), ("scale", scale), ("out", out)):
        if t is None:
            continue
        if t.device != u.device:
            raise ValueError(f"{name} is on {t.device}, u on {u.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if u.is_cuda and u.data_ptr() % 16:
        raise ValueError("u must be 16-byte aligned")
    return quant, acc_dtype


def fused_panel_dot(u, stats, node, num_nodes: int, scale=None, out=None) -> torch.Tensor:
    """The U pass's contraction, ``acc[c, s*k + j] += sum_i U[c, i] *
    q_s[i] * (node_i == j)``: (K_pad, 3k) int32 for int8 ``stats`` (exact
    quantized sums), int64 for bf16 ``stats`` with their (3,) fixed-point
    ``scale`` (``q = round(x * scale)``). Rows keyed outside
    ``[0, num_nodes)`` and U columns past the stats add nothing; U must be
    0/1. Adds into ``out`` when given (the chunked pass accumulates its
    chunks there), else into a fresh zeroed accumulator.

    On a CUDA tensor it launches ``kernels/csrc/u_histogram.cu``; on a CPU
    tensor it computes :func:`fused_panel_dot_plain`."""
    quant, acc_dtype = _check_panel_dot(u, stats, node, num_nodes, scale, out)
    if not u.is_cuda:
        return fused_panel_dot_plain(u, stats, node, num_nodes, scale, out)
    from mmlspark_tpu_torch.kernels.build import histogram_extension

    k_pad, n_pad = u.shape
    if out is None:
        out = torch.zeros((k_pad, 3 * num_nodes), dtype=acc_dtype, device=u.device)
    n = stats.shape[1]
    if n == 0:
        return out
    props = torch.cuda.get_device_properties(u.device)
    plan = panel_dot_plan(k_pad, n_pad, num_nodes, quant, props.multi_processor_count)
    with torch.cuda.device(u.device):
        stream = torch.cuda.current_stream(u.device).cuda_stream
        histogram_extension().u_panel_dot(
            u.data_ptr(), stats.data_ptr(), node.data_ptr(),
            0 if scale is None else scale.data_ptr(), int(quant), n, n_pad, k_pad,
            num_nodes, plan.chunk_rows, plan.grid_x, plan.grid_y, plan.rows_per_block,
            THREADS, plan.smem_bytes, out.data_ptr(), stream,
        )
    fused_panel_dot.launches += 1
    return out


fused_panel_dot.launches = 0


def panel_dot_bytes(k_pad: int, n_pad: int, n: int, num_nodes: int, quant: bool) -> int:
    """Least bytes one pass must move: U once, each row's stats and node
    key, and the accumulator once."""
    stat_bytes = 1 if quant else 2
    return k_pad * n_pad + n * (3 * stat_bytes + 4) + k_pad * 3 * num_nodes * (4 if quant else 8)


# -- histogram passes ---------------------------------------------------------


def _split_stats(stats, grad, hess, count):
    scales = None
    if isinstance(stats, tuple):
        stats, scales = stats
    if stats is None:
        stats = stat_rows(grad, hess, count)
    return stats, scales


def build_histograms_u(
    u: torch.Tensor,  # (K_pad, N_pad) uint8 from build_u
    grad, hess, count,  # (N,); ignored when stats is given
    node: torch.Tensor,  # (N,) int32; out-of-range keys add nothing
    num_nodes: int,
    spec: USpec,
    *,
    stats=None,  # (3, N) bf16 from stat_rows, or (int8 stats, scales)
    dequant: bool = True,
) -> torch.Tensor:
    """(num_nodes, F, B, 3) histogram against the fit-resident U: float32,
    or on the quantized path with ``dequant=False`` the packed integer
    accumulator dtype (:func:`histogram_acc_dtype`) for exact sibling
    subtraction before :func:`dequant_hist`."""
    stats, scales = _split_stats(stats, grad, hess, count)
    if 3 * num_nodes > _LANE:
        raise ValueError(f"panel width 3*{num_nodes} exceeds one lane group")
    scale = None if scales is not None else stat_scales(stats)
    acc = fused_panel_dot(u, stats, node.to(torch.int32).contiguous(), num_nodes, scale)
    packed = _finish(acc, scale, node.shape[0], num_nodes)
    return _expand_packed(packed, scales, spec, num_nodes, dequant=dequant)


def build_histograms_u_chunked(
    bins_chunks: torch.Tensor,  # (m, F, chunk) uint8 from prepare_chunked_bins
    grad, hess, count,
    node: torch.Tensor,
    num_nodes: int,
    spec: USpec,  # chunked (spec.chunk_rows > 0)
    *,
    stats=None,
    dequant: bool = True,
) -> torch.Tensor:
    """Row-chunked :func:`build_histograms_u`, same contract and arithmetic:
    chunk by chunk, the chunk's one-hot is rebuilt from its bins and
    contracted into one accumulator, in chunk order. The fixed-point scales
    come from all N rows, so the result equals the resident pass bit for
    bit."""
    stats, scales = _split_stats(stats, grad, hess, count)
    if 3 * num_nodes > _LANE:
        raise ValueError(f"panel width 3*{num_nodes} exceeds one lane group")
    m, _, chunk = bins_chunks.shape
    n = node.shape[0]
    scale = None if scales is not None else stat_scales(stats)
    total = m * chunk
    node_p = torch.full((total,), -1, dtype=torch.int32, device=node.device)
    node_p[:n] = node
    stats_p = torch.zeros((3, total), dtype=stats.dtype, device=stats.device)
    stats_p[:, :n] = stats
    node_c = node_p.reshape(m, chunk)
    stats_c = stats_p.reshape(3, m, chunk).permute(1, 0, 2).contiguous()  # (m, 3, chunk)
    acc = torch.zeros((spec.k_pad, 3 * num_nodes),
                      dtype=torch.int32 if scale is None else torch.int64, device=node.device)
    u_c = None
    for j in range(m):
        u_c = _onehot(bins_chunks[j], spec, chunk, out=u_c)
        fused_panel_dot(u_c, stats_c[j], node_c[j], num_nodes, scale, out=acc)
    packed = _finish(acc, scale, n, num_nodes)
    return _expand_packed(packed, scales, spec, num_nodes, dequant=dequant)
