"""GBDT training loop on the device: leafwise (LightGBM best-first) and
depthwise growth.

The port's counterpart of ``mmlspark_tpu/lightgbm/train.py``: the gbdt,
``goss``, ``dart`` and ``rf`` boosting types, one tree per margin column
(multiclass), leafwise growth with ``leaf_batch`` frontier leaves per
histogram pass and sibling histogram subtraction, depthwise growth with one
pass per level, numeric and categorical features, Exclusive Feature
Bundling, and the precomputed-U histogram path with quantized gradients and
its out-of-memory ladder. Each iteration:

  gradients (N, C) -> per column: histogram pass(es) on the Hopper kernels
  -> split search over the (node, feature, bin) lattice -> row routing ->
  leaf values -> margins.

GOSS keeps the rows of largest |g| and a draw of the rest (the reference's
``lax.top_k`` and ``jax.random`` draw, bit for bit); DART drops earlier
trees from the margins a new tree fits and rescales both (the reference's
numpy stream); rf fits every tree to the init score and averages them.

Each iteration draws its bag and feature mask on the host from the
reference's numpy stream (:func:`_mask_schedule`); bagged-out rows keep
their routing but add exact zeros to every histogram (g, h and count 0).
After the tree, validation sets are routed through it on the device
(:func:`_route_binned`) and scored on the host (:func:`_evaluate`), which
feeds early stopping and the callbacks.

Histogram passes take one of two paths, by the reference's rule: the
compare-built kernel (``ops/histogram.py``) by default, or the U pass
(``ops/u_histogram.py``) when ``histogram_method="u"``. The reference picks
U by itself only on a TPU backend, so the port never does.

PyTorch runs eagerly, so the reference's ``lax.while_loop`` over passes is a
host loop: each pass reads the frontier's candidate gains to the host once
(one device sync), which decides both whether the loop goes on and which
leaves split. :class:`FitStats` counts those syncs.

Under bundling (a mapper with a :class:`~.bundling.BundleSpec`) the bins
are the packed (N, C) columns: every histogram pass, and the subtraction
cache, lives in the packed space, and :func:`_expand` takes a pass back to
the original (k, F, B, 3) after subtraction and dequantization, so the
split search, the trees and the model text stay in original feature ids.

A depthwise level wider than one histogram launch holds (past 42 nodes)
runs in node groups of ``histogram.cu`` (``ops/hopper_histogram.py``); on
the U path such a level takes the compare-built pass on exact stats, as
the reference's does.

The objectives are binary, multiclass, the regression family (l2, l1,
huber, quantile, poisson, tweedie; l1 and quantile leaves renewed to the
percentile of their residuals, :func:`renew_leaves`) and a per-fit one
handed in (lambdarank, ``ranker.py``).

Not ported yet: meshes, process groups and the other tree learners.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import logging
import math
import time
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from mmlspark_tpu_torch import random as threefry
from mmlspark_tpu_torch.core.profiling import annotate
from mmlspark_tpu_torch.device import DeviceLike, resolve_device
from mmlspark_tpu_torch.lightgbm.binning import BinMapper
from mmlspark_tpu_torch.lightgbm.booster import Booster
from mmlspark_tpu_torch.lightgbm.bundling import cat_row_maps_bundled, expand_maps, route_maps
from mmlspark_tpu_torch.lightgbm.callbacks import CallbackEnv, _has_iteration_hooks, _lr_schedule
from mmlspark_tpu_torch.lightgbm.objectives import (
    METRICS,
    Objective,
    get_objective,
    metric_higher_is_better,
    row_sum,
)
from mmlspark_tpu_torch.ops import histogram
from mmlspark_tpu_torch.ops import hopper_histogram as hh
from mmlspark_tpu_torch.ops import u_histogram as uh
from mmlspark_tpu_torch.observability import events
from mmlspark_tpu_torch.observability.profiler import _signature, get_profiler
from mmlspark_tpu_torch.runtime.faults import current_faults, is_oom_error

_log = logging.getLogger("mmlspark_tpu_torch.lightgbm")

#: Rows above which quantized training falls back to exact stats: int32 sums
#: of 127-level stats wrap past 2**31/127 rows, and float32 counts stop being
#: exact integers past 2**24; the tighter cap holds.
QUANT_ROW_CAP = min((1 << 31) // 127, 1 << 24)
#: Device bytes the sibling-subtraction cache may take; above it the grower
#: builds both children of every split instead.
SUBTRACTION_CACHE_BYTES = 256 << 20
#: Retries of one iteration on the out-of-memory ladder.
OOM_RETRY_CAP = 8
#: The ladder's floor for the U budget.
OOM_MIN_BUDGET = 1 << 20


@dataclasses.dataclass
class TrainOptions:
    """The JAX package's ``TrainOptions``, field for field. Fields of paths
    the port has not taken over must keep their defaults
    (:func:`check_supported`)."""

    objective: str = "binary"
    num_iterations: int = 100
    learning_rate: float = 0.1
    num_leaves: int = 31
    max_depth: int = -1  # -1: unbounded (leafwise) / derived (depthwise)
    max_bin: int = 255
    lambda_l1: float = 0.0
    lambda_l2: float = 0.0
    min_data_in_leaf: int = 20
    min_sum_hessian_in_leaf: float = 1e-3
    min_gain_to_split: float = 0.0
    bagging_fraction: float = 1.0
    pos_bagging_fraction: float = 1.0
    neg_bagging_fraction: float = 1.0
    bagging_freq: int = 0
    feature_fraction: float = 1.0
    max_delta_step: float = 0.0
    num_class: int = 1
    alpha: float = 0.9
    tweedie_variance_power: float = 1.5
    boosting_type: str = "gbdt"
    metric: Optional[str] = None
    early_stopping_round: int = 0
    improvement_tolerance: float = 0.0
    seed: int = 0
    histogram_method: Optional[str] = None
    growth: str = "leafwise"
    tree_learner: str = "data_parallel"
    top_k: int = 20
    top_rate: float = 0.2
    other_rate: float = 0.1
    drop_rate: float = 0.1
    leaf_batch: int = 8  # frontier leaves split per histogram pass (1 = exact best-first)
    use_quantized_grad: bool = False
    histogram_subtraction: bool = True
    leaf_batch_ratio: float = 0.0
    categorical_slots: tuple = ()
    max_cat_threshold: int = 32
    cat_smooth: float = 10.0
    cat_l2: float = 10.0
    max_cat_to_onehot: int = 4
    min_data_per_group: int = 100
    onehot_slots: tuple = ()
    boost_from_average: bool = True
    provide_training_metric: bool = False
    verbosity: int = -1

    @property
    def depth(self) -> int:
        """Static depth of a depthwise tree."""
        if self.max_depth and self.max_depth > 0:
            return self.max_depth
        return max(1, math.ceil(math.log2(max(2, self.num_leaves))))

    @property
    def num_nodes(self) -> int:
        """Node-slot count M of one tree in pointer layout."""
        if self.growth == "depthwise":
            return 2 ** (self.depth + 1) - 1
        return 2 * self.num_leaves - 1

    @property
    def routing_steps(self) -> int:
        """Static bound on tree depth for routing loops."""
        if self.growth == "depthwise":
            return self.depth
        if self.max_depth and self.max_depth > 0:
            return min(self.max_depth, self.num_leaves - 1)
        return self.num_leaves - 1


#: Options whose non-default values select paths the port has not taken over.
_UNPORTED = {
    "tree_learner": "data_parallel",
}
GROWTHS = ("leafwise", "depthwise")
BOOSTING_TYPES = ("gbdt", "rf", "dart", "goss")


def check_supported(opts: TrainOptions, objective: Optional[Objective] = None) -> None:
    """Raise ``NotImplementedError`` for options the port cannot honour, and
    ``ValueError`` for a growth or boosting type no package knows, or an
    objective that is not one of ``objectives.OBJECTIVES`` (binary,
    multiclass, regression, regression_l1, huber, quantile, poisson,
    tweedie and their aliases) unless ``objective`` is given (lambdarank)."""
    if opts.growth not in GROWTHS:
        raise ValueError(f"growth={opts.growth!r} is not one of {GROWTHS}")
    if opts.boosting_type not in BOOSTING_TYPES:
        raise ValueError(f"boosting_type={opts.boosting_type!r} is not one of {BOOSTING_TYPES}")
    for name, default in _UNPORTED.items():
        if getattr(opts, name) != default:
            raise NotImplementedError(
                f"TrainOptions.{name}={getattr(opts, name)!r} is not ported yet "
                f"(only {default!r})"
            )
    if opts.histogram_method not in (None, "pallas", "u"):
        raise NotImplementedError(f"histogram_method={opts.histogram_method!r} is not ported")
    if opts.max_bin + 1 > 256:
        raise NotImplementedError("max_bin > 255 is not ported (bins are uint8)")
    if objective is None:
        get_objective(opts.objective)


@dataclasses.dataclass
class FitStats:
    """What one fit did, counted on the host: trees, histogram passes, the
    host syncs the grower paid (one per pass that splits or stops growth,
    plus the final fetch), wall seconds of boosting
    (device upload to the packed booster, less the U build), of building U
    and of the host binning before it, where the caller binned; and which
    histogram path ran ("compare", "u" or "u_chunked", with its chunk count)
    and whether its stats were quantized; the out-of-memory retries the
    ladder took and the U budget in force at the end (0: no U path).
    ``level_launches[d]``: under depthwise growth, the histogram kernel
    launches of level d over the fit (every tree, every class): more than
    one a pass where the level runs in node groups; 0 on the CPU, where no
    kernel launches. ``dart_drops[i]``: under dart, the earlier iterations
    dropped at iteration i. ``renewal_seconds``: the percentile leaf
    renewal of l1 and quantile fits (inside ``boost_seconds``), each
    iteration's closed by a device sync. ``upload_seconds``: the bins'
    upload (inside ``boost_seconds``), closed by a device sync.

    ``per_iteration`` holds, for each iteration run, the host seconds of
    its bag and feature-mask draw, their upload, the boosting step, the
    validation sets' margin update and the evaluation (the training metric
    included), each closed by a device sync. ``boost_seconds`` leaves out
    all but the step's."""

    trees: int = 0
    passes: int = 0
    syncs: int = 0
    boost_seconds: float = 0.0
    binning_seconds: float = 0.0
    u_build_seconds: float = 0.0
    histogram_path: str = "compare"
    u_chunks: int = 0
    quantized: bool = False
    oom_retries: int = 0
    u_budget: int = 0
    per_iteration: List[Dict[str, float]] = dataclasses.field(default_factory=list)
    level_launches: List[int] = dataclasses.field(default_factory=list)
    dart_drops: List[List[int]] = dataclasses.field(default_factory=list)
    renewal_seconds: float = 0.0
    upload_seconds: float = 0.0


@dataclasses.dataclass
class TrainResult:
    """The booster, what the fit did, the metric history (set name ->
    metric -> one score per iteration run) and the best iteration (1-based;
    0 when no evaluation improved)."""

    booster: Booster
    stats: FitStats
    evals: Dict[str, Dict[str, List[float]]] = dataclasses.field(default_factory=dict)
    best_iteration: int = 0


class TreeArrays(NamedTuple):
    """One tree in pointer layout (each (M,) on the device); an iteration's
    trees stacked per margin column ((C, M), row_leaf (C, N))."""

    feat: torch.Tensor
    bin: torch.Tensor
    thr: torch.Tensor
    left: torch.Tensor
    right: torch.Tensor
    is_leaf: torch.Tensor
    leaf_val: torch.Tensor
    cover: torch.Tensor
    gain: torch.Tensor
    row_leaf: torch.Tensor  # (N,) final leaf slot of every training row
    cat_node: torch.Tensor  # (M,) bool: categorical split at this node
    cat_mask: torch.Tensor  # (M, B) bool left-set bins ((M, 1) when no categoricals)


class SplitSearch(NamedTuple):
    """Per-node best-split candidates from one histogram batch (each (k,))."""

    value: torch.Tensor  # own leaf value (lr-scaled)
    cover: torch.Tensor  # row count
    hess: torch.Tensor  # hessian sum
    gain: torch.Tensor  # best gain, -inf if unsplittable
    feat: torch.Tensor
    bin: torch.Tensor
    thr: torch.Tensor  # raw-value threshold
    lval: torch.Tensor  # left child value if split (lr-scaled)
    rval: torch.Tensor
    lcov: torch.Tensor
    rcov: torch.Tensor
    is_cat: torch.Tensor  # (k,) bool: categorical split (bin = the prefix-defining bin)
    cat_mask: torch.Tensor  # (k, B) bool: bins of the LEFT set (all False if numeric)
    value_cat: torch.Tensor  # (k,) own leaf value under l2 + cat_l2


_NO_REGION = contextlib.nullcontext()


def _region(on: bool, name: str):
    """A named region of the boosting step (``core.profiling.annotate``)
    while the device profiler is active, else a reusable no-op: a quiet fit
    pays one branch per site."""
    return annotate(name) if on else _NO_REGION


def _soft_threshold(g: torch.Tensor, l1: float) -> torch.Tensor:
    if l1 == 0.0:
        return g
    return torch.sign(g) * torch.clamp(g.abs() - l1, min=0.0)


def _prefix_lanes(num_bins: int) -> int:
    """Lanes of the reference's triangular-matmul prefix on XLA's CPU
    backend at ``num_bins`` bins (measured at every width from 2 to 256,
    and at every (k, F) tried): 1 is bin order; 2 and 4 are that many
    interleaved float32 chains (see :func:`_lane_prefix`). The widths
    repeat with period 64 past 32; 17-32 takes 2 lanes but for 19, 20, 23
    and 24."""
    r = (num_bins - 1) % 64 + 1
    if r <= 16 or r > 32 and r <= 48 or num_bins in (19, 20, 23, 24):
        return 4
    return 2 if r <= 32 else 1


def _lane_prefix(h: np.ndarray, lanes: int) -> np.ndarray:
    """Inclusive prefix over axis 2 of float32 ``h`` in XLA's CPU dot
    order: over the first ``q = B - B % lanes`` bins, lane ``r`` adds bins
    ``r, r + lanes, ...`` in order; the lanes are added pairwise ((0+1),
    then ((0+1)+(2+3))); the last ``B % lanes`` bins are added in order
    among themselves and their sum to that."""
    k, f, b, s = h.shape
    if lanes == 1:
        return np.cumsum(h, axis=2, dtype=np.float32)
    q = b - b % lanes
    last = np.minimum(np.arange(b), q - 1)
    parts = []
    for r in range(lanes):
        chain = np.cumsum(h[:, :, r:q:lanes], axis=2, dtype=np.float32)
        chain = np.concatenate([np.zeros((k, f, 1, s), np.float32), chain], axis=2)
        taken = np.where(last >= r, (last - r) // lanes + 1, 0)
        parts.append(chain[:, :, taken])
    while len(parts) > 1:
        parts = [parts[i] + parts[i + 1] for i in range(0, len(parts), 2)]
    out = parts[0]
    if q < b:
        out[:, :, q:] += np.cumsum(h[:, :, q:], axis=2, dtype=np.float32)
    return out


def _chain_prefix(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Inclusive float32 prefix sums over ``dim`` as one chain in index
    order, the same bits on both devices: numpy's float32 ``cumsum`` on the
    CPU (``torch.cumsum`` there accumulates in float64) and ``torch.cumsum``
    on the card, which over a dimension that is not the innermost runs one
    sequential float32 loop per column (``chip_smoke.py`` checks it)."""
    if x.device.type == "cpu":
        return torch.from_numpy(np.cumsum(x.numpy(), axis=dim, dtype=np.float32))
    return torch.cumsum(x, dim=dim)


def _bin_sum(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Sum over the bin axis ``dim``: exact on integer (quantized) sums,
    else the last of :func:`_chain_prefix`, so the default path's node
    totals and bundle residuals do not depend on the device's reduction
    order."""
    if not x.is_floating_point():
        return x.sum(dim=dim)
    return _chain_prefix(x, dim).select(dim, -1)


def _bin_prefix(hist: torch.Tensor, in_bin_order: bool) -> torch.Tensor:
    """Left stats at "<= bin": inclusive prefix sums over the bin axis (dim
    2 of (k, F, B, 3)), in float32 on both devices. ``in_bin_order``:
    float32 sums in the order of the reference's HIGHEST-precision
    triangular matmul on the CPU: bin order at 49-64 bins and 113-128,
    241-256, interleaved lanes at other widths (:func:`_prefix_lanes`). The
    quantized path asks for it: its histograms are the reference's bit for
    bit, and so then are its gains. Otherwise one chain in bin order
    (:func:`_chain_prefix`), which the card computes too."""
    if in_bin_order and hist.device.type == "cpu":
        lanes = _prefix_lanes(hist.shape[2])
        return torch.from_numpy(_lane_prefix(hist.numpy(), lanes))
    return _chain_prefix(hist, 2)


@functools.lru_cache(maxsize=64)
def _cat_static_maps(cat_slots: tuple, onehot_slots: tuple, num_features: int,
                     device: torch.device):
    """Index maps of the categorical split search, on ``device`` once per
    fit: sorted categorical feature indices, the is-categorical mask, the
    feature -> categorical position map, and the one-vs-rest mask."""
    cat_idx = np.asarray(sorted(cat_slots), np.int64)
    is_cat = np.zeros(num_features, bool)
    is_cat[cat_idx] = True
    inv = np.zeros(num_features, np.int64)
    inv[cat_idx] = np.arange(len(cat_idx))
    onehot = np.isin(cat_idx, np.asarray(onehot_slots, np.int64))
    return tuple(torch.as_tensor(a, device=device) for a in (cat_idx, is_cat, inv, onehot))


def _split_search(
    hist: torch.Tensor,  # (k, F, B, 3)
    totals: torch.Tensor,  # (k, 3) per-node [sum_g, sum_h, count]
    edges: torch.Tensor,  # (F, E)
    feature_mask: torch.Tensor,  # (F,)
    opts: TrainOptions,
    lr: Optional[float] = None,  # this iteration's learning rate (callbacks)
    in_bin_order: bool = False,  # prefix sums in bin order (quantized stats)
    quant_totals: Optional[tuple] = None,  # (integer totals (k, 3), scales (3,))
) -> SplitSearch:
    """Best split per node from its histogram: numeric thresholds, and on
    categorical features LightGBM's sorted-set search (both directions) or,
    up to ``max_cat_to_onehot`` seen categories, one-vs-rest.

    ``quant_totals``: the quantized pass's integer totals and scales behind
    ``totals``. The right child's value then takes ``total * scale - left``
    in one rounding: XLA contracts the reference's dequantizing multiply
    into that subtraction (a fused multiply-subtract) where the product has
    no other use, as in the child values the depthwise grower reads below
    ``max_depth`` 1."""
    k, f, b, _ = hist.shape
    dev = hist.device
    l1, l2 = opts.lambda_l1, opts.lambda_l2
    lr = opts.learning_rate if lr is None else lr
    g_tot, h_tot, c_tot = totals[:, 0], totals[:, 1], totals[:, 2]

    cum = _bin_prefix(hist, in_bin_order)
    gl, hl, cl = cum[..., 0], cum[..., 1], cum[..., 2]
    gr = g_tot[:, None, None] - gl
    hr = h_tot[:, None, None] - hl
    cr = c_tot[:, None, None] - cl

    tl, tr = _soft_threshold(gl, l1), _soft_threshold(gr, l1)
    tg = _soft_threshold(g_tot, l1)
    parent_score = (tg * tg) / (h_tot + l2)
    gain = tl * tl / (hl + l2) + tr * tr / (hr + l2) - parent_score[:, None, None]

    bins_ok = torch.arange(b, device=dev)[None, None, :] < b - 1
    valid = (
        (cl >= opts.min_data_in_leaf)
        & (cr >= opts.min_data_in_leaf)
        & (hl >= opts.min_sum_hessian_in_leaf)
        & (hr >= opts.min_sum_hessian_in_leaf)
        & bins_ok
        & (feature_mask[None, :, None] > 0)
    )
    gain = torch.where(valid, gain, torch.full_like(gain, -math.inf))

    has_cat = bool(opts.categorical_slots)
    if has_cat:
        # LightGBM's sorted-prefix search without a sort: the prefix of the
        # g/h-ratio order that ends at category i is {j : key_j <= key_i},
        # ties broken by bin index (a stable sort's order), so each
        # candidate's left sums are one masked prefix against the order
        # indicator M, candidate index = the prefix-defining bin, and the
        # winner's left set is M's row. Axis d: 0 ascending ratio, 1
        # descending. Bin 0 (unseen/NaN) never enters a left set.
        cat_idx, is_cat_f, inv, oh_mask = _cat_static_maps(
            tuple(opts.categorical_slots), tuple(opts.onehot_slots), f, dev)
        hist_c = hist[:, cat_idx]  # (k, Fc, B, 3)
        gsum, hsum, cnt = hist_c[..., 0], hist_c[..., 1], hist_c[..., 2]
        jpos = torch.arange(b, device=dev)[None, None, :]
        # min_data_per_group gates the sorted candidates only (one-vs-rest
        # is exempt, as in native LightGBM)
        nonempty = (cnt >= max(1, opts.min_data_per_group)) & (jpos > 0)
        ratio = gsum / (hsum + opts.cat_smooth)
        l2c = l2 + opts.cat_l2
        parent_c = (tg * tg) / (h_tot + l2c)
        fm_c = feature_mask[cat_idx]
        keys = torch.stack([ratio, -ratio])  # (2, k, Fc, B)
        ki = keys[..., :, None]  # candidate i
        kj = keys[..., None, :]  # member j
        ar = torch.arange(b, device=dev)
        tie = ar[None, :] <= ar[:, None]  # [i, j]: j <= i
        M = ((kj < ki) | ((kj == ki) & tie)) & nonempty[None, :, :, None, :]
        Mf = M.to(torch.float32)

        def prefix(stat):
            """(k, Fc, B) member sums -> (2, k, Fc, B) per candidate, in
            float32 (TF32 must stay off on the card: ``chip_smoke.py``)."""
            return torch.einsum("dkfij,kfj->dkfi", Mf, stat)

        sg, sh, sc = prefix(gsum), prefix(hsum), prefix(cnt)
        sizes = prefix(nonempty.to(torch.float32))
        grc = g_tot[None, :, None, None] - sg
        hrc = h_tot[None, :, None, None] - sh
        crc = c_tot[None, :, None, None] - sc
        tlc, trc = _soft_threshold(sg, l1), _soft_threshold(grc, l1)
        gain_c = (tlc * tlc / (sh + l2c) + trc * trc / (hrc + l2c)
                  - parent_c[None, :, None, None])
        valid_c = (
            nonempty[None]  # the prefix-defining category itself qualifies
            & (sizes <= opts.max_cat_threshold)
            & (sc >= opts.min_data_in_leaf)
            & (crc >= opts.min_data_in_leaf)
            & (sh >= opts.min_sum_hessian_in_leaf)
            & (hrc >= opts.min_sum_hessian_in_leaf)
            & (fm_c[None, None, :, None] > 0)
        )
        gain_dirs = torch.where(valid_c, gain_c, torch.full_like(gain_c, -math.inf))
        gain_cat = torch.maximum(gain_dirs[0], gain_dirs[1])
        use_desc = gain_dirs[1] > gain_dirs[0]  # (k, Fc, B)

        # One-vs-rest for low-cardinality features: the candidates are the
        # single-category left sets {bin j}; no cat_smooth, no
        # min_data_per_group.
        has_oh = bool(set(opts.onehot_slots) & set(opts.categorical_slots))
        if has_oh:
            gr_oh = g_tot[:, None, None] - gsum
            hr_oh = h_tot[:, None, None] - hsum
            cr_oh = c_tot[:, None, None] - cnt
            tl_oh, tr_oh = _soft_threshold(gsum, l1), _soft_threshold(gr_oh, l1)
            gain_oh = (tl_oh * tl_oh / (hsum + l2c) + tr_oh * tr_oh / (hr_oh + l2c)
                       - parent_c[:, None, None])
            valid_oh = (
                (jpos > 0)
                & (cnt >= opts.min_data_in_leaf)
                & (cr_oh >= opts.min_data_in_leaf)
                & (hsum >= opts.min_sum_hessian_in_leaf)
                & (hr_oh >= opts.min_sum_hessian_in_leaf)
                & (fm_c[None, :, None] > 0)
            )
            gain_oh = torch.where(valid_oh, gain_oh, torch.full_like(gain_oh, -math.inf))
            gain_cat = torch.where(oh_mask[None, :, None], gain_oh, gain_cat)
        gain = gain.clone()
        gain[:, cat_idx] = gain_cat

    flat = gain.reshape(k, f * b)
    best_idx = torch.argmax(flat, dim=1)  # first maximum, as jnp.argmax
    best_gain = flat.gather(1, best_idx[:, None])[:, 0]
    best_f = best_idx // b
    best_b = best_idx % b

    def finish(v):
        if opts.max_delta_step > 0:
            v = torch.clamp(v, -opts.max_delta_step, opts.max_delta_step)
        return v * lr

    def leaf_value(g, h):
        return finish(-_soft_threshold(g, l1) / (h + l2))

    iota = torch.arange(k, device=dev)
    glb = gl[iota, best_f, best_b]
    hlb = hl[iota, best_f, best_b]
    clb = cl[iota, best_f, best_b]

    def right_of(g_left, h_left):
        if quant_totals is None:
            return g_tot - g_left, h_tot - h_left
        tq, scales = quant_totals
        fused = tq[:, :2].double() * scales[:2].double() - torch.stack([g_left, h_left], 1).double()
        return fused[:, 0].float(), fused[:, 1].float()

    # Raw threshold: split bin t means "x <= edges[f, t-1]"; t=0 => NaN-only left.
    thr_raw = edges[best_f, torch.clamp(best_b - 1, min=0)]
    thr_raw = torch.where(best_b == 0, torch.full_like(thr_raw, -math.inf), thr_raw)

    if has_cat:
        # Leaves made by a categorical split take l2 + cat_l2 outputs
        # (native LightGBM's categorical CalculateSplittedLeafOutput).
        def leaf_value_cat(g, h):
            return finish(-_soft_threshold(g, l1) / (h + l2 + opts.cat_l2))

        is_cat_best = is_cat_f[best_f]
        cpos = inv[best_f]
        dsel = use_desc[iota, cpos, best_b].long()
        glb_c = sg[dsel, iota, cpos, best_b]
        hlb_c = sh[dsel, iota, cpos, best_b]
        clb_c = sc[dsel, iota, cpos, best_b]
        if has_oh:
            # one-vs-rest winners read their left stats straight from the bin
            is_oh_best = oh_mask[cpos] & is_cat_best
            glb_c = torch.where(is_oh_best, gsum[iota, cpos, best_b], glb_c)
            hlb_c = torch.where(is_oh_best, hsum[iota, cpos, best_b], hlb_c)
            clb_c = torch.where(is_oh_best, cnt[iota, cpos, best_b], clb_c)
        glb = torch.where(is_cat_best, glb_c, glb)
        hlb = torch.where(is_cat_best, hlb_c, hlb)
        clb = torch.where(is_cat_best, clb_c, clb)
        thr_raw = torch.where(is_cat_best, torch.full_like(thr_raw, math.inf), thr_raw)
        cat_mask = M[dsel, iota, cpos, best_b, :] & is_cat_best[:, None]
        if has_oh:
            cat_mask = torch.where(is_oh_best[:, None], ar[None, :] == best_b[:, None], cat_mask)
        lval = torch.where(is_cat_best, leaf_value_cat(glb, hlb), leaf_value(glb, hlb))
        g_right, h_right = right_of(glb, hlb)
        rval = torch.where(is_cat_best, leaf_value_cat(g_right, h_right),
                           leaf_value(g_right, h_right))
        value_cat = leaf_value_cat(g_tot, h_tot)
    else:
        is_cat_best = torch.zeros(k, dtype=torch.bool, device=dev)
        cat_mask = torch.zeros((k, b), dtype=torch.bool, device=dev)
        lval = leaf_value(glb, hlb)
        rval = leaf_value(*right_of(glb, hlb))
        value_cat = leaf_value(g_tot, h_tot)

    return SplitSearch(
        value=leaf_value(g_tot, h_tot),
        cover=c_tot,
        hess=h_tot,
        gain=best_gain,
        feat=best_f,
        bin=best_b,
        thr=thr_raw,
        lval=lval,
        rval=rval,
        lcov=clb,
        rcov=c_tot - clb,
        is_cat=is_cat_best,
        cat_mask=cat_mask,
        value_cat=value_cat,
    )


@functools.lru_cache(maxsize=32)
def _bundle_route_consts(bundle, device: torch.device):
    """Device copies of the per-original-feature routing arrays of
    ``bundling.route_maps``: (col, lo, span, skip, dflt), each (F,) int64."""
    return tuple(torch.as_tensor(a, dtype=torch.int64, device=device)
                 for a in route_maps(bundle))


def _orig_bins(packed_cols, feats, consts):
    """Packed column values -> original-feature bin ids. ``packed_cols``
    holds each row's value of the packed column of feature ``feats`` (same
    shape); q = x - lo recovers the member-local offset, the +1 step crosses
    the member's elided default bin, and a value out of the member's span
    means another member was non-default, so this feature sat at its
    default bin."""
    _, lo, span, skip, dflt = consts
    xb = packed_cols.to(torch.int64)
    q = xb - lo[feats]
    inb = (q >= 0) & (q < span[feats])
    return torch.where(inb, q + (q >= skip[feats]).to(torch.int64), dflt[feats])


@functools.lru_cache(maxsize=32)
def _expand_consts(bundle, num_bins: int, device: torch.device):
    cidx, gmask, dmask = expand_maps(bundle, num_bins)
    return (torch.as_tensor(cidx.reshape(-1), dtype=torch.int64, device=device),
            torch.as_tensor(gmask, device=device), torch.as_tensor(dmask, device=device))


def _expand_bundled(h, totals, bundle, num_bins: int):
    """Packed-space histogram (k, C, B_b, 3) -> original space (k, F, B, 3):
    each feature's non-default bins gather from its packed column, and a
    bundled member's default bin is the node totals less its other bins.
    On integer (quantized) sums the subtraction is exact, so the result is
    the unbundled histogram bit for bit (returned as int64); on float32 sums
    counts are exact and g and h within float32 rounding of a direct build."""
    cidx, gmask, dmask = _expand_consts(bundle, num_bins, h.device)
    k = h.shape[0]
    dense = h.reshape(k, -1, 3)[:, cidx].reshape(k, bundle.num_features, num_bins, 3)
    dense = dense * gmask.to(h.dtype)[None, :, :, None]
    resid = totals[:, None, :] - _bin_sum(dense, 2)
    return dense + dmask.to(resid.dtype)[None, :, :, None] * resid[:, :, None, :]


def _packed_pass(bins_t, u, u_spec, grad, hess, count, key, num_nodes, num_bins, tree_stats):
    """One histogram pass and its per-node totals (column 0 covers every
    row of a node), before dequantization and bundle expansion: the
    representation the sibling cache keeps. ``num_bins`` is the packed
    width under bundling. float32 on the compare-built and bf16 U paths; on
    the quantized U path the narrow integer accumulator, so that parent -
    child is exact. The U path takes a pass whose stat panel fits one lane
    group (3 * num_nodes <= 128); a wider one (a deep depthwise level)
    takes the compare-built pass on the exact stats, as the reference's
    ``_hist_fn`` does."""
    if u is None or 3 * num_nodes > 128:
        h = histogram.build_histograms(bins_t, grad, hess, count, key, num_nodes, num_bins)
    elif u_spec.chunk_rows:
        h = uh.build_histograms_u_chunked(u, grad, hess, count, key, num_nodes, u_spec,
                                          stats=tree_stats, dequant=False)
    else:
        h = uh.build_histograms_u(u, grad, hess, count, key, num_nodes, u_spec,
                                  stats=tree_stats, dequant=False)
    return h, _bin_sum(h[:, 0], 1)


def _expand(h, totals, tree_stats, bundle=None, num_bins: int = 0):
    """A packed pass ready for the split search: under bundling the packed
    columns expanded to the original features' ``num_bins`` bins, then the
    quantized path's scales applied once, after any subtraction. The
    reference applies the scales before the expansion; expanding the
    integers first makes a member's default bin exact, so a quantized fit
    with conflict-free bundles writes the unbundled fit's model text."""
    if bundle is not None:
        h = _expand_bundled(h, totals, bundle, num_bins)
    if not h.is_floating_point():
        scales = tree_stats[1]
        h, totals = uh.dequant_hist(h, scales), uh.dequant_hist(totals, scales)
    return h, totals


def _tree_stats(grad, hess, count, noise=None):
    """The U pass's (3, N) stat rows, built once per tree: quantized with
    ``noise`` (int8 rows and their scales), else bf16."""
    if noise is not None:
        return uh.stat_rows_quant(grad, hess, count, noise)
    return uh.stat_rows(grad, hess, count)


def _build_tree_leafwise(
    bins_t: torch.Tensor,  # (C, N) uint8: F original or C packed columns
    grad: torch.Tensor,  # (N,)
    hess: torch.Tensor,
    count: torch.Tensor,
    edges: torch.Tensor,  # (F, E)
    feature_mask: torch.Tensor,  # (F,)
    *,
    num_bins: int,
    opts: TrainOptions,
    stats: FitStats,
    u: Optional[torch.Tensor] = None,  # U (resident) or the chunked bins layout
    u_spec: Optional[uh.USpec] = None,
    noise: Optional[torch.Tensor] = None,  # (2, N) uniforms: quantized stats
    bundle=None,
    cat_u: Optional[tuple] = None,  # categorical rows of U and their maps
    lr: Optional[float] = None,
    regions: bool = False,  # profiler regions (:func:`_region`)
) -> TreeArrays:
    """Best-first growth, ``leaf_batch`` frontier leaves per histogram pass,
    with the reference's semantics: the top-k frontier leaves by cached gain
    (descending, ties by lower slot) split together; the j-th split overall
    creates slots 2j+1 and 2j+2. With sibling subtraction only the smaller
    child of each split is histogrammed (key = lane for its rows, ``2k``
    elsewhere) and the sibling is the parent's cached histogram minus it;
    the cache is gated on its size, as the reference's is, and without it
    both children are keyed (``2*lane + went_right``) in one pass of 2k
    nodes, so k is capped at 21 instead of 42.

    Under bundling ``bins_t`` holds the packed columns; the cache and the
    subtraction live in the packed space, while the search and the tree
    are in original features (``f`` below), and routing decodes a row's
    packed value to the split feature's bin before every compare. A
    categorical split sends a row left iff its bin is in the split's set:
    on the resident U path from one membership product against U's
    categorical rows (``cat_u``), elsewhere from a gather of the set."""
    c_cols, n = bins_t.shape
    dev = bins_t.device
    f = bundle.num_features if bundle is not None else c_cols
    rconsts = _bundle_route_consts(bundle, dev) if bundle is not None else None
    b = num_bins
    b_pack = bundle.num_bins if bundle is not None else b
    num_leaves = opts.num_leaves
    m = 2 * num_leaves - 1
    max_depth = opts.max_depth if (opts.max_depth and opts.max_depth > 0) else m
    use_sub = _subtraction_cache_bytes(
        opts, c_cols, b_pack, uh.histogram_acc_dtype(n, u is not None and noise is not None)
    ) is not None
    k = max(1, min(opts.leaf_batch, num_leaves - 1, 42 if use_sub else 21))
    tree_stats = _tree_stats(grad, hess, count, noise) if u is not None else None
    quant = noise is not None
    has_cat = bool(opts.categorical_slots)

    def packed(key, num_nodes):
        stats.passes += 1
        with _region(regions, "gbdt.histogram"):
            return _packed_pass(bins_t, u, u_spec, grad, hess, count, key, num_nodes, b_pack,
                                tree_stats)

    def expand(h, totals):
        with _region(regions, "gbdt.histogram"):
            return _expand(h, totals, tree_stats, bundle, b)

    def searchk(histk, totalsk, depthk):
        """Candidate searches for fresh children: depth-capped, NaN gains
        set to -inf so they can neither halt growth nor win."""
        with _region(regions, "gbdt.split_search"):
            s = _split_search(histk, totalsk, edges, feature_mask, opts, lr, quant)
            capped = torch.where(depthk >= max_depth, torch.full_like(s.gain, -math.inf), s.gain)
            capped = torch.where(torch.isnan(capped), torch.full_like(capped, -math.inf), capped)
            return s._replace(gain=capped)

    root_p, root_tp = packed(torch.zeros(n, dtype=torch.int32, device=dev), 1)
    root_hist, root_tot = expand(root_p, root_tp)
    with _region(regions, "gbdt.split_search"):
        root = _split_search(root_hist, root_tot, edges, feature_mask, opts, lr, quant)

    zi = torch.zeros(m, dtype=torch.int64, device=dev)
    zf = torch.zeros(m, dtype=torch.float32, device=dev)
    st = dict(
        node=torch.zeros(n, dtype=torch.int32, device=dev),
        feat=zi.clone(),
        bin=torch.full((m,), b, dtype=torch.int64, device=dev),
        thr=torch.full((m,), math.inf, dtype=torch.float32, device=dev),
        left=zi.clone(),
        right=zi.clone(),
        is_leaf=torch.zeros(m, dtype=torch.bool, device=dev),
        leaf_val=zf.clone(),
        cover=zf.clone(),
        gain=zf.clone(),
        depth=zi.clone(),
        c_gain=torch.full((m,), -math.inf, dtype=torch.float32, device=dev),
        c_feat=zi.clone(),
        c_bin=zi.clone(),
        c_thr=zf.clone(),
    )
    st["is_leaf"][0] = True
    st["leaf_val"][0] = root.value[0]
    st["cover"][0] = root.cover[0]
    st["c_gain"][0] = torch.nan_to_num(root.gain[0], nan=-math.inf, posinf=math.inf,
                                       neginf=-math.inf)
    st["c_feat"][0] = root.feat[0]
    st["c_bin"][0] = root.bin[0]
    st["c_thr"][0] = root.thr[0]
    if has_cat:
        st["cat_node"] = torch.zeros(m, dtype=torch.bool, device=dev)
        st["cat_mask"] = torch.zeros((m, b), dtype=torch.bool, device=dev)
        st["c_iscat"] = torch.zeros(m, dtype=torch.bool, device=dev)
        st["c_catmask"] = torch.zeros((m, b), dtype=torch.bool, device=dev)
        st["c_iscat"][0] = root.is_cat[0]
        st["c_catmask"][0] = root.cat_mask[0]
    if use_sub:
        # Packed-space cache, in the pass's accumulator dtype: subtraction
        # happens before dequantization and bundle expansion.
        st["c_subR"] = torch.zeros(m, dtype=torch.bool, device=dev)
        st["c_subR"][0] = root.rcov[0] < root.lcov[0]
        st["leaf_hist"] = torch.zeros((m, c_cols, b_pack, 3), dtype=root_p.dtype, device=dev)
        st["leaf_tot"] = torch.zeros((m, 3), dtype=root_tp.dtype, device=dev)
        st["leaf_hist"][0] = root_p[0]
        st["leaf_tot"][0] = root_tp[0]

    rows = torch.arange(n, device=dev)
    # slot -> lane of the pass (-1: row's leaf does not split this pass)
    lane_of = torch.full((m,), -1, dtype=torch.int64, device=dev)
    n_splits = 0
    while n_splits < num_leaves - 1:
        # The pass's one sync: the frontier's cached gains, ordered
        # descending with ties by lower slot (stable sort), as lax.top_k.
        with _region(regions, "gbdt.sync"):
            c_gain = st["c_gain"].cpu().numpy()
        stats.syncs += 1
        order = np.argsort(-c_gain, kind="stable")[:k]
        top_g = c_gain[order]
        if not top_g[0] > opts.min_gain_to_split:
            break
        j = np.arange(k)
        can = (top_g > opts.min_gain_to_split) & (n_splits + j < num_leaves - 1)
        if opts.leaf_batch_ratio > 0.0:
            can &= (j == 0) | (top_g >= opts.leaf_batch_ratio * top_g[0])
        ka = int(np.argmin(can)) if not can.all() else k  # `can` is monotone in j
        with _region(regions, "gbdt.routing"):
            top_l = torch.as_tensor(order[:ka], dtype=torch.int64, device=dev)
            lslot = torch.as_tensor(2 * (n_splits + np.arange(ka)) + 1, dtype=torch.int64,
                                    device=dev)
            rslot = lslot + 1
            lanes = torch.arange(ka, dtype=torch.int64, device=dev)

            sf, sb, sthr = st["c_feat"][top_l], st["c_bin"][top_l], st["c_thr"][top_l]

            # Route the splitting leaves' rows and key the pass: one lookup from
            # a row's slot to its lane replaces the reference's unrolled per-lane
            # sweep (leaves are distinct, so a row has at most one lane).
            lane_of[top_l] = lanes
            node = st["node"]
            lane = lane_of[node.long()]
            lane_of[top_l] = -1
            active = lane >= 0
            lc = lane.clamp(min=0)
            feat_r = sf[lc]  # each row's split feature (original id)
            if rconsts is not None:
                col = _orig_bins(bins_t[rconsts[0][feat_r], rows], feat_r, rconsts)
            else:
                col = bins_t[feat_r, rows].long()
            right = col > sb[lc]
            if has_cat:
                sic = st["c_iscat"][top_l]
                scm = st["c_catmask"][top_l]  # (ka, B)
                if cat_u is not None:
                    u_rows, feat_of_row, local_of_row = cat_u
                    in_set = uh.membership_matmul(u_rows, feat_of_row, local_of_row, sf, scm, n)
                    left_cat = in_set[lc, rows]
                else:
                    left_cat = scm[lc, col]
                right = torch.where(sic[lc], ~left_cat, right)
            new_node = torch.where(
                active, torch.where(right, rslot[lc], lslot[lc]), node.long()
            ).to(torch.int32)
            out_of_range = torch.full_like(lane, 2 * k)

        if use_sub:
            small_r = st["c_subR"][top_l]  # (ka,) smaller child is RIGHT
            key = torch.where(active & (right == small_r[lc]), lane, out_of_range)
            hist_s, tot_s = packed(key.to(torch.int32), ka)
            with _region(regions, "gbdt.subtraction"):
                hist_o = st["leaf_hist"][top_l] - hist_s
                tot_o = st["leaf_tot"][top_l] - tot_s
                sel = small_r[:, None, None, None]
                hist_lr = torch.cat([torch.where(sel, hist_o, hist_s),
                                     torch.where(sel, hist_s, hist_o)])
                tot_lr = torch.cat([torch.where(small_r[:, None], tot_o, tot_s),
                                    torch.where(small_r[:, None], tot_s, tot_o)])
            hist_x, tot_x = expand(hist_lr, tot_lr)
        else:
            key = torch.where(active, 2 * lane + right.long(), out_of_range)
            h2, t2 = expand(*packed(key.to(torch.int32), 2 * ka))
            h2 = h2.reshape(ka, 2, f, b, 3)
            t2 = t2.reshape(ka, 2, 3)
            hist_x = torch.cat([h2[:, 0], h2[:, 1]])
            tot_x = torch.cat([t2[:, 0], t2[:, 1]])

        child_depth = st["depth"][top_l] + 1
        cs = searchk(hist_x, tot_x, torch.cat([child_depth, child_depth]))
        # (2ka,) fields: [left children | right children]

        with _region(regions, "gbdt.tree_update"):
            both = torch.cat([lslot, rslot])
            if use_sub:
                st["leaf_hist"][both] = hist_lr
                st["leaf_tot"][both] = tot_lr
                st["c_subR"][both] = cs.rcov < cs.lcov
            # A leaf's value comes from the split that made it: children of a
            # categorical split take the l2 + cat_l2 output.
            values = cs.value
            if has_cat:
                values = torch.where(torch.cat([sic, sic]), cs.value_cat, cs.value)
            st["node"] = new_node
            st["feat"][top_l] = sf
            st["bin"][top_l] = sb
            st["thr"][top_l] = sthr
            st["left"][top_l] = lslot
            st["right"][top_l] = rslot
            st["is_leaf"][top_l] = False
            st["is_leaf"][both] = True
            st["leaf_val"][both] = values
            st["cover"][both] = cs.cover
            st["gain"][top_l] = torch.as_tensor(top_g[:ka], dtype=torch.float32, device=dev)
            st["depth"][both] = torch.cat([child_depth, child_depth])
            st["c_gain"][top_l] = -math.inf
            st["c_gain"][both] = cs.gain
            st["c_feat"][both] = cs.feat
            st["c_bin"][both] = cs.bin
            st["c_thr"][both] = cs.thr
            if has_cat:
                st["cat_node"][top_l] = sic
                st["cat_mask"][top_l] = scm
                st["c_iscat"][both] = cs.is_cat
                st["c_catmask"][both] = cs.cat_mask
        n_splits += ka

    return TreeArrays(
        feat=st["feat"],
        bin=st["bin"],
        thr=st["thr"],
        left=st["left"],
        right=st["right"],
        is_leaf=st["is_leaf"],
        leaf_val=st["leaf_val"],
        cover=st["cover"],
        gain=st["gain"],
        row_leaf=st["node"],
        cat_node=st["cat_node"] if has_cat else torch.zeros(m, dtype=torch.bool, device=dev),
        cat_mask=(st["cat_mask"] if has_cat
                  else torch.zeros((m, 1), dtype=torch.bool, device=dev)),
    )


def _kernel_launches() -> int:
    """Launches of the three histogram kernels so far, in this process."""
    return (hh.build_histograms_cuda.launches + hh.build_histograms_combined_cuda.launches
            + hh.bin_scatter.launches + uh.fused_panel_dot.launches)


def _build_tree_depthwise(
    bins_t: torch.Tensor,  # (C, N) uint8: F original or C packed columns
    grad: torch.Tensor,  # (N,)
    hess: torch.Tensor,
    count: torch.Tensor,
    edges: torch.Tensor,  # (F, E)
    feature_mask: torch.Tensor,  # (F,)
    *,
    num_bins: int,
    opts: TrainOptions,
    stats: FitStats,
    u: Optional[torch.Tensor] = None,  # U (resident) or the chunked bins layout
    u_spec: Optional[uh.USpec] = None,
    noise: Optional[torch.Tensor] = None,  # (2, N) uniforms: quantized stats
    bundle=None,
    lr: Optional[float] = None,
    regions: bool = False,  # profiler regions (:func:`_region`)
) -> TreeArrays:
    """Level-wise growth to ``opts.depth``, one histogram pass per level,
    with the reference's semantics: level d keys every row by its heap
    position less ``2**d - 1``, so all ``2**d`` nodes of the level share one
    pass (no sibling subtraction); a node splits where its best gain is
    finite and above ``min_gain_to_split`` and its parent split; a dead or
    unsplit node records bin ``B`` and threshold +inf, so every row goes
    left, and its children inherit its value. Rows route by the split
    feature's bin (decoded from the packed column under bundling; a
    categorical node sends a row left iff its bin is in the node's set).
    The heap becomes the pointer layout: internal slots ``0 .. 2**D - 2``,
    leaves ``2**D - 1 .. 2**(D+1) - 2``, and a row's final heap position
    is its leaf slot.

    Levels wider than one launch (past 42 nodes) run in node groups on the
    card; on the U path they take the compare-built pass on exact stats
    (:func:`_packed_pass`), and only the U levels' prefix sums take the
    quantized path's bin order."""
    c_cols, n = bins_t.shape
    dev = bins_t.device
    rconsts = _bundle_route_consts(bundle, dev) if bundle is not None else None
    b = num_bins
    b_pack = bundle.num_bins if bundle is not None else b
    depth = opts.depth
    tree_stats = _tree_stats(grad, hess, count, noise) if u is not None else None
    has_cat = bool(opts.categorical_slots)
    rows = torch.arange(n, device=dev)
    if len(stats.level_launches) < depth:
        stats.level_launches += [0] * (depth - len(stats.level_launches))

    node = torch.zeros(n, dtype=torch.int64, device=dev)  # heap position
    alive = torch.ones(1, dtype=torch.bool, device=dev)
    inherited = torch.zeros(1, dtype=torch.float32, device=dev)
    cover_cur = torch.zeros(1, dtype=torch.float32, device=dev)
    lv = {name: [] for name in ("feat", "bin", "thr", "cover", "gain", "iscat", "catmask")}
    for d in range(depth):
        k = 1 << d
        local = node - (k - 1)
        launched = _kernel_launches()
        with _region(regions, "gbdt.histogram"):
            h, tot = _packed_pass(bins_t, u, u_spec, grad, hess, count, local.to(torch.int32),
                                  k, b_pack, tree_stats)
            stats.passes += 1
            stats.level_launches[d] += _kernel_launches() - launched
            hist, totals = _expand(h, tot, tree_stats, bundle, b)
        quant = not h.is_floating_point()
        # XLA fuses the dequantizing multiply into the right child's
        # subtraction except in a one-level program, where the root's own
        # value reads the same product and keeps it apart
        fused = quant and depth > 1
        with _region(regions, "gbdt.split_search"):
            s = _split_search(hist, totals, edges, feature_mask, opts, lr, in_bin_order=quant,
                              quant_totals=(tot, tree_stats[1]) if fused else None)

        can_split = alive & torch.isfinite(s.gain) & (s.gain > opts.min_gain_to_split)
        # A node's value if it ends here is what its parent's split gave it
        # (l2 + cat_l2 under a categorical parent); the root takes its own.
        value_cur = s.value if d == 0 else inherited
        cover_here = torch.where(alive, s.cover, cover_cur)
        feat = torch.where(can_split, s.feat, torch.zeros_like(s.feat))
        binthr = torch.where(can_split, s.bin, torch.full_like(s.bin, b))
        lv["feat"].append(feat)
        lv["bin"].append(binthr)
        lv["thr"].append(torch.where(can_split, s.thr, torch.full_like(s.thr, math.inf)))
        lv["cover"].append(cover_here)
        lv["gain"].append(torch.where(can_split, s.gain, torch.zeros_like(s.gain)))

        with _region(regions, "gbdt.routing"):
            row_f = feat[local]
            if rconsts is not None:
                x_bin = _orig_bins(bins_t[rconsts[0][row_f], rows], row_f, rconsts)
            else:
                x_bin = bins_t[row_f, rows].long()
            go_right = x_bin > binthr[local]
            if has_cat:
                iscat = can_split & s.is_cat
                catmask = s.cat_mask & can_split[:, None]
                lv["iscat"].append(iscat)
                lv["catmask"].append(catmask)
                go_right = torch.where(iscat[local], ~catmask[local, x_bin], go_right)
            node = 2 * node + 1 + go_right.long()

        inherited = torch.stack([torch.where(can_split, s.lval, value_cur),
                                 torch.where(can_split, s.rval, value_cur)], dim=1).reshape(2 * k)
        cover_cur = torch.stack([torch.where(can_split, s.lcov, cover_here),
                                 torch.where(can_split, s.rcov, torch.zeros_like(s.rcov))],
                                dim=1).reshape(2 * k)
        alive = can_split.repeat_interleave(2)

    internal = 2 ** depth - 1
    leaves = 2 ** depth
    iota = torch.arange(internal, dtype=torch.int64, device=dev)
    zeros_l = torch.zeros(leaves, dtype=torch.int64, device=dev)
    fzeros_l = torch.zeros(leaves, dtype=torch.float32, device=dev)
    return TreeArrays(
        feat=torch.cat(lv["feat"] + [zeros_l]),
        bin=torch.cat(lv["bin"] + [torch.full_like(zeros_l, b)]),
        thr=torch.cat(lv["thr"] + [torch.full_like(fzeros_l, math.inf)]),
        left=torch.cat([2 * iota + 1, zeros_l]),
        right=torch.cat([2 * iota + 2, zeros_l]),
        is_leaf=torch.cat([torch.zeros(internal, dtype=torch.bool, device=dev),
                           torch.ones(leaves, dtype=torch.bool, device=dev)]),
        leaf_val=torch.cat([torch.zeros(internal, dtype=torch.float32, device=dev), inherited]),
        cover=torch.cat(lv["cover"] + [cover_cur]),
        gain=torch.cat(lv["gain"] + [fzeros_l]),
        row_leaf=node.to(torch.int32),
        cat_node=(torch.cat(lv["iscat"] + [torch.zeros(leaves, dtype=torch.bool, device=dev)])
                  if has_cat else torch.zeros(internal + leaves, dtype=torch.bool, device=dev)),
        cat_mask=(torch.cat(lv["catmask"]
                            + [torch.zeros((leaves, b), dtype=torch.bool, device=dev)])
                  if has_cat else torch.zeros((internal + leaves, 1), dtype=torch.bool,
                                              device=dev)),
    )


def quant_noise(seed: int, iteration: int, column: int, n: int, device) -> torch.Tensor:
    """(2, n) float32 uniforms in [0, 1) for one tree's stochastic rounding
    (``ops.u_histogram.stat_rows_quant``; row 0 for g, row 1 for h): the
    reference's own draws. Its key for (iteration, margin column) is
    ``split(fold_in(PRNGKey(seed ^ 0x51AB51AB), iteration), C)[column]``,
    split again into the g and h keys; the fold-like split makes key
    ``column`` independent of C. Integer arithmetic on ``device``, so the
    bits are the same on the CPU and the card."""
    key = threefry.split(threefry.fold_in(threefry.PRNGKey(seed ^ 0x51AB51AB), iteration),
                         column + 1)[column]
    kg, kh = threefry.split(key)
    return torch.stack([threefry.uniform(kg, n, device), threefry.uniform(kh, n, device)])


def _goss_weights(grad: torch.Tensor, bag: Optional[torch.Tensor], opts: TrainOptions,
                  it: int) -> torch.Tensor:
    """Gradient-based One-Side Sampling (the reference's, row for row): keep
    the ``max(1, round(N * top_rate))`` rows of largest ``sum_c |g|`` (ties
    to the lower row, as ``lax.top_k``: a stable descending sort), draw
    each other row with probability ``other_rate / (1 - top_rate)`` from
    ``uniform(fold_in(PRNGKey(seed), it))`` and weigh it by ``(1 -
    top_rate) / other_rate``, so that histogram sums stay unbiased. Returns
    the (N,) row weights, times the bag where there is one."""
    n = grad.shape[0]
    gabs = row_sum(grad.abs())
    if bag is not None:
        gabs = gabs * bag
    n_top = max(1, int(round(n * opts.top_rate)))
    top_idx = torch.sort(gabs, descending=True, stable=True).indices[:n_top]
    top = torch.zeros(n, dtype=torch.bool, device=grad.device)
    top[top_idx] = True
    key = threefry.fold_in(threefry.PRNGKey(opts.seed), it)
    p = float(np.float32(opts.other_rate / max(1e-12, 1.0 - opts.top_rate)))
    sampled = ~top & (threefry.uniform(key, n, grad.device) < p)
    amp = float(np.float32((1.0 - opts.top_rate) / max(1e-12, opts.other_rate)))
    w = top.to(grad.dtype) + sampled.to(grad.dtype) * amp
    return w if bag is None else bag * w


#: Objectives whose leaves take the weighted percentile of their residuals
#: (native RenewTreeOutput): l1 the median, quantile its ``alpha``.
RENEWED_OBJECTIVES = ("regression_l1", "quantile")
#: Block width of XLA's CPU prefix sum (its reduce-window rewrite).
_SCAN_BLOCK = 16


def xla_cumsum(x: torch.Tensor) -> torch.Tensor:
    """float32 inclusive prefix sum of a 1-D tensor in XLA's CPU order: rows
    of 16 summed in order, the rows' totals scanned the same way
    recursively, and each row's exclusive prefix added to its sums. Only
    float32 adds in a fixed order, so the bits are the same on the CPU and
    the card (``torch.cumsum`` accumulates in float64 on the CPU and scans
    in parallel on the card)."""
    n = x.shape[0]
    if n <= _SCAN_BLOCK:
        return _row_scan(x[None, :])[0]
    m = -(-n // _SCAN_BLOCK)
    padded = torch.zeros(m * _SCAN_BLOCK, dtype=x.dtype, device=x.device)
    padded[:n] = x
    rows = _row_scan(padded.view(m, _SCAN_BLOCK))
    tops = xla_cumsum(rows[:, -1].contiguous())
    before = torch.cat([tops.new_zeros(1), tops[:-1]])
    return (rows + before[:, None]).reshape(-1)[:n]


def _row_scan(x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sums along each row, added left to right."""
    cols = [x[:, 0]]
    for j in range(1, x.shape[1]):
        cols.append(cols[-1] + x[:, j])
    return torch.stack(cols, dim=1)


def renew_leaves(leaf_val: torch.Tensor, row_leaf: torch.Tensor, resid: torch.Tensor,
                 w_eff: torch.Tensor, pct: float, lr: float) -> torch.Tensor:
    """(M,) leaf values renewed to the ``w_eff``-weighted ``pct``-percentile
    of each leaf's residuals ``y - margin``, times ``lr`` (the reference's
    step, op for op): rows ordered by (leaf, residual) with two stable
    sorts; one global float32 prefix sum of the sorted weights in XLA's
    order (:func:`xla_cumsum`); within a leaf the first row whose inclusive
    weight reaches ``pct`` of the leaf's total ``tw`` gives the value, and
    the leaf's last row always does. Leaves without weight keep their
    value. ``tw`` is a scatter-add of the sorted weights: in row order on
    the CPU, as the reference's; in the order of the card's atomics there,
    which can move a threshold by an ulp only where weights are not
    integers."""
    n, m_slots = resid.shape[0], leaf_val.shape[0]
    leaf = row_leaf.long()
    perm1 = torch.sort(resid, stable=True).indices
    order = perm1[torch.sort(leaf[perm1], stable=True).indices]
    r_s, l_s, w_s = resid[order], leaf[order], w_eff[order]
    cum_all = xla_cumsum(w_s)
    tw = torch.zeros(m_slots, dtype=w_s.dtype, device=w_s.device).index_add_(0, l_s, w_s)
    before = cum_all - w_s  # exclusive global prefix
    start = torch.full_like(tw, float("inf")).scatter_reduce_(0, l_s, before, "amin")
    in_leaf_cum = cum_all - start[l_s]  # inclusive prefix within the leaf
    hit = in_leaf_cum >= torch.clamp(pct * tw[l_s], min=1e-12)
    last_in_leaf = torch.ones_like(hit)
    last_in_leaf[:-1] = l_s[1:] != l_s[:-1]
    rows = torch.arange(n, device=resid.device)
    pos = torch.where(hit | last_in_leaf, rows, n)
    first = torch.full((m_slots,), n, dtype=torch.int64, device=resid.device).scatter_reduce_(
        0, l_s, pos, "amin")
    vals = r_s[first.clamp(0, n - 1)] * lr
    return torch.where((tw > 0) & (first < n), vals, leaf_val)


def _stack_trees(trees: List[TreeArrays]) -> TreeArrays:
    """An iteration's per-column trees as one (C, M) TreeArrays."""
    return TreeArrays(*(torch.stack(field) for field in zip(*trees)))


def _make_step(opts: TrainOptions, objective: Objective, num_bins: int, stats: FitStats, u=None,
               u_spec=None, quant: bool = False, bundle=None, cat_u=None,
               regions: bool = False):
    """One boosting iteration: gradients (N, C) (bagged-out rows zeroed,
    GOSS weights applied), one tree per margin column in column order, the
    percentile leaf renewal of l1 and quantile, the margin update (none
    under rf, whose trees all fit the init score). ``regions``: name the
    step's parts for the device profiler (:func:`_region`)."""
    # depthwise routing gathers a categorical split's set, as the reference's
    build = (functools.partial(_build_tree_leafwise, cat_u=cat_u) if opts.growth == "leafwise"
             else _build_tree_depthwise)
    build = functools.partial(build, regions=regions)
    obj_kwargs = dict(alpha=opts.alpha, tweedie_variance_power=opts.tweedie_variance_power)
    renew_pct = None
    if objective.name in RENEWED_OBJECTIVES:
        renew_pct = opts.alpha if objective.name == "quantile" else 0.5

    def step(bins_t, y, w, margins, edges, bag, feature_mask, it, lr):
        with _region(regions, "gbdt.gradient"):
            grad, hess = objective.grad_hess(margins, y, w, **obj_kwargs)  # (N, C)
            n = y.shape[0]
            if opts.boosting_type == "goss":
                bag = _goss_weights(grad, bag, opts, it)
            if bag is None:
                count = torch.ones_like(y)
            else:
                grad, hess = grad * bag[:, None], hess * bag[:, None]
                count = (bag > 0).to(grad.dtype)
        trees = []
        for c in range(grad.shape[1]):
            # one stochastic-rounding draw per (iteration, margin column)
            with _region(regions, "gbdt.gradient"):
                noise = quant_noise(opts.seed, it, c, n, y.device) if quant else None
            trees.append(build(
                bins_t, grad[:, c].contiguous(), hess[:, c].contiguous(), count, edges,
                feature_mask, num_bins=num_bins, opts=opts, stats=stats, u=u, u_spec=u_spec,
                noise=noise, bundle=bundle, lr=lr,
            ))
            stats.trees += 1
        tree = _stack_trees(trees)
        if renew_pct is not None:
            t_r = time.perf_counter()
            w_eff = w if bag is None else w * bag
            renewed = renew_leaves(tree.leaf_val[0], tree.row_leaf[0], y - margins[:, 0], w_eff,
                                   renew_pct, lr)
            tree = tree._replace(leaf_val=renewed[None, :])
            _sync(y.device)
            stats.renewal_seconds += time.perf_counter() - t_r
        if opts.boosting_type == "rf":
            return tree, margins
        with _region(regions, "gbdt.margin_update"):
            return tree, margins + tree.leaf_val.gather(1, tree.row_leaf.long()).t()

    return step


def _bagging_active(opts: TrainOptions) -> bool:
    return opts.bagging_freq > 0 and (
        opts.bagging_fraction < 1.0
        or opts.pos_bagging_fraction < 1.0
        or opts.neg_bagging_fraction < 1.0
    )


def _mask_schedule(opts: TrainOptions, rng, n, num_bag, num_feat, f, y=None):
    """Per-iteration (bag, bag_changed, feature_mask_or_None): the
    reference's schedule, draw for draw on the same numpy generator, so the
    port's bags and feature masks are the reference's. ``bag`` is None
    without bagging (every row in), else a (N,) uint8 0/1 mask, redrawn
    every ``bagging_freq`` iterations. Class-stratified bagging
    (pos/neg_bagging_fraction) samples each binary class at its own rate."""
    bag = None
    stratified = (
        opts.pos_bagging_fraction < 1.0 or opts.neg_bagging_fraction < 1.0
    ) and y is not None
    if stratified:
        pos_idx = np.nonzero(np.asarray(y[:n]) > 0.5)[0]
        neg_idx = np.nonzero(np.asarray(y[:n]) <= 0.5)[0]
        n_pos = max(1, int(round(len(pos_idx) * opts.pos_bagging_fraction)))
        n_neg = max(1, int(round(len(neg_idx) * opts.neg_bagging_fraction)))
    for it in range(opts.num_iterations):
        changed = False
        if _bagging_active(opts) and it % opts.bagging_freq == 0:
            bag = np.zeros(n, dtype=np.uint8)
            if stratified:
                if len(pos_idx):
                    bag[rng.choice(pos_idx, size=n_pos, replace=False)] = 1
                if len(neg_idx):
                    bag[rng.choice(neg_idx, size=n_neg, replace=False)] = 1
            else:
                bag[rng.choice(n, size=num_bag, replace=False)] = 1
            changed = True
        if opts.feature_fraction < 1.0:
            fm = np.zeros(f, dtype=np.float32)
            fm[rng.choice(f, size=num_feat, replace=False)] = 1.0
        else:
            fm = None
        yield bag, changed, fm


def _route_binned(bins, feat, binthr, left, right, is_leaf, steps: int, cat_node=None,
                  cat_mask=None, bundle_consts=None) -> torch.Tensor:
    """Route binned rows ``bins`` (N, C) through one pointer tree; returns
    each row's final leaf slot (N,). At categorical nodes (``cat_node``) a
    row goes left iff its bin is in the node's set ``cat_mask`` (M, B) ((M,
    1): no categoricals). With ``bundle_consts`` the bins are EFB-packed:
    each node's packed column is gathered and decoded to the original bin
    before the compare."""
    n = bins.shape[0]
    node = torch.zeros(n, dtype=torch.int64, device=bins.device)
    for _ in range(steps):
        fcur = feat[node]
        fcol = bundle_consts[0][fcur] if bundle_consts is not None else fcur
        x_bin = bins.gather(1, fcol[:, None])[:, 0].long()
        if bundle_consts is not None:
            x_bin = _orig_bins(x_bin, fcur, bundle_consts)
        go_left = x_bin <= binthr[node]
        if cat_mask is not None and cat_mask.shape[-1] > 1:
            cm = cat_mask.reshape(-1)[node * cat_mask.shape[-1] + x_bin]
            go_left = torch.where(cat_node[node], cm, go_left)
        nxt = torch.where(go_left, left[node], right[node])
        node = torch.where(is_leaf[node], node, nxt)
    return node


def _tree_contrib(bins_v, tree: TreeArrays, steps: int, bundle=None) -> torch.Tensor:
    """(N, C) margin contribution of one iteration's (C, M) trees on a
    binned (N, columns) matrix."""
    consts = _bundle_route_consts(bundle, bins_v.device) if bundle is not None else None
    cols = []
    for c in range(tree.feat.shape[0]):
        leaf = _route_binned(bins_v, tree.feat[c], tree.bin[c], tree.left[c], tree.right[c],
                             tree.is_leaf[c], steps, cat_node=tree.cat_node[c],
                             cat_mask=tree.cat_mask[c], bundle_consts=consts)
        cols.append(tree.leaf_val[c][leaf])
    return torch.stack(cols, dim=1)


def _dropped_contrib(trees: List[TreeArrays], dropped: List[int], bins_v, steps: int,
                     bundle=None) -> torch.Tensor:
    """(N, C) sum of the dropped iterations' contributions, added in drop
    order."""
    total = _tree_contrib(bins_v, trees[dropped[0]], steps, bundle)
    for di in dropped[1:]:
        total = total + _tree_contrib(bins_v, trees[di], steps, bundle)
    return total


def _margin_to_score(margins: np.ndarray, metric: str, objective: str) -> np.ndarray:
    """What the metric consumes: every margin column for the multiclass
    metrics, the response scale for l2, rmse and l1 of poisson and tweedie,
    else margin column 0 (auc is rank-invariant)."""
    if metric in ("multi_logloss", "multi_error"):
        return margins
    if objective in ("poisson", "tweedie") and metric in ("l2", "rmse", "l1"):
        return np.exp(margins[:, 0])
    return margins[:, 0]


def _evaluate(metric: str, objective: str, y: np.ndarray, margins: np.ndarray,
              w: np.ndarray, alpha: float) -> float:
    fn, _ = METRICS[metric]
    score = _margin_to_score(margins, metric, objective)
    if metric == "quantile":
        return fn(y, score, w, alpha=alpha)
    return fn(y, score, w)


def _histogram_path(opts: TrainOptions, n: int, f: int, num_bins: int,
                    mapper: Optional[BinMapper]):
    """The U spec (None: the compare-built path) and whether the stats are
    quantized, by the reference's rules: U only when
    ``histogram_method`` is "u" (the reference also picks it by itself on a
    TPU), laid out over the packed columns under bundling, chunked rows
    when the resident U would pass the U budget; quantized stats only on the
    U path and up to :data:`QUANT_ROW_CAP` rows, else a warning and exact
    stats. ``f`` is the width of the bins: packed columns under bundling."""
    u_spec = None
    if opts.histogram_method == "u":
        bundle = None if mapper is None else mapper.bundles
        if bundle is not None:
            # K = sum of the packed widths: fewer rows of U per pass
            u_spec = uh.make_u_spec(bundle.num_bins, f, [int(x) for x in bundle.widths])
        else:
            per_feature = None if mapper is None else [int(x) for x in mapper.num_bins]
            u_spec = uh.make_u_spec(num_bins, f, per_feature)
        budget = uh.u_budget()
        if uh.u_bytes(n, u_spec) > budget:
            u_spec = uh.chunked_u_spec(n, u_spec, budget)
            _log.info(
                "U one-hot (%.1f GB) exceeds MMLSPARK_TPU_U_BUDGET (%.1f GB); streaming each "
                "histogram pass in %d row chunks of %d", uh.u_bytes(n, u_spec) / 1e9,
                budget / 1e9, uh.num_u_chunks(n, u_spec), u_spec.chunk_rows,
            )
    quant = opts.use_quantized_grad
    reason = None
    if quant and u_spec is None:
        reason = ("the precomputed-U histogram path is inactive (the port takes it only "
                  "with histogram_method='u')")
    elif quant and n > QUANT_ROW_CAP:
        reason = (f"{n} rows exceeds the quantized-path cap min(2^31/127, 2^24) = 2^24 "
                  "(float32 count exactness / int32 histogram accumulator)")
    if reason is not None:
        _log.warning("use_quantized_grad requested but %s; training with exact stats "
                     "instead", reason)
        quant = False
    return u_spec, quant


def _dtype_name(dtype: torch.dtype) -> str:
    """A torch dtype by its numpy name (``int16``), the events' spelling."""
    return str(dtype).replace("torch.", "")


def _subtraction_cache_bytes(opts: TrainOptions, cols: int, bins: int,
                             acc_dtype: torch.dtype) -> Optional[int]:
    """Bytes of the leafwise grower's sibling-subtraction cache (one
    histogram of ``cols`` x ``bins`` x 3 per node of every class's tree),
    or None when the grower keeps none: subtraction is off, or the cache
    would exceed ``SUBTRACTION_CACHE_BYTES``."""
    cache = (max(1, opts.num_class) * (2 * opts.num_leaves - 1) * cols * bins * 3
             * acc_dtype.itemsize)
    if not opts.histogram_subtraction or cache > SUBTRACTION_CACHE_BYTES:
        return None
    return cache


def _publish_plan_events(bus, opts: TrainOptions, n: int, f: int, num_bins: int, bundle,
                         u_spec, quant: bool) -> None:
    """The histogram plan's events, with the reference's fields:
    ``HistogramChunked`` when the U pass streams row chunks, then
    ``HistogramSubtracted`` when the leafwise grower keeps the
    sibling-subtraction cache."""
    if u_spec is not None and u_spec.chunk_rows:
        dt = uh.histogram_acc_dtype(n, quant)
        leaf_batch = max(1, min(opts.leaf_batch, opts.num_leaves - 1))
        bus.publish(events.HistogramChunked(
            rows=n, k_packed=u_spec.k_pad, chunk_rows=u_spec.chunk_rows,
            num_chunks=uh.num_u_chunks(n, u_spec), budget_bytes=uh.u_budget(),
            acc_dtype=_dtype_name(dt),
            bytes_saved=u_spec.k_pad * 3 * leaf_batch * (4 - dt.itemsize),
        ))
    if opts.growth != "leafwise":
        return
    cols = len(bundle.widths) if bundle is not None else f
    bins = bundle.num_bins if bundle is not None else num_bins
    dt = uh.histogram_acc_dtype(n, quant and u_spec is not None)
    cache = _subtraction_cache_bytes(opts, cols, bins, dt)
    if cache is not None:
        bus.publish(events.HistogramSubtracted(
            rows=n, num_leaves=opts.num_leaves, packed_columns=cols, packed_bins=bins,
            acc_dtype=_dtype_name(dt), cache_bytes=cache,
            bytes_saved_per_tree=(opts.num_leaves - 1) * cols * bins * 3 * dt.itemsize,
        ))


def _cat_u_rows(u, u_spec, bundle, cat_slots):
    """The resident U's categorical rows for the membership product (bf16,
    cut once per fit) and their feature and local-bin maps; None off the
    resident U path or without categoricals."""
    if u is None or u_spec is None or u_spec.chunk_rows or not cat_slots:
        return None
    if bundle is not None:
        rows, feats, locals_ = cat_row_maps_bundled(u_spec, bundle, cat_slots)
    else:
        rows, feats, locals_ = uh.cat_row_maps(u_spec, cat_slots)
    dev = u.device
    return (u[torch.as_tensor(rows, dtype=torch.int64, device=dev)].to(torch.bfloat16),
            torch.as_tensor(feats, dtype=torch.int64, device=dev),
            torch.as_tensor(locals_, dtype=torch.int64, device=dev))


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


ValidSet = Tuple[str, np.ndarray, np.ndarray, Optional[np.ndarray]]


#: Host bytes of bins one upload block holds.
UPLOAD_BLOCK_BYTES = 64 << 20


def _file_rows(bins: np.ndarray) -> Optional[Tuple[str, int]]:
    """(file, byte offset of row 0) of a C-contiguous uint8 memmap whose
    rows lie in its file, a row slice of one too; None for an array in
    memory or a copy-on-write map. The view's offset counts from the map's
    own start, which sits at the file offset ``bins.offset``."""
    if not (isinstance(bins, np.memmap) and bins.filename and bins.mode != "c"
            and bins.dtype == np.uint8 and bins.flags.c_contiguous):
        return None
    root = bins
    while isinstance(root.base, np.ndarray):
        root = root.base
    return bins.filename, bins.offset + (bins.ctypes.data - root.ctypes.data)


def upload_bins(bins: np.ndarray, dev: torch.device) -> torch.Tensor:
    """(N, C) host bins as the (C, N) uint8 tensor on ``dev`` that the fit
    keeps: feature-major, so the kernel's rows are contiguous per feature
    and routing gathers whole rows of it. Copied in row blocks of at most
    :data:`UPLOAD_BLOCK_BYTES`. A memmap's rows are read through its file
    into one block buffer, so the file's pages are never mapped into the
    process and its resident memory does not grow with N."""
    n, c = bins.shape
    out = torch.empty((c, n), dtype=torch.uint8, device=dev)
    rows = max(1, UPLOAD_BLOCK_BYTES // max(c, 1))
    buf = np.empty((min(rows, n), c), dtype=np.uint8)
    span = _file_rows(bins)
    with open(span[0], "rb") if span else contextlib.nullcontext() as fh:
        if fh:
            fh.seek(span[1])
        for lo in range(0, n, rows):
            block = buf[: min(rows, n - lo)]
            if not fh:
                block[...] = bins[lo: lo + len(block)]
            elif fh.readinto(memoryview(block).cast("B")) != block.nbytes:
                raise OSError(f"{span[0]}: short read at row {lo}")
            out[:, lo: lo + len(block)] = torch.from_numpy(block).to(dev).t()
    return out


def train(
    bins: np.ndarray,  # (N, F) uint8, or (N, C) packed columns under bundling
    y: np.ndarray,
    opts: TrainOptions,
    w: Optional[np.ndarray] = None,
    init_margins: Optional[np.ndarray] = None,  # (N, C) warm-start margins
    valid_sets: Optional[Sequence[ValidSet]] = None,
    mapper: Optional[BinMapper] = None,
    feature_names: Optional[List[str]] = None,
    callbacks: Optional[Sequence] = None,
    device: DeviceLike = None,
    objective: Optional[Objective] = None,
) -> TrainResult:
    """Run boosting on ``device`` (CUDA unless ``device='cpu'``).

    ``objective`` is a per-fit :class:`~.objectives.Objective` (lambdarank,
    from :func:`~.ranker.make_lambdarank_objective`, whose gradients close
    over the fit's query groups); without it ``opts.objective`` names one
    of ``objectives.OBJECTIVES``. l1 and quantile fits renew each tree's
    leaves to the percentile of their residuals (:func:`renew_leaves`).

    ``valid_sets`` entries are (name, bins_v, y_v, w_v), binned by the
    fit's mapper (packed under bundling). Each iteration routes them
    through the new tree and scores them with ``opts.metric`` (the
    objective's default metric when None); ``early_stopping_round`` stops
    after that many iterations without an improvement above
    ``improvement_tolerance`` on any set, and the booster keeps the best
    iteration. ``init_margins`` warm-starts the fit: the init score is then
    0 and the booster a delta model. ``callbacks`` are
    :class:`~.callbacks.TrainingCallback` delegates: LR schedules and
    per-iteration hooks.

    A mapper with categorical features makes their slots categorical (the
    mapper is the one source of truth, as in the reference); one with a
    bundle spec takes the packed bins of ``apply_bins``/``bin_dataset``.

    On the U path a device out-of-memory error in an iteration (a card's
    ``torch.cuda.OutOfMemoryError``, or the injected one of
    ``FaultPlan.oom_task(i, kind="device")`` from an ambient
    :func:`~mmlspark_tpu_torch.runtime.faults.inject_faults`) walks the
    reference's ladder: halve the U budget (down to 1 MiB), re-plan the
    chunked passes, rebuild their bins layout and retry the same iteration
    with the same bag, feature mask and learning rate, at most
    :data:`OOM_RETRY_CAP` times. Chunked and resident passes sum the same
    integers, so the fit's model text does not change.

    Boosting types keep the reference's contracts: rf needs bagging,
    refuses validation sets and fits its trees at learning rate 1 (the
    booster averages them); goss refuses bagging and needs ``top_rate +
    other_rate <= 1``; dart refuses early stopping, and draws its dropped
    trees once per iteration, so that an out-of-memory retry reuses them."""
    check_supported(opts, objective)
    if opts.boosting_type == "rf":
        if not (opts.bagging_fraction < 1.0 and opts.bagging_freq > 0):
            raise ValueError("boosting_type='rf' requires bagging "
                             "(bagging_fraction < 1 and bagging_freq > 0)")
        if valid_sets:
            raise ValueError("boosting_type='rf' does not support validation sets "
                             "(averaged-ensemble eval is not incremental)")
        opts = dataclasses.replace(opts, learning_rate=1.0)
    elif opts.boosting_type == "goss":
        if opts.bagging_fraction < 1.0:
            raise ValueError("boosting_type='goss' cannot be combined with bagging")
        if opts.top_rate + opts.other_rate > 1.0:
            raise ValueError("goss requires top_rate + other_rate <= 1 "
                             f"(got {opts.top_rate} + {opts.other_rate})")
    elif opts.boosting_type == "dart" and opts.early_stopping_round > 0:
        raise ValueError("early stopping is not available in dart mode")
    if (opts.pos_bagging_fraction < 1.0 or opts.neg_bagging_fraction < 1.0) \
            and opts.objective != "binary":
        # native LightGBM likewise restricts pos/neg bagging to binary
        raise ValueError("posBaggingFraction/negBaggingFraction require the binary "
                         f"objective (got {opts.objective!r})")
    dev = resolve_device(device)
    t0 = time.perf_counter()
    if objective is None:
        objective = get_objective(opts.objective)
    else:
        opts = dataclasses.replace(opts, objective=objective.name)
    num_classes = objective.num_outputs_fn(opts.num_class)
    n, f = bins.shape
    num_bins = opts.max_bin + 1  # + missing bin
    bundle = None if mapper is None else mapper.bundles
    if bundle is not None and f != bundle.num_columns:
        raise ValueError(
            f"bundled mapper expects packed bins with {bundle.num_columns} columns, got {f}"
            " - bin through apply_bins/bin_dataset with this mapper")
    f_feat = bundle.num_features if bundle is not None else f
    if mapper is not None and mapper.cat_values:
        opts = dataclasses.replace(
            opts,
            categorical_slots=tuple(sorted(mapper.cat_values)),
            # native max_cat_to_onehot: features with few seen categories
            # take the one-vs-rest search
            onehot_slots=tuple(j for j in sorted(mapper.cat_values)
                               if len(mapper.cat_values[j]) <= opts.max_cat_to_onehot),
        )

    w_np = np.ones(n, dtype=np.float32) if w is None else np.asarray(w, dtype=np.float32)
    y_np = np.asarray(y, dtype=np.float32)
    if init_margins is not None:
        # Warm start: a delta model (LightGBM disables boost_from_average
        # when an init score is given).
        init_score = np.zeros(num_classes, dtype=np.float32)
    elif opts.boost_from_average:
        init_score = objective.init_score(y_np, num_classes, w_np)
    else:
        init_score = np.zeros(num_classes, dtype=np.float32)

    if mapper is not None:
        edges = np.where(np.isfinite(mapper.edges), mapper.edges,
                         np.float32(np.finfo(np.float32).max))
    else:
        edges = np.zeros((f_feat, 1))
    edges_dev = torch.as_tensor(edges.astype(np.float32), device=dev)
    t_bins = time.perf_counter()
    bins_t = upload_bins(bins, dev)
    _sync(dev)
    upload_seconds = time.perf_counter() - t_bins
    y_dev = torch.as_tensor(y_np, device=dev)
    w_dev = torch.as_tensor(w_np, device=dev)
    if init_margins is None:
        margins = torch.as_tensor(init_score, device=dev)[None, :].expand(n, num_classes).clone()
    else:
        margins = torch.as_tensor(
            np.asarray(init_margins, dtype=np.float32).reshape(n, num_classes), device=dev)
    fm_ones = torch.ones(f_feat, dtype=torch.float32, device=dev)

    stats = FitStats()
    stats.upload_seconds = upload_seconds
    faults = current_faults()  # injected device OOMs, keyed (iteration, retry)
    u_spec, quant = _histogram_path(opts, n, f, num_bins, mapper)
    stats.u_budget = uh.u_budget() if u_spec is not None else 0
    prof = get_profiler()
    prof_on = prof.active  # the profiler's sites below cost this one read when quiet
    bus = events.get_bus()
    if bus.active:
        _publish_plan_events(bus, opts, n, f, num_bins, bundle, u_spec, quant)
    stats.quantized = quant
    if quant and opts.growth == "depthwise" and opts.depth >= 7:
        _log.warning(
            "use_quantized_grad with depthwise growth and depth %d: levels deeper than 5 "
            "have > 42 frontier nodes and exceed the 128-slot U panel budget (3 stats x "
            "nodes), so those levels fall back to exact (non-quantized) histograms per level",
            opts.depth)
    u = None

    def build_u_path():
        """Lay out the U path for ``u_spec``: the resident one-hot or the
        chunked pass's bins layout, and the step over it."""
        nonlocal u
        u = None
        if u_spec is not None:
            t_u = time.perf_counter()
            u = uh.prepare_chunked_bins(bins_t, u_spec) if u_spec.chunk_rows else uh.build_u(
                bins_t, u_spec)
            _sync(dev)
            stats.u_build_seconds += time.perf_counter() - t_u
            stats.histogram_path = "u_chunked" if u_spec.chunk_rows else "u"
            stats.u_chunks = uh.num_u_chunks(n, u_spec)
        cat_u = _cat_u_rows(u, u_spec, bundle, opts.categorical_slots)
        return _make_step(opts, objective, num_bins, stats, u=u, u_spec=u_spec, quant=quant,
                          bundle=bundle, cat_u=cat_u, regions=prof_on)

    def degrade(err, it, retries) -> bool:
        """One rung down the out-of-memory ladder; True when the caller may
        retry the iteration."""
        nonlocal u_spec, u
        if u_spec is None:
            return False  # no U path: nothing to shrink
        new_budget = max(stats.u_budget // 2, OOM_MIN_BUDGET)
        if new_budget == stats.u_budget and u_spec.chunk_rows:
            return False  # at the floor: the memory is really not there
        stats.u_budget = new_budget
        u_spec = uh.chunked_u_spec(n, dataclasses.replace(u_spec, chunk_rows=0), new_budget)
        _log.warning(
            "histogram pass ran out of device memory at iteration %d (%s); degrading: U "
            "budget -> %d bytes, chunk_rows -> %d, retry %d", it, str(err)[:120],
            new_budget, u_spec.chunk_rows, retries)
        bus = events.get_bus()
        if bus.active:
            bus.publish(events.MemoryPressure(
                source="device", level="critical", used_bytes=0.0, limit_bytes=0.0,
                detail=str(err)[:200]))
            bus.publish(events.HistogramDegraded(
                rows=n, budget_bytes=new_budget, chunk_rows=u_spec.chunk_rows, stage="loop",
                iteration=int(it), retries=int(retries)))
        return True

    valid_state = []
    for name, bv, yv, wv in valid_sets or []:
        bv = np.asarray(bv, dtype=np.uint8)
        if bv.ndim != 2 or bv.shape[1] != f:
            raise ValueError(f"valid set {name!r} has bins of shape {bv.shape}; the fit's "
                             f"bins have {f} columns - bin it with the fit's mapper")
        nv = len(yv)
        valid_state.append(dict(
            name=name, bins=torch.as_tensor(bv, device=dev),
            y=np.asarray(yv, dtype=np.float32),
            w=np.ones(nv, dtype=np.float32) if wv is None else np.asarray(wv, np.float32),
            margins=torch.as_tensor(init_score, device=dev)[None, :].expand(
                nv, num_classes).clone(),
        ))

    metric = opts.metric or objective.default_metric
    if (valid_state or opts.provide_training_metric) and metric not in METRICS:
        raise NotImplementedError(f"metric {metric!r} is not ported (ported: {sorted(METRICS)})")
    higher_better = metric_higher_is_better(metric)
    evals: Dict[str, Dict[str, List[float]]] = {vs["name"]: {metric: []} for vs in valid_state}
    if opts.provide_training_metric:
        evals["training"] = {metric: []}

    rng = np.random.default_rng(opts.seed)
    num_bag = max(1, int(round(n * opts.bagging_fraction)))
    num_feat = max(1, int(round(f_feat * opts.feature_fraction)))
    schedule = _mask_schedule(opts, rng, n, num_bag, num_feat, f_feat, y=y_np)

    callbacks = list(callbacks or [])
    lr_all = _lr_schedule(callbacks, opts.learning_rate, opts.num_iterations)
    hooks = _has_iteration_hooks(callbacks)

    def cb_env(it: int) -> CallbackEnv:
        lr_it = float(lr_all[it]) if (lr_all is not None and it < len(lr_all)) \
            else opts.learning_rate
        return CallbackEnv(iteration=it, num_iterations=opts.num_iterations,
                           learning_rate=lr_it, evals=evals)

    for cb in callbacks:
        cb.before_training(cb_env(0))

    best_score = -np.inf if higher_better else np.inf
    best_iter = 0
    stale = 0
    bag_dev = None
    step = build_u_path()
    step_fresh = True
    trees = []
    dart_rng = np.random.default_rng(opts.seed + 7919) if opts.boosting_type == "dart" else None
    bins_rows = bins_t.t()  # (N, columns) view for routing the training rows
    side_seconds = 0.0  # bag draws, uploads, valid updates and evals
    for it in range(opts.num_iterations):
        t_it = time.perf_counter()
        bag_np, bag_changed, fm_np = next(schedule)
        t_drawn = time.perf_counter()
        if bag_changed:
            # uint8 on the wire, widened on the device
            bag_dev = torch.as_tensor(bag_np, device=dev).to(torch.float32)
        fm_dev = fm_ones if fm_np is None else torch.as_tensor(fm_np, device=dev)
        _sync(dev)
        t_up = time.perf_counter()
        if hooks:
            for cb in callbacks:
                cb.before_iteration(cb_env(it))
        lr_it = float(lr_all[it]) if lr_all is not None else opts.learning_rate
        # dart: drop each earlier iteration's trees with probability
        # drop_rate from the margins the new trees fit (one draw per
        # iteration, before the retry loop)
        dropped = []
        if dart_rng is not None and trees:
            dropped = np.nonzero(dart_rng.random(len(trees)) < opts.drop_rate)[0].tolist()
        if dart_rng is not None:
            stats.dart_drops.append(dropped)
        margins_in = margins
        if dropped:
            c_d = _dropped_contrib(trees, dropped, bins_rows, opts.routing_steps, bundle)
            margins_in = margins - c_d
        # the step's device window: dispatch through the sync below
        with _region(prof_on, "gbdt.step"):
            retries = 0
            while True:
                failed = None
                try:
                    if faults is not None:
                        faults.apply_on_histogram(it, retries)
                    tree, new_margins = step(bins_t, y_dev, w_dev, margins_in, edges_dev, bag_dev,
                                             fm_dev, it, lr_it)
                except (MemoryError, RuntimeError) as err:
                    if not is_oom_error(err):
                        raise
                    failed = err
                if failed is None:
                    break
                if retries >= OOM_RETRY_CAP or not degrade(failed, it, retries + 1):
                    raise failed
                # Outside the handler, so that the failed step's frames are gone:
                # free U, return the cached blocks, then lay out the new plan.
                # The retry reuses this iteration's bag, feature mask and rate.
                retries += 1
                stats.oom_retries += 1
                failed = step = None
                u = None
                if dev.type == "cuda":
                    torch.cuda.empty_cache()
                step = build_u_path()
                step_fresh = True
            valid_done = False
            if dropped:
                # DART's rescale: the new trees x 1/(k+1), the dropped ones
                # x k/(k+1), in the reference's order of operations; the valid
                # sets take the same delta from the dropped trees before rescaling.
                scale_new = float(np.float32(1.0 / (len(dropped) + 1)))
                scale_drop = float(np.float32(len(dropped) / (len(dropped) + 1)))
                c_new = tree.leaf_val.gather(1, tree.row_leaf.long()).t()
                for vs in valid_state:
                    c_dv = _dropped_contrib(trees, dropped, vs["bins"], opts.routing_steps, bundle)
                    c_newv = _tree_contrib(vs["bins"], tree, opts.routing_steps, bundle)
                    vs["margins"] = vs["margins"] - c_dv * scale_new + c_newv * scale_new
                valid_done = True
                tree = tree._replace(leaf_val=tree.leaf_val * scale_new)
                for di in dropped:
                    trees[di] = trees[di]._replace(leaf_val=trees[di].leaf_val * scale_drop)
                margins = margins - c_d * scale_new + c_new * scale_new
            else:
                margins = new_margins
            _sync(dev)
        t_step = time.perf_counter()
        if prof_on:
            # one iteration at a time: the step's first call (a fit's
            # first iteration, or the first after an OOM rebuild) books as
            # its first-call miss, the rest as hits
            if step_fresh:
                prof.note_compile("gbdt.step", t_step - t_up, signature=_signature(
                    (bins_t, y_dev, w_dev, margins_in, edges_dev, bag_dev, fm_dev), {}))
            else:
                prof.note_cache_hit("gbdt.step")
            prof.note_execute("gbdt.step", t_step - t_up)
            step_fresh = False
        for vs in valid_state if not valid_done else ():
            vs["margins"] = vs["margins"] + _tree_contrib(vs["bins"], tree, opts.routing_steps,
                                                          bundle)
        _sync(dev)
        t_valid = time.perf_counter()
        trees.append(tree._replace(row_leaf=None))

        if opts.provide_training_metric:
            evals["training"][metric].append(_evaluate(
                metric, opts.objective, y_np, margins.cpu().numpy(), w_np, opts.alpha))
        improved_any = False
        for vs in valid_state:
            score = _evaluate(metric, opts.objective, vs["y"], vs["margins"].cpu().numpy(),
                              vs["w"], opts.alpha)
            evals[vs["name"]][metric].append(score)
            # best-so-far from the true score; the first finite eval improves
            # on the +-inf sentinel, and a NaN never counts as an improvement
            delta = (score - best_score) if higher_better else (best_score - score)
            if delta > opts.improvement_tolerance:
                best_score, best_iter, improved_any = score, it + 1, True
        t_eval = time.perf_counter()
        stats.per_iteration.append(dict(
            bag_draw=t_drawn - t_it, mask_upload=t_up - t_drawn, boost=t_step - t_up,
            valid_update=t_valid - t_step, eval=t_eval - t_valid))
        side_seconds += (t_up - t_it) + (t_eval - t_step)

        stop_requested = False
        if hooks:
            for cb in callbacks:
                if cb.after_iteration(cb_env(it)):
                    stop_requested = True
        if stop_requested:
            break
        if valid_state and opts.early_stopping_round > 0:
            stale = 0 if improved_any else stale + 1
            if stale >= opts.early_stopping_round:
                break
    for cb in callbacks:
        cb.after_training(cb_env(max(0, len(trees) - 1)))

    booster = _pack_booster(
        trees, opts, num_classes, init_score, mapper, feature_names,
        best_iteration=best_iter if (valid_state and opts.early_stopping_round > 0) else -1)
    stats.syncs += 1  # the packing fetch
    stats.boost_seconds = time.perf_counter() - t0 - stats.u_build_seconds - side_seconds
    return TrainResult(booster=booster, stats=stats, evals=evals, best_iteration=best_iter)


def _pack_booster(
    trees: List[TreeArrays],
    opts: TrainOptions,
    num_classes: int,
    init_score: np.ndarray,
    mapper: Optional[BinMapper],
    feature_names: Optional[List[str]] = None,
    best_iteration: int = -1,
) -> Booster:
    """Per-iteration (C, M) device arrays -> one host :class:`Booster` of
    T * C trees, tree ``i*C + c`` = iteration i, column c (one fetch, and
    one more for the categorical split sets). rf's leaf values are divided
    by the iterations, so the booster predicts the trees' average."""
    fields = ("feat", "bin", "thr", "left", "right", "is_leaf", "leaf_val", "cover", "gain")
    if trees:
        packed = torch.stack([
            torch.cat([getattr(tr, fld).to(torch.float32) for tr in trees])
            for fld in fields
        ]).cpu().numpy()
    else:
        packed = np.zeros((len(fields), 0, opts.num_nodes), np.float32)

    def stack(field, dtype):
        return packed[fields.index(field)].astype(dtype)

    cat_nodes = cat_masks = None
    if opts.categorical_slots and trees:
        cat_nodes = torch.cat([tr.cat_node for tr in trees]).cpu().numpy().astype(bool)
        cat_masks = torch.cat([tr.cat_mask for tr in trees]).cpu().numpy().astype(bool)
    left = stack("left", np.int32)
    right = stack("right", np.int32)
    is_leaf = stack("is_leaf", bool)
    leaf_values = stack("leaf_val", np.float32)
    if opts.boosting_type == "rf":
        leaf_values = leaf_values / max(1, len(trees))
    return Booster(
        split_feature=stack("feat", np.int32),
        split_bin=stack("bin", np.int32),
        split_threshold=stack("thr", np.float32),
        left_child=left,
        right_child=right,
        is_leaf=is_leaf,
        leaf_values=leaf_values,
        cover=stack("cover", np.float32),
        split_gain=stack("gain", np.float32),
        init_score=np.asarray(init_score, dtype=np.float32),
        num_classes=num_classes,
        objective=opts.objective,
        max_depth=_realized_depth(left, right, is_leaf, opts.routing_steps),
        best_iteration=best_iteration,
        feature_names=feature_names,
        bin_edges=None if mapper is None else mapper.edges,
        cat_nodes=cat_nodes,
        cat_masks=cat_masks,
        cat_values=(
            None if (mapper is None or not mapper.cat_values)
            else {int(j): np.asarray(v) for j, v in mapper.cat_values.items()}
        ),
    )


def _realized_depth(left, right, is_leaf, bound: int) -> int:
    """Max root->leaf depth over all trees (children always occupy a higher
    slot than their parent, so one forward pass over slots suffices)."""
    t, m = left.shape
    depth = np.zeros((t, m), dtype=np.int64)
    rows = np.arange(t)
    for j in range(m):
        internal = ~is_leaf[:, j] & (left[:, j] > j)
        if not internal.any():
            continue
        for child in (left[:, j], right[:, j]):
            depth[rows[internal], child[internal]] = depth[internal, j] + 1
    reachable = depth[is_leaf]
    realized = int(reachable.max()) if reachable.size else 1
    return max(1, min(realized, bound))
