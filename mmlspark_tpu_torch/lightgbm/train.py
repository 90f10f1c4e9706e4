"""GBDT training loop: leafwise (LightGBM best-first) growth on the device.

The port's counterpart of ``mmlspark_tpu/lightgbm/train.py`` for the
flagship path: gbdt boosting, leafwise growth with ``leaf_batch`` frontier
leaves per histogram pass, sibling histogram subtraction, numeric features,
and the precomputed-U histogram path with quantized gradients. Each
iteration:

  gradients -> histogram pass(es) on the Hopper kernels -> split search over
  the (node, feature, bin) lattice -> row routing -> leaf values -> margins.

Histogram passes take one of two paths, by the reference's rule: the
compare-built kernel (``ops/histogram.py``) by default, or the U pass
(``ops/u_histogram.py``) when ``histogram_method="u"``. The reference picks
U by itself only on a TPU backend, so the port never does.

PyTorch runs eagerly, so the reference's ``lax.while_loop`` over passes is a
host loop: each pass reads the frontier's candidate gains to the host once
(one device sync), which decides both whether the loop goes on and which
leaves split. :class:`FitStats` counts those syncs.

Not ported yet: depthwise growth, multiclass, rf/dart/goss, bagging and
feature fraction, categorical splits, feature bundling, validation sets,
callbacks, meshes, and the U path's out-of-memory ladder.
"""

from __future__ import annotations

import dataclasses
import logging
import math
import time
from typing import List, NamedTuple, Optional

import numpy as np
import torch

from mmlspark_tpu_torch.device import DeviceLike, resolve_device
from mmlspark_tpu_torch.lightgbm.binning import BinMapper
from mmlspark_tpu_torch.lightgbm.booster import Booster
from mmlspark_tpu_torch.lightgbm.objectives import get_objective
from mmlspark_tpu_torch.ops import histogram
from mmlspark_tpu_torch.ops import u_histogram as uh

_log = logging.getLogger("mmlspark_tpu_torch.lightgbm")

#: Rows above which quantized training falls back to exact stats: int32 sums
#: of 127-level stats wrap past 2**31/127 rows, and float32 counts stop being
#: exact integers past 2**24; the tighter cap holds.
QUANT_ROW_CAP = min((1 << 31) // 127, 1 << 24)
#: Device bytes the sibling-subtraction cache may take; above it the grower
#: builds both children of every split instead.
SUBTRACTION_CACHE_BYTES = 256 << 20


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
    def num_nodes(self) -> int:
        """Node-slot count M of one leafwise tree in pointer layout."""
        return 2 * self.num_leaves - 1

    @property
    def routing_steps(self) -> int:
        """Static bound on tree depth for routing loops."""
        if self.max_depth and self.max_depth > 0:
            return min(self.max_depth, self.num_leaves - 1)
        return self.num_leaves - 1


#: Options whose non-default values select paths the port has not taken over.
_UNPORTED = {
    "growth": "leafwise",
    "boosting_type": "gbdt",
    "tree_learner": "data_parallel",
    "bagging_fraction": 1.0,
    "pos_bagging_fraction": 1.0,
    "neg_bagging_fraction": 1.0,
    "bagging_freq": 0,
    "feature_fraction": 1.0,
    "early_stopping_round": 0,
    "categorical_slots": (),
    "provide_training_metric": False,
}


def check_supported(opts: TrainOptions) -> None:
    """Raise ``NotImplementedError`` for options the port cannot honour."""
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
    get_objective(opts.objective)


@dataclasses.dataclass
class FitStats:
    """What one fit did, counted on the host: trees, histogram passes, the
    host syncs the grower paid (one per pass that splits or stops growth,
    plus the final fetch), wall seconds of boosting
    (device upload to the packed booster, less the U build), of building U
    and of the host binning before it, where the caller binned; and which
    histogram path ran ("compare", "u" or "u_chunked", with its chunk count)
    and whether its stats were quantized."""

    trees: int = 0
    passes: int = 0
    syncs: int = 0
    boost_seconds: float = 0.0
    binning_seconds: float = 0.0
    u_build_seconds: float = 0.0
    histogram_path: str = "compare"
    u_chunks: int = 0
    quantized: bool = False


@dataclasses.dataclass
class TrainResult:
    booster: Booster
    stats: FitStats


class TreeArrays(NamedTuple):
    """One tree in pointer layout (each (M,) on the device)."""

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


def _soft_threshold(g: torch.Tensor, l1: float) -> torch.Tensor:
    if l1 == 0.0:
        return g
    return torch.sign(g) * torch.clamp(g.abs() - l1, min=0.0)


def _split_search(
    hist: torch.Tensor,  # (k, F, B, 3)
    totals: torch.Tensor,  # (k, 3) per-node [sum_g, sum_h, count]
    edges: torch.Tensor,  # (F, E)
    feature_mask: torch.Tensor,  # (F,)
    opts: TrainOptions,
) -> SplitSearch:
    """Best numeric split per node from its histogram."""
    k, f, b, _ = hist.shape
    l1, l2, lr = opts.lambda_l1, opts.lambda_l2, opts.learning_rate
    g_tot, h_tot, c_tot = totals[:, 0], totals[:, 1], totals[:, 2]

    # Left stats at "<= bin": a float32 prefix sum over the bin axis (the
    # reference takes a HIGHEST-precision triangular matmul for the same sums).
    cum = torch.cumsum(hist, dim=2)
    gl, hl, cl = cum[..., 0], cum[..., 1], cum[..., 2]
    gr = g_tot[:, None, None] - gl
    hr = h_tot[:, None, None] - hl
    cr = c_tot[:, None, None] - cl

    tl, tr = _soft_threshold(gl, l1), _soft_threshold(gr, l1)
    tg = _soft_threshold(g_tot, l1)
    parent_score = (tg * tg) / (h_tot + l2)
    gain = tl * tl / (hl + l2) + tr * tr / (hr + l2) - parent_score[:, None, None]

    bins_ok = torch.arange(b, device=hist.device)[None, None, :] < b - 1
    valid = (
        (cl >= opts.min_data_in_leaf)
        & (cr >= opts.min_data_in_leaf)
        & (hl >= opts.min_sum_hessian_in_leaf)
        & (hr >= opts.min_sum_hessian_in_leaf)
        & bins_ok
        & (feature_mask[None, :, None] > 0)
    )
    gain = torch.where(valid, gain, torch.full_like(gain, -math.inf))

    flat = gain.reshape(k, f * b)
    best_idx = torch.argmax(flat, dim=1)  # first maximum, as jnp.argmax
    best_gain = flat.gather(1, best_idx[:, None])[:, 0]
    best_f = best_idx // b
    best_b = best_idx % b

    def leaf_value(g, h):
        v = -_soft_threshold(g, l1) / (h + l2)
        if opts.max_delta_step > 0:
            v = torch.clamp(v, -opts.max_delta_step, opts.max_delta_step)
        return v * lr

    iota = torch.arange(k, device=hist.device)
    glb = gl[iota, best_f, best_b]
    hlb = hl[iota, best_f, best_b]
    clb = cl[iota, best_f, best_b]

    # Raw threshold: split bin t means "x <= edges[f, t-1]"; t=0 => NaN-only left.
    thr_raw = edges[best_f, torch.clamp(best_b - 1, min=0)]
    thr_raw = torch.where(best_b == 0, torch.full_like(thr_raw, -math.inf), thr_raw)

    return SplitSearch(
        value=leaf_value(g_tot, h_tot),
        cover=c_tot,
        hess=h_tot,
        gain=best_gain,
        feat=best_f,
        bin=best_b,
        thr=thr_raw,
        lval=leaf_value(glb, hlb),
        rval=leaf_value(g_tot - glb, h_tot - hlb),
        lcov=clb,
        rcov=c_tot - clb,
    )


def _packed_pass(bins_t, u, u_spec, grad, hess, count, key, num_nodes, num_bins, tree_stats):
    """One histogram pass and its per-node totals (feature 0 covers every
    row of a node), before dequantization: the representation the sibling
    cache keeps. float32 on the compare-built and bf16 U paths; on the
    quantized U path the narrow integer accumulator, so that parent - child
    is exact."""
    if u is None:
        h = histogram.build_histograms(bins_t, grad, hess, count, key, num_nodes, num_bins)
    elif u_spec.chunk_rows:
        h = uh.build_histograms_u_chunked(u, grad, hess, count, key, num_nodes, u_spec,
                                          stats=tree_stats, dequant=False)
    else:
        h = uh.build_histograms_u(u, grad, hess, count, key, num_nodes, u_spec,
                                  stats=tree_stats, dequant=False)
    return h, h[:, 0].sum(dim=1)


def _expand(h, totals, tree_stats):
    """A packed pass ready for the split search: the quantized path's scales
    applied once, after any subtraction."""
    if h.is_floating_point():
        return h, totals
    scales = tree_stats[1]
    return uh.dequant_hist(h, scales), uh.dequant_hist(totals, scales)


def _tree_stats(grad, hess, count, noise=None):
    """The U pass's (3, N) stat rows, built once per tree: quantized with
    ``noise`` (int8 rows and their scales), else bf16."""
    if noise is not None:
        return uh.stat_rows_quant(grad, hess, count, noise)
    return uh.stat_rows(grad, hess, count)


def _build_tree_leafwise(
    bins_t: torch.Tensor,  # (F, N) uint8
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
) -> TreeArrays:
    """Best-first growth, ``leaf_batch`` frontier leaves per histogram pass,
    with the reference's semantics: the top-k frontier leaves by cached gain
    (descending, ties by lower slot) split together; the j-th split overall
    creates slots 2j+1 and 2j+2. With sibling subtraction only the smaller
    child of each split is histogrammed (key = lane for its rows, ``2k``
    elsewhere) and the sibling is the parent's cached histogram minus it;
    the cache is gated on its size, as the reference's is, and without it
    both children are keyed (``2*lane + went_right``) in one pass of 2k
    nodes, so k is capped at 21 instead of 42."""
    f, n = bins_t.shape
    dev = bins_t.device
    b = num_bins
    num_leaves = opts.num_leaves
    m = 2 * num_leaves - 1
    max_depth = opts.max_depth if (opts.max_depth and opts.max_depth > 0) else m
    acc_bytes = uh.histogram_acc_dtype(n, u is not None and noise is not None).itemsize
    use_sub = (
        opts.histogram_subtraction
        and max(1, opts.num_class) * m * f * b * 3 * acc_bytes <= SUBTRACTION_CACHE_BYTES
    )
    k = max(1, min(opts.leaf_batch, num_leaves - 1, 42 if use_sub else 21))
    tree_stats = _tree_stats(grad, hess, count, noise) if u is not None else None

    def packed(key, num_nodes):
        stats.passes += 1
        return _packed_pass(bins_t, u, u_spec, grad, hess, count, key, num_nodes, b, tree_stats)

    def searchk(histk, totalsk, depthk):
        """Candidate searches for fresh children: depth-capped, NaN gains
        set to -inf so they can neither halt growth nor win."""
        s = _split_search(histk, totalsk, edges, feature_mask, opts)
        capped = torch.where(depthk >= max_depth, torch.full_like(s.gain, -math.inf), s.gain)
        capped = torch.where(torch.isnan(capped), torch.full_like(capped, -math.inf), capped)
        return s._replace(gain=capped)

    root_p, root_tp = packed(torch.zeros(n, dtype=torch.int32, device=dev), 1)
    root_hist, root_tot = _expand(root_p, root_tp, tree_stats)
    root = _split_search(root_hist, root_tot, edges, feature_mask, opts)

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
    if use_sub:
        # Packed-space cache, in the pass's accumulator dtype: subtraction
        # happens before dequantization.
        st["c_subR"] = torch.zeros(m, dtype=torch.bool, device=dev)
        st["c_subR"][0] = root.rcov[0] < root.lcov[0]
        st["leaf_hist"] = torch.zeros((m, f, b, 3), dtype=root_p.dtype, device=dev)
        st["leaf_tot"] = torch.zeros((m, 3), dtype=root_tp.dtype, device=dev)
        st["leaf_hist"][0] = root_p[0]
        st["leaf_tot"][0] = root_tp[0]

    # slot -> lane of the pass (-1: row's leaf does not split this pass)
    lane_of = torch.full((m,), -1, dtype=torch.int64, device=dev)
    n_splits = 0
    while n_splits < num_leaves - 1:
        # The pass's one sync: the frontier's cached gains, ordered
        # descending with ties by lower slot (stable sort), as lax.top_k.
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
        col = bins_t[sf[lc], torch.arange(n, device=dev)]
        right = col.long() > sb[lc]
        new_node = torch.where(
            active, torch.where(right, rslot[lc], lslot[lc]), node.long()
        ).to(torch.int32)
        out_of_range = torch.full_like(lane, 2 * k)

        if use_sub:
            small_r = st["c_subR"][top_l]  # (ka,) smaller child is RIGHT
            key = torch.where(active & (right == small_r[lc]), lane, out_of_range)
            hist_s, tot_s = packed(key.to(torch.int32), ka)
            hist_o = st["leaf_hist"][top_l] - hist_s
            tot_o = st["leaf_tot"][top_l] - tot_s
            sel = small_r[:, None, None, None]
            hist_lr = torch.cat([torch.where(sel, hist_o, hist_s),
                                 torch.where(sel, hist_s, hist_o)])
            tot_lr = torch.cat([torch.where(small_r[:, None], tot_o, tot_s),
                                torch.where(small_r[:, None], tot_s, tot_o)])
            hist_x, tot_x = _expand(hist_lr, tot_lr, tree_stats)
        else:
            key = torch.where(active, 2 * lane + right.long(), out_of_range)
            h2, t2 = _expand(*packed(key.to(torch.int32), 2 * ka), tree_stats)
            h2 = h2.reshape(ka, 2, f, b, 3)
            t2 = t2.reshape(ka, 2, 3)
            hist_x = torch.cat([h2[:, 0], h2[:, 1]])
            tot_x = torch.cat([t2[:, 0], t2[:, 1]])

        child_depth = st["depth"][top_l] + 1
        cs = searchk(hist_x, tot_x, torch.cat([child_depth, child_depth]))
        # (2ka,) fields: [left children | right children]

        both = torch.cat([lslot, rslot])
        if use_sub:
            st["leaf_hist"][both] = hist_lr
            st["leaf_tot"][both] = tot_lr
            st["c_subR"][both] = cs.rcov < cs.lcov
        st["node"] = new_node
        st["feat"][top_l] = sf
        st["bin"][top_l] = sb
        st["thr"][top_l] = sthr
        st["left"][top_l] = lslot
        st["right"][top_l] = rslot
        st["is_leaf"][top_l] = False
        st["is_leaf"][both] = True
        st["leaf_val"][both] = cs.value
        st["cover"][both] = cs.cover
        st["gain"][top_l] = torch.as_tensor(top_g[:ka], dtype=torch.float32, device=dev)
        st["depth"][both] = torch.cat([child_depth, child_depth])
        st["c_gain"][top_l] = -math.inf
        st["c_gain"][both] = cs.gain
        st["c_feat"][both] = cs.feat
        st["c_bin"][both] = cs.bin
        st["c_thr"][both] = cs.thr
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
    )


def quant_noise(seed: int, iteration: int, column: int, n: int, device) -> torch.Tensor:
    """(2, n) float32 uniforms in [0, 1) for one tree's stochastic rounding
    (``ops.u_histogram.stat_rows_quant``; row 0 for g, row 1 for h). One draw
    per (iteration, margin column), from a ``torch.Generator`` seeded from
    ``(seed ^ 0x51AB51AB, iteration, column)``, so a quantized fit repeats
    run to run. The reference folds the same triple into ``jax.random`` keys;
    the two generators give different numbers."""
    words = np.random.SeedSequence(
        [(seed ^ 0x51AB51AB) & 0xFFFFFFFFFFFFFFFF, iteration, column]
    ).generate_state(2, np.uint32)
    gen = torch.Generator(device=device)
    gen.manual_seed((int(words[0]) << 32) | int(words[1]))
    return torch.rand((2, n), generator=gen, device=device, dtype=torch.float32)


def _make_step(opts: TrainOptions, num_bins: int, stats: FitStats, u=None, u_spec=None,
               quant: bool = False):
    """One boosting iteration (gbdt): gradients, one tree, margin update."""
    objective = get_objective(opts.objective)

    def step(bins_t, y, w, margins, edges, feature_mask, it):
        grad, hess = objective.grad_hess(margins, y, w)  # (N, 1)
        count = torch.ones_like(y)
        noise = quant_noise(opts.seed, it, 0, y.shape[0], y.device) if quant else None
        tree = _build_tree_leafwise(
            bins_t, grad[:, 0].contiguous(), hess[:, 0].contiguous(), count, edges,
            feature_mask, num_bins=num_bins, opts=opts, stats=stats, u=u, u_spec=u_spec,
            noise=noise,
        )
        stats.trees += 1
        contrib = tree.leaf_val[tree.row_leaf.long()]
        return tree, margins + contrib[:, None]

    return step


def _histogram_path(opts: TrainOptions, n: int, f: int, num_bins: int,
                    mapper: Optional[BinMapper]):
    """The U spec (None: the compare-built path) and whether the stats are
    quantized, by the reference's rules: U only when ``histogram_method`` is
    "u" (the reference also picks it by itself on a TPU), chunked rows when
    the resident U would pass the U budget; quantized stats only on the U
    path and up to :data:`QUANT_ROW_CAP` rows, else a warning and exact
    stats."""
    u_spec = None
    if opts.histogram_method == "u":
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


def train(
    bins: np.ndarray,  # (N, F) uint8
    y: np.ndarray,
    opts: TrainOptions,
    w: Optional[np.ndarray] = None,
    mapper: Optional[BinMapper] = None,
    feature_names: Optional[List[str]] = None,
    device: DeviceLike = None,
) -> TrainResult:
    """Run boosting on ``device`` (CUDA unless ``device='cpu'``)."""
    check_supported(opts)
    dev = resolve_device(device)
    t0 = time.perf_counter()
    objective = get_objective(opts.objective)
    num_classes = objective.num_outputs_fn(opts.num_class)
    n, f = bins.shape
    num_bins = opts.max_bin + 1  # + missing bin

    w_np = np.ones(n, dtype=np.float32) if w is None else np.asarray(w, dtype=np.float32)
    y_np = np.asarray(y, dtype=np.float32)
    if opts.boost_from_average:
        init_score = objective.init_score(y_np, num_classes, w_np)
    else:
        init_score = np.zeros(num_classes, dtype=np.float32)

    if mapper is not None:
        edges = np.where(np.isfinite(mapper.edges), mapper.edges,
                         np.float32(np.finfo(np.float32).max))
    else:
        edges = np.zeros((f, 1))
    edges_dev = torch.as_tensor(edges.astype(np.float32), device=dev)
    # Feature-major uint8 bins, laid out once per fit on the device: the
    # kernel's rows are then contiguous per feature, and routing gathers
    # whole rows of it.
    bins_t = torch.as_tensor(np.asarray(bins, dtype=np.uint8), device=dev).t().contiguous()
    y_dev = torch.as_tensor(y_np, device=dev)
    w_dev = torch.as_tensor(w_np, device=dev)
    margins = torch.as_tensor(init_score, device=dev)[None, :].expand(n, num_classes).clone()
    feature_mask = torch.ones(f, dtype=torch.float32, device=dev)

    stats = FitStats()
    u_spec, quant = _histogram_path(opts, n, f, num_bins, mapper)
    u = None
    if u_spec is not None:
        # Built once per fit: the resident one-hot, or the chunked pass's
        # bins layout.
        t_u = time.perf_counter()
        u = uh.prepare_chunked_bins(bins_t, u_spec) if u_spec.chunk_rows else uh.build_u(
            bins_t, u_spec)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        stats.u_build_seconds = time.perf_counter() - t_u
        stats.histogram_path = "u_chunked" if u_spec.chunk_rows else "u"
        stats.u_chunks = uh.num_u_chunks(n, u_spec)
    stats.quantized = quant
    step = _make_step(opts, num_bins, stats, u=u, u_spec=u_spec, quant=quant)
    trees = []
    for it in range(opts.num_iterations):
        tree, margins = step(bins_t, y_dev, w_dev, margins, edges_dev, feature_mask, it)
        trees.append(tree._replace(row_leaf=None))
    booster = _pack_booster(trees, opts, num_classes, init_score, mapper, feature_names)
    stats.syncs += 1  # the packing fetch
    stats.boost_seconds = time.perf_counter() - t0 - stats.u_build_seconds
    return TrainResult(booster=booster, stats=stats)


def _pack_booster(
    trees: List[TreeArrays],
    opts: TrainOptions,
    num_classes: int,
    init_score: np.ndarray,
    mapper: Optional[BinMapper],
    feature_names: Optional[List[str]] = None,
) -> Booster:
    """Per-tree device arrays -> one host :class:`Booster` (one fetch)."""
    fields = ("feat", "bin", "thr", "left", "right", "is_leaf", "leaf_val", "cover", "gain")
    if trees:
        packed = torch.stack([
            torch.stack([getattr(tr, fld).to(torch.float32) for tr in trees])
            for fld in fields
        ]).cpu().numpy()
    else:
        packed = np.zeros((len(fields), 0, opts.num_nodes), np.float32)

    def stack(field, dtype):
        return packed[fields.index(field)].astype(dtype)

    left = stack("left", np.int32)
    right = stack("right", np.int32)
    is_leaf = stack("is_leaf", bool)
    return Booster(
        split_feature=stack("feat", np.int32),
        split_bin=stack("bin", np.int32),
        split_threshold=stack("thr", np.float32),
        left_child=left,
        right_child=right,
        is_leaf=is_leaf,
        leaf_values=stack("leaf_val", np.float32),
        cover=stack("cover", np.float32),
        split_gain=stack("gain", np.float32),
        init_score=np.asarray(init_score, dtype=np.float32),
        num_classes=num_classes,
        objective=opts.objective,
        max_depth=_realized_depth(left, right, is_leaf, opts.routing_steps),
        best_iteration=-1,
        feature_names=feature_names,
        bin_edges=None if mapper is None else mapper.edges,
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
