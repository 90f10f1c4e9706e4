"""GBDT training loop: leafwise (LightGBM best-first) growth on the device.

The port's counterpart of ``mmlspark_tpu/lightgbm/train.py`` for the
flagship path: gbdt boosting, leafwise growth with ``leaf_batch`` frontier
leaves per histogram pass, sibling histogram subtraction, numeric features.
Each iteration:

  gradients -> histogram pass(es) on the Hopper kernel -> split search over
  the (node, feature, bin) lattice -> row routing -> leaf values -> margins.

PyTorch runs eagerly, so the reference's ``lax.while_loop`` over passes is a
host loop: each pass reads the frontier's candidate gains to the host once
(one device sync), which decides both whether the loop goes on and which
leaves split. :class:`FitStats` counts those syncs.

Not ported yet: depthwise growth, multiclass, rf/dart/goss, bagging and
feature fraction, categorical splits, feature bundling, the precomputed-U
and quantized histogram paths, validation sets, callbacks and meshes.
"""

from __future__ import annotations

import dataclasses
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
    "use_quantized_grad": False,
    "histogram_subtraction": True,
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
    if opts.histogram_method not in (None, "pallas"):
        raise NotImplementedError(f"histogram_method={opts.histogram_method!r} is not ported")
    if opts.max_bin + 1 > 256:
        raise NotImplementedError("max_bin > 255 is not ported (bins are uint8)")
    get_objective(opts.objective)


@dataclasses.dataclass
class FitStats:
    """What one fit did, counted on the host: trees, histogram passes, the
    host syncs the grower paid (one per pass that splits or stops growth,
    plus the final fetch), and wall seconds of boosting (device upload to
    the packed booster) and of the host binning before it, where the caller
    binned."""

    trees: int = 0
    passes: int = 0
    syncs: int = 0
    boost_seconds: float = 0.0
    binning_seconds: float = 0.0


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


def _histograms(bins_t, grad, hess, count, key, num_nodes, num_bins):
    """One histogram pass and its per-node totals (feature 0 covers every
    row of a node)."""
    h = histogram.build_histograms(bins_t, grad, hess, count, key, num_nodes, num_bins)
    return h, h[:, 0].sum(dim=1)


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
) -> TreeArrays:
    """Best-first growth, ``leaf_batch`` frontier leaves per histogram pass,
    with the reference's semantics: the top-k frontier leaves by cached gain
    (descending, ties by lower slot) split together; the j-th split overall
    creates slots 2j+1 and 2j+2; only the smaller child of each split is
    histogrammed (key = lane for its rows, ``2k`` elsewhere) and the sibling
    is the parent's cached histogram minus it."""
    f, n = bins_t.shape
    dev = bins_t.device
    b = num_bins
    num_leaves = opts.num_leaves
    m = 2 * num_leaves - 1
    max_depth = opts.max_depth if (opts.max_depth and opts.max_depth > 0) else m
    k = max(1, min(opts.leaf_batch, num_leaves - 1, 42))

    def searchk(histk, totalsk, depthk):
        """Candidate searches for fresh children: depth-capped, NaN gains
        set to -inf so they can neither halt growth nor win."""
        s = _split_search(histk, totalsk, edges, feature_mask, opts)
        capped = torch.where(depthk >= max_depth, torch.full_like(s.gain, -math.inf), s.gain)
        capped = torch.where(torch.isnan(capped), torch.full_like(capped, -math.inf), capped)
        return s._replace(gain=capped)

    root_hist, root_tot = _histograms(
        bins_t, grad, hess, count, torch.zeros(n, dtype=torch.int32, device=dev), 1, b
    )
    stats.passes += 1
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
        c_subR=torch.zeros(m, dtype=torch.bool, device=dev),
        leaf_hist=torch.zeros((m, f, b, 3), dtype=torch.float32, device=dev),
        leaf_tot=torch.zeros((m, 3), dtype=torch.float32, device=dev),
    )
    st["is_leaf"][0] = True
    st["leaf_val"][0] = root.value[0]
    st["cover"][0] = root.cover[0]
    st["c_gain"][0] = torch.nan_to_num(root.gain[0], nan=-math.inf, posinf=math.inf,
                                       neginf=-math.inf)
    st["c_feat"][0] = root.feat[0]
    st["c_bin"][0] = root.bin[0]
    st["c_thr"][0] = root.thr[0]
    st["c_subR"][0] = root.rcov[0] < root.lcov[0]
    st["leaf_hist"][0] = root_hist[0]
    st["leaf_tot"][0] = root_tot[0]

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
        small_r = st["c_subR"][top_l]  # (ka,) smaller child is RIGHT

        # Route the splitting leaves' rows and key the smaller children:
        # one lookup from a row's slot to its lane replaces the reference's
        # unrolled per-lane sweep (leaves are distinct, so a row has at most
        # one lane).
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
        key = torch.where(
            active & (right == small_r[lc]), lane, torch.full_like(lane, 2 * k)
        ).to(torch.int32)

        hist_s, tot_s = _histograms(bins_t, grad, hess, count, key, ka, b)
        stats.passes += 1
        hist_o = st["leaf_hist"][top_l] - hist_s
        tot_o = st["leaf_tot"][top_l] - tot_s
        sel = small_r[:, None, None, None]
        hist_l = torch.where(sel, hist_o, hist_s)
        hist_r = torch.where(sel, hist_s, hist_o)
        tot_l = torch.where(small_r[:, None], tot_o, tot_s)
        tot_r = torch.where(small_r[:, None], tot_s, tot_o)

        child_depth = st["depth"][top_l] + 1
        cs = searchk(
            torch.cat([hist_l, hist_r]),
            torch.cat([tot_l, tot_r]),
            torch.cat([child_depth, child_depth]),
        )  # (2ka,) fields: [left children | right children]

        both = torch.cat([lslot, rslot])
        st["leaf_hist"][both] = torch.cat([hist_l, hist_r])
        st["leaf_tot"][both] = torch.cat([tot_l, tot_r])
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


def _make_step(opts: TrainOptions, num_bins: int, stats: FitStats):
    """One boosting iteration (gbdt): gradients, one tree, margin update."""
    objective = get_objective(opts.objective)

    def step(bins_t, y, w, margins, edges, feature_mask):
        grad, hess = objective.grad_hess(margins, y, w)  # (N, 1)
        count = torch.ones_like(y)
        tree = _build_tree_leafwise(
            bins_t, grad[:, 0].contiguous(), hess[:, 0].contiguous(), count, edges,
            feature_mask, num_bins=num_bins, opts=opts, stats=stats,
        )
        stats.trees += 1
        contrib = tree.leaf_val[tree.row_leaf.long()]
        return tree, margins + contrib[:, None]

    return step


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
    step = _make_step(opts, num_bins, stats)
    trees = []
    for _ in range(opts.num_iterations):
        tree, margins = step(bins_t, y_dev, w_dev, margins, edges_dev, feature_mask)
        trees.append(tree._replace(row_leaf=None))
    booster = _pack_booster(trees, opts, num_classes, init_score, mapper, feature_names)
    stats.syncs += 1  # the packing fetch
    stats.boost_seconds = time.perf_counter() - t0
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
