"""Path-dependent TreeSHAP for pointer-layout boosters.

The port's counterpart of ``mmlspark_tpu/lightgbm/shap.py`` (LightGBM's
``predict_contrib``, Lundberg et al.'s polynomial-time algorithm), vectorized
over rows as the reference's is: the cold-path cover fractions *z* are the
same for every row and stay Python floats; the hot-path fractions *o* and
the permutation weights *w* depend on each row's path and are (N,) float64
tensors on the booster's device, so one recursion over a tree's nodes
explains every row at once. Each row's decision at each node is the
predict path's (float32 compare against the thresholds snapped down to
float32, NaN and zero-as-missing directions, categorical left sets), so the
values add up to the margin.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from mmlspark_tpu_torch.device import DeviceLike, resolve_device
from mmlspark_tpu_torch.lightgbm.booster import (
    K_ZERO_THRESHOLD,
    _cat_lookup,
    _cat_to_bins,
    _thr_f32,
)


def tree_shap(booster, X: np.ndarray, num_iteration: Optional[int] = None,
              device: DeviceLike = None) -> np.ndarray:
    """(N, C, F+1) float64: per-feature SHAP values plus the bias term (last
    column), on ``device``; ``out.sum(-1)`` equals ``booster.raw_margin(X)``
    up to float tolerance."""
    dev = resolve_device(device)
    t_used = booster._used_trees(num_iteration)
    n, f = X.shape
    c = booster.num_classes
    has_cat = booster.has_categorical
    xd = torch.tensor(np.asarray(X, np.float64), device=dev)
    if has_cat:  # categorical columns -> value-bin ids, as predict reads them
        for j, sv, order in _cat_lookup(booster, dev):
            xd[:, j] = _cat_to_bins(xd[:, j].contiguous(), sv, order)
    x32 = xd.to(torch.float32)
    phi = torch.zeros((n, c, f + 1), dtype=torch.float64, device=dev)
    phi[:, :, f] += torch.as_tensor(np.asarray(booster.init_score, np.float64), device=dev)
    for t in range(t_used):
        contrib, bias = _shap_one_tree(
            booster.split_feature[t], booster.split_threshold[t], booster.left_child[t],
            booster.right_child[t], booster.is_leaf[t], booster.leaf_values[t],
            booster.cover[t], x32,
            nan_left=None if booster.nan_left is None else booster.nan_left[t],
            cat_node=booster.cat_nodes[t] if has_cat else None,
            cat_mask=booster.cat_masks[t] if has_cat else None,
            zero_missing=None if booster.zero_missing is None else booster.zero_missing[t],
        )
        cls = t % c
        phi[:, cls, :f] += contrib
        phi[:, cls, f] += bias
    return phi.cpu().numpy()


def _goes_left(feat, thr, x32, nan_left, cat_node, cat_mask, zero_missing) -> torch.Tensor:
    """(N, M) bool: each row's decision at each node slot, the predict
    path's rule."""
    dev = x32.device
    m = len(feat)
    xv = x32[:, torch.as_tensor(np.asarray(feat, np.int64), device=dev)]
    nl = torch.as_tensor(np.ones(m, bool) if nan_left is None else np.asarray(nan_left, bool),
                         device=dev)
    miss = torch.isnan(xv)
    if zero_missing is not None and np.any(zero_missing):
        zm = torch.as_tensor(np.asarray(zero_missing, bool), device=dev)
        miss = miss | (zm[None, :] & (xv.abs() <= K_ZERO_THRESHOLD))
    thr32 = torch.as_tensor(_thr_f32(thr), device=dev)
    left = torch.where(miss, nl[None, :], xv <= thr32[None, :])
    if cat_node is not None and np.any(cat_node):
        bc = cat_mask.shape[-1]
        xb = torch.nan_to_num(xv, nan=0.0).clamp(0, bc - 1).to(torch.int64)
        cm = torch.as_tensor(np.asarray(cat_mask, bool), device=dev)
        left_cat = cm[torch.arange(m, device=dev)[None, :], xb]
        left = torch.where(torch.as_tensor(np.asarray(cat_node, bool), device=dev)[None, :],
                           left_cat, left)
    return left


def _shap_one_tree(feat, thr, left, right, is_leaf, leaf_val, cover, x32, nan_left=None,
                   cat_node=None, cat_mask=None, zero_missing=None):
    """(N, F) float64 contributions of one tree and its bias (the expected
    value over the training covers)."""
    n, num_features = x32.shape
    dev = x32.device
    f64 = torch.float64
    phi = torch.zeros((n, num_features), dtype=f64, device=dev)
    goes_left = _goes_left(feat, thr, x32, nan_left, cat_node, cat_mask, zero_missing)
    root_cover = max(float(cover[0]), 1e-12)
    # float32 products summed by numpy, as the reference's
    bias = float(np.sum(np.where(is_leaf, leaf_val * cover, 0.0)) / root_cover)

    def extend(d: List[int], z: List[float], o, w, pz: float, po, pi: int):
        p = len(d)
        d = d + [pi]
        z = z + [pz]
        o = torch.cat([o, po[:, None]], dim=1)
        w = torch.cat([w, torch.full((n, 1), 1.0 if p == 0 else 0.0, dtype=f64, device=dev)],
                      dim=1)
        for i in range(p - 1, -1, -1):
            w[:, i + 1] += po * w[:, i] * (i + 1) / (p + 1)
            w[:, i] = pz * w[:, i] * (p - i) / (p + 1)
        return d, z, o, w

    def unwind(d, z, o, w, i):
        p = len(d) - 1
        o_i = o[:, i]
        z_i = z[i]
        hot = o_i != 0.0
        o_safe = torch.where(hot, o_i, torch.ones_like(o_i))
        z_safe = z_i if z_i != 0.0 else 1.0
        nn = w[:, p].clone()
        w = w.clone()
        for j in range(p - 1, -1, -1):
            t_ = w[:, j].clone()
            w_hot = nn * (p + 1) / ((j + 1) * o_safe)
            nn_hot = t_ - w_hot * z_i * (p - j) / (p + 1)
            w_cold = t_ * (p + 1) / (z_safe * (p - j))
            w[:, j] = torch.where(hot, w_hot, w_cold)
            nn = torch.where(hot, nn_hot, nn)
        keep = [k for k in range(len(d)) if k != i]
        d = [d[k] for k in keep]
        z = [z[k] for k in keep]
        o = o[:, keep]
        w = w[:, :-1]
        return d, z, o, w

    def unwound_sum(z, o, w, i):
        p = len(z) - 1
        o_i = o[:, i]
        z_i = z[i]
        hot = o_i != 0.0
        o_safe = torch.where(hot, o_i, torch.ones_like(o_i))
        z_safe = z_i if z_i != 0.0 else 1.0
        total = torch.zeros(n, dtype=f64, device=dev)
        nn = w[:, p].clone()
        for j in range(p - 1, -1, -1):
            t_hot = nn * (p + 1) / ((j + 1) * o_safe)
            total += torch.where(hot, t_hot, w[:, j] * (p + 1) / (z_safe * (p - j)))
            nn = torch.where(hot, w[:, j] - t_hot * z_i * (p - j) / (p + 1), nn)
        return total

    def recurse(node: int, d, z, o, w, pz: float, po, pi: int):
        d, z, o, w = extend(d, z, o, w, pz, po, pi)
        if is_leaf[node]:
            v = float(leaf_val[node])
            for i in range(1, len(d)):
                s = unwound_sum(z, o, w, i)
                phi[:, d[i]] += s * (o[:, i] - z[i]) * v
            return
        split = int(feat[node])
        lc, rc = int(left[node]), int(right[node])
        cov = max(float(cover[node]), 1e-12)
        rl = float(cover[lc]) / cov
        rr = float(cover[rc]) / cov
        hot_left = goes_left[:, node]  # (N,) this row's hot child is the left one
        iz, io = 1.0, torch.ones(n, dtype=f64, device=dev)
        k = next((i for i in range(1, len(d)) if d[i] == split), -1)
        if k >= 0:
            iz, io = z[k], o[:, k].clone()
            d, z, o, w = unwind(d, z, o, w, k)
        zero = torch.zeros((), dtype=f64, device=dev)
        # left child: hot for rows going left, cold (o = 0) for the others
        if float(cover[lc]) > 0:
            recurse(lc, list(d), list(z), o.clone(), w.clone(), iz * rl,
                    torch.where(hot_left, io, zero), split)
        if float(cover[rc]) > 0:
            recurse(rc, list(d), list(z), o.clone(), w.clone(), iz * rr,
                    torch.where(hot_left, zero, io), split)

    empty = torch.empty((n, 0), dtype=f64, device=dev)
    recurse(0, [], [], empty, empty.clone(), 1.0, torch.ones(n, dtype=f64, device=dev), -1)
    return phi, bias
