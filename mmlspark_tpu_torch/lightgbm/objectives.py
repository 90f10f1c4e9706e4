"""Training objectives and evaluation metrics.

The port's copy of ``mmlspark_tpu/lightgbm/objectives.py``: binary,
multiclass softmax and the regression family (l2, l1, huber, quantile,
poisson, tweedie), with gradients and hessians in torch on the fit's device
and init scores and metrics in host numpy. Each objective's arithmetic is
the compiled reference's on XLA's CPU backend, bit for bit: its ``exp``
(:func:`xla_exp`) and the multiply-adds XLA fuses (tweedie). lambdarank is
built per fit by :mod:`~mmlspark_tpu_torch.lightgbm.ranker` and handed to
``train`` directly.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Tuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class Objective:
    name: str
    num_outputs_fn: Callable[[int], int]  # num_classes -> margin columns
    # (margins (N,C), y (N,), w (N,)) -> grad (N,C), hess (N,C)
    grad_hess: Callable[..., Tuple[torch.Tensor, torch.Tensor]]
    # (y, num_classes, w) -> init margin (C,)
    init_score: Callable[..., np.ndarray]
    default_metric: str


def _binary_grad_hess(margins, y, w, **kw):
    # the reference's compiled sigmoid, 1 / (1 + exp(-x)) with XLA's exp,
    # so that g and h are its bits (they feed the quantized stats)
    p = _flush(1.0 / (1.0 + xla_exp(-margins[:, 0])))
    g = _flush((p - y) * w)
    h = torch.clamp(p * (1.0 - p), min=1e-16) * w
    return g[:, None], h[:, None]


def _binary_init(y, num_classes, w):
    pos = float(np.sum(y * w))
    neg = float(np.sum(w)) - pos
    pos, neg = max(pos, 1e-12), max(neg, 1e-12)
    return np.array([np.log(pos / neg)], dtype=np.float32)


# float32 constants of the Cephes exp polynomial
_LOG2E = float(np.float32(1.44269504088896341))
_LN2_HI = float(np.float32(0.693359375))
_LN2_LO = float(np.float32(-2.12194440e-4))
_EXP_POLY = tuple(float(np.float32(c)) for c in (
    1.9875691500e-4, 1.3981999507e-3, 8.3334519073e-3, 4.1665795894e-2, 1.6666665459e-1,
    5.0000001201e-1))
_FLT_MIN = float(np.finfo(np.float32).tiny)


def _fma(a, b, c):
    """float32 ``a * b + c`` in one rounding, as a fused multiply-add: the
    float64 product of two float32 values is exact."""
    return (a.double() * b + c).to(torch.float32)


def xla_exp(x: torch.Tensor) -> torch.Tensor:
    """float32 ``exp(x)`` with the reference's bits: XLA's CPU exp is the
    Cephes polynomial with fused multiply-adds; it clamps the power of two to
    at most 2**127 (so ``exp`` stays finite up to log(FLT_MAX)) and flushes
    results below the smallest normal float32 to zero. The softmax, poisson
    and tweedie take it, so that their gradients are the reference's bit for
    bit on the CPU and the card alike."""
    x = torch.clamp(x.to(torch.float32), min=-88.0, max=88.8)
    fx = torch.clamp(torch.floor(_fma(x, _LOG2E, 0.5)), max=127.0)
    r = _fma(fx, -_LN2_HI, x.double())
    r = _fma(fx, -_LN2_LO, r.double())
    z = r * r
    y = torch.full_like(r, _EXP_POLY[0])
    for c in _EXP_POLY[1:]:
        y = _fma(y, r.double(), c)
    y = _fma(y, z.double(), r.double()) + 1.0
    return _flush(y * torch.pow(2.0, fx))


def _flush(x: torch.Tensor) -> torch.Tensor:
    """Subnormal float32 values to zero, as the reference's compiled CPU code
    runs with flush-to-zero."""
    return torch.where(x.abs() < _FLT_MIN, torch.zeros_like(x), x)


def row_sum(x: torch.Tensor) -> torch.Tensor:
    """(N, C) -> (N,): the columns added left to right in float32, the
    reference's reduction order."""
    acc = x[:, 0]
    for c in range(1, x.shape[1]):
        acc = acc + x[:, c]
    return acc


def _multiclass_grad_hess(margins, y, w, **kw):
    """Softmax cross-entropy: ``g = p - onehot(y)``, ``h = 2 p (1 - p)``
    (LightGBM's factor 2), each times the weight."""
    e = xla_exp(margins - margins.amax(dim=1, keepdim=True))
    p = _flush(e / row_sum(e)[:, None])
    onehot = torch.nn.functional.one_hot(y.long(), margins.shape[1]).to(p.dtype)
    g = _flush((p - onehot) * w[:, None])
    h = torch.clamp(2.0 * p * (1.0 - p), min=1e-16) * w[:, None]
    return g, h


def _multiclass_init(y, num_classes, w):
    counts = np.array([np.sum(w[np.asarray(y) == c]) for c in range(num_classes)],
                      dtype=np.float64)
    probs = np.maximum(counts / max(counts.sum(), 1e-12), 1e-12)
    return np.log(probs).astype(np.float32)


def _ones_hess(g, w):
    return (w * torch.ones_like(g))[:, None]


def _l2_grad_hess(margins, y, w, **kw):
    g = (margins[:, 0] - y) * w
    return g[:, None], _ones_hess(g, w)


def _l2_init(y, num_classes, w):
    return np.array([np.average(y, weights=w)], dtype=np.float32)


def _l1_grad_hess(margins, y, w, **kw):
    g = torch.sign(margins[:, 0] - y) * w
    return g[:, None], _ones_hess(g, w)


def _huber_grad_hess(margins, y, w, alpha=0.9, **kw):
    """The reference's huber: ``clip(d, -alpha, alpha)`` with hessian ``w``."""
    g = torch.clamp(margins[:, 0] - y, -alpha, alpha) * w
    return g[:, None], _ones_hess(g, w)


def _quantile_grad_hess(margins, y, w, alpha=0.9, **kw):
    # 1.0 - alpha rounds as the reference's: a Python double, then float32
    d = margins[:, 0] - y
    g = torch.where(d >= 0, 1.0 - alpha, -alpha).to(d.dtype) * w
    return g[:, None], _ones_hess(g, w)


def _poisson_grad_hess(margins, y, w, **kw):
    mu = xla_exp(margins[:, 0])
    g = (mu - y) * w
    h = torch.clamp(mu, min=1e-16) * w
    return g[:, None], h[:, None]


def _poisson_init(y, num_classes, w):
    return np.array([np.log(max(np.average(y, weights=w), 1e-12))], dtype=np.float32)


def _tweedie_grad_hess(margins, y, w, tweedie_variance_power=1.5, **kw):
    """``g = -y e^((1-rho) m) + e^((2-rho) m)``, ``h = -a (1-rho) + b
    (2-rho)``; XLA contracts ``-y * ea + b`` and ``b * (2-rho) + ...`` into
    fused multiply-adds, and so does this copy."""
    rho = tweedie_variance_power
    m = margins[:, 0]
    ea = xla_exp((1.0 - rho) * m)
    b = xla_exp((2.0 - rho) * m)
    a = y * ea
    g = _fma(-y, ea.double(), b.double()) * w
    c2 = float(np.float32(2.0 - rho))
    h = torch.clamp(_fma(b, c2, (-a * (1.0 - rho)).double()), min=1e-16) * w
    return g[:, None], h[:, None]


OBJECTIVES: Dict[str, Objective] = {
    "binary": Objective("binary", lambda c: 1, _binary_grad_hess, _binary_init, "auc"),
    "multiclass": Objective("multiclass", lambda c: c, _multiclass_grad_hess, _multiclass_init,
                            "multi_logloss"),
    "regression": Objective("regression", lambda c: 1, _l2_grad_hess, _l2_init, "l2"),
    "regression_l1": Objective("regression_l1", lambda c: 1, _l1_grad_hess, _l2_init, "l1"),
    "huber": Objective("huber", lambda c: 1, _huber_grad_hess, _l2_init, "l2"),
    "quantile": Objective("quantile", lambda c: 1, _quantile_grad_hess, _l2_init, "quantile"),
    "poisson": Objective("poisson", lambda c: 1, _poisson_grad_hess, _poisson_init, "poisson"),
    "tweedie": Objective("tweedie", lambda c: 1, _tweedie_grad_hess, _poisson_init, "tweedie"),
}

# LightGBM objective aliases (TrainParams.scala objective strings).
_ALIASES = {"l2": "regression", "mean_squared_error": "regression", "mse": "regression",
            "l1": "regression_l1", "mae": "regression_l1"}


def get_objective(name: str) -> Objective:
    name = _ALIASES.get(name, name)
    if name not in OBJECTIVES:
        raise ValueError(f"unknown objective {name!r}; known: {sorted(OBJECTIVES)} (lambdarank: "
                         "LightGBMRanker, or train(objective=ranker.make_lambdarank_objective(...)))")
    return OBJECTIVES[name]


# ---------------------------------------------------------------------------
# Metrics (host-side numpy)
# ---------------------------------------------------------------------------


def auc(y: np.ndarray, score: np.ndarray, w: np.ndarray) -> float:
    """Weighted ROC AUC with ties averaged over equal-score groups."""
    order = np.argsort(score, kind="stable")
    y, w = np.asarray(y, dtype=np.float64)[order], np.asarray(w, dtype=np.float64)[order]
    score = np.asarray(score)[order]
    pos_w = y * w
    neg_w = (1.0 - y) * w
    total_pos, total_neg = pos_w.sum(), neg_w.sum()
    if total_pos == 0 or total_neg == 0:
        return 0.5
    # group boundaries of equal scores; each group's positives rank above
    # the negatives before it and tie with half of its own negatives
    starts = np.flatnonzero(np.r_[True, score[1:] != score[:-1]])
    grp_pos = np.add.reduceat(pos_w, starts)
    grp_neg = np.add.reduceat(neg_w, starts)
    prev_neg = np.cumsum(grp_neg) - grp_neg
    auc_sum = float(np.sum(grp_pos * (prev_neg + grp_neg / 2.0)))
    return float(auc_sum / (total_pos * total_neg))


def binary_logloss(y, margin, w):
    p = np.clip(1.0 / (1.0 + np.exp(-margin)), 1e-15, 1 - 1e-15)
    return float(np.average(-(y * np.log(p) + (1 - y) * np.log(1 - p)), weights=w))


def multi_logloss(y, margins, w):
    m = margins - margins.max(axis=1, keepdims=True)
    logp = m - np.log(np.exp(m).sum(axis=1, keepdims=True))
    ll = logp[np.arange(len(y)), np.asarray(y, dtype=int)]
    return float(np.average(-ll, weights=w))


def multi_error(y, margins, w):
    pred = margins.argmax(axis=1)
    return float(np.average(pred != np.asarray(y, dtype=int), weights=w))


def binary_error(y, margin, w):
    return float(np.average((margin > 0) != (y > 0.5), weights=w))


def l2_loss(y, pred, w):
    return float(np.average((pred - y) ** 2, weights=w))


def rmse(y, pred, w):
    return float(np.sqrt(l2_loss(y, pred, w)))


def l1_loss(y, pred, w):
    return float(np.average(np.abs(pred - y), weights=w))


def quantile_loss(y, pred, w, alpha=0.9):
    d = y - pred
    return float(np.average(np.maximum(alpha * d, (alpha - 1) * d), weights=w))


#: metric name -> (fn(y, score_or_margin, w), higher_is_better): the
#: reference's metrics.
METRICS = {
    "auc": (auc, True),
    "binary_logloss": (binary_logloss, False),
    "binary_error": (binary_error, False),
    "multi_logloss": (multi_logloss, False),
    "multi_error": (multi_error, False),
    "l2": (l2_loss, False),
    "mse": (l2_loss, False),
    "rmse": (rmse, False),
    "l1": (l1_loss, False),
    "mae": (l1_loss, False),
    "quantile": (quantile_loss, False),
    "poisson": (l2_loss, False),  # l2, on the margin or response scale (train._margin_to_score)
    "tweedie": (l2_loss, False),
}


def metric_higher_is_better(name: str) -> bool:
    if name in METRICS:
        return METRICS[name][1]
    # ndcg@k / map@k style names maximize (TrainUtils.scala:283-287)
    return name.split("@")[0] in ("auc", "ndcg", "map")
