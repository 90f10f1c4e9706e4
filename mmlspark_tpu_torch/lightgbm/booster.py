"""Booster: the trained forest, with batch predict on the device and serde.

The port's counterpart of ``mmlspark_tpu/lightgbm/booster.py``, with the same
pointer-based tree layout (per tree, ``M`` node slots; forest arrays stacked
as (num_trees, M), tree ``i*C + c`` = iteration i, class c):

- ``split_feature``   (T, M) int32   — internal nodes; 0 at leaves/dead slots
- ``split_threshold`` (T, M) float   — raw-value "go left if NaN or x <= t"
- ``split_bin``       (T, M) int32   — binned-space threshold
- ``left_child`` / ``right_child`` (T, M) int32 — slot indices
- ``is_leaf``         (T, M) bool
- ``leaf_values``     (T, M) float32 — learning-rate-scaled leaf outputs
- ``cover``           (T, M) float32 — training rows through the node
- ``split_gain``      (T, M) float32 — realized gain

:meth:`Booster.raw_margin` routes every row through every tree at once with
plain torch gathers, ``max_depth`` rounds (the reference predicts through a
path-matrix product; neither is a kernel). At a categorical node a row goes
left iff its category's value bin is in the node's left set; unseen and NaN
categories take bin 0, which no left set holds, so they go right.
:meth:`Booster.predict_leaf` returns the routed slots, linear-tree models
evaluate their leaf models on the host after routing, and
:meth:`Booster.features_shap` runs TreeSHAP (``shap.py``). Each takes dense
rows or a :class:`~mmlspark_tpu_torch.data.sparse.CSRMatrix`, which is
densified at the trained width in row chunks of at most 256 MB.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, Optional

import numpy as np
import torch

from mmlspark_tpu_torch.data.sparse import CSRMatrix
from mmlspark_tpu_torch.device import DeviceLike, resolve_device

#: LightGBM's kZeroThreshold: |x| <= this counts as zero (zero_as_missing).
K_ZERO_THRESHOLD = 1e-35

#: Bytes of routing transients one predict chunk may hold.
_PREDICT_CHUNK_BYTES = 256 << 20


@dataclasses.dataclass
class Booster:
    split_feature: np.ndarray  # (T, M) int32
    split_threshold: np.ndarray  # (T, M) float32 (float64 on imported models)
    split_bin: np.ndarray  # (T, M) int32
    left_child: np.ndarray  # (T, M) int32
    right_child: np.ndarray  # (T, M) int32
    is_leaf: np.ndarray  # (T, M) bool
    leaf_values: np.ndarray  # (T, M) float32
    init_score: np.ndarray  # (C,)
    num_classes: int  # margin columns C
    objective: str
    max_depth: int  # routing steps (>= realized depth of every tree)
    cover: Optional[np.ndarray] = None  # (T, M) float32
    split_gain: Optional[np.ndarray] = None  # (T, M) float32
    best_iteration: int = -1  # -1 = use all
    feature_names: Optional[list] = None
    bin_edges: Optional[np.ndarray] = None  # (F, max_bin-1)
    # (T, M) bool: where a NaN routes at each node (None = always left)
    nan_left: Optional[np.ndarray] = None
    # Categorical splits: cat_nodes (T, M) marks categorical decisions,
    # cat_masks (T, M, Bc) is each one's left set over value bins, and
    # cat_values maps a feature to its raw category values (bin i+1 <->
    # values[i]). zero_missing (T, M): zero_as_missing nodes. Linear leaves
    # (imported linear_tree models): at slot m the output is leaf_const +
    # sum_l leaf_coeff[l] * x[leaf_feat[l]] (leaf_feat -1 pads), or the
    # plain leaf value where a feature it reads is NaN.
    cat_nodes: Optional[np.ndarray] = None
    cat_masks: Optional[np.ndarray] = None
    cat_values: Optional[Dict[int, np.ndarray]] = None
    zero_missing: Optional[np.ndarray] = None
    leaf_const: Optional[np.ndarray] = None
    leaf_coeff: Optional[np.ndarray] = None
    leaf_feat: Optional[np.ndarray] = None

    @property
    def has_categorical(self) -> bool:
        return self.cat_nodes is not None and bool(np.any(self.cat_nodes))

    @property
    def has_linear(self) -> bool:
        return self.leaf_const is not None

    @property
    def num_trees(self) -> int:
        return self.split_feature.shape[0]

    @property
    def num_features(self) -> int:
        if self.feature_names:
            return len(self.feature_names)
        if self.bin_edges is not None:
            return self.bin_edges.shape[0]
        internal = (~self.is_leaf) & np.isfinite(self.split_threshold)
        feats = self.split_feature[internal]
        return int(feats.max()) + 1 if feats.size else 0

    @property
    def num_iterations(self) -> int:
        return self.num_trees // self.num_classes

    def _used_trees(self, num_iteration: Optional[int] = None) -> int:
        it = num_iteration
        if it is None:
            it = self.best_iteration if self.best_iteration > 0 else self.num_iterations
        return min(it, self.num_iterations) * self.num_classes

    # -- predict -------------------------------------------------------------

    def _leaf_chunks(self, X, t: int, dev: torch.device):
        """Per chunk of rows of ``X``: the (n, t) final leaf slots of the
        first ``t`` trees on ``dev``, and the trees' tables."""
        has_cat = self.has_categorical
        tables = _tree_tables(self, t, dev, has_cat)
        cats = _cat_lookup(self, dev) if has_cat else ()
        chunk = max(1, _PREDICT_CHUNK_BYTES // (64 * t))
        for lo in range(0, max(X.shape[0], 1), chunk):
            if cats:
                # Raw category ids are read as float64 before they become
                # value bins, so ids above 2**24 are not rounded on the way.
                xd = torch.tensor(np.asarray(X[lo : lo + chunk], np.float64), device=dev)
                for f, sv, order in cats:
                    xd[:, f] = _cat_to_bins(xd[:, f].contiguous(), sv, order)
                xd = xd.to(torch.float32)
            else:
                xd = torch.as_tensor(np.asarray(X[lo : lo + chunk], np.float32), device=dev)
            yield _route_rows(xd, tables, self.max_depth), tables

    def raw_margin(self, X, num_iteration: Optional[int] = None,
                   device: DeviceLike = None) -> np.ndarray:
        """(N, C) raw margins (init_score + sum of tree outputs) of a dense
        (N, F) batch or a CSRMatrix, routed on ``device`` (CUDA unless
        ``device='cpu'``). Linear-tree boosters evaluate their leaf models
        in float64 on the host after routing (:meth:`_raw_margin_linear`)."""
        chunks = self._csr_chunks(
            X, np.float64 if self.has_categorical or self.has_linear else np.float32)
        if chunks is not None:
            return np.concatenate([self.raw_margin(c, num_iteration, device) for c in chunks])
        dev = resolve_device(device)
        X = np.asarray(X)
        n = X.shape[0]
        t = self._used_trees(num_iteration)
        if t == 0:
            return np.broadcast_to(self.init_score[None, :], (n, self.num_classes)).copy()
        if self.has_linear:
            return self._raw_margin_linear(X, num_iteration, dev)
        from mmlspark_tpu_torch.lightgbm.train import _chain_prefix

        init = torch.as_tensor(np.asarray(self.init_score, np.float32), device=dev)
        outs = []
        for leaf, tables in self._leaf_chunks(X, t, dev):
            contrib = torch.gather(tables["leaf_values"].expand(leaf.shape[0], -1, -1),
                                   2, leaf[:, :, None])[:, :, 0]
            # (rounds, rows, classes): the trees added one after another in
            # float32, one chain per row over the outer axis, so a row's
            # margin has the same bits on every device and in every chunk or
            # batch of rows (a reduction's order follows both)
            per_round = contrib.reshape(-1, t // self.num_classes, self.num_classes)
            per_round = per_round.transpose(0, 1).contiguous()
            m = _chain_prefix(per_round, 0)[-1]
            outs.append((m + init[None, :]).cpu().numpy())
        if not outs:
            return np.zeros((0, self.num_classes), np.float32)
        return np.concatenate(outs, axis=0)

    def predict_leaf(self, X, num_iteration: Optional[int] = None,
                     device: DeviceLike = None) -> np.ndarray:
        """(N, T) int32 final leaf slot of every row in every used tree
        (``predictLeaf``), routed on ``device``."""
        chunks = self._csr_chunks(X, np.float64 if self.has_categorical else np.float32)
        if chunks is not None:
            return np.concatenate([self.predict_leaf(c, num_iteration, device) for c in chunks])
        dev = resolve_device(device)
        X = np.asarray(X)
        t = self._used_trees(num_iteration)
        if t == 0:
            return np.zeros((X.shape[0], 0), np.int32)
        outs = [leaf.to(torch.int32).cpu().numpy() for leaf, _ in self._leaf_chunks(X, t, dev)]
        return np.concatenate(outs, axis=0) if outs else np.zeros((0, t), np.int32)

    def _raw_margin_linear(self, X: np.ndarray, num_iteration: Optional[int],
                           dev: torch.device) -> np.ndarray:
        """Margins of a linear-tree booster: leaf slots routed on ``dev``,
        then each leaf's model ``leaf_const + sum_l leaf_coeff * x`` in
        float64 on the host, in the reference's order of operations; a leaf
        whose model reads a NaN feature gives its plain leaf value (native
        LightGBM's fallback)."""
        slots = self.predict_leaf(X, num_iteration, device=dev)  # (N, T)
        t = slots.shape[1]
        Xd = np.asarray(X, np.float64)
        n = Xd.shape[0]
        tt = np.arange(t)[None, :]
        lmax = self.leaf_feat.shape[-1]
        out = np.empty((n, t), np.float64)
        chunk = max(1, (64 << 20) // max(8 * t * lmax, 1))
        for lo in range(0, max(n, 1), chunk):
            sl = slots[lo : lo + chunk]
            const = self.leaf_const[tt, sl]  # (n, T)
            coeff = self.leaf_coeff[tt, sl]  # (n, T, L)
            fidx = self.leaf_feat[tt, sl]  # (n, T, L)
            valid = fidx >= 0
            rows = np.arange(sl.shape[0])[:, None, None]
            xv = Xd[lo : lo + chunk][rows, np.maximum(fidx, 0)]
            nanf = np.any(valid & np.isnan(xv), axis=-1)
            lin = const + np.where(valid & ~np.isnan(xv), coeff * xv, 0.0).sum(axis=-1)
            plain = self.leaf_values[tt, sl].astype(np.float64)
            out[lo : lo + chunk] = np.where(nanf, plain, lin)
        rounds = t // self.num_classes
        margins = out.reshape(n, rounds, self.num_classes).sum(axis=1)
        return margins + np.asarray(self.init_score, np.float64)[None, :]

    def features_shap(self, X, num_iteration: Optional[int] = None,
                      device: DeviceLike = None) -> np.ndarray:
        """(N, C, F+1) float64 SHAP values per feature plus the bias (last
        column), path-dependent TreeSHAP over the training covers on
        ``device``; they add up to :meth:`raw_margin` (``featuresShap``)."""
        from mmlspark_tpu_torch.lightgbm.shap import tree_shap

        if self.has_linear:
            raise NotImplementedError(
                "SHAP values are not implemented for linear-tree models (leaf outputs are "
                "per-leaf linear functions, outside TreeSHAP's piecewise-constant contract)")
        chunks = self._csr_chunks(X, np.float64)
        if chunks is not None:
            return np.concatenate([self.features_shap(c, num_iteration, device) for c in chunks])
        return tree_shap(self, np.asarray(X, dtype=np.float64), num_iteration, device=device)

    def _csr_chunks(self, X, dtype, target_bytes: int = _PREDICT_CHUNK_BYTES):
        """None for dense input; for a CSRMatrix, its rows densified at the
        trained width in chunks of at most 65,536 rows and ``target_bytes``.
        A narrower matrix is padded with implicit zeros; an explicit index
        past the trained width raises. Categorical boosters densify in
        float64: a float32 detour would round category ids above 2**24
        before the value-identity match and route them as unseen."""
        if not isinstance(X, CSRMatrix):
            return None
        width = self.num_features
        if X.nnz and int(X.indices.max()) >= width:
            raise ValueError(f"sparse feature index {int(X.indices.max())} out of range for "
                             f"the booster's {width} trained features")
        X = CSRMatrix(X.data, X.indices, X.indptr, (X.num_rows, width))
        rows = min(65536, max(1, target_bytes // (np.dtype(dtype).itemsize * max(width, 1))))
        return (X.row_slice(lo, min(lo + rows, X.num_rows)).to_dense(dtype)
                for lo in range(0, max(X.num_rows, 1), rows))

    # -- serde ---------------------------------------------------------------

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "Booster":
        d = dict(d)
        for k in ("split_feature", "split_bin", "left_child", "right_child"):
            d[k] = np.asarray(d[k], dtype=np.int32)
        for k in ("leaf_values", "init_score"):
            d[k] = np.asarray(d[k], dtype=np.float32)
        thr = np.asarray(d["split_threshold"])
        d["split_threshold"] = thr.astype(
            np.float64 if thr.dtype == np.float64 else np.float32
        )
        d["is_leaf"] = np.asarray(d["is_leaf"], dtype=bool)
        for k in ("cover", "split_gain"):
            if d.get(k) is not None:
                d[k] = np.asarray(d[k], dtype=np.float32)
        for k in ("nan_left", "cat_nodes", "cat_masks", "zero_missing"):
            if d.get(k) is not None:
                d[k] = np.asarray(d[k], dtype=bool)
        if d.get("bin_edges") is not None:
            d["bin_edges"] = np.asarray(d["bin_edges"], dtype=np.float64)
        if d.get("cat_values") is not None:
            d["cat_values"] = {
                int(k): np.asarray(v, dtype=np.float64)
                for k, v in d["cat_values"].items()
            }
        for k, dt in (("leaf_const", np.float64), ("leaf_coeff", np.float64),
                      ("leaf_feat", np.int32)):
            if d.get(k) is not None:
                d[k] = np.asarray(d[k], dtype=dt)
        return Booster(**d)

    def model_to_string(self) -> str:
        """LightGBM model text (``saveNativeModel``); the init score is
        folded into the iteration-0 leaf values, as LightGBM's own
        boost_from_average does."""
        from mmlspark_tpu_torch.lightgbm.model_text import to_lightgbm_text

        return to_lightgbm_text(self)

    def to_json_string(self) -> str:
        """Lossless JSON dump, the reference's: every field with its dtype
        and shape (split bins, bin edges and the init score exactly)."""
        d = self.to_dict()
        for k, v in d.items():
            if isinstance(v, np.ndarray):
                d[k] = {"__nd__": v.tolist(), "dtype": str(v.dtype), "shape": v.shape}
        if d.get("cat_values") is not None:
            d["cat_values"] = {str(k): np.asarray(v).tolist() for k, v in d["cat_values"].items()}
        return json.dumps(d)

    @staticmethod
    def from_string(s: str) -> "Booster":
        """Parse either format: LightGBM model text (starts with ``tree``)
        or the JSON dump of :meth:`to_json_string`, written by either
        package."""
        if s.lstrip()[:16].startswith("tree"):
            from mmlspark_tpu_torch.lightgbm.model_text import from_lightgbm_text

            return from_lightgbm_text(s)
        d = json.loads(s)
        for k, v in list(d.items()):
            if isinstance(v, dict) and "__nd__" in v:
                d[k] = np.asarray(v["__nd__"], dtype=v["dtype"]).reshape(v["shape"])
        return Booster.from_dict(d)

    def feature_importances(self, importance_type: str = "split") -> np.ndarray:
        """Split-count or total-gain importance per feature."""
        internal = (~self.is_leaf) & np.isfinite(self.split_threshold)
        feats = self.split_feature[internal]
        num_features = self.num_features
        if importance_type == "gain":
            if self.split_gain is None:
                raise ValueError("importance_type='gain' requires split_gain")
            out = np.zeros(num_features, dtype=np.float64)
            np.add.at(out, feats.ravel(), self.split_gain[internal].ravel())
            return out
        if importance_type != "split":
            raise ValueError(f"unknown importance_type {importance_type!r}")
        return np.bincount(feats.ravel(), minlength=num_features).astype(np.float64)


def _thr_f32(thr) -> np.ndarray:
    """f64 thresholds -> the LARGEST f32 value <= each threshold, so that for
    f32 inputs ``x <= thr_f32`` decides as LightGBM's f64 ``x <= thr``."""
    thr = np.asarray(thr)
    if thr.dtype != np.float64:
        return thr.astype(np.float32)
    t32 = thr.astype(np.float32)
    over = t32.astype(np.float64) > thr
    if over.any():
        t32 = np.where(over, np.nextafter(t32, np.float32(-np.inf)), t32)
    return t32


def _tree_tables(b: Booster, t: int, dev: torch.device,
                 has_cat: bool = False) -> Dict[str, torch.Tensor]:
    """The first ``t`` trees' node tables on ``dev``, shaped (1, T, M) so
    they broadcast against an (N, T) node index; with categorical splits
    also the flat (T * M * Bc,) left-set table."""
    nan_left = b.nan_left if b.nan_left is not None else np.ones_like(b.is_leaf)
    zero_missing = (
        b.zero_missing if b.zero_missing is not None else np.zeros_like(b.is_leaf)
    )

    def put(a, dtype):
        return torch.as_tensor(np.ascontiguousarray(a[:t]), dtype=dtype, device=dev)[None]

    tables = {
        "feat": put(b.split_feature, torch.int64),
        "thr": put(_thr_f32(b.split_threshold), torch.float32),
        "left": put(b.left_child, torch.int64),
        "right": put(b.right_child, torch.int64),
        "is_leaf": put(b.is_leaf, torch.bool),
        "nan_left": put(nan_left, torch.bool),
        "zero_missing": put(zero_missing, torch.bool),
        "leaf_values": put(b.leaf_values, torch.float32),
    }
    if has_cat:
        tables["cat_node"] = put(b.cat_nodes, torch.bool)
        tables["cat_mask"] = torch.as_tensor(
            np.ascontiguousarray(b.cat_masks[:t]).reshape(-1), dtype=torch.bool, device=dev)
    return tables


def _cat_lookup(b: Booster, dev: torch.device):
    """Per categorical feature: (feature, its values sorted, float64; each
    sorted value's bin - 1), on ``dev``."""
    out = []
    for f, vals in sorted((b.cat_values or {}).items()):
        vals = np.asarray(vals, np.float64)
        order = np.argsort(vals, kind="stable")
        out.append((int(f), torch.as_tensor(vals[order], device=dev),
                    torch.as_tensor(order, dtype=torch.int64, device=dev)))
    return out


def _cat_to_bins(col: torch.Tensor, sv: torch.Tensor, order: torch.Tensor) -> torch.Tensor:
    """``binning.cat_to_bins`` on the device: value ``sv[i]`` -> bin
    ``order[i] + 1``; NaN, unseen and overflowed values -> bin 0."""
    if sv.numel() == 0:
        return torch.zeros_like(col)
    pos = torch.searchsorted(sv, col).clamp(max=sv.numel() - 1)
    return torch.where(sv[pos] == col, (order[pos] + 1).to(col.dtype), torch.zeros_like(col))


def _route_rows(X: torch.Tensor, tables: Dict[str, torch.Tensor], depth: int) -> torch.Tensor:
    """(N, T) final leaf slot of every row in every tree: ``depth`` rounds
    of gathers through the pointer arrays; rows at a leaf stay there."""
    n = X.shape[0]
    t, m = tables["feat"].shape[1:]
    node = torch.zeros((n, t), dtype=torch.int64, device=X.device)
    has_cat = "cat_mask" in tables
    if has_cat:
        bc = tables["cat_mask"].shape[0] // (t * m)
        tree_base = torch.arange(t, device=X.device)[None, :] * m

    def at(name):
        return torch.gather(tables[name].expand(n, -1, -1), 2, node[:, :, None])[:, :, 0]

    for _ in range(depth):
        x = torch.gather(X, 1, at("feat"))
        miss = torch.isnan(x) | (at("zero_missing") & (x.abs() <= K_ZERO_THRESHOLD))
        go_left = torch.where(miss, at("nan_left"), x <= at("thr"))
        if has_cat:
            # categorical columns hold value bins; bin 0 is in no left set
            xb = torch.nan_to_num(x, nan=0.0).clamp(0, bc - 1).to(torch.int64)
            left_cat = tables["cat_mask"][(tree_base + node) * bc + xb]
            go_left = torch.where(at("cat_node"), left_cat, go_left)
        nxt = torch.where(go_left, at("left"), at("right"))
        node = torch.where(at("is_leaf"), node, nxt)
    return node
