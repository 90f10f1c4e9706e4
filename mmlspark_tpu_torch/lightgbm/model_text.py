"""Native LightGBM model-text serde.

The port's copy of ``mmlspark_tpu/lightgbm/model_text.py`` (pure text and
numpy; kept as a copy so the port never imports the JAX package).

The reference's booster string IS LightGBM's text format — loadable by any
LightGBM runtime, ONNX converters, and SHAP tooling
(``lightgbm/LightGBMBooster.scala:277-310``; save/load API
``LightGBMClassifier.scala:172-194``). This module emits and parses that
format (model file ``version=v3``, the LightGBM 3.x layout) so boosters
trained here interoperate with the LightGBM ecosystem and models trained by
LightGBM score here.

Encoding notes (mirroring LightGBM's ``src/io/tree.cpp`` / ``gbdt_model_text.cpp``):

- A tree with L leaves has L-1 internal nodes. ``left_child``/``right_child``
  entries >= 0 index internal nodes; negative entries encode leaves as
  ``~leaf_index`` (i.e. leaf j is stored as -(j+1)).
- ``decision_type`` is a bit field: bit 0 = categorical, bit 1 =
  default_left, bits 2-3 = missing type (0 none, 1 zero, 2 NaN). Numeric
  nodes trained here always route NaN left: ``decision_type = 10``.
- Categorical splits (``num_cat > 0``): a cat node's ``threshold`` is an
  index into ``cat_boundaries`` (num_cat+1 cumulative uint32-word offsets)
  / ``cat_threshold`` (bitset words over RAW category values; value v in
  the left set iff word[v//32] has bit v%32). Export requires the
  category values be non-negative integers (LightGBM's own contract);
  NaN/unseen values route right on both engines.
- ``boost_from_average``: LightGBM has no init-score field — the init score
  lives inside the first iteration's leaf values. Export therefore folds
  ``init_score[c]`` into iteration-0 class-c leaf values; import leaves
  ``init_score = 0`` (the margins come out identical).
- Floats print with ``%.17g`` (round-trip exact for float64).

- Linear trees (``is_linear=1``, LightGBM's ``linear_tree=true``): per-leaf
  linear models import/export via ``leaf_const`` / ``num_features`` /
  ``leaf_features`` / ``leaf_coeff`` (concatenated in leaf order); predict
  evaluates them in float64 with native LightGBM's NaN fallback to the
  plain leaf output. SHAP on such models raises.

``missing_type=None`` imports with the LightGBM predictor's convention that
a NaN at such a node behaves like 0.0, which resolves to a static per-node
direction ``nan_left = (0.0 <= threshold)``; ``missing_type=Zero``
(``zero_as_missing=true``) imports as per-node ``zero_missing`` flags — a
0.0 or NaN value routes per ``default_left`` there.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

_G = "%.17g"


def _fmt(values) -> str:
    return " ".join(_G % float(v) for v in values)


def _fmt_int(values) -> str:
    return " ".join(str(int(v)) for v in values)


# Our objective names -> LightGBM model-file objective strings.
def _objective_str(objective: str, num_classes: int) -> str:
    if objective == "binary":
        return "binary sigmoid:1"
    if objective == "multiclass":
        return f"multiclass num_class:{num_classes}"
    return objective  # regression / regression_l1 / huber / quantile / poisson / tweedie


def _parse_objective(s: str) -> str:
    tok = s.split()
    return tok[0] if tok else "regression"


def to_lightgbm_text(booster, shrinkage: float = 1.0) -> str:
    """Serialize a :class:`~mmlspark_tpu_torch.lightgbm.booster.Booster` to
    LightGBM's model text. ``shrinkage`` is recorded per tree (informational:
    leaf values in the file are final, as LightGBM itself writes them)."""
    t = booster.num_trees
    c = booster.num_classes
    f = booster.num_features
    nan_left = getattr(booster, "nan_left", None)
    init = np.asarray(booster.init_score, dtype=np.float64)
    if t == 0 and np.any(init != 0):
        raise ValueError(
            "cannot export a zero-tree booster with nonzero init_score: "
            "LightGBM's format stores the init score inside the first "
            "iteration's leaf values"
        )

    cat_nodes_all = booster.cat_nodes
    cat_masks_all = booster.cat_masks
    cat_values_all = booster.cat_values or {}
    zero_missing_all = booster.zero_missing

    tree_strs: List[str] = []
    for ti in range(t):
        is_leaf = np.asarray(booster.is_leaf[ti], dtype=bool)
        left = np.asarray(booster.left_child[ti])
        right = np.asarray(booster.right_child[ti])
        feat = np.asarray(booster.split_feature[ti])
        thr = np.asarray(booster.split_threshold[ti], dtype=np.float64)
        cat_node = (
            np.asarray(cat_nodes_all[ti], bool)
            if cat_nodes_all is not None else np.zeros(len(feat), bool)
        )
        lval = np.asarray(booster.leaf_values[ti], dtype=np.float64)
        gain = (
            np.asarray(booster.split_gain[ti], dtype=np.float64)
            if booster.split_gain is not None
            else np.zeros(len(feat))
        )
        cover = (
            np.asarray(booster.cover[ti], dtype=np.float64)
            if booster.cover is not None
            else np.zeros(len(feat))
        )
        nl = (
            np.asarray(nan_left[ti], dtype=bool)
            if nan_left is not None
            else np.ones(len(feat), dtype=bool)
        )

        # init-score folding: iteration 0, class ti % c
        bias = float(init[ti % c]) if ti < c else 0.0

        # Walk reachable slots from the root, assigning LightGBM indices:
        # internal nodes and leaves each in pre-order discovery order.
        internal_ids = {}
        leaf_ids = {}
        order: List[int] = []
        stack = [0]
        while stack:
            slot = stack.pop()
            order.append(slot)
            if is_leaf[slot]:
                leaf_ids[slot] = len(leaf_ids)
                continue
            internal_ids[slot] = len(internal_ids)
            stack.append(int(right[slot]))
            stack.append(int(left[slot]))
        num_leaves = len(leaf_ids)
        ni = len(internal_ids)

        sf = np.zeros(ni, np.int64)
        sg = np.zeros(ni, np.float64)
        th = np.zeros(ni, np.float64)
        dt = np.zeros(ni, np.int64)
        lc = np.zeros(ni, np.int64)
        rc = np.zeros(ni, np.int64)
        ivalue = np.zeros(ni, np.float64)
        iw = np.zeros(ni, np.float64)  # float cover (weighted row mass)
        lv = np.zeros(max(num_leaves, 1), np.float64)
        lw = np.zeros(max(num_leaves, 1), np.float64)

        def child_ref(slot: int) -> int:
            return internal_ids[slot] if not is_leaf[slot] else ~leaf_ids[slot]

        # categorical nodes: threshold = index into cat_boundaries /
        # cat_threshold (bitsets over RAW category values, uint32 words)
        cat_boundaries = [0]
        cat_words: List[int] = []
        slot_by_ii = {ii: slot for slot, ii in internal_ids.items()}
        for slot in order:
            if is_leaf[slot]:
                li = leaf_ids[slot]
                lv[li] = lval[slot] + bias
                lw[li] = cover[slot]
                continue
            ii = internal_ids[slot]
            sf[ii] = int(feat[slot])
            sg[ii] = max(gain[slot], 0.0)
            th[ii] = thr[slot]
            # bit1 default_left per the node's NaN routing; bits2-3 =
            # Zero(1) for zero_missing nodes, NaN(2) otherwise
            zm_bit = (
                zero_missing_all is not None and bool(zero_missing_all[ti][slot])
            )
            dt[ii] = (2 if nl[slot] else 0) | ((1 if zm_bit else 2) << 2)
            lc[ii] = child_ref(int(left[slot]))
            rc[ii] = child_ref(int(right[slot]))
            iw[ii] = cover[slot]
        num_cat = 0
        for ii in range(ni):  # cat indexes assigned in internal-node order
            slot = slot_by_ii[ii]
            if not cat_node[slot]:
                continue
            f_idx = int(feat[slot])
            vals_f = np.asarray(cat_values_all.get(f_idx, ()), np.float64)
            bins_in = np.nonzero(np.asarray(cat_masks_all[ti][slot], bool))[0]
            bins_in = bins_in[(bins_in >= 1) & (bins_in <= len(vals_f))]
            raw = vals_f[bins_in - 1]
            if raw.size == 0 or np.any(raw < 0) or np.any(np.mod(raw, 1) != 0):
                raise ValueError(
                    f"tree {ti} slot {slot}: categorical split values must "
                    "be non-negative integers for LightGBM's bitset format "
                    f"(got {raw[:5]}...)"
                )
            raw_i = raw.astype(np.int64)
            nwords = int(raw_i.max()) // 32 + 1
            words = np.zeros(nwords, np.uint32)
            np.bitwise_or.at(
                words, raw_i // 32, np.uint32(1) << (raw_i % 32).astype(np.uint32)
            )
            th[ii] = float(num_cat)
            dt[ii] = 1 | (2 << 2)  # bit0 categorical, missing NaN (-> right)
            cat_words.extend(int(w) for w in words)
            cat_boundaries.append(len(cat_words))
            num_cat += 1

        if num_leaves == 0:  # degenerate: root itself missing (cannot happen)
            num_leaves = 1

        fields = [
            f"num_leaves={num_leaves}",
            f"num_cat={num_cat}",
            f"split_feature={_fmt_int(sf)}",
            f"split_gain={_fmt(sg)}",
            f"threshold={_fmt(th)}",
            f"decision_type={_fmt_int(dt)}",
            f"left_child={_fmt_int(lc)}",
            f"right_child={_fmt_int(rc)}",
            f"leaf_value={_fmt(lv)}",
            f"leaf_weight={_fmt(lw)}",
            f"leaf_count={_fmt_int(np.round(lw))}",
            f"internal_value={_fmt(ivalue)}",
            f"internal_weight={_fmt(iw)}",
            f"internal_count={_fmt_int(np.round(iw))}",
        ]
        if num_cat:
            fields += [
                f"cat_boundaries={_fmt_int(cat_boundaries)}",
                f"cat_threshold={_fmt_int(cat_words)}",
            ]

        # Linear leaves (imported linear_tree models being re-exported):
        # concatenate per-leaf models in leaf-id order; the iteration-0 bias
        # folds into BOTH the intercepts and the fallback leaf values.
        lin_fields: List[str] = []
        if getattr(booster, "leaf_const", None) is not None:
            lconst = np.zeros(max(num_leaves, 1), np.float64)
            per: List[tuple] = [((), ())] * max(num_leaves, 1)
            for slot, li in leaf_ids.items():
                lconst[li] = float(booster.leaf_const[ti][slot]) + bias
                fi = np.asarray(booster.leaf_feat[ti][slot])
                co = np.asarray(booster.leaf_coeff[ti][slot])
                v = fi >= 0
                per[li] = (fi[v].tolist(), co[v].tolist())
            lin_fields = [
                "is_linear=1",
                f"leaf_const={_fmt(lconst)}",
                f"num_features={_fmt_int([len(p[0]) for p in per])}",
                f"leaf_features={_fmt_int([x for p in per for x in p[0]])}",
                f"leaf_coeff={_fmt([x for p in per for x in p[1]])}",
            ]
        else:
            lin_fields = ["is_linear=0"]

        fields += lin_fields + [f"shrinkage={_G % shrinkage}"]
        if ni == 0:
            # single-leaf tree: LightGBM omits the internal-node arrays
            fields = [
                f"num_leaves={num_leaves}",
                "num_cat=0",
                f"leaf_value={_fmt(lv)}",
            ] + lin_fields + [f"shrinkage={_G % shrinkage}"]
        tree_strs.append(f"Tree={ti}\n" + "\n".join(fields) + "\n\n\n")

    names = booster.feature_names or [f"Column_{j}" for j in range(f)]
    edges = booster.bin_edges
    infos = []
    for j in range(f):
        if edges is not None and np.isfinite(edges[j]).any():
            fin = edges[j][np.isfinite(edges[j])]
            infos.append(f"[{_G % fin.min()}:{_G % fin.max()}]")
        else:
            infos.append("none")

    header = "\n".join(
        [
            "tree",
            "version=v3",
            f"num_class={c}",
            f"num_tree_per_iteration={c}",
            "label_index=0",
            f"max_feature_idx={max(f - 1, 0)}",
            f"objective={_objective_str(booster.objective, c)}",
            "feature_names=" + " ".join(names),
            "feature_infos=" + " ".join(infos),
            "tree_sizes=" + " ".join(str(len(s.encode())) for s in tree_strs),
        ]
    )
    imp = booster.feature_importances("split") if t else np.zeros(f)
    imp_lines = "\n".join(
        f"{names[j]}={int(imp[j])}"
        for j in np.argsort(-imp, kind="stable")
        if imp[j] > 0
    )
    return (
        header
        + "\n\n"
        + "".join(tree_strs)
        + "end of trees\n\n"
        + "feature_importances:\n"
        + imp_lines
        + ("\n" if imp_lines else "")
        + "\nparameters:\n"
        + f"[objective: {_parse_objective(_objective_str(booster.objective, c))}]\n"
        + "end of parameters\n\n"
        + "pandas_categorical:null\n"
    )


def _parse_linear_block(blk: dict, num_leaves: int, bi: int):
    """Per-leaf linear models of an ``is_linear=1`` tree block
    (LightGBM's ``linear_tree=true`` serialization): ``leaf_const`` is the
    intercept per leaf, ``num_features`` the per-leaf model width, and
    ``leaf_features``/``leaf_coeff`` the concatenated feature ids /
    coefficients in leaf order. Returns (const, [feat_ids...], [coefs...])."""
    const = np.fromstring(_block_value(blk, "leaf_const"), sep=" ")
    if const.size != num_leaves:
        raise ValueError(
            f"tree {bi}: leaf_const has {const.size} entries for "
            f"{num_leaves} leaves"
        )
    counts = np.fromstring(blk.get("num_features", ""), sep=" ").astype(np.int64)
    if counts.size == 0:
        counts = np.zeros(num_leaves, np.int64)
    if counts.size != num_leaves:
        raise ValueError(
            f"tree {bi}: num_features has {counts.size} entries for "
            f"{num_leaves} leaves"
        )
    feats = np.fromstring(blk.get("leaf_features", ""), sep=" ").astype(np.int64)
    coefs = np.fromstring(blk.get("leaf_coeff", ""), sep=" ")
    total = int(counts.sum())
    if feats.size != total or coefs.size != total:
        raise ValueError(
            f"tree {bi}: leaf_features/leaf_coeff lengths "
            f"({feats.size}/{coefs.size}) do not match num_features sum {total}"
        )
    offs = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
    return (
        const,
        [feats[offs[j] : offs[j + 1]] for j in range(num_leaves)],
        [coefs[offs[j] : offs[j + 1]] for j in range(num_leaves)],
    )


def _block_value(block: dict, key: str, default=None):
    if key not in block:
        if default is not None:
            return default
        raise ValueError(f"LightGBM model text: tree block missing {key!r}")
    return block[key]


def from_lightgbm_text(s: str):
    """Parse LightGBM model text into a Booster (categorical splits,
    ``zero_as_missing``, and linear trees included). Raises ``ValueError``
    on structurally invalid files."""
    from mmlspark_tpu_torch.lightgbm.booster import Booster

    lines = s.splitlines()
    header = {}
    i = 0
    while i < len(lines):
        line = lines[i].strip()
        if line.startswith("Tree="):
            break
        if "=" in line:
            k, _, v = line.partition("=")
            header[k] = v
        i += 1

    num_classes = int(header.get("num_class", 1))
    per_iter = int(header.get("num_tree_per_iteration", num_classes))
    if per_iter != num_classes:
        raise ValueError(
            f"num_tree_per_iteration={per_iter} != num_class={num_classes} "
            "(boosted random forests of multiple trees per round are not supported)"
        )
    objective = _parse_objective(header.get("objective", "regression"))
    if objective not in (
        "binary", "multiclass", "regression", "regression_l1", "huber",
        "quantile", "poisson", "tweedie", "lambdarank",
    ):
        raise ValueError(f"unsupported objective in model text: {objective!r}")
    max_feature_idx = int(header.get("max_feature_idx", 0))
    feature_names = header.get("feature_names", "").split() or None

    # Tree blocks: key=value lines between "Tree=i" and the next blank run.
    blocks = []
    cur: Optional[dict] = None
    for line in lines[i:]:
        line = line.strip()
        if line.startswith("Tree="):
            cur = {}
            blocks.append(cur)
            continue
        if line == "end of trees":
            break
        if not line or cur is None:
            continue
        k, _, v = line.partition("=")
        cur[k] = v

    trees = []
    for bi, blk in enumerate(blocks):
        num_leaves = int(_block_value(blk, "num_leaves"))
        num_cat = int(blk.get("num_cat", "0"))
        is_lin = blk.get("is_linear", "0").strip() not in ("0", "")
        lin_fields = (
            _parse_linear_block(blk, num_leaves, bi) if is_lin else None
        )
        lv = np.fromstring(_block_value(blk, "leaf_value"), sep=" ")
        if num_leaves == 1:
            tr = dict(feat=[0], thr=[np.inf], left=[0], right=[0],
                      is_leaf=[True], lval=[lv[0]], nanl=[True], zm=[False],
                      cover=[0.0], gain=[0.0], cat={})
            if lin_fields is not None:
                tr["lin"] = lin_fields
            trees.append(tr)
            continue
        sf = np.fromstring(_block_value(blk, "split_feature"), sep=" ").astype(np.int64)
        th = np.fromstring(_block_value(blk, "threshold"), sep=" ")
        dt = np.fromstring(_block_value(blk, "decision_type"), sep=" ").astype(np.int64)
        lc = np.fromstring(_block_value(blk, "left_child"), sep=" ").astype(np.int64)
        rc = np.fromstring(_block_value(blk, "right_child"), sep=" ").astype(np.int64)
        gain = np.fromstring(blk.get("split_gain", ""), sep=" ")
        # Covers: prefer the *_weight fields (we export float row mass there;
        # real LightGBM stores hessian sums — both are the TreeSHAP node
        # measure), falling back to the integer *_count fields.
        icnt = np.fromstring(
            blk.get("internal_weight", "") or blk.get("internal_count", ""), sep=" "
        )
        lcnt = np.fromstring(
            blk.get("leaf_weight", "") or blk.get("leaf_count", ""), sep=" "
        )
        ni = num_leaves - 1
        if any(len(a) != ni for a in (sf, th, dt, lc, rc)):
            raise ValueError(f"tree {bi}: inconsistent internal-node array lengths")

        is_cat_i = (dt & 1) != 0
        missing = (dt >> 2) & 3
        default_left = (dt & 2) != 0
        # missing_type None: LightGBM's predictor treats NaN like 0.0 there;
        # missing_type Zero: 0.0 AND NaN route per default_left (zero_missing)
        nan_left_i = np.where(missing == 0, 0.0 <= th, default_left)
        nan_left_i = np.where(is_cat_i, False, nan_left_i)  # cat NaN -> right
        zero_missing_i = (missing == 1) & ~is_cat_i

        # Categorical nodes: threshold = index into cat_boundaries /
        # cat_threshold; decode each node's bitset into raw value arrays.
        cat_sets = {}
        if np.any(is_cat_i) and num_cat == 0:
            raise ValueError(
                f"tree {bi}: categorical decision_type on a node but "
                "num_cat=0 (cat_boundaries/cat_threshold missing)"
            )
        if num_cat > 0 and np.any(is_cat_i):
            cbound = np.fromstring(
                _block_value(blk, "cat_boundaries"), sep=" "
            ).astype(np.int64)
            cwords = np.fromstring(
                _block_value(blk, "cat_threshold"), sep=" "
            ).astype(np.int64)
            for ii in np.nonzero(is_cat_i)[0]:
                c = int(th[ii])
                if not (0 <= c < num_cat):
                    raise ValueError(
                        f"tree {bi}: categorical threshold index {c} out of "
                        f"range for num_cat={num_cat}"
                    )
                words = cwords[cbound[c] : cbound[c + 1]]
                vals = [
                    wi * 32 + bit
                    for wi, w in enumerate(words)
                    for bit in range(32)
                    if (int(w) >> bit) & 1
                ]
                cat_sets[int(ii)] = np.asarray(vals, np.int64)

        # LightGBM indices -> slot layout: internal i -> slot i,
        # leaf j -> slot ni + j (any consistent layout works for routing).
        m = 2 * num_leaves - 1

        def slot_of(ref: int) -> int:
            return int(ref) if ref >= 0 else ni + (~int(ref))

        feat = np.zeros(m, np.int64)
        thr_s = np.full(m, np.inf)
        left_s = np.zeros(m, np.int64)
        right_s = np.zeros(m, np.int64)
        isl = np.zeros(m, bool)
        lval_s = np.zeros(m)
        nanl_s = np.ones(m, bool)
        zm_s = np.zeros(m, bool)
        cover_s = np.zeros(m)
        gain_s = np.zeros(m)
        isl[ni:] = True
        lval_s[ni:] = lv[:num_leaves]
        if len(lcnt) == num_leaves:
            cover_s[ni:] = lcnt
        for ii in range(ni):
            feat[ii] = sf[ii]
            # cat nodes: the file's threshold is a cat index, meaningless as
            # a numeric cut — keep +inf; routing uses the decoded value set
            thr_s[ii] = np.inf if ii in cat_sets else th[ii]
            left_s[ii] = slot_of(lc[ii])
            right_s[ii] = slot_of(rc[ii])
            nanl_s[ii] = bool(nan_left_i[ii])
            zm_s[ii] = bool(zero_missing_i[ii])
            if len(gain) == ni:
                gain_s[ii] = gain[ii]
            if len(icnt) == ni:
                cover_s[ii] = icnt[ii]
        tr = dict(feat=feat, thr=thr_s, left=left_s, right=right_s,
                  is_leaf=isl, lval=lval_s, nanl=nanl_s, zm=zm_s,
                  cover=cover_s, gain=gain_s, cat=cat_sets)
        if lin_fields is not None:
            tr["lin"] = lin_fields
        trees.append(tr)

    t = len(trees)
    m = max((len(tr["feat"]) for tr in trees), default=1)

    def pad(key, fill, dtype):
        out = np.full((t, m), fill, dtype=dtype)
        for ti, tr in enumerate(trees):
            out[ti, : len(tr[key])] = tr[key]
        return out

    # Linear-tree state: per-LEAF linear models land at their leaf SLOTS
    # (leaf j of a tree with ni internal nodes sits at slot ni + j). Trees
    # without a model (mixed files — LightGBM itself writes all-or-nothing)
    # fall back to const = plain leaf value with zero features, which makes
    # the linear predict path exact for them too.
    leaf_const = leaf_coeff = leaf_feat = None
    if any("lin" in tr for tr in trees):
        lmax = max(
            (
                max((len(a) for a in tr["lin"][1]), default=0)
                for tr in trees if "lin" in tr
            ),
            default=0,
        )
        lmax = max(lmax, 1)
        leaf_const = pad("lval", 0.0, np.float64)
        leaf_coeff = np.zeros((t, m, lmax), np.float64)
        leaf_feat = np.full((t, m, lmax), -1, np.int32)
        for ti, tr in enumerate(trees):
            if "lin" not in tr:
                continue
            m_t = len(tr["feat"])
            nl_t = (m_t + 1) // 2
            ni_t = m_t - nl_t
            const, lfeats, lcoefs = tr["lin"]
            leaf_const[ti, ni_t : ni_t + nl_t] = const[:nl_t]
            for j in range(nl_t):
                w = len(lfeats[j])
                leaf_feat[ti, ni_t + j, :w] = lfeats[j]
                leaf_coeff[ti, ni_t + j, :w] = lcoefs[j]

    # Booster-level categorical state: per-feature sorted value lists (the
    # union of every node's bitset on that feature) and per-node masks over
    # the value-bin ids (bin i+1 <-> values[i]; bin 0 = unseen/NaN).
    cat_nodes = cat_masks = cat_values = None
    if any(tr.get("cat") for tr in trees):
        feat_vals: dict = {}
        for tr in trees:
            for slot, vals in tr.get("cat", {}).items():
                f_ = int(tr["feat"][slot])
                feat_vals.setdefault(f_, set()).update(int(v) for v in vals)
        cat_values = {
            f_: np.asarray(sorted(s), np.float64) for f_, s in feat_vals.items()
        }
        bc = max(len(v) for v in cat_values.values()) + 1
        cat_nodes = np.zeros((t, m), bool)
        cat_masks = np.zeros((t, m, bc), bool)
        for ti, tr in enumerate(trees):
            for slot, vals in tr.get("cat", {}).items():
                f_ = int(tr["feat"][slot])
                idx = np.searchsorted(
                    cat_values[f_], np.asarray(vals, np.float64)
                )
                cat_nodes[ti, slot] = True
                cat_masks[ti, slot, idx + 1] = True

    booster = Booster(
        split_feature=pad("feat", 0, np.int32),
        # float64: LightGBM thresholds are f64 midpoints; narrowing here would
        # misroute rows whose f32-cast value falls between the f64 threshold
        # and its f32 rounding. Predict snaps to f32 DOWNWARD (booster.py
        # _thr_f32), which preserves the f64 decision set exactly for f32
        # inputs; residual contract: f64 inputs that straddle an f32 gap can
        # still differ (the predict kernel compares in f32).
        split_threshold=pad("thr", np.inf, np.float64),
        split_bin=np.zeros((t, m), np.int32),
        left_child=pad("left", 0, np.int32),
        right_child=pad("right", 0, np.int32),
        is_leaf=pad("is_leaf", False, bool),
        leaf_values=pad("lval", 0.0, np.float32),
        cover=pad("cover", 0.0, np.float32),
        split_gain=pad("gain", 0.0, np.float32),
        init_score=np.zeros(num_classes, np.float32),
        num_classes=num_classes,
        objective=objective,
        max_depth=_pointer_depth(trees),
        feature_names=feature_names
        or [f"Column_{j}" for j in range(max_feature_idx + 1)],
        nan_left=pad("nanl", True, bool),
        zero_missing=(
            pad("zm", False, bool)
            if any(np.any(tr["zm"]) for tr in trees) else None
        ),
        cat_nodes=cat_nodes,
        cat_masks=cat_masks,
        cat_values=cat_values,
        leaf_const=leaf_const,
        leaf_coeff=leaf_coeff,
        leaf_feat=leaf_feat,
    )
    return booster


def _pointer_depth(trees) -> int:
    depth = 1
    for tr in trees:
        left, right, isl = tr["left"], tr["right"], tr["is_leaf"]
        d = {0: 0}
        best = 0
        stack = [0]
        while stack:
            s = stack.pop()
            if isl[s]:
                best = max(best, d[s])
                continue
            for ch in (int(left[s]), int(right[s])):
                d[ch] = d[s] + 1
                stack.append(ch)
        depth = max(depth, best)
    return max(1, depth)
