"""Shared LightGBM-style estimator machinery: param surface + train flow.

The port's counterpart of ``mmlspark_tpu/lightgbm/base.py``: the same param
names and defaults (``LightGBMParams.scala``), plus ``device``. Params that
select a path the port has not taken over raise ``NotImplementedError`` when
set away from their defaults, instead of being ignored.

``numExecutors`` (or an ambient ``runtime.policy()``) bins on the
fault-tolerant scheduler, inside a ``lightgbm.binning`` tracer span; under
``MMLSPARK_TPU_CHECKPOINT_DIR`` that binning is journaled and the fitted
model committed to a ``ModelStore``, in the reference's layout;
``numBatches`` chains boosters over row batches
(``LightGBMBase.scala:26-48``). A finished fit publishes ``ModelCommitted``
on the event bus. Models save and load as stages, and as LightGBM model
text (``save_native_model``, ``load_native_model``, ``from_model_string``).
"""

from __future__ import annotations

import dataclasses
import os
import time
import zlib
from typing import List

import numpy as np
import torch

from mmlspark_tpu_torch.core.params import (
    HasFeaturesCol,
    HasInitScoreCol,
    HasLabelCol,
    HasPredictionCol,
    HasValidationIndicatorCol,
    HasWeightCol,
    Param,
    Params,
    ge,
    gt,
    in_range,
    one_of,
    to_bool,
    to_float,
    to_int,
    to_list_int,
    to_list_str,
    to_str,
)
from mmlspark_tpu_torch import runtime
from mmlspark_tpu_torch.core.pipeline import Estimator, Model
from mmlspark_tpu_torch.data.sparse import CSRMatrix, csr_column_to_matrix, is_sparse_column
from mmlspark_tpu_torch.data.table import Table
from mmlspark_tpu_torch.device import DeviceLike, resolve_device
from mmlspark_tpu_torch.lightgbm.binning import BinMapper, bin_dataset, bin_dataset_partitioned
from mmlspark_tpu_torch.lightgbm.booster import Booster
from mmlspark_tpu_torch.lightgbm.train import (
    FitStats,
    TrainOptions,
    TrainResult,
    _bundle_route_consts,
    _route_binned,
    train,
)
from mmlspark_tpu_torch.observability.events import ModelCommitted, get_bus
from mmlspark_tpu_torch.observability.tracing import get_tracer

#: FitStats fields that add up over the batches of a numBatches fit
_SUMMED_STATS = ("trees", "passes", "syncs", "boost_seconds", "u_build_seconds", "oom_retries",
                 "renewal_seconds", "upload_seconds")


class LightGBMParams(HasFeaturesCol, HasLabelCol, HasPredictionCol, HasWeightCol,
                     HasInitScoreCol, HasValidationIndicatorCol, Params):
    """The shared knob surface (LightGBMParams.scala)."""

    numIterations = Param("Number of boosting iterations", default=100, converter=to_int, validator=gt(0))
    learningRate = Param("Shrinkage rate", default=0.1, converter=to_float, validator=gt(0))
    numLeaves = Param("Max leaves per tree", default=31, converter=to_int, validator=gt(1))
    maxDepth = Param("Max tree depth (-1 = derive from numLeaves)", default=-1, converter=to_int)
    maxBin = Param("Max number of feature bins", default=255, converter=to_int, validator=gt(1))
    binSampleCount = Param(
        "Rows sampled when computing histogram bin edges (bin_construct_sample_cnt)",
        default=200000, converter=to_int, validator=gt(0),
    )
    maxBinByFeature = Param("Per-feature max-bin override (empty = maxBin everywhere)",
                            default=[], converter=to_list_int)
    slotNames = Param("Feature slot names (overrides the generated f0..fN)",
                      default=[], converter=to_list_str)
    baggingFraction = Param("Row subsample fraction", default=1.0, converter=to_float, validator=in_range(0, 1))
    posBaggingFraction = Param("Positive-class bagging fraction (binary; 1.0 = off)",
                               default=1.0, converter=to_float, validator=in_range(0, 1))
    negBaggingFraction = Param("Negative-class bagging fraction (binary; 1.0 = off)",
                               default=1.0, converter=to_float, validator=in_range(0, 1))
    baggingFreq = Param("Resample bagging mask every k iterations (0=off)", default=0, converter=to_int, validator=ge(0))
    baggingSeed = Param("Bagging seed", default=3, converter=to_int)
    featureFraction = Param("Feature subsample fraction per tree", default=1.0, converter=to_float, validator=in_range(0, 1))
    lambdaL1 = Param("L1 regularization", default=0.0, converter=to_float, validator=ge(0))
    lambdaL2 = Param("L2 regularization", default=0.0, converter=to_float, validator=ge(0))
    minSumHessianInLeaf = Param("Minimum hessian sum per leaf", default=1e-3, converter=to_float, validator=ge(0))
    minDataInLeaf = Param("Minimum rows per leaf", default=20, converter=to_int, validator=ge(0))
    minGainToSplit = Param("Minimum gain to split", default=0.0, converter=to_float, validator=ge(0))
    maxDeltaStep = Param("Max leaf output magnitude (0=off)", default=0.0, converter=to_float, validator=ge(0))
    boostingType = Param("gbdt, rf, dart, or goss", default="gbdt", converter=to_str,
                         validator=one_of("gbdt", "rf", "dart", "goss"))
    earlyStoppingRound = Param("Stop after k rounds without improvement (0=off)", default=0, converter=to_int, validator=ge(0))
    improvementTolerance = Param("Minimal delta counted as improvement", default=0.0, converter=to_float, validator=ge(0))
    metric = Param("Eval metric name ('' = objective default)", default="", converter=to_str)
    parallelism = Param("data_parallel, voting_parallel, or serial", default="data_parallel",
                        converter=to_str, validator=one_of("data_parallel", "voting_parallel", "serial"))
    topK = Param("Top features for voting parallel", default=20, converter=to_int, validator=gt(0))
    topRate = Param("GOSS: kept fraction of large-gradient rows", default=0.2, converter=to_float, validator=in_range(0, 1))
    otherRate = Param("GOSS: sampled fraction of remaining rows", default=0.1, converter=to_float, validator=in_range(0, 1))
    dropRate = Param("DART: per-tree dropout probability", default=0.1, converter=to_float, validator=in_range(0, 1))
    growthPolicy = Param("leafwise (best-first) or depthwise", default="leafwise", converter=to_str,
                         validator=one_of("leafwise", "depthwise"))
    leafBatch = Param("Frontier leaves split per histogram pass under leafwise growth "
                      "(1 = exact sequential best-first)", default=8, converter=to_int, validator=gt(0))
    leafBatchRatio = Param("Only batch leaves whose gain >= ratio * pass-best (0 = off)",
                           default=0.0, converter=to_float, validator=in_range(0, 1))
    useQuantizedGrad = Param("Gradient-quantization training", default=False, converter=to_bool)
    featureBundling = Param("Exclusive Feature Bundling", default=False, converter=to_bool)
    maxConflictRate = Param("EFB conflict budget", default=0.0, converter=to_float, validator=in_range(0, 1))
    categoricalSlotIndexes = Param("Feature indexes treated as categorical", default=[], converter=to_list_int)
    categoricalSlotNames = Param("Feature names treated as categorical", default=[], converter=to_list_str)
    maxCatThreshold = Param("Max categories in a categorical split's left set", default=32, converter=to_int, validator=gt(0))
    catSmooth = Param("Smoothing for the categorical g/h bin ordering", default=10.0, converter=to_float, validator=ge(0))
    catL2 = Param("Extra L2 applied to categorical split gains", default=10.0, converter=to_float, validator=ge(0))
    maxCatToOnehot = Param("One-vs-rest categorical search up to this many categories",
                           default=4, converter=to_int, validator=gt(0))
    minDataPerGroup = Param("Minimal rows a category needs in the sorted-set search",
                            default=100, converter=to_int, validator=gt(0))
    boostFromAverage = Param("Start boosting from the label average init score (false = from 0)",
                             default=True, converter=to_bool)
    isProvideTrainingMetric = Param("Record the train-set metric each iteration", default=False, converter=to_bool)
    numBatches = Param("Split training into sequential batches (0=off)", default=0, converter=to_int, validator=ge(0))
    modelString = Param("Warm-start booster string", default="", converter=to_str)
    verbosity = Param("Verbosity", default=-1, converter=to_int)
    seed = Param("Master seed", default=0, converter=to_int)
    featuresShapCol = Param("Output column for SHAP values ('' = off)", default="", converter=to_str)
    leafPredictionCol = Param("Output column for leaf indices ('' = off)", default="", converter=to_str)
    useSingleDatasetMode = Param("Accepted for API parity", default=True, converter=to_bool)
    numTasks = Param("Override number of mesh shards (0 = all devices)", default=0, converter=to_int, validator=ge(0))
    numExecutors = Param("Partitioned binning executors (0 = inline)", default=0, converter=to_int, validator=ge(0))
    numProcesses = Param("Process-parallel fit (0/1 = in-process)", default=0, converter=to_int, validator=ge(0))
    device = Param("Torch device the fit and predict run on: 'cuda' (default) or 'cpu'",
                   default="cuda", converter=to_str, port_only=True)

    #: Params of paths the port has not taken over, with the values it takes.
    _PORTED_VALUES = {"numProcesses": (0, 1), "parallelism": ("data_parallel", "serial")}

    def _objective_name(self) -> str:
        raise NotImplementedError

    def _extra_train_options(self) -> dict:
        """Learner-specific ``TrainOptions`` fields (regressor: alpha and
        the tweedie power; ranker: its default metric)."""
        return {}

    def _check_ported(self) -> None:
        for name, ported in self._PORTED_VALUES.items():
            if self.getOrDefault(name) not in ported:
                raise NotImplementedError(f"{name}={self.getOrDefault(name)!r} is not ported yet")

    def _make_options(self, num_class: int = 1) -> TrainOptions:
        kwargs = dict(
            objective=self._objective_name(),
            num_iterations=self.getNumIterations(),
            learning_rate=self.getLearningRate(),
            num_leaves=self.getNumLeaves(),
            max_depth=self.getMaxDepth(),
            max_bin=self.getMaxBin(),
            lambda_l1=self.getLambdaL1(),
            lambda_l2=self.getLambdaL2(),
            min_data_in_leaf=self.getMinDataInLeaf(),
            min_sum_hessian_in_leaf=self.getMinSumHessianInLeaf(),
            min_gain_to_split=self.getMinGainToSplit(),
            bagging_fraction=self.getBaggingFraction(),
            pos_bagging_fraction=self.getPosBaggingFraction(),
            neg_bagging_fraction=self.getNegBaggingFraction(),
            bagging_freq=self.getBaggingFreq(),
            feature_fraction=self.getFeatureFraction(),
            max_delta_step=self.getMaxDeltaStep(),
            num_class=num_class,
            boosting_type=self.getBoostingType(),
            metric=self.getMetric() or None,
            early_stopping_round=self.getEarlyStoppingRound(),
            improvement_tolerance=self.getImprovementTolerance(),
            seed=self.getSeed(),
            growth=self.getGrowthPolicy(),
            leaf_batch=self.getLeafBatch(),
            leaf_batch_ratio=self.getLeafBatchRatio(),
            use_quantized_grad=self.getUseQuantizedGrad(),
            top_k=self.getTopK(),
            top_rate=self.getTopRate(),
            other_rate=self.getOtherRate(),
            drop_rate=self.getDropRate(),
            max_cat_threshold=self.getMaxCatThreshold(),
            cat_smooth=self.getCatSmooth(),
            cat_l2=self.getCatL2(),
            max_cat_to_onehot=self.getMaxCatToOnehot(),
            min_data_per_group=self.getMinDataPerGroup(),
            boost_from_average=self.getBoostFromAverage(),
            provide_training_metric=self.getIsProvideTrainingMetric(),
        )
        kwargs.update(self._extra_train_options())
        return TrainOptions(**kwargs)


def extract_features(table: Table, features_col: str, num_features: int = 0):
    """Dense (N, F) float64 features of ``table``, or a
    :class:`~mmlspark_tpu_torch.data.sparse.CSRMatrix` when the column holds
    sparse rows (``SparseRows``, or per-row (indices, values) tuples: the
    ``LGBM_DatasetCreateFromCSRSpark`` ingest). ``num_features`` pins the
    sparse width: pass the trained width at predict and validation time,
    so a batch whose highest explicit index is smaller keeps it; an index
    past it raises."""
    feats = table.column(features_col)
    if feats.dtype == object:
        if is_sparse_column(feats):
            return csr_column_to_matrix(feats, num_features=num_features)
        feats = np.stack([np.asarray(row, dtype=np.float64) for row in feats])
    return np.asarray(feats, dtype=np.float64)


class LightGBMBase(LightGBMParams, Estimator):
    """Shared fit flow: features and labels from the table, host binning,
    boosting on the device."""

    def _num_classes(self, y: np.ndarray) -> int:
        return 1

    def _adjust_weights(self, y: np.ndarray, w):
        return w

    def _prepare(self, table: Table, num_features: int = 0):
        """Features (sparse ones at ``num_features``, when given), labels,
        weights and init scores of ``table``."""
        X = extract_features(table, self.getFeaturesCol(), num_features)
        y = np.asarray(table.column(self.getLabelCol()), dtype=np.float64)
        w = init = None
        if self.isSet("weightCol"):
            w = np.asarray(table.column(self.getWeightCol()), dtype=np.float64)
        if self.isSet("initScoreCol"):
            init = np.asarray(table.column(self.getInitScoreCol()), dtype=np.float64)
        return X, y, w, init

    def set_delegate(self, *callbacks) -> "LightGBMBase":
        """Attach training delegates (:class:`~.callbacks.TrainingCallback`):
        live objects, not Params, so no param map holds them."""
        self._callbacks = list(callbacks)
        return self

    @property
    def callbacks(self):
        return list(getattr(self, "_callbacks", []))

    def _train_objective(self, table: Table):
        """A per-fit objective handed to ``train`` (the ranker's), else None."""
        return None

    def _fit(self, table: Table) -> "LightGBMModelBase":
        if self.getNumBatches() > 1 and self.getNumProcesses() > 1:
            raise ValueError("numProcesses and numBatches are exclusive")
        self._check_ported()
        # Validation split by indicator column (LightGBMBase.scala:196-197).
        valid_table = None
        if self.isSet("validationIndicatorCol"):
            ind = np.asarray(table.column(self.getValidationIndicatorCol()), dtype=bool)
            valid_table, table = table.filter(ind), table.filter(~ind)
        warm = self.getModelString()
        prev = Booster.from_string(warm) if warm else None
        # warm start: sparse rows at the previous booster's width, so its
        # trees never read past the batch's explicit columns
        X, y, w, init = self._prepare(table, num_features=prev.num_features if prev else 0)
        w = self._adjust_weights(y, w)
        opts = self._make_options(self._num_classes(y))
        num_features = X.shape[1]
        slot_names = self.getSlotNames()
        if slot_names and len(slot_names) != num_features:
            raise ValueError(f"slotNames has {len(slot_names)} entries for {num_features} features")
        feature_names = list(slot_names) or [f"f{i}" for i in range(num_features)]
        cat_slots = self._categorical_slots(feature_names)
        t0 = time.perf_counter()
        bins, mapper = self._bin_dataset(X, opts, cat_slots)
        binning_seconds = time.perf_counter() - t0
        valid_sets = []
        if valid_table is not None and valid_table.num_rows > 0:
            Xv, yv, wv, _ = self._prepare(valid_table, num_features=num_features)
            bv, _ = bin_dataset(Xv, mapper=mapper)
            valid_sets.append(("valid_0", bv, yv, wv))
        init_margins = None
        if init is not None:
            init_margins = np.asarray(init, dtype=np.float32)
            if init_margins.ndim == 1:
                init_margins = init_margins[:, None]
        if prev is not None:
            init_margins = prev.raw_margin(X, device=self.getDevice())
        objective = self._train_objective(table)
        num_batches = self.getNumBatches()
        if num_batches > 1:
            if objective is not None:
                raise ValueError("numBatches would cut the ranker's query groups; "
                                 "fit the ranker in one batch")
            result = self._fit_batches(bins, y, w, init_margins, opts, mapper, valid_sets,
                                       feature_names, num_batches)
        else:
            result = train(bins, y, opts, w=w, init_margins=init_margins,
                           valid_sets=valid_sets, mapper=mapper, feature_names=feature_names,
                           callbacks=self.callbacks, device=self.getDevice(),
                           objective=objective)
        result.stats.binning_seconds = binning_seconds
        model = self._make_model(result)
        model.parent = self
        model.fit_stats = result.stats
        # per-iteration metric histories (valid sets, and 'training' under
        # isProvideTrainingMetric)
        model._train_evals = result.evals
        # durable model commit: a versioned atomic write under the
        # checkpoint root, so a restarting server's recovery scan
        # (ModelStore.latest) never reads a torn model file
        version = None
        ckpt_root = runtime.default_checkpoint_dir()
        if ckpt_root is not None:
            version = runtime.ModelStore(os.path.join(ckpt_root, "models")).commit(
                model.get_model_string(), name=type(model).__name__.lower())
        bus = get_bus()
        if bus.active:
            detail = f"{result.booster.num_trees} trees"
            if version is not None:
                detail = f"{detail} v{version}"
            bus.publish(ModelCommitted(model=type(model).__name__, detail=detail))
        return model

    def _bin_dataset(self, X, opts: TrainOptions, cat_slots):
        """Bin the training matrix. With ``numExecutors`` > 0 or an ambient
        :func:`mmlspark_tpu_torch.runtime.policy`, the row pass runs as
        partitioned tasks on the fault-tolerant scheduler (Spark's binning
        inside executors), byte-identical to the inline pass; its metrics
        land on ``self._runtime_metrics``. Under a checkpoint root the
        partitions are journaled under ``<root>/binning``, so a rerun with
        the same params and data re-executes none of them."""
        kwargs = dict(
            max_bin=opts.max_bin, categorical_features=sorted(cat_slots) or None,
            sample_cnt=self.getBinSampleCount(),
            max_bin_by_feature=self.getMaxBinByFeature() or None,
            feature_bundling=self.getFeatureBundling(),
            max_conflict_rate=self.getMaxConflictRate(),
        )
        ambient = runtime.current_policy()
        if ambient is None and self.getNumExecutors() <= 0:
            return bin_dataset(X, **kwargs)
        pol = ambient or runtime.SchedulerPolicy(max_workers=self.getNumExecutors(),
                                                 seed=self.getSeed())
        journal_root = journal_key = None
        ckpt_root = runtime.default_checkpoint_dir()
        # CSR input bins inline (bin_dataset_partitioned's rule), so it has
        # no partitions to journal
        if ckpt_root is not None and not isinstance(X, CSRMatrix):
            journal_root = os.path.join(ckpt_root, "binning")
            journal_key = self._checkpoint_key(X, kwargs)
        self._runtime_metrics = runtime.RuntimeMetrics()
        with get_tracer().span("lightgbm.binning", rows=int(X.shape[0])):
            bins, mapper = bin_dataset_partitioned(
                X, policy=pol, metrics=self._runtime_metrics, journal_root=journal_root,
                journal_key=journal_key, **kwargs)
        self._runtime_metrics.log(prefix="binning: ")
        return bins, mapper

    def _checkpoint_key(self, X, bin_kwargs: dict) -> str:
        """Identity of one durable fit, the reference's: estimator class,
        seed, binning params and a data fingerprint (shape and CRC32 of the
        float64 bytes). A rerun with identical inputs resumes, under either
        package; any change lands in a fresh journal directory."""
        arr = np.ascontiguousarray(np.asarray(X, dtype=np.float64))
        crc = zlib.crc32(arr.view(np.uint8).reshape(-1)) & 0xFFFFFFFF
        parts = [type(self).__name__, f"seed{self.getSeed()}"]
        parts += [f"{k}={bin_kwargs[k]}" for k in sorted(bin_kwargs)]
        parts.append(f"X{arr.shape[0]}x{arr.shape[1] if arr.ndim > 1 else 1}")
        parts.append(f"{crc:08x}")
        return "-".join(parts)

    def _fit_batches(self, bins, y, w, init_margins, opts, mapper, valid_sets, feature_names,
                     num_batches) -> TrainResult:
        """Batch-mode training (LightGBMBase.scala:26-48): one booster per
        contiguous row batch, each started from the margins of the boosters
        before it on its rows, then merged into one additive model."""
        n = len(y)
        edges = np.linspace(0, n, num_batches + 1).astype(int)
        boosters: List[Booster] = []
        stats: List[FitStats] = []
        merged_evals: dict = {}
        result = None
        for lo, hi in zip(edges[:-1], edges[1:]):
            if hi <= lo:
                continue
            im = None if init_margins is None else init_margins[lo:hi]
            if boosters:
                im = _ensemble_margin(boosters, bins[lo:hi], mapper, self.getDevice())
            result = train(bins[lo:hi], y[lo:hi], opts, w=None if w is None else w[lo:hi],
                           init_margins=im, valid_sets=valid_sets, mapper=mapper,
                           feature_names=feature_names, device=self.getDevice())
            boosters.append(result.booster)
            stats.append(result.stats)
            # metric histories concatenate across the chained batches (each
            # batch scores its delta booster)
            for name, metrics in result.evals.items():
                dst = merged_evals.setdefault(name, {})
                for mname, scores in metrics.items():
                    dst.setdefault(mname, []).extend(scores)
        summed = {f: sum(getattr(st, f) for st in stats) for f in _SUMMED_STATS}
        merged_stats = dataclasses.replace(
            stats[-1], per_iteration=[it for st in stats for it in st.per_iteration], **summed)
        return TrainResult(booster=_merge_boosters(boosters), stats=merged_stats,
                           evals=merged_evals, best_iteration=result.best_iteration)

    def _categorical_slots(self, feature_names) -> set:
        """``categoricalSlotIndexes`` united with ``categoricalSlotNames``
        resolved against the feature names (LightGBMBase.scala:148-156)."""
        num_features = len(feature_names)
        cat_slots = set(self.getCategoricalSlotIndexes() or [])
        bad = sorted(i for i in cat_slots if not 0 <= i < num_features)
        if bad:
            raise ValueError(f"categoricalSlotIndexes out of range for {num_features} "
                             f"features: {bad}")
        name_to_idx = {nm: i for i, nm in enumerate(feature_names)}
        for nm in self.getCategoricalSlotNames() or []:
            if nm not in name_to_idx:
                raise ValueError(f"categoricalSlotNames: unknown feature name {nm!r}")
            cat_slots.add(name_to_idx[nm])
        return cat_slots

    def _make_model(self, result: TrainResult) -> "LightGBMModelBase":
        raise NotImplementedError


def _ensemble_margin(boosters: List[Booster], bins: np.ndarray, mapper: BinMapper,
                     device: DeviceLike = None) -> np.ndarray:
    """(N, C) float32 margins of the chained ``boosters`` on ``bins`` binned
    with their shared mapper (EFB-packed when it carries a bundle plan; the
    trees are in original feature ids), routed on ``device`` through the
    training loop's :func:`~.train._route_binned`: each booster's init
    score plus its trees' leaf values, in tree order, summed over boosters
    in order, as the reference adds them."""
    dev = resolve_device(device)
    bins_t = torch.as_tensor(np.ascontiguousarray(bins), device=dev)
    spec = mapper.bundles
    consts = _bundle_route_consts(spec, dev) if spec is not None else None
    total = None
    for b in boosters:
        def arr(a, dtype=torch.int64):
            return torch.as_tensor(np.asarray(a), device=dev).to(dtype)

        m = arr(b.init_score, torch.float32)[None, :].expand(bins_t.shape[0],
                                                              b.num_classes).clone()
        for t in range(b.num_trees):
            leaf = _route_binned(
                bins_t, arr(b.split_feature[t]), arr(b.split_bin[t]), arr(b.left_child[t]),
                arr(b.right_child[t]), arr(b.is_leaf[t], torch.bool), b.max_depth,
                cat_node=None if b.cat_nodes is None else arr(b.cat_nodes[t], torch.bool),
                cat_mask=None if b.cat_masks is None else arr(b.cat_masks[t], torch.bool),
                bundle_consts=consts)
            m[:, t % b.num_classes] += arr(b.leaf_values[t], torch.float32)[leaf]
        total = m if total is None else total + m
    return total.cpu().numpy()


def _merge_boosters(boosters: List[Booster]) -> Booster:
    """Concatenate chained batch boosters into one additive model (the
    ``LGBM_BoosterMerge`` analogue, TrainUtils.scala:165-167)."""
    if len(boosters) == 1:
        return boosters[0]
    first = boosters[0]

    def cat(field, pad=0):
        arrs = [getattr(b, field) for b in boosters]
        if any(a is None for a in arrs):
            return None
        arrs = [np.asarray(a) for a in arrs]
        # pad the node (and bitmask) axes to the widest booster: a model
        # text round trip trims each tree's arrays to its own width. Pad
        # slots are unreachable; is_leaf pads True all the same.
        target = tuple(max(a.shape[d] for a in arrs) for d in range(1, arrs[0].ndim))
        padded = []
        for a in arrs:
            widths = [(0, 0)] + [(0, t - a.shape[d + 1]) for d, t in enumerate(target)]
            if any(wd for _, wd in widths):
                a = np.pad(a, widths, constant_values=pad)
            padded.append(a)
        return np.concatenate(padded)

    return Booster(
        split_feature=cat("split_feature"), split_bin=cat("split_bin"),
        split_threshold=cat("split_threshold"), left_child=cat("left_child"),
        right_child=cat("right_child"), is_leaf=cat("is_leaf", pad=1),
        leaf_values=cat("leaf_values"), cover=cat("cover"), split_gain=cat("split_gain"),
        init_score=first.init_score, num_classes=first.num_classes, objective=first.objective,
        max_depth=max(b.max_depth for b in boosters), best_iteration=-1,
        feature_names=first.feature_names, bin_edges=first.bin_edges,
        nan_left=cat("nan_left"), zero_missing=cat("zero_missing"),
        cat_nodes=cat("cat_nodes"), cat_masks=cat("cat_masks"), cat_values=first.cat_values,
    )


class LightGBMModelBase(HasFeaturesCol, HasPredictionCol, Model):
    """Shared model surface: booster access, native-model text, feature
    importances, and the leaf-index and SHAP output columns. A model saves
    and loads as a stage (``save``/``load``: the booster dict under the
    ``pickle`` tag, ``device`` not written), or as LightGBM model text;
    either way a loaded model predicts on the card unless ``device`` is set
    to ``'cpu'``."""

    boosterData = Param("Fitted booster state", is_complex=True)
    leafPredictionCol = Param("Output column for leaf indices ('' = off)", default="",
                              converter=to_str)
    featuresShapCol = Param("Output column for SHAP values ('' = off)", default="",
                            converter=to_str)
    device = Param("Torch device predict runs on: 'cuda' (default) or 'cpu'",
                   default="cuda", converter=to_str, port_only=True)

    @property
    def booster(self) -> Booster:
        return Booster.from_dict(self.getBoosterData())

    def set_booster(self, booster: Booster) -> None:
        self.set("boosterData", booster.to_dict())

    def get_model_string(self) -> str:
        return self.booster.model_to_string()

    def save_native_model(self, path: str) -> None:
        """``saveNativeModel``: the booster as LightGBM model text."""
        with open(path, "w") as f:
            f.write(self.get_model_string())

    @classmethod
    def from_model_string(cls, text: str, **kwargs) -> "LightGBMModelBase":
        """A model of ``text``, LightGBM model text or the booster's JSON
        dump (:meth:`Booster.to_json_string`); ``kwargs`` are its params."""
        m = cls(**kwargs)
        m.set_booster(Booster.from_string(text))
        return m

    @classmethod
    def load_native_model(cls, path: str, **kwargs) -> "LightGBMModelBase":
        with open(path) as f:
            return cls.from_model_string(f.read(), **kwargs)

    def get_feature_importances(self, importance_type: str = "split") -> np.ndarray:
        """Split-count or total-gain importance per feature."""
        return self.booster.feature_importances(importance_type)

    def _with_leaf_col(self, table: Table, X, booster: Booster) -> Table:
        """``table`` with the leaf slots per tree (``leafPredictionCol``) and
        the SHAP values (``featuresShapCol``) of ``X`` (dense or CSR) where
        those are set;
        SHAP in LightGBM's contrib layout (N, C*(F+1)): per class, the
        feature contributions then the bias."""
        if self.getLeafPredictionCol():
            leaves = booster.predict_leaf(X, device=self.getDevice()).astype(np.float64)
            table = table.with_column(self.getLeafPredictionCol(), leaves)
        if self.getFeaturesShapCol():
            shap = booster.features_shap(X, device=self.getDevice())
            table = table.with_column(self.getFeaturesShapCol(),
                                      shap.reshape(shap.shape[0], -1).astype(np.float64))
        return table
