"""Bucket execution: fit every candidate in a shape-bucket, score them.

The port's copy of ``mmlspark_tpu/sweep/batched.py``. One
:class:`~mmlspark_tpu_torch.sweep.bucketing.CandidateBucket` is one unit
of work. A batchable bucket extracts the features and bins them ONCE,
through candidate 0's own ``_bin_dataset`` (so ``numExecutors`` and
durable binning apply as in a fit), and hands the K candidates to
:func:`~mmlspark_tpu_torch.lightgbm.train.train_many`, which uploads the
bins once and runs every candidate's ``histogram.cu`` passes on the
estimator's ``device``. A VW bucket lays its rows out once through
candidate 0's ``_train_setup`` and hands the K candidates to
:func:`~mmlspark_tpu_torch.vw.base.train_linear_many`. A singleton (``kind
is None``) bucket falls back to the ordinary ``estimator.copy(params).fit``.

The same executor serves the inline sweep
(:class:`~mmlspark_tpu_torch.sweep.estimator.TrainValidSweep`), the
batched CV path inside
:class:`~mmlspark_tpu_torch.automl.tune.TuneHyperparameters`, and the gang
workers (:mod:`mmlspark_tpu_torch.sweep.distributed`).
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Sequence, Tuple

import numpy as np

from mmlspark_tpu_torch.data.table import Table
from mmlspark_tpu_torch.sweep.bucketing import CandidateBucket, bucket_candidates


def _score(model, valid_table: Table, label_col: str, metric: str) -> float:
    from mmlspark_tpu_torch.automl.tune import _evaluate

    return _evaluate(model.transform(valid_table), label_col, metric)


def _fit_bucket_gbdt(bucket: CandidateBucket, table: Table) -> List[Any]:
    """K GBDT candidates through one binning pass and one
    :func:`~mmlspark_tpu_torch.lightgbm.train.train_many` call: the
    estimator's own fit up to its train call (the bucket key pins every
    data-shaping param, so candidate 0 speaks for the bucket), then one
    model per candidate. Each candidate infers its own class count, so a
    multiclass bucket of a classifier without an explicit objective keeps
    one objective."""
    from mmlspark_tpu_torch.lightgbm.train import train_many

    cands = [bucket.estimator.copy(p) for p in bucket.param_maps]
    c0 = cands[0]
    X, y, w, _init = c0._prepare(table)
    w = c0._adjust_weights(y, w)
    opts_list = [c._make_options(c._num_classes(y)) for c in cands]
    num_features = X.shape[1]
    slot_names = c0.getSlotNames()
    if slot_names and len(slot_names) != num_features:
        raise ValueError(f"slotNames has {len(slot_names)} entries for {num_features} features")
    feature_names = list(slot_names) or [f"f{i}" for i in range(num_features)]
    cat_slots = c0._categorical_slots(feature_names)
    t0 = time.perf_counter()
    bins, mapper = c0._bin_dataset(X, opts_list[0], cat_slots)
    binning_seconds = time.perf_counter() - t0
    results = train_many(bins, y, opts_list, w=w, mapper=mapper, feature_names=feature_names,
                         device=c0.getDevice())
    models = []
    for c, r in zip(cands, results):
        r.stats.binning_seconds = binning_seconds  # the bucket's one binning
        model = c._make_model(r)
        model.parent = c
        model.fit_stats = r.stats
        model._train_evals = r.evals
        models.append(model)
    return models


def _fit_bucket_vw(bucket: CandidateBucket, table: Table) -> List[Any]:
    """K VW candidates through one row layout and one
    :func:`~mmlspark_tpu_torch.vw.base.train_linear_many` call on candidate
    0's ``device``."""
    from mmlspark_tpu_torch.vw.base import train_linear_many

    cands = [bucket.estimator.copy(p) for p in bucket.param_maps]
    c0 = cands[0]
    args, batch, y, w, const_idx, init = c0._train_setup(table)
    results = train_linear_many(
        batch, y, w,
        loss=args.get("loss", c0._default_loss),
        num_passes=args.get("passes", c0.getNumPasses()),
        learning_rates=[c.getLearningRate() for c in cands],
        power_ts=[c.getPowerT() for c in cands],
        l1s=[c.getL1() for c in cands],
        l2s=[c.getL2() for c in cands],
        batch_size=c0.getBatchSize(),
        constant_index=const_idx,
        initial_weights=init,
        quantile_tau=args.get("quantile_tau", 0.5),
        optimizer="ftrl" if args.get("ftrl") else "adagrad",
        ftrl_alpha=args.get("ftrl_alpha", 0.005),
        ftrl_beta=args.get("ftrl_beta", 0.1),
        device=c0.getDevice(),
    )
    link = args.get("link", "identity")
    models = []
    for c, r in zip(cands, results):
        c._link = link
        model = c._make_model(r, batch.dim, const_idx)
        model.set("linkFunction", link)
        model.parent = c
        models.append(model)
    return models


def fit_bucket(
    bucket: CandidateBucket,
    train_table: Table,
    valid_table: Table,
    label_col: str,
    metric: str,
    bucket_index: int = -1,
) -> List[Tuple[float, Any]]:
    """Fit + score every candidate in one bucket.

    Returns ``(metric, model)`` pairs aligned with ``bucket.param_maps``
    order. Publishes one ``CandidateBatchFitted`` event per call, whichever
    plane (inline sweep, batched CV, gang worker) ran the bucket.
    """
    from mmlspark_tpu_torch.observability import CandidateBatchFitted, get_bus

    t0 = time.perf_counter()
    if bucket.kind == "gbdt":
        models = _fit_bucket_gbdt(bucket, train_table)
    elif bucket.kind == "vw":
        models = _fit_bucket_vw(bucket, train_table)
    else:
        models = [bucket.estimator.copy(p).fit(train_table) for p in bucket.param_maps]
    scored = [(_score(m, valid_table, label_col, metric), m) for m in models]
    bus = get_bus()
    if bus.active:
        bus.publish(CandidateBatchFitted(
            bucket=int(bucket_index), size=bucket.size,
            kind=bucket.kind or "sequential",
            batched=bucket.kind is not None,
            seconds=time.perf_counter() - t0,
        ))
    return scored


def cv_metrics_batched(
    candidates: List[Tuple[Any, Dict[str, Any]]],
    table: Table,
    folds: Sequence[np.ndarray],
    label_col: str,
    metric: str,
) -> List[float]:
    """K-fold CV over all candidates through shape-buckets: per fold, each
    bucket fits K at once instead of candidate-at-a-time. Returns the
    per-candidate mean metric in candidate order: the drop-in replacement
    for ``TuneHyperparameters``'s thread-pool metric loop."""
    buckets = bucket_candidates(candidates)
    n = table.num_rows
    sums = np.zeros(len(candidates), dtype=np.float64)
    for fold in folds:
        mask = np.zeros(n, dtype=bool)
        mask[fold] = True
        train, valid = table.filter(~mask), table.filter(mask)
        for bi, bucket in enumerate(buckets):
            scored = fit_bucket(bucket, train, valid, label_col, metric, bucket_index=bi)
            for pos, idx in enumerate(bucket.indices):
                sums[idx] += scored[pos][0]
    return [float(s / len(folds)) for s in sums]
