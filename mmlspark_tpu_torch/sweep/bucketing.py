"""Shape-bucketing: which sweep candidates can share one batched fit.

The port's copy of ``mmlspark_tpu/sweep/bucketing.py``. The many-models
plane fits a bucket's candidates K at once
(:func:`mmlspark_tpu_torch.lightgbm.train.train_many`: one binning, one
upload of the bins, the candidates in lockstep;
:func:`mmlspark_tpu_torch.vw.base.train_linear_many`: one row layout, one
upload, K states stepped together). Two candidates share a bucket only when
every *program-shaping* option agrees (``numLeaves`` changes tree-array
shapes, ``numIterations`` the loop length, the objective the gradients)
while the per-candidate lanes (learning rate, bagging and feature fractions
for GBDT; learning rate, ``powerT``, ``l1``, ``l2`` for VW) may differ.

:func:`bucket_candidates` partitions a candidate list into
:class:`CandidateBucket` groups by that rule: candidates whose param maps
differ only in vmapped params share a bucket; everything else
(heterogeneous statics, non-batchable estimators, option surfaces the
batched core excludes) lands in singleton buckets fitted through the
ordinary ``estimator.fit`` path. Bucketing is deterministic (first-seen
order) so the gang scheduler can shard buckets across processes by index.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

from mmlspark_tpu_torch.core.pipeline import Estimator

#: Estimator param names that may differ inside a GBDT bucket: the
#: ``lightgbm.train.MANY_VMAPPED_FIELDS`` in estimator-param space.
GBDT_VMAPPED = frozenset({
    "learningRate",
    "featureFraction",
    "baggingFraction",
    "baggingFreq",
    "posBaggingFraction",
    "negBaggingFraction",
})

#: Estimator param names that may differ inside a VW bucket.
VW_VMAPPED = frozenset({"learningRate", "powerT", "l1", "l2"})

#: VW pass-through flags that would override a per-candidate lane with a
#: static (``--learning_rate 0.1`` wins over ``learningRate``), breaking the
#: per-candidate stacks. Candidates carrying them fall back to singleton.
_VW_ARG_CONFLICTS = frozenset({"learning_rate", "power_t", "l1", "l2"})


def _freeze(value: Any):
    """Hashable stand-in for a param value (bucket keys live in sets)."""
    if isinstance(value, (list, tuple)):
        return tuple(_freeze(v) for v in value)
    if isinstance(value, dict):
        return tuple(sorted((k, _freeze(v)) for k, v in value.items()))
    try:
        hash(value)
        return value
    except TypeError:
        return repr(value)


@dataclasses.dataclass
class CandidateBucket:
    """One shape-bucket: candidates sharing one batched fit.

    ``kind`` is ``"gbdt"`` / ``"vw"`` for a batchable bucket (fitted K at
    once by :func:`mmlspark_tpu_torch.sweep.batched.fit_bucket`) or ``None`` for
    a singleton fallback fitted through ``estimator.copy(params).fit``.
    ``indices`` maps each bucket position back into the original candidate
    list, so leaderboards and journals stay in candidate order.
    """

    estimator: Estimator
    kind: Optional[str]
    param_maps: List[Dict[str, Any]]
    indices: List[int]

    @property
    def size(self) -> int:
        return len(self.param_maps)


def _gbdt_batchable(cand: Estimator) -> bool:
    """Option surface the GBDT batched core supports: plain gbdt/goss
    boosting, single-program fit (no batch/process splits), no warm start,
    no init scores, no validation sets or per-iteration metric plumbing
    (``train_many`` returns no eval history), no live callbacks, and no
    per-fit objective (the ranker's closes over its fit's query groups)."""
    from mmlspark_tpu_torch.lightgbm.base import LightGBMBase

    if cand.getBoostingType() not in ("gbdt", "goss"):
        return False
    if cand.getNumIterations() <= 0:
        return False
    if cand.getNumBatches() > 1 or cand.getNumProcesses() > 1:
        return False
    if cand.getModelString():
        return False
    if cand.isSet("initScoreCol") or cand.isSet("validationIndicatorCol"):
        return False
    if cand.getIsProvideTrainingMetric() or cand.getEarlyStoppingRound() > 0:
        return False
    if cand.callbacks:
        return False
    if type(cand)._train_objective is not LightGBMBase._train_objective:
        return False
    return True


def _vw_batchable(cand: Estimator) -> bool:
    """VW candidates batch unless pass-through args pin a vmapped lane."""
    try:
        args = cand._parse_args()
    except ValueError:
        return False  # bad flags surface on the sequential path
    return not (_VW_ARG_CONFLICTS & set(args))


def _candidate_kind(cand: Estimator) -> Optional[str]:
    from mmlspark_tpu_torch.lightgbm.base import LightGBMBase
    from mmlspark_tpu_torch.vw.base import VowpalWabbitBase

    if isinstance(cand, LightGBMBase) and _gbdt_batchable(cand):
        return "gbdt"
    if isinstance(cand, VowpalWabbitBase) and _vw_batchable(cand):
        return "vw"
    return None


def _bucket_key(cand: Estimator, kind: str):
    """Statics that must agree for two candidates to share a bucket:
    every set param EXCEPT the vmapped lanes. Estimator class is part of
    the key (classifier vs regressor = different objective)."""
    vmapped = GBDT_VMAPPED if kind == "gbdt" else VW_VMAPPED
    statics = frozenset(
        (name, _freeze(value))
        for name, value in cand.extractParamMap().items()
        if name not in vmapped
    )
    return (kind, type(cand).__name__, statics)


def bucket_candidates(
    candidates: List[Tuple[Estimator, Dict[str, Any]]],
) -> List[CandidateBucket]:
    """Partition ``(estimator, param_map)`` candidates into shape-buckets.

    Returns buckets in first-seen deterministic order; the union of all
    ``indices`` is exactly ``range(len(candidates))``.
    """
    buckets: List[CandidateBucket] = []
    by_key: Dict[Any, CandidateBucket] = {}
    for i, (est, params) in enumerate(candidates):
        cand = est.copy(params)
        kind = _candidate_kind(cand)
        if kind is None:
            buckets.append(CandidateBucket(
                estimator=est, kind=None, param_maps=[dict(params)],
                indices=[i],
            ))
            continue
        key = _bucket_key(cand, kind)
        bucket = by_key.get(key)
        if bucket is None:
            bucket = CandidateBucket(
                estimator=est, kind=kind, param_maps=[], indices=[],
            )
            by_key[key] = bucket
            buckets.append(bucket)
        bucket.param_maps.append(dict(params))
        bucket.indices.append(i)
    return buckets
