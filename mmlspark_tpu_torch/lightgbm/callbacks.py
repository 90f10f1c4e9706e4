"""Training delegate/callback hooks for GBDT boosting.

The port's copy of ``mmlspark_tpu/lightgbm/callbacks.py`` (the reference's
``LightGBMDelegate``: beforeTrainIteration / afterTrainIteration /
getLearningRate). ``get_learning_rate(iteration)`` is a schedule: a pure
function of the iteration, read once into a ``(num_iterations,)`` float32
array before the fit. ``before_iteration`` / ``after_iteration`` run on the
host each iteration; ``after_iteration`` returning ``True`` stops training
(the delegate's early-stop channel, beside metric-based early stopping).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np


@dataclasses.dataclass
class CallbackEnv:
    """What a hook sees. ``evals`` holds the metric history so far
    (set name -> metric -> scores per iteration)."""

    iteration: int  # 0-based
    num_iterations: int
    learning_rate: float
    evals: Dict[str, Dict[str, List[float]]]


class TrainingCallback:
    """Base delegate. Override any subset; the default is a no-op."""

    def before_training(self, env: CallbackEnv) -> None:  # noqa: B027
        pass

    def after_training(self, env: CallbackEnv) -> None:  # noqa: B027
        pass

    def before_iteration(self, env: CallbackEnv) -> None:  # noqa: B027
        pass

    def after_iteration(self, env: CallbackEnv) -> Optional[bool]:
        """Return True to stop training after this iteration."""
        return None

    def get_learning_rate(self, iteration: int) -> Optional[float]:
        """Schedule-only dynamic LR; None = keep the configured rate."""
        return None


class LearningRateSchedule(TrainingCallback):
    """``reset_parameter``-style LR schedule from a function or list."""

    def __init__(self, schedule):
        self._schedule = schedule

    def get_learning_rate(self, iteration: int) -> float:
        if callable(self._schedule):
            return float(self._schedule(iteration))
        return float(self._schedule[iteration])


def _has_iteration_hooks(callbacks: Sequence[TrainingCallback]) -> bool:
    """True when any callback overrides a per-iteration host hook."""
    for cb in callbacks:
        if type(cb).before_iteration is not TrainingCallback.before_iteration:
            return True
        if type(cb).after_iteration is not TrainingCallback.after_iteration:
            return True
    return False


def _lr_schedule(callbacks: Sequence[TrainingCallback], base_lr: float, num_iterations: int):
    """(num_iterations,) float32 LR array, or None when constant. The LAST
    callback that returns a rate for an iteration wins (delegate chaining)."""
    out = np.full(num_iterations, base_lr, dtype=np.float32)
    dynamic = False
    for cb in callbacks:
        if type(cb).get_learning_rate is TrainingCallback.get_learning_rate:
            continue
        for it in range(num_iterations):
            lr = cb.get_learning_rate(it)
            if lr is not None:
                out[it] = lr
                dynamic = True
    return out if dynamic else None
