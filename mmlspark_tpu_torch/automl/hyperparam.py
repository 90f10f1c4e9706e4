"""Hyperparameter spaces: the port's copy of
``mmlspark_tpu/automl/hyperparam.py`` (reference
``automl/HyperparamBuilder.scala:11-57`` and
``automl/DefaultHyperparams.scala:13``). The draws are numpy's, so a seed
gives the same candidates in both packages."""

from __future__ import annotations

from typing import Any, Dict, Iterator, List, Sequence

import numpy as np


class Dist:
    """A distribution over one hyperparameter's values."""

    def get_next(self, rng: np.random.Generator) -> Any:
        raise NotImplementedError


class DiscreteHyperParam(Dist):
    """Uniform over an explicit value list (``DiscreteHyperParam``)."""

    def __init__(self, values: Sequence[Any]):
        if not values:
            raise ValueError("DiscreteHyperParam needs at least one value")
        self.values = list(values)

    def get_next(self, rng: np.random.Generator) -> Any:
        return self.values[int(rng.integers(len(self.values)))]


class IntRangeHyperParam(Dist):
    """Uniform integer in [min, max) (``IntRangeHyperParam``)."""

    def __init__(self, min: int, max: int):
        if max <= min:
            raise ValueError(f"empty range [{min}, {max})")
        self.min, self.max = int(min), int(max)

    def get_next(self, rng: np.random.Generator) -> int:
        return int(rng.integers(self.min, self.max))


class DoubleRangeHyperParam(Dist):
    """Uniform float in [min, max) (``DoubleRangeHyperParam``)."""

    def __init__(self, min: float, max: float):
        if max <= min:
            raise ValueError(f"empty range [{min}, {max})")
        self.min, self.max = float(min), float(max)

    def get_next(self, rng: np.random.Generator) -> float:
        return float(rng.uniform(self.min, self.max))


class HyperparamBuilder:
    """Collects (param name, Dist) pairs into a :class:`RandomSpace`
    (``HyperparamBuilder`` + ``RandomSpace``)."""

    def __init__(self):
        self._dists: Dict[str, Dist] = {}

    def add_hyperparam(self, name: str, dist: Dist) -> "HyperparamBuilder":
        self._dists[name] = dist
        return self

    def build(self) -> "RandomSpace":
        return RandomSpace(self._dists)


class RandomSpace:
    """Samples param maps from per-param distributions (``RandomSpace``)."""

    def __init__(self, dists: Dict[str, Dist], seed: int = 0):
        self.dists = dict(dists)
        self.seed = seed

    def param_maps(self, n: int) -> Iterator[Dict[str, Any]]:
        rng = np.random.default_rng(self.seed)
        for _ in range(n):
            yield {k: d.get_next(rng) for k, d in self.dists.items()}


class GridSpace:
    """Exhaustive cross-product over discrete values (``GridSpace``)."""

    def __init__(self, grids: Dict[str, Sequence[Any]]):
        self.grids = {k: list(v) for k, v in grids.items()}

    def param_maps(self, n: int = -1) -> Iterator[Dict[str, Any]]:
        import itertools

        keys = list(self.grids)
        count = 0
        for combo in itertools.product(*(self.grids[k] for k in keys)):
            if 0 <= n <= count:
                return
            count += 1
            yield dict(zip(keys, combo))


class DefaultHyperparams:
    """Reasonable sweep ranges for the framework's learners
    (``automl/DefaultHyperparams.scala:13``)."""

    @staticmethod
    def lightgbm() -> Dict[str, Dist]:
        return {
            "numLeaves": DiscreteHyperParam([15, 31, 63]),
            "numIterations": DiscreteHyperParam([50, 100, 200]),
            "learningRate": DoubleRangeHyperParam(0.01, 0.3),
            "featureFraction": DoubleRangeHyperParam(0.6, 1.0),
        }

    @staticmethod
    def sgd() -> Dict[str, Dist]:
        """The VW learners' SGD space."""
        # param names match the VW estimator surface (``l2``, not the
        # reference's ``l2Regularization`` — that drift made the space
        # unusable against the real estimators)
        return {
            "learningRate": DoubleRangeHyperParam(0.005, 0.5),
            "l2": DoubleRangeHyperParam(1e-8, 1e-2),
            "numPasses": DiscreteHyperParam([1, 3, 5]),
        }

    @staticmethod
    def vw() -> Dict[str, Dist]:
        """Text-learner space for the VW estimators: the per-candidate
        lanes (``learningRate``/``powerT``/``l1``/``l2``) plus
        ``numPasses``, so a random draw shape-buckets into few batched fits."""
        return {
            "learningRate": DoubleRangeHyperParam(0.05, 1.0),
            "powerT": DiscreteHyperParam([0.0, 0.5]),
            "l1": DiscreteHyperParam([0.0, 1e-6, 1e-4]),
            "l2": DoubleRangeHyperParam(1e-8, 1e-3),
            "numPasses": DiscreteHyperParam([1, 3, 5]),
        }
