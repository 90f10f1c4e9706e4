"""Carry fitted state from the JAX package into the port.

Each takes plain numpy state — ``mmlspark_tpu`` ``Booster.to_dict()``, a
``BinMapper``'s arrays, a VW model's param values, the fitted arrays of an
isolation forest, a SAR, a KNN index, a tabular LIME model or a ResNet's
parameter tree — so this module imports nothing of the JAX package.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np

from mmlspark_tpu_torch.lightgbm.binning import BinMapper
from mmlspark_tpu_torch.lightgbm.booster import Booster
from mmlspark_tpu_torch.lightgbm.bundling import BundleSpec


def booster_from_jax(d: Dict[str, Any]) -> Booster:
    """The port's :class:`Booster` from a JAX ``Booster.to_dict()``. The two
    dataclasses share their fields; values arrive as numpy arrays, a
    categorical booster brings its split sets and category values, and a
    linear-tree booster its leaf models. Boosters of every objective carry
    over (the objective is a name in the booster)."""
    fields = {f.name for f in Booster.__dataclass_fields__.values()}
    unknown = set(d) - fields
    if unknown:
        raise ValueError(f"JAX booster fields unknown to the port: {sorted(unknown)}")
    return Booster.from_dict({k: v for k, v in d.items() if k in fields})


def bin_mapper_from_jax(edges, num_bins, max_bin: int, cat_values=None,
                        bundles=None) -> BinMapper:
    """The port's :class:`BinMapper` from a JAX mapper's ``edges``,
    ``num_bins``, ``max_bin``, ``cat_values`` (feature -> raw category
    values) and ``bundles`` (a JAX ``BundleSpec``, or the dict of its
    fields); the bundle spec is rebuilt field for field from its tuples."""
    if bundles is not None:
        fields = (bundles if isinstance(bundles, dict)
                  else {k: getattr(bundles, k) for k in BundleSpec.__dataclass_fields__})
        bundles = BundleSpec(**{
            k: (tuple(tuple(int(j) for j in m) for m in v) if k == "members"
                else tuple(bool(x) for x in v) if k == "identity"
                else tuple(int(x) for x in v) if isinstance(v, (tuple, list)) else int(v))
            for k, v in fields.items()
        })
    return BinMapper(
        edges=np.array(edges, dtype=np.float64),
        num_bins=np.array(num_bins, dtype=np.int32),
        max_bin=int(max_bin),
        cat_values=({int(j): np.array(v, dtype=np.float64) for j, v in cat_values.items()}
                    if cat_values else None),
        bundles=bundles,
    )


#: the params that make a VW model: its weights and feature space, its bias
#: slot and its link
VW_MODEL_PARAMS = ("modelWeights", "sparseDim", "constantIndex", "numBits", "linkFunction")


def vw_model_from_jax(params: Dict[str, Any], kind: str = "classifier", **kwargs):
    """The port's VW model (``kind`` "classifier" or "regressor") from a JAX
    VW model's param values as numpy (``{name: model.getOrDefault(name)}``
    for :data:`VW_MODEL_PARAMS`; ``modelWeights`` is required, the others
    take their defaults when absent). ``kwargs`` are the port model's other
    params (columns, ``device``)."""
    from mmlspark_tpu_torch.vw import (
        VowpalWabbitClassificationModel,
        VowpalWabbitRegressionModel,
    )

    classes = {"classifier": VowpalWabbitClassificationModel,
               "regressor": VowpalWabbitRegressionModel}
    if kind not in classes:
        raise ValueError(f"kind must be one of {sorted(classes)}, got {kind!r}")
    if "modelWeights" not in params:
        raise ValueError("a VW model's params need modelWeights")
    values = {k: params[k] for k in VW_MODEL_PARAMS if k in params}
    values["modelWeights"] = np.asarray(values["modelWeights"], dtype=np.float32)
    return classes[kind](**values, **kwargs)


def isolation_forest_from_jax(trees: Dict[str, Any], numSamples: int, maxDepth: int,
                              outlierScoreThreshold: float, **params):
    """The port's :class:`IsolationForestModel` from a JAX model's packed
    ``trees`` (a dict of numpy arrays, ``getTrees()``), ``numSamples``,
    ``maxDepth`` and ``outlierScoreThreshold``; ``params`` are its other
    params (columns, ``device``)."""
    from mmlspark_tpu_torch.isolationforest import IsolationForestModel

    dtypes = {"feature": np.int32, "threshold": np.float32, "left": np.int32,
              "right": np.int32, "path_adjust": np.float32}
    missing = sorted(set(dtypes) - set(trees))
    if missing:
        raise ValueError(f"packed trees lack {missing}")
    packed = {k: np.array(trees[k], dtype=t) for k, t in dtypes.items()}
    return IsolationForestModel(trees=packed, numSamples=int(numSamples),
                                maxDepth=int(maxDepth),
                                outlierScoreThreshold=float(outlierScoreThreshold), **params)


def sar_model_from_jax(userAffinity, itemSimilarity, **params):
    """The port's :class:`SARModel` from a JAX model's ``userAffinity`` and
    ``itemSimilarity`` (numpy, float64 as fitted); ``params`` are its other
    params (columns, ``device``)."""
    from mmlspark_tpu_torch.recommendation import SARModel

    return SARModel(userAffinity=np.array(userAffinity, dtype=np.float64),
                    itemSimilarity=np.array(itemSimilarity, dtype=np.float64), **params)


def knn_model_from_jax(indexKeys, indexValues, indexLabels=None, **params):
    """The port's :class:`KNNModel`, or :class:`ConditionalKNNModel` when
    ``indexLabels`` is given, from a JAX model's index keys (numpy), values
    and labels; ``params`` are its other params (columns, ``k``,
    ``method``, ``device``)."""
    from mmlspark_tpu_torch.nn import ConditionalKNNModel, KNNModel

    keys = np.array(indexKeys, dtype=np.float64)
    if indexLabels is None:
        return KNNModel(indexKeys=keys, indexValues=list(indexValues), **params)
    return ConditionalKNNModel(indexKeys=keys, indexValues=list(indexValues),
                               indexLabels=list(indexLabels), **params)


def tabular_lime_model_from_jax(columnMeans, columnSTDs, model, **params):
    """The port's :class:`TabularLIMEModel` from a JAX model's column means
    and standard deviations (numpy) and an inner ``model`` of the port (one
    carried with :func:`booster_from_jax`, say); ``params`` are its other
    params (columns, ``nSamples``, ``regularization``, ``seed``,
    ``device``)."""
    from mmlspark_tpu_torch.lime import TabularLIMEModel

    return TabularLIMEModel(columnMeans=np.array(columnMeans, dtype=np.float64),
                            columnSTDs=np.array(columnSTDs, dtype=np.float64), model=model,
                            **params)


def resnet_params_from_jax(params: Any, device: Any = None):
    """The port's ResNet from a JAX zoo ResNet's parameter tree (numpy
    arrays, as ``init_resnet`` makes them or ``jax.device_get`` returns
    them): ``(tree, ResNet)``, the tree as float32 numpy and the module on
    ``device`` (default the card)."""
    from mmlspark_tpu_torch.device import resolve_device
    from mmlspark_tpu_torch.models.resnet import ResNet

    tree = _float32_tree(params)
    return tree, ResNet(tree, device=resolve_device(device))


def _float32_tree(params: Any) -> Any:
    from mmlspark_tpu_torch.core.pytree import tree_map

    return tree_map(lambda a: np.array(a, dtype=np.float32), params)


#: the params of an ImageFeaturizer that carry over as they are
FEATURIZER_PARAMS = ("inputCol", "outputCol", "cutOutputLayers", "inputHeight", "inputWidth",
                     "autoResize", "scale", "batchSize")


def dnn_model_from_jax(model: Any, **params):
    """The port's :class:`ImageFeaturizer` from a JAX ``ImageFeaturizer``
    whose backbone is the zoo ResNet (``applyFn`` unset, or the JAX zoo's
    ``resnet_apply``): its params and its weights as numpy. ``params`` are
    the port model's other params (``device``). A JAX ``applyFn`` (a
    ``DNNModel``'s, a pipeline stage, an expert, a featurizer's own
    backbone) is a jax function and cannot cross: this raises
    ``ValueError`` for it; rebuild such a model with a torch callable
    (``from_torch``, ``from_onnx``) and carry its params."""
    from mmlspark_tpu_torch.image import ImageFeaturizer

    kind = type(model).__name__
    fns = {name: model.getOrDefault(name) for name in
           ("applyFn", "pipelineStageFn", "expertFn") if name in model.params}
    if kind == "ImageFeaturizer":
        fn = fns.get("applyFn")
        if fn is None or (getattr(fn, "__name__", "") == "resnet_apply"
                          and getattr(fn, "__module__", "").endswith("models.resnet")):
            values = {name: model.getOrDefault(name) for name in FEATURIZER_PARAMS}
            return ImageFeaturizer(modelParams=_float32_tree(model.getOrDefault("modelParams")),
                                   **values, **params)
    used = sorted(k for k, v in fns.items() if v is not None)
    raise ValueError(
        f"a JAX {kind}'s {', '.join(used) or 'backbone'} is a jax function and cannot "
        "cross to the port; only an ImageFeaturizer over the zoo ResNet carries over. "
        "Rebuild the network as a torch module (from_torch, from_onnx) and carry its params"
    )
