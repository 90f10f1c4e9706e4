"""Imports, the reference's import shim, fixtures and helpers shared by
the test files of one subject:
``test_torch_bundling.py``, ``test_torch_bundling_fits.py``.

Not a test module: pytest collects nothing here. Each test file imports
by name what it uses, the fixtures included.
"""

import dataclasses

import numpy as np
import pytest
import torch

from mmlspark_tpu_torch.data.table import Table
from mmlspark_tpu_torch.lightgbm import LightGBMClassifier
from mmlspark_tpu_torch.lightgbm import binning as tbinning
from mmlspark_tpu_torch.lightgbm import bundling as tbund
from mmlspark_tpu_torch.lightgbm import train as ttrain
from mmlspark_tpu_torch.lightgbm.convert import bin_mapper_from_jax
from mmlspark_tpu_torch.ops import u_histogram as tu


def _import_reference():
    """Import the JAX package's fit path through the u_histogram shim it
    needs on jax 0.9 (see ``tests/test_torch_gbdt.py``); the JAX package
    itself is not changed."""
    from jax._src.lax import lax as lax_internal
    from jax.interpreters import batching

    saved = batching.primitive_batchers
    batching.primitive_batchers = {lax_internal.optimization_barrier_p: None}
    try:
        import mmlspark_tpu.ops.u_histogram  # noqa: F401
    finally:
        batching.primitive_batchers = saved


try:
    _import_reference()
    import jax
    import jax.numpy as jnp
    import mmlspark_tpu.lightgbm.binning as jbinning
    import mmlspark_tpu.lightgbm.bundling as jbund
    import mmlspark_tpu.lightgbm.train as jtrain
    import mmlspark_tpu.ops.u_histogram as ju
    from mmlspark_tpu.lightgbm import LightGBMClassifier as JLightGBMClassifier
    from mmlspark_tpu.data.table import Table as JTable
except ModuleNotFoundError as err:
    if err.name != "jax":
        raise

STRUCTURE = ("split_feature", "split_bin", "left_child", "right_child", "is_leaf")


def one_hot_case(n=2000, blocks=4, card=5, conts=2, seed=0, conflict=0.0):
    """Blocks of value-bearing one-hot indicators (exclusive within a block)
    and dense continuous columns; ``conflict`` sets a second hot column in
    that share of a block's rows. The label carries noise, so leaves stay
    mixed and no split is chosen on a gain at float32 noise level."""
    rng = np.random.default_rng(seed)
    X = np.zeros((n, blocks * card), np.float64)
    for b in range(blocks):
        hot = rng.integers(0, card, n)
        X[np.arange(n), b * card + hot] = rng.uniform(0.5, 2.0, n)
        if conflict:
            rows = np.nonzero(rng.uniform(size=n) < conflict)[0]
            X[rows, b * card + (hot[rows] + 1) % card] = 1.0
    X = np.hstack([X, rng.normal(size=(n, conts))])
    logit = X[:, 0] + 2 * X[:, (card + 2) % (blocks * card)] + X[:, -1] - 1.2
    y = (logit + rng.logistic(size=n) > 0).astype(np.float64)
    return X, y


def _spec_dict(spec):
    return None if spec is None else dataclasses.asdict(spec)


# -- fits ------------------------------------------------------------------------

FIT = dict(objective="binary", num_iterations=4, num_leaves=15, max_bin=31, learning_rate=0.2)
# (name, histogram_method, quantized, MMLSPARK_TPU_U_BUDGET)
PATHS = [
    ("compare", None, False, None),
    ("u_bf16", "u", False, None),
    ("u_quant", "u", True, None),
    ("chunked_bf16", "u", False, "40000"),
    ("chunked_quant", "u", True, "40000"),
]


def _fit_both(monkeypatch, X, y, budget, bundling=True, cats=(), **kw):
    if budget is None:
        monkeypatch.delenv("MMLSPARK_TPU_U_BUDGET", raising=False)
    else:
        monkeypatch.setenv("MMLSPARK_TPU_U_BUDGET", budget)
    bkw = dict(max_bin=FIT["max_bin"], feature_bundling=bundling,
               categorical_features=list(cats) or None)
    bt, mt = tbinning.bin_dataset(X, **bkw)
    bj, mj = jbinning.bin_dataset(X, **bkw)
    opts = {**FIT, **kw}
    rt = ttrain.train(bt, y, ttrain.TrainOptions(**opts), mapper=mt, device="cpu")
    jb = jtrain.train(bj, y, jtrain.TrainOptions(**opts), mapper=mj).booster
    return rt, jb, mt
