"""Imports, the reference's import shim, fixtures and helpers shared by
the test files of one subject:
``test_torch_regression.py``, ``test_torch_regression_quantized.py``,
``test_torch_regression_quantized_robust.py``.

Not a test module: pytest collects nothing here. Each test file imports
by name what it uses, the fixtures included.
"""

import numpy as np
import pytest
import torch

from mmlspark_tpu_torch.data.table import Table
from mmlspark_tpu_torch.lightgbm import LightGBMRegressor
from mmlspark_tpu_torch.lightgbm import binning as tbinning
from mmlspark_tpu_torch.lightgbm import objectives as tobj
from mmlspark_tpu_torch.lightgbm import train as ttrain
from mmlspark_tpu_torch.ops import hopper_histogram as hh


def _import_reference():
    """Import the JAX package's fit path through the u_histogram shim (see
    ``tests/test_torch_gbdt.py``). The JAX package itself is not changed."""
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
except ModuleNotFoundError as err:
    if err.name != "jax":
        raise

STRUCTURE = ("split_feature", "split_bin", "left_child", "right_child", "is_leaf")
OBJECTIVES = ("regression", "regression_l1", "huber", "quantile", "poisson", "tweedie")
BASE = dict(num_iterations=5, num_leaves=15, learning_rate=0.2, min_gain_to_split=1e-3)
QUANT = dict(histogram_method="u", use_quantized_grad=True)


@pytest.fixture(scope="module")
def ref():
    import jax
    import jax.numpy as jnp
    import mmlspark_tpu.lightgbm.binning as jbinning
    import mmlspark_tpu.lightgbm.objectives as jobj
    import mmlspark_tpu.lightgbm.train as jtrain
    from mmlspark_tpu.data.table import Table as JTable
    from mmlspark_tpu.lightgbm import LightGBMRegressor as JRegressor

    return dict(jax=jax, jnp=jnp, binning=jbinning, obj=jobj, train=jtrain, Table=JTable,
                Regressor=JRegressor)


def _case(seed, objective, n=2000, f=8):
    """Gaussian features, a nonlinear score, and a target of the objective's
    kind: counts (poisson), mostly zeros and gamma amounts (tweedie), else a
    shifted score with t(3) noise; row weights in [0.5, 2]."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, f))
    s = X[:, 0] * 2 + X[:, 1] * X[:, 2] + np.sin(X[:, 3]) + 0.5 * rng.normal(size=n)
    if objective == "poisson":
        y = rng.poisson(np.exp(0.3 * s)).astype(np.float64)
    elif objective == "tweedie":
        y = np.where(rng.random(n) < 0.6, 0.0, rng.gamma(2.0, np.exp(0.3 * s)))
    else:
        y = s * 10 + 50 + rng.standard_t(3, n) * 3
    return X, y, rng.uniform(0.5, 2.0, n)


def _fit_both(ref, X, y, w, max_bin, **kw):
    opts = dict(BASE, max_bin=max_bin, **kw)
    bt, mt = tbinning.bin_dataset(X, max_bin=max_bin)
    bj, mj = ref["binning"].bin_dataset(X, max_bin=max_bin)
    rt = ttrain.train(bt, y, ttrain.TrainOptions(**opts), w=w, mapper=mt, device="cpu")
    rj = ref["train"].train(bj, y, ref["train"].TrainOptions(**opts), w=w, mapper=mj)
    return rt, rj


def _same_trees(tb, jb, rtol=1e-5):
    for field in STRUCTURE:
        assert np.array_equal(getattr(tb, field), np.asarray(getattr(jb, field))), field
    jl = np.asarray(jb.leaf_values)
    np.testing.assert_allclose(tb.leaf_values, jl, rtol=rtol, atol=rtol * np.abs(jl).max())


# -- gradients and hessians ---------------------------------------------------------


def _margins(n, seed):
    rng = np.random.default_rng(seed)
    m = rng.normal(size=(n, 1)) * rng.choice([0.1, 1.0, 5.0, 30.0], (n, 1))
    return m.astype(np.float32)


# -- percentile leaf renewal --------------------------------------------------------


def _reference_renewal(jax, jnp):
    """The reference step's renewal (``mmlspark_tpu/lightgbm/train.py``,
    the lines under ``objective.name in ("quantile", "regression_l1")``), line
    for line, jitted as the step is: the oracle for the port's copy."""

    def renew(leaf_val, leaf, resid, w_eff, pct, lr_t):
        m_slots, n_rows = leaf_val.shape[0], resid.shape[0]
        perm1 = jnp.argsort(resid)
        order = perm1[jnp.argsort(leaf[perm1], stable=True)]
        r_s, l_s, w_s = resid[order], leaf[order], w_eff[order]
        cum_all = jnp.cumsum(w_s)
        tw = jax.ops.segment_sum(w_s, l_s, num_segments=m_slots)
        before = cum_all - w_s
        start = jax.ops.segment_min(before, l_s, num_segments=m_slots)
        in_leaf_cum = cum_all - start[l_s]
        hit = in_leaf_cum >= jnp.maximum(pct * tw[l_s], 1e-12)
        last_in_leaf = jnp.concatenate([l_s[1:] != l_s[:-1], jnp.ones(1, bool)])
        hit = hit | last_in_leaf
        pos = jnp.where(hit, jnp.arange(n_rows), n_rows)
        first = jax.ops.segment_min(pos, l_s, num_segments=m_slots)
        vals = r_s[jnp.clip(first, 0, n_rows - 1)] * lr_t
        return jnp.where((tw > 0) & (first < n_rows), vals, leaf_val)

    # pct and the rate traced as float32 scalars: the step's weakly typed
    # Python floats round to the same float32 values
    return jax.jit(renew)


@pytest.fixture(scope="module")
def reference_renewal(ref):
    return _reference_renewal(ref["jax"], ref["jnp"])


def quantized_regression_case(ref, objective, max_bin):
    """Byte for byte for every regression objective, poisson and tweedie
    included: their gradients are the reference's bits, and l1 and quantile
    leaves renew in the reference's order."""
    X, y, w = _case(3, objective)
    rt, rj = _fit_both(ref, X, y, w, max_bin, objective=objective, **QUANT)
    assert rt.stats.quantized and rt.stats.histogram_path == "u"
    assert rt.booster.model_to_string() == rj.booster.model_to_string()
