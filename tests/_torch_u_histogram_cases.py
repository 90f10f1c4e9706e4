"""Imports, the reference's import shim, fixtures and helpers shared by
the test files of one subject:
``test_torch_u_histogram.py``, ``test_torch_fits_u_path.py``,
``test_torch_oom_ladder.py``, ``test_torch_u_path_parity_fits.py``.

Not a test module: pytest collects nothing here. Each test file imports
by name what it uses, the fixtures included.
"""

import dataclasses
import logging

import numpy as np
import pytest
import torch

from mmlspark_tpu_torch.data.table import Table
from mmlspark_tpu_torch.lightgbm import LightGBMClassifier
from mmlspark_tpu_torch.lightgbm import binning as tbinning
from mmlspark_tpu_torch.lightgbm import train as ttrain
from mmlspark_tpu_torch.ops import hopper_histogram as hh
from mmlspark_tpu_torch.ops import u_histogram as tu
from mmlspark_tpu_torch.runtime.faults import DeviceOomError, FaultPlan, inject_faults


def _import_reference():
    """Import the JAX package's U module through the shim it needs on jax
    0.9, where ``mmlspark_tpu/ops/u_histogram.py`` fails at import (it tests
    membership in ``batching.primitive_batchers``, which jax 0.9 no longer
    makes iterable): while it imports, a plain dict that already holds the
    barrier rule stands in; then the original table is restored. The JAX
    package itself is not changed."""
    from jax._src.lax import lax as lax_internal
    from jax.interpreters import batching

    saved = batching.primitive_batchers
    batching.primitive_batchers = {lax_internal.optimization_barrier_p: None}
    try:
        import mmlspark_tpu.ops.u_histogram  # noqa: F401
    finally:
        batching.primitive_batchers = saved


# At import, so that every pytest worker has the module before it collects
# the JAX package's own test files. A machine without jax (the card's) runs
# only the `cuda` tests, which need none of it.
try:
    _import_reference()
    import jax
    import jax.numpy as jnp
    import mmlspark_tpu.lightgbm.binning as jbinning
    import mmlspark_tpu.lightgbm.train as jtrain
    import mmlspark_tpu.ops.u_histogram as ju
    from mmlspark_tpu.lightgbm.objectives import auc
    from mmlspark_tpu.ops import pallas_histogram as jp
except ModuleNotFoundError as err:
    if err.name != "jax":
        raise

WIDTHS = (32, 5, 17, 32, 2, 9, 31)


def _mixed_case(seed=0, n=3000, k=5):
    """``tests/test_u_histogram.py``'s case: mixed feature widths, node keys
    in [-1, k+2) (some out of range)."""
    rng = np.random.default_rng(seed)
    bins = np.stack([rng.integers(0, w, size=n) for w in WIDTHS], axis=1).astype(np.uint8)
    g = rng.normal(size=n).astype(np.float32)
    h = rng.uniform(0.1, 1, size=n).astype(np.float32)
    c = (rng.uniform(size=n) > 0.2).astype(np.float32)
    node = rng.integers(-1, k + 2, size=n).astype(np.int32)
    return bins, g, h, c, node


def _jax_uniforms(key, n):
    """The (2, n) uniforms ``stat_rows_quant`` draws from ``key``."""
    kg, kh = jax.random.split(key)
    return np.stack([np.asarray(jax.random.uniform(kk, (n,), dtype=jnp.float32))
                     for kk in (kg, kh)])


def _quant_stats(g, h, c, seed):
    """The reference's quantized stats as its fits compute them: compiled,
    where XLA fuses ``x * (127 / s) + u`` into a multiply-add and divides
    by the constant 127 as a multiply by its reciprocal."""
    key = jax.random.PRNGKey(seed)
    ref = jax.jit(ju.stat_rows_quant)(jnp.asarray(g), jnp.asarray(h), jnp.asarray(c), key)
    port = tu.stat_rows_quant(torch.from_numpy(g), torch.from_numpy(h), torch.from_numpy(c),
                              torch.from_numpy(_jax_uniforms(key, len(g))))
    return ref, port


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _assert_bf16_close(port, ref):
    """bf16 path: counts exact, g and h within 1e-5 * sum|x| + 1e-6."""
    port, ref = np.asarray(port, np.float64), np.asarray(ref, np.float64)
    np.testing.assert_array_equal(port[..., 2], ref[..., 2])
    assert np.all(np.abs(port - ref) <= 1e-5 * np.abs(ref) + 1e-6)


# -- histogram passes ---------------------------------------------------------


def _pass_inputs(k, quant, seed=0, n=3000):
    bins, g, h, c, node = _mixed_case(seed=seed, n=n, k=k)
    if quant:
        jstats, tstats = _quant_stats(g, h, c, seed + 100)
    else:
        jstats = tstats = None
    return bins, g, h, c, node, jstats, tstats


def _reference_pass(builder, bins, g, h, c, node, k, jstats, dequant):
    js = ju.make_u_spec(32, len(WIDTHS), WIDTHS)
    args = tuple(map(jnp.asarray, (g, h, c, node)))
    kw = dict(stats=jstats, dequant=dequant)
    if builder == "resident":
        return ju.build_histograms_u(ju.build_u(jnp.asarray(bins), js), *args, k, js, **kw)
    if builder == "chunked":
        cs = ju.chunked_u_spec(len(bins), js, 1)
        return ju.build_histograms_u_chunked(ju.prepare_chunked_bins(jnp.asarray(bins), cs),
                                             *args, k, cs, **kw)
    return jp.build_histograms_bin_scatter(jnp.asarray(bins.astype(np.int32)), *args, k, js,
                                           interpret=True, **kw)


def _port_pass(builder, bins, g, h, c, node, k, tstats, dequant):
    ts = tu.make_u_spec(32, len(WIDTHS), WIDTHS)
    (bt,) = _t(bins.T)
    args = _t(g, h, c, node)
    kw = dict(stats=tstats, dequant=dequant)
    if builder == "resident":
        return tu.build_histograms_u(tu.build_u(bt, ts), *args, k, ts, **kw)
    if builder == "chunked":
        cs = tu.chunked_u_spec(len(bins), ts, 1)
        return tu.build_histograms_u_chunked(tu.prepare_chunked_bins(bt, cs), *args, k, cs,
                                             **kw)
    return hh.build_histograms_bin_scatter(bt, *args, k, ts, **kw)


def _wrapper_args(n=64, k=2):
    ts = tu.make_u_spec(32, len(WIDTHS), WIDTHS)
    return dict(u=torch.zeros((ts.k_pad, 512), dtype=torch.uint8),
                stats=torch.zeros((3, n), dtype=torch.int8),
                node=torch.zeros(n, dtype=torch.int32), num_nodes=k)


def _check_scatter_plan(per_feature, k, quant, budget):
    spec = tu.make_u_spec(256, 28 if per_feature is None else len(per_feature), per_feature)
    plan = hh.bin_scatter_plan(11_000_000, spec, k, quant, num_sms=132)
    assert plan.smem_bytes <= budget <= hh.SMEM_MAX
    assert plan.smem_bytes == plan.chunk_rows * 3 * k * (4 if quant else 8)
    assert plan.grid_x * plan.chunk_rows >= spec.k > (plan.grid_x - 1) * plan.chunk_rows
    # the fewest chunks the budget allows
    assert plan.grid_x == -(-spec.k // min(spec.k, budget // (3 * k * (4 if quant else 8))))
    assert plan.rows_per_block % hh.ROWS_PER_THREAD == 0
    assert plan.grid_y * plan.rows_per_block >= 11_000_000 > (
        (plan.grid_y - 1) * plan.rows_per_block)
    for j in range(plan.grid_x):
        first, last = plan.features[2 * j : 2 * j + 2]
        c0, c1 = j * plan.chunk_rows, min((j + 1) * plan.chunk_rows, spec.k)
        owners = {f for f, (o, w) in enumerate(zip(spec.offsets, spec.widths))
                  if o < c1 and o + w > c0}
        assert owners == set(range(first, last + 1))


# -- the packed-space kernels' arithmetic, mirrored in numpy ------------------

MASK32 = (1 << 32) - 1
MASK64 = (1 << 64) - 1


def _plane_add(lo, hi, idx, v):
    """``packed_hist.cuh``'s 64-bit shared add: the low half with one uint32
    atomic, its carry out added with the high half by a second, and a half
    that adds 0 skipped. ``lo`` and ``hi`` are the two planes."""
    v &= MASK64
    ql, qh = v & MASK32, v >> 32
    if ql:
        old = lo[idx]
        lo[idx] = (old + ql) & MASK32
        qh = (qh + (1 if old > MASK32 - ql else 0)) & MASK32  # old > ~ql
    if qh:
        hi[idx] = (hi[idx] + qh) & MASK32


def _as_int64(v):
    v &= MASK64
    return v - (1 << 64) if v >> 63 else v


def _largest_fixed_point(n):
    """The largest ``round(x * 2**s)`` the U path's scales give N rows."""
    x = torch.full((n,), 0.99609375, dtype=torch.bfloat16)  # just below a power of two
    scale = tu.stat_scales(torch.stack([x, x, x]))[0].item()
    return int(round(0.99609375 * scale))


Q64 = _largest_fixed_point(11_000_000)
EDGES64 = [1, -1, 2 ** 32 - 1, -(2 ** 32 - 1), 2 ** 32, -(2 ** 32), 2 ** 37, Q64, -Q64,
           2 ** 62, -(2 ** 62)]


def _stack(bins_t, chunk, seed):
    """(m, F, chunk) stack of the (F, N) bins, as ``prepare_chunked_bins``
    lays it out, with random bins in the padded tail (rows at or past N),
    which no version may read."""
    f, n = bins_t.shape
    m = -(-n // chunk)
    x = torch.from_numpy(np.random.default_rng(seed).integers(0, 256, (f, m * chunk))
                         .astype(np.uint8))
    x[:, :n] = bins_t
    return x.reshape(f, m, chunk).permute(1, 0, 2).contiguous()


def _mirror_bin_scatter(stack, q, node, k, spec, plan, n, quant, seed):
    """bin_scatter.cu in numpy: the plan's blocks, each walking its row
    range in 4-row steps (in a shuffled order: threads run in any order),
    finding each row's bytes in the stack (a step may cross a chunk's end),
    adding into int32 cells or lo/hi planes, then the flush into the global
    accumulator mod 2**64. ``q`` holds the (3, n) integers the kernel sums."""
    m, f, chunk = stack.shape
    flat = stack.reshape(-1).tolist()
    width = 3 * k
    out = [0] * (spec.k_pad * width)
    rng = np.random.default_rng(seed)
    for bx in range(plan.grid_x):
        c0 = bx * plan.chunk_rows
        nc = min(plan.chunk_rows, spec.k - c0)
        first, last = plan.features[2 * bx : 2 * bx + 2]
        for by in range(plan.grid_y):
            r0 = by * plan.rows_per_block
            assert r0 % hh.ROWS_PER_THREAD == 0
            r1 = min(n, r0 + plan.rows_per_block)
            lo, hi = [0] * (nc * width), [0] * (nc * width)
            for i in rng.permutation(np.arange(r0, r1, 4)).tolist():
                rows = range(i, min(i + 4, r1))
                keys = [int(node[r]) if 0 <= node[r] < k else -1 for r in rows]
                ci, col = divmod(i, chunk)
                for ff in range(first, last + 1):
                    for r, key in enumerate(keys):
                        cr = (col + r) // chunk
                        b = flat[((ci + cr) * f + ff) * chunk + col + r - cr * chunk]
                        c = spec.offsets[ff] - c0 + b
                        if key < 0 or b >= spec.widths[ff] or not 0 <= c < nc:
                            continue
                        for s in range(3):
                            cell = c * width + s * k + key
                            if quant:
                                lo[cell] += q[s][i + r]
                            else:
                                _plane_add(lo, hi, cell, q[s][i + r])
            for j in range(nc * width):
                v = lo[j] if quant else lo[j] | (hi[j] << 32)
                out[c0 * width + j] = (out[c0 * width + j] + v) & MASK64
    acc = np.array([_as_int64(v) for v in out], dtype=np.int64).reshape(spec.k_pad, width)
    return acc.astype(np.int32) if quant else acc


# -- fits -----------------------------------------------------------------------

STRUCTURE = ("split_feature", "split_bin", "left_child", "right_child", "is_leaf")


def _fit_case(seed=11, n=1400, f=8):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, f))
    y = ((X[:, 0] + X[:, 1] * X[:, 2]) > 0).astype(np.float64)
    return X, y


FIT = dict(objective="binary", num_iterations=6, num_leaves=15, max_bin=63)


def _fit_port(X, y, **kw):
    bt, mt = tbinning.bin_dataset(X, max_bin=63)
    return ttrain.train(bt, y, ttrain.TrainOptions(**{**FIT, **kw}), mapper=mt, device="cpu")


def _fit_reference(X, y, **kw):
    bj, mj = jbinning.bin_dataset(X, max_bin=63)
    return jtrain.train(bj, y, jtrain.TrainOptions(**{**FIT, **kw}), mapper=mj).booster


# -- the out-of-memory ladder --------------------------------------------------


def _device_ooms(*keys):
    """A fault plan with a device OOM at each (iteration, retry) key."""
    plan = FaultPlan()
    for it, attempt in keys:
        plan.oom_task(it, kind="device", attempt=attempt)
    return plan


def _fired(plan):
    return [(it, attempt) for kind, it, attempt in plan.fired if kind == "oom_device"]


def _oom_fit(X, y, fault=None, bundling=False, cats=None, **kw):
    bt, mt = tbinning.bin_dataset(X, max_bin=63, feature_bundling=bundling,
                                  categorical_features=cats)
    opts = ttrain.TrainOptions(**{**FIT, "histogram_method": "u", **kw})
    if fault is None:
        return ttrain.train(bt, y, opts, mapper=mt, device="cpu")
    with inject_faults(fault):
        return ttrain.train(bt, y, opts, mapper=mt, device="cpu")


def _card_case(n, k, quant, skew, seed):
    """Bins, stats, keys and scale on the card at HIGGS width: keys in
    [0, k] (key k out of range), skewed bins with three values on 9 of the
    28 features."""
    dev = torch.device("cuda")
    rng = np.random.default_rng(seed)
    bins = rng.integers(0, 256, size=(28, n)).astype(np.uint8)
    if skew:
        bins[:9] = rng.integers(0, 3, size=(9, n))
    g, h, c = (torch.from_numpy(a.astype(np.float32)).to(dev) for a in
               (rng.normal(size=n), rng.uniform(0.01, 0.25, size=n), np.ones(n)))
    node = torch.from_numpy(rng.integers(0, k + 1, size=n).astype(np.int32)).to(dev)
    if quant:
        stats, _ = tu.stat_rows_quant(g, h, c, torch.rand((2, n), device=dev))
        scale = None
    else:
        stats = tu.stat_rows(g, h, c)
        scale = tu.stat_scales(stats)
    return torch.from_numpy(bins).to(dev), stats, node, scale
