"""The port's U histogram path and quantized gradients against the JAX package.

``mmlspark_tpu_torch.ops.u_histogram`` (layout, stat rows, the U pass and
its chunked form), ``ops.hopper_histogram``'s bin-scatter entry point and
``train(histogram_method="u")`` with and without ``use_quantized_grad``.
Inputs come from numpy seeds and go through both packages on the CPU: the
port with its kernels' plain versions, the JAX package as its own tests run
it (its Pallas kernels in interpret mode). The reference's random draws are
handed to the port, so the quantized path must agree exactly:

- quantized histograms: integer-equal before dequantization, bit-equal
  after (both sum exact integers and apply the same float32 scales);
- bf16 histograms: within 1e-5 * sum|x| + 1e-6, counts exact (the reference
  sums the bf16 values in float32, the port in 64-bit fixed point);
- a quantized fit: identical trees, leaf values and margins within 1e-5 (the
  split search takes float32 prefix sums where the reference takes a
  HIGHEST-precision matmul); a bf16 fit: held-out AUC within 2e-5.
The CUDA kernels themselves are checked against the plain versions by the
``cuda``-marked tests, on a card.
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


# -- layout -------------------------------------------------------------------


@pytest.mark.parametrize("per_feature", [None, WIDTHS, (300, 0, 1, 256)])
@pytest.mark.parametrize("n,budget", [(3000, 1), (3000, 200_000), (1_500_000, 8 << 30),
                                      (11_000_000, 8 << 30)])
def test_layout_matches_jax(per_feature, n, budget):
    b = 256 if per_feature is None or max(per_feature) > 32 else 32
    f = 28 if per_feature is None else len(per_feature)
    js = ju.make_u_spec(b, f, per_feature)
    ts = tu.make_u_spec(b, f, per_feature)
    assert dataclasses.asdict(ts) == dataclasses.asdict(js)
    assert tu.u_bytes(n, ts) == ju.u_bytes(n, js)
    jc, tc = ju.chunked_u_spec(n, js, budget), tu.chunked_u_spec(n, ts, budget)
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    assert tu.num_u_chunks(n, tc) == ju.num_u_chunks(n, jc)
    for port, ref in zip(tu._dense_maps_cached(ts), ju._dense_maps_cached(js)):
        np.testing.assert_array_equal(port, ref)


def test_u_budget_reads_the_environment(monkeypatch, caplog):
    monkeypatch.delenv("MMLSPARK_TPU_U_BUDGET", raising=False)
    assert tu.u_budget() == 8 << 30
    monkeypatch.setenv("MMLSPARK_TPU_U_BUDGET", "120000")
    assert tu.u_budget() == 120_000
    monkeypatch.setenv("MMLSPARK_TPU_U_BUDGET", "8GB")
    with caplog.at_level(logging.WARNING, logger="mmlspark_tpu_torch.lightgbm"):
        assert tu.u_budget() == 8 << 30
    assert any("MMLSPARK_TPU_U_BUDGET" in m for m in caplog.messages)


def test_build_u_and_chunked_bins_match_jax():
    bins, *_ = _mixed_case(seed=1, n=2777)
    bins[::7, 1] = 31  # past feature 1's width (5): matches no packed row
    bins[::11, 4] = 2  # feature 4 has width 2
    js = ju.make_u_spec(32, len(WIDTHS), WIDTHS)
    ts = tu.make_u_spec(32, len(WIDTHS), WIDTHS)
    (bt,) = _t(bins.T)
    ref = np.asarray(ju.build_u(jnp.asarray(bins), js))
    port = tu.build_u(bt, ts).numpy()
    assert port.dtype == np.uint8 and port.shape == ref.shape == (ts.k_pad, 3072)
    np.testing.assert_array_equal(port, ref.astype(np.uint8))
    jc, tc = ju.chunked_u_spec(2777, js, 1), tu.chunked_u_spec(2777, ts, 1)
    np.testing.assert_array_equal(tu.prepare_chunked_bins(bt, tc).numpy(),
                                  np.asarray(ju.prepare_chunked_bins(jnp.asarray(bins), jc)))


@pytest.mark.parametrize("group_features", [1, 2, 7])
def test_u_build_in_feature_groups_matches_jax(monkeypatch, group_features):
    """The U build scatters a few features at a time (its int64 positions
    bounded by ONEHOT_GROUP_BYTES); every grouping gives the reference's U."""
    bins, *_ = _mixed_case(seed=3, n=2777)
    bins[::5, 2] = 200  # past feature 2's width
    js = ju.make_u_spec(32, len(WIDTHS), WIDTHS)
    ts = tu.make_u_spec(32, len(WIDTHS), WIDTHS)
    monkeypatch.setattr(tu, "ONEHOT_GROUP_BYTES", 8 * 2777 * group_features)
    (bt,) = _t(bins.T)
    np.testing.assert_array_equal(tu.build_u(bt, ts).numpy(),
                                  np.asarray(ju.build_u(jnp.asarray(bins), js)).astype(np.uint8))


# -- stat rows ------------------------------------------------------------------


def test_stat_rows_are_bit_equal():
    _, g, h, c, _ = _mixed_case(seed=2)
    g[:7] = [0.0, -0.0, 1e-30, 3.0e38, -2.5, 1.00390625, 1.0058594]  # ties, extremes
    ref = np.asarray(ju.stat_rows(*map(jnp.asarray, (g, h, c))).astype(jnp.float32))
    port = tu.stat_rows(*_t(g, h, c))
    assert port.dtype == torch.bfloat16
    np.testing.assert_array_equal(port.float().numpy().view(np.uint32), ref.view(np.uint32))


@pytest.mark.parametrize("seed,gscale", [(3, 1.0), (4, 1e-20), (5, 1e20)])
def test_stat_rows_quant_is_bit_equal_given_the_draws(seed, gscale):
    _, g, h, c, _ = _mixed_case(seed=seed)
    g = (g * gscale).astype(np.float32)
    (rq, rs), (tq, ts) = _quant_stats(g, h, c, seed)
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(rq))
    np.testing.assert_array_equal(ts.numpy().view(np.uint32), np.asarray(rs).view(np.uint32))


def test_histogram_acc_dtype_ladder():
    for n, quant in ((10**9, False), (258, True), (259, True), (1 << 24, True)):
        port = tu.histogram_acc_dtype(n, quant)
        ref = jnp.dtype(ju.histogram_acc_dtype(n, quant))
        assert str(port).removeprefix("torch.") == ref.name


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


@pytest.mark.parametrize("builder", ["resident", "chunked", "bin_scatter"])
@pytest.mark.parametrize("quant", [True, False], ids=["quant", "bf16"])
@pytest.mark.parametrize("dequant", [False, True], ids=["packed", "dequant"])
@pytest.mark.parametrize("k", [1, 5, 42])
def test_histograms_match_jax(builder, quant, dequant, k):
    bins, g, h, c, node, jstats, tstats = _pass_inputs(k, quant, seed=k)
    ref = np.asarray(_reference_pass(builder, bins, g, h, c, node, k, jstats, dequant))
    port = _port_pass(builder, bins, g, h, c, node, k, tstats, dequant)
    assert port.shape == ref.shape == (k, len(WIDTHS), 32, 3)
    if quant and not dequant:
        assert str(port.dtype).removeprefix("torch.") == ref.dtype.name
        np.testing.assert_array_equal(port.numpy(), ref)  # integer-equal
    elif quant:
        assert port.dtype == torch.float32
        np.testing.assert_array_equal(port.numpy().view(np.uint32), ref.view(np.uint32))
    else:
        assert port.dtype == torch.float32
        _assert_bf16_close(port.numpy(), ref)


@pytest.mark.parametrize("quant", [True, False], ids=["quant", "bf16"])
@pytest.mark.parametrize("k", [1, 4, 42])
def test_fused_panel_dot_matches_the_pallas_kernel(quant, k):
    """The contraction alone: the port's ``fused_panel_dot`` (its plain
    version on the CPU) against ``_fused_panel_dot`` in interpret mode."""
    bins, g, h, c, node, jstats, tstats = _pass_inputs(k, quant, seed=10 + k, n=1024)
    js = ju.make_u_spec(32, len(WIDTHS), WIDTHS)
    ts = tu.make_u_spec(32, len(WIDTHS), WIDTHS)
    u = ju.build_u(jnp.asarray(bins), js)
    jrows = jstats[0] if quant else ju.stat_rows(*map(jnp.asarray, (g, h, c)))
    aux = jnp.concatenate([jrows.astype(jnp.float32), jnp.asarray(node, jnp.float32)[None, :],
                           jnp.zeros((4, len(node)), jnp.float32)])
    ref = np.asarray(ju._fused_panel_dot(u, aux, k, quant=quant, interpret=True))[:, :3 * k]
    trows = tstats[0] if quant else tu.stat_rows(*_t(g, h, c))
    scale = None if quant else tu.stat_scales(trows)
    acc = tu.fused_panel_dot(tu.build_u(*_t(bins.T), ts), trows, *_t(node), k, scale)
    if quant:
        assert acc.dtype == torch.int32
        np.testing.assert_array_equal(acc.numpy(), ref)
    else:
        assert acc.dtype == torch.int64
        _assert_bf16_close(tu._finish(acc, scale, len(node), k).numpy().reshape(-1, 3, k)
                           .transpose(0, 2, 1), ref.reshape(-1, 3, k).transpose(0, 2, 1))


def test_packed_space_subtraction_is_integer_exact():
    bins, g, h, c, _ = _mixed_case(seed=19)
    n = len(bins)
    child = (np.arange(n) % 3 == 0).astype(np.int32)
    ts = tu.make_u_spec(32, len(WIDTHS), WIDTHS)
    u = tu.build_u(*_t(bins.T), ts)
    _, stats = _quant_stats(g, h, c, 7)
    args = _t(g, h, c)
    parent = tu.build_histograms_u(u, *args, torch.zeros(n, dtype=torch.int32), 1, ts,
                                   stats=stats, dequant=False)
    both = tu.build_histograms_u(u, *args, *_t(child), 2, ts, stats=stats, dequant=False)
    torch.testing.assert_close(parent[0] - both[1], both[0], rtol=0, atol=0)
    full = tu.build_histograms_u(u, *args, *_t(child), 2, ts, stats=stats)
    torch.testing.assert_close(tu.dequant_hist(both, stats[1]), full, rtol=0, atol=0)


@pytest.mark.parametrize("builder", ["resident", "chunked", "bin_scatter"])
def test_panel_wider_than_a_lane_group_raises(builder):
    bins, g, h, c, node, _, tstats = _pass_inputs(43, False)
    with pytest.raises(ValueError, match="lane group"):
        _port_pass(builder, bins, g, h, c, node, 43, tstats, True)


def test_exact_contraction_keeps_every_bit():
    rng = np.random.default_rng(0)
    u = (rng.uniform(size=(40, 700)) < 0.3).astype(np.uint8)
    panel = rng.integers(-(2 ** 61), 2 ** 61, size=(6, 700), dtype=np.int64) // 700
    out = tu._exact_contract(torch.from_numpy(u), torch.from_numpy(panel), limbs=3, rows=128)
    ref = np.array([[sum(int(p) for p, s in zip(prow, urow) if s) for prow in panel]
                    for urow in u], dtype=object)
    assert (out.numpy().astype(object) == ref).all()


# -- kernel wrappers and launch plans --------------------------------------


def test_cpu_tensors_take_the_plain_versions():
    bins, g, h, c, node, _, (qs, _) = _pass_inputs(4, True)
    ts = tu.make_u_spec(32, len(WIDTHS), WIDTHS)
    bt, nd = _t(bins.T, node)
    u = tu.build_u(bt, ts)
    before = (tu.fused_panel_dot.launches, hh.bin_scatter.launches)
    a = tu.fused_panel_dot(u, qs, nd, 4)
    torch.testing.assert_close(a, tu.fused_panel_dot_plain(u, qs, nd, 4), rtol=0, atol=0)
    b = hh.bin_scatter(bt, qs, nd, 4, ts)
    torch.testing.assert_close(b, hh.bin_scatter_plain(bt, qs, nd, 4, ts), rtol=0, atol=0)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert (tu.fused_panel_dot.launches, hh.bin_scatter.launches) == before


def _wrapper_args(n=64, k=2):
    ts = tu.make_u_spec(32, len(WIDTHS), WIDTHS)
    return dict(u=torch.zeros((ts.k_pad, 512), dtype=torch.uint8),
                stats=torch.zeros((3, n), dtype=torch.int8),
                node=torch.zeros(n, dtype=torch.int32), num_nodes=k)


@pytest.mark.parametrize(
    "bad",
    [
        dict(num_nodes=43), dict(num_nodes=0),
        dict(u=torch.zeros((128, 500), dtype=torch.uint8)),
        dict(u=torch.zeros((128, 512), dtype=torch.int8)),
        dict(stats=torch.zeros((3, 64), dtype=torch.float32)),
        dict(stats=torch.zeros((3, 600), dtype=torch.int8), node=torch.zeros(600, dtype=torch.int32)),
        dict(node=torch.zeros(64, dtype=torch.int64)),
        dict(stats=torch.zeros((3, 64), dtype=torch.bfloat16)),  # bf16 without its scales
        dict(scale=torch.ones(3, dtype=torch.float64)),  # int8 with scales
        dict(u=torch.zeros((128, 528), dtype=torch.uint8)[:, :512]),  # not contiguous
    ],
)
def test_panel_dot_rejects_inputs_the_kernel_does_not_take(bad):
    args = _wrapper_args()
    args.update(bad)
    with pytest.raises((TypeError, ValueError)):
        tu.fused_panel_dot(**args)


@pytest.mark.parametrize(
    "bad",
    [
        dict(num_nodes=43),
        dict(bins_t=torch.zeros((7, 64), dtype=torch.int32)),
        dict(bins_t=torch.zeros((6, 64), dtype=torch.uint8)),
        dict(stats=torch.zeros((3, 64), dtype=torch.float32)),
        dict(node=torch.zeros(64, dtype=torch.int64)),
        dict(scale=torch.ones(3, dtype=torch.float64)),
        dict(bins_t=torch.zeros((2, 7, 31), dtype=torch.uint8)),  # a stack short of N rows
        dict(bins_t=torch.zeros((7, 65), dtype=torch.uint8)),  # flat bins of another N
    ],
)
def test_bin_scatter_rejects_inputs_the_kernel_does_not_take(bad):
    args = dict(bins_t=torch.zeros((7, 64), dtype=torch.uint8),
                stats=torch.zeros((3, 64), dtype=torch.int8),
                node=torch.zeros(64, dtype=torch.int32), num_nodes=2,
                spec=tu.make_u_spec(32, len(WIDTHS), WIDTHS))
    args.update(bad)
    args["bins"] = args.pop("bins_t")
    with pytest.raises((TypeError, ValueError)):
        hh.bin_scatter(**args)


@pytest.mark.parametrize("k", [1, 8, 21, 42])
@pytest.mark.parametrize("quant", [True, False])
@pytest.mark.parametrize("n", [512, 1_000_448, 599_040])
def test_panel_dot_plan_covers_u_and_fits_shared_memory(k, quant, n):
    plan = tu.panel_dot_plan(7168, n, k, quant, num_sms=132)
    assert plan.smem_bytes <= (tu.SMEM_BUDGET if quant else tu.SMEM_BUDGET_BF16) <= hh.SMEM_MAX
    assert plan.rows_per_block % tu.TILE_ROWS == 0
    assert plan.grid_x * plan.chunk_rows >= 7168 > (plan.grid_x - 1) * plan.chunk_rows
    assert plan.grid_y * plan.rows_per_block >= n > (plan.grid_y - 1) * plan.rows_per_block


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


@pytest.mark.parametrize("per_feature", [None, WIDTHS])
@pytest.mark.parametrize("k", [1, 8, 42])
@pytest.mark.parametrize("quant", [True, False])
def test_bin_scatter_plan_gives_each_chunk_its_features(per_feature, k, quant):
    _check_scatter_plan(per_feature, k, quant, hh.BIN_SCATTER_SMEM_BUDGET)


@pytest.mark.parametrize("budget", [112 * 1024, hh.SMEM_MAX], ids=["112KB", "227KB"])
@pytest.mark.parametrize("per_feature", [None, WIDTHS])
@pytest.mark.parametrize("k", [1, 8, 21, 42])
@pytest.mark.parametrize("quant", [True, False])
def test_bin_scatter_plan_at_both_budgets(per_feature, k, quant, budget, monkeypatch):
    monkeypatch.setattr(hh, "BIN_SCATTER_SMEM_BUDGET", budget)
    _check_scatter_plan(per_feature, k, quant, budget)


def test_bin_scatter_plan_refuses_what_it_cannot_take():
    with pytest.raises(ValueError, match="lane group"):
        hh.bin_scatter_plan(100, tu.make_u_spec(256, 3), 43, True, num_sms=132)
    with pytest.raises(ValueError, match="uint8"):
        hh.bin_scatter_plan(100, tu.make_u_spec(512, 3), 8, True, num_sms=132)


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


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("edge", EDGES64)
def test_two_plane_carry_add_gives_exact_int64_cells_in_any_order(edge, seed):
    """Adds spread over the cells of a (c, s, key) block: the lo/hi planes
    recombine to the exact int64 sum of each cell whatever the order,
    including low halves that carry on every add (2**32 - 1, -1) and
    partial sums that wrap past 2**63 when the cell's total does not."""
    rng = np.random.default_rng(seed)
    cells = 12
    reps = max(1, min(40, 2 ** 61 // abs(edge)))
    adds = [(int(c), edge) for c in rng.integers(0, cells, reps)]
    adds += [(int(c), int(v)) for c, v in zip(rng.integers(0, cells, 80),
                                              rng.integers(-Q64, Q64, 80))]
    adds += [(3, 2 ** 62), (3, 2 ** 62), (3, -(2 ** 62)), (3, -(2 ** 62))]  # wraps, then back
    exact = [0] * cells
    for c, v in adds:
        exact[c] += v
    assert all(abs(v) < 2 ** 63 for v in exact)
    for _ in range(3):
        rng.shuffle(adds)
        lo, hi = [0] * cells, [0] * cells
        for c, v in adds:
            _plane_add(lo, hi, c, v)
        assert [_as_int64(lo[c] | (hi[c] << 32)) for c in range(cells)] == exact


@pytest.mark.parametrize("blocks", [1, 3, 7])
def test_plane_cells_flushed_with_64_bit_adds_give_the_exact_sum(blocks):
    """Per-block planes, then the flush's native 64-bit global adds of the
    recombined words (mod 2**64): the exact sum whatever the split."""
    rng = np.random.default_rng(blocks)
    values = [int(v) for v in rng.integers(-Q64, Q64, 500)] + [Q64] * 50 + [-1] * 30
    total = 0
    for part in np.array_split(np.array(values, dtype=object), blocks):
        lo, hi = [0], [0]
        for v in part:
            _plane_add(lo, hi, 0, int(v))
        total = (total + (lo[0] | (hi[0] << 32))) & MASK64
    assert _as_int64(total) == sum(values)


def test_largest_fixed_point_value_of_the_u_path_sums_within_int64():
    assert 2 ** 36 < Q64 < 2 ** 38
    assert 11_000_000 * Q64 < 2 ** 62


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


@pytest.mark.parametrize("chunk", [None, 7, 512], ids=["flat", "chunk7", "chunk512"])
@pytest.mark.parametrize("quant", [True, False], ids=["quant", "bf16"])
@pytest.mark.parametrize("k", [1, 5, 42])
def test_chunk_stack_mirror_equals_the_plain_version_on_flat_bins(chunk, quant, k, monkeypatch):
    """The kernel's indexing of a stack of row chunks (odd N, pad bins in
    the stack's tail, keys out of range, bins past their feature's width),
    mirrored in numpy, against ``bin_scatter_plain`` on the flat (F, N)
    bins; the wrapper on the stack (its plain version here) agrees too."""
    n = 1001
    bins, g, h, c, node, _, tstats = _pass_inputs(k, quant, seed=40 + k, n=n)
    bins[::7, 1] = 31  # past feature 1's width (5)
    spec = tu.make_u_spec(32, len(WIDTHS), WIDTHS)
    (bt,) = _t(bins.T)
    stats = tstats[0] if quant else tu.stat_rows(*_t(g, h, c))
    scale = None if quant else tu.stat_scales(stats)
    nd = torch.from_numpy(node)
    stack = bt[None] if chunk is None else _stack(bt, chunk, seed=k)
    row_bytes = 3 * k * (4 if quant else 8)
    monkeypatch.setattr(hh, "BIN_SCATTER_THREADS", 8)  # several row blocks at this size
    monkeypatch.setattr(hh, "BIN_SCATTER_SMEM_BUDGET", 40 * row_bytes)  # 4 packed-row chunks
    plan = hh.bin_scatter_plan(n, spec, k, quant, num_sms=2)
    assert plan.grid_x == 4 and plan.grid_y > 1
    q = (stats.long() if quant else torch.round(stats.double() * scale[:, None]).long()).tolist()
    mirror = _mirror_bin_scatter(stack, q, node, k, spec, plan, n, quant, seed=k)
    flat = hh.bin_scatter_plain(bt, stats, nd, k, spec, scale)
    np.testing.assert_array_equal(mirror, flat.numpy())
    on_stack = hh.bin_scatter(stack if chunk else bt, stats, nd, k, spec, scale)
    assert on_stack.dtype == flat.dtype
    torch.testing.assert_close(on_stack, flat, rtol=0, atol=0)


def test_bin_scatter_layout_is_made_once_per_spec_and_plan():
    spec = tu.make_u_spec(32, len(WIDTHS), WIDTHS)
    chunked = tu.chunked_u_spec(3000, spec, 1)
    for sp in (spec, chunked):
        plan = hh.bin_scatter_plan(3000, sp, 5, True, num_sms=132)
        layout = hh._bin_scatter_layout(sp, plan.features, torch.device("cpu"))
        assert layout.dtype == torch.int32
        assert layout.tolist() == list(sp.offsets) + list(sp.widths) + list(plan.features)
        again = hh.bin_scatter_plan(10_000, sp, 5, True, num_sms=132)
        assert hh._bin_scatter_layout(sp, again.features, torch.device("cpu")) is layout
    other = hh.bin_scatter_plan(3000, spec, 42, False, num_sms=132)
    assert hh._bin_scatter_layout(spec, other.features, torch.device("cpu")) is not layout


@pytest.mark.parametrize("quant", [True, False], ids=["quant", "bf16"])
@pytest.mark.parametrize("dequant", [False, True], ids=["packed", "dequant"])
@pytest.mark.parametrize("k", [1, 5, 42])
def test_chunked_pass_is_bit_equal_to_the_resident_pass(k, quant, dequant):
    bins, g, h, c, node, _, tstats = _pass_inputs(k, quant, seed=50 + k, n=2777)
    ts = tu.make_u_spec(32, len(WIDTHS), WIDTHS)
    (bt,) = _t(bins.T)
    args = _t(g, h, c, node)
    kw = dict(stats=tstats, dequant=dequant)
    resident = tu.build_histograms_u(tu.build_u(bt, ts), *args, k, ts, **kw)
    for budget in (1, 2 * ts.k_pad * 1024, 2 * ts.k_pad * 4096):  # 6, 3 and 1 chunks
        cs = tu.chunked_u_spec(2777, ts, budget)
        chunked = tu.build_histograms_u_chunked(tu.prepare_chunked_bins(bt, cs), *args, k, cs,
                                                **kw)
        assert chunked.dtype == resident.dtype
        torch.testing.assert_close(chunked, resident, rtol=0, atol=0)


@pytest.mark.parametrize("quant", [True, False], ids=["quant", "bf16"])
@pytest.mark.parametrize("chunk_budget", [512, 1024, 2048])
def test_chunked_pass_matches_jax_at_every_chunk_size(quant, chunk_budget):
    k = 5
    bins, g, h, c, node, jstats, tstats = _pass_inputs(k, quant, seed=60, n=3000)
    js = ju.make_u_spec(32, len(WIDTHS), WIDTHS)
    ts = tu.make_u_spec(32, len(WIDTHS), WIDTHS)
    jc = ju.chunked_u_spec(3000, js, 2 * js.k_pad * chunk_budget)
    tc = tu.chunked_u_spec(3000, ts, 2 * ts.k_pad * chunk_budget)
    assert tc.chunk_rows == jc.chunk_rows == chunk_budget
    ref = np.asarray(ju.build_histograms_u_chunked(
        ju.prepare_chunked_bins(jnp.asarray(bins), jc), *map(jnp.asarray, (g, h, c, node)), k,
        jc, stats=jstats, dequant=False))
    (bt,) = _t(bins.T)
    port = tu.build_histograms_u_chunked(tu.prepare_chunked_bins(bt, tc), *_t(g, h, c, node), k,
                                         tc, stats=tstats, dequant=False)
    if quant:
        np.testing.assert_array_equal(port.numpy(), ref)
    else:
        _assert_bf16_close(port.numpy(), ref)


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


@pytest.mark.parametrize("subtraction", [True, False], ids=["sub", "nosub"])
@pytest.mark.parametrize("leaf_batch", [1, 8])
def test_quantized_fit_matches_jax(subtraction, leaf_batch):
    X, y = _fit_case(seed=11 + leaf_batch)
    kw = dict(histogram_method="u", use_quantized_grad=True, leaf_batch=leaf_batch,
              histogram_subtraction=subtraction)
    rt = _fit_port(X, y, **kw)
    jb = _fit_reference(X, y, **kw)
    tb = rt.booster
    assert rt.stats.quantized and rt.stats.histogram_path == "u"
    for field in STRUCTURE:
        assert np.array_equal(getattr(tb, field), getattr(jb, field)), field
    np.testing.assert_allclose(tb.leaf_values, jb.leaf_values, atol=1e-5)
    np.testing.assert_allclose(tb.raw_margin(X, device="cpu"), jb.raw_margin(X), atol=1e-5)


@pytest.mark.parametrize("subtraction", [True, False], ids=["sub", "nosub"])
def test_bf16_u_fit_matches_jax_auc(subtraction):
    X, y = _fit_case(seed=13, n=2000)
    Xv, yv = _fit_case(seed=14, n=2000)
    kw = dict(histogram_method="u", histogram_subtraction=subtraction)
    rt = _fit_port(X, y, **kw)
    jb = _fit_reference(X, y, **kw)
    assert not rt.stats.quantized and rt.stats.histogram_path == "u"
    a_port = auc(yv, rt.booster.raw_margin(Xv, device="cpu")[:, 0], np.ones(len(yv)))
    a_ref = auc(yv, jb.raw_margin(Xv)[:, 0], np.ones(len(yv)))
    assert abs(a_port - a_ref) <= 2e-5, (a_port, a_ref)


@pytest.mark.parametrize("objective", ["binary", "regression"])
def test_compare_built_fit_without_subtraction_matches_jax(objective):
    """The grower's no-subtraction branch on the default path: both children
    of every split keyed in one pass (``2*lane + went_right``, k <= 21)."""
    # Small leaves make near-tied gains common at 31 leaves; this case has
    # none within float32 noise, with or without subtraction.
    X, y = _fit_case(seed=23, n=2000, f=6)
    if objective == "regression":
        y = X[:, 0] * 2 + X[:, 1] * X[:, 2]
    kw = dict(objective=objective, num_iterations=5, num_leaves=31, max_bin=63,
              leaf_batch=30, histogram_subtraction=False)
    bt, mt = tbinning.bin_dataset(X, max_bin=63)
    bj, mj = jbinning.bin_dataset(X, max_bin=63)
    rt = ttrain.train(bt, y, ttrain.TrainOptions(**kw), mapper=mt, device="cpu")
    jb = jtrain.train(bj, y, jtrain.TrainOptions(**kw), mapper=mj).booster
    tb = rt.booster
    for field in STRUCTURE:
        assert np.array_equal(getattr(tb, field), getattr(jb, field)), field
    np.testing.assert_allclose(tb.leaf_values, jb.leaf_values, atol=1e-5)


def test_quantized_model_text_is_identical_across_subtraction_and_chunking(monkeypatch):
    X, y = _fit_case(seed=17)
    kw = dict(histogram_method="u", use_quantized_grad=True, num_iterations=8)
    texts = {}
    for name, sub, budget in (("resident", True, None), ("nosub", False, None),
                              ("chunked", True, "120000"), ("chunked_nosub", False, "120000")):
        if budget is None:
            monkeypatch.delenv("MMLSPARK_TPU_U_BUDGET", raising=False)
        else:
            monkeypatch.setenv("MMLSPARK_TPU_U_BUDGET", budget)
        r = _fit_port(X, y, histogram_subtraction=sub, **kw)
        assert r.stats.histogram_path == ("u_chunked" if budget else "u")
        assert r.stats.u_chunks == (3 if budget else 1)
        texts[name] = r.booster.model_to_string()
    assert len(set(texts.values())) == 1


def test_subtraction_cache_gate_takes_the_no_subtraction_branch(monkeypatch):
    X, y = _fit_case(seed=23)
    kw = dict(histogram_method="u", use_quantized_grad=True)
    off = _fit_port(X, y, histogram_subtraction=False, **kw)
    monkeypatch.setattr(ttrain, "SUBTRACTION_CACHE_BYTES", 0)
    gated = _fit_port(X, y, histogram_subtraction=True, **kw)
    assert gated.booster.model_to_string() == off.booster.model_to_string()
    assert gated.stats.passes == off.stats.passes


def test_quantized_fits_repeat_and_follow_the_seed():
    X, y = _fit_case(seed=29)
    kw = dict(histogram_method="u", use_quantized_grad=True)
    a, b = (_fit_port(X, y, **kw).booster.model_to_string() for _ in range(2))
    assert a == b
    assert _fit_port(X, y, seed=1, **kw).booster.model_to_string() != a
    noise = ttrain.quant_noise(0, 3, 0, 1000, torch.device("cpu"))
    assert noise.shape == (2, 1000) and noise.dtype == torch.float32
    assert 0.0 <= float(noise.min()) and float(noise.max()) < 1.0
    assert not torch.equal(noise, ttrain.quant_noise(0, 4, 0, 1000, torch.device("cpu")))
    # the reference's draws: the g and h keys of the per-tree key
    key = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(0 ^ 0x51AB51AB), 3), 1)[0]
    np.testing.assert_array_equal(noise.numpy(), _jax_uniforms(key, 1000))


def test_quantized_fit_falls_back_with_a_warning_when_u_is_inactive(caplog):
    X, y = _fit_case(seed=31)
    with caplog.at_level(logging.WARNING, logger="mmlspark_tpu_torch.lightgbm"):
        r = _fit_port(X, y, use_quantized_grad=True)
    assert any("use_quantized_grad" in m for m in caplog.messages)
    assert not r.stats.quantized and r.stats.histogram_path == "compare"
    exact = _fit_port(X, y)
    assert r.booster.model_to_string() == exact.booster.model_to_string()


def test_quantized_row_cap_falls_back_with_a_warning(caplog):
    opts = ttrain.TrainOptions(histogram_method="u", use_quantized_grad=True)
    with caplog.at_level(logging.WARNING, logger="mmlspark_tpu_torch.lightgbm"):
        spec, quant = ttrain._histogram_path(opts, ttrain.QUANT_ROW_CAP + 1, 28, 256, None)
    assert spec is not None and spec.chunk_rows and not quant
    assert any("2^24" in m for m in caplog.messages)
    assert ttrain._histogram_path(opts, ttrain.QUANT_ROW_CAP, 28, 256, None)[1]


def test_estimator_with_quantized_grad_warns_and_trains_exact(caplog):
    X, y = _fit_case(seed=37, n=900)
    params = dict(numIterations=3, numLeaves=7, maxBin=31, device="cpu")
    with caplog.at_level(logging.WARNING, logger="mmlspark_tpu_torch.lightgbm"):
        quant = LightGBMClassifier(useQuantizedGrad=True, **params).fit(
            Table({"features": X, "label": y}))
    assert any("use_quantized_grad" in m for m in caplog.messages)
    exact = LightGBMClassifier(**params).fit(Table({"features": X, "label": y}))
    assert quant.get_model_string() == exact.get_model_string()
    assert not quant.fit_stats.quantized


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


@pytest.mark.parametrize("subtraction", [True, False], ids=["sub", "nosub"])
@pytest.mark.parametrize("quant", [True, False], ids=["quant", "bf16"])
def test_oom_ladder_degrades_to_identical_model_text(monkeypatch, quant, subtraction):
    """An out-of-memory error at the first pass halves the U budget once,
    re-plans chunked passes and retries the iteration: the model text is the
    undisturbed fit's, byte for byte (the reference's
    ``tests/test_pressure.py`` degraded-fit parity)."""
    monkeypatch.delenv("MMLSPARK_TPU_U_BUDGET", raising=False)
    X, y = _fit_case(seed=41)
    kw = dict(use_quantized_grad=quant, histogram_subtraction=subtraction)
    clean = _oom_fit(X, y, **kw)
    fault = _device_ooms((0, 0))
    hit = _oom_fit(X, y, fault, **kw)
    assert _fired(fault) == [(0, 0)]
    assert clean.stats.histogram_path == "u" and clean.stats.oom_retries == 0
    assert hit.stats.histogram_path == "u_chunked" and hit.stats.oom_retries == 1
    assert hit.stats.u_budget == clean.stats.u_budget // 2
    assert hit.booster.model_to_string() == clean.booster.model_to_string()


@pytest.mark.parametrize("data", ["categorical", "bundled"])
def test_oom_ladder_on_categorical_and_bundled_fits(monkeypatch, data):
    monkeypatch.delenv("MMLSPARK_TPU_U_BUDGET", raising=False)
    X, y = _fit_case(seed=42)
    kw = dict(use_quantized_grad=True)
    if data == "categorical":
        X[:, 0] = np.floor(np.abs(X[:, 0]) * 4)
        kw["cats"] = [0]
    else:
        hot = np.random.default_rng(42).integers(0, 5, len(X))
        X = np.hstack([X, np.eye(5)[hot]])
        kw["bundling"] = True
    clean = _oom_fit(X, y, **kw)
    hit = _oom_fit(X, y, _device_ooms((0, 0)), **kw)
    assert hit.stats.histogram_path == "u_chunked" and hit.stats.oom_retries == 1
    assert hit.booster.model_to_string() == clean.booster.model_to_string()


@pytest.mark.parametrize("keys,retries", [([(2, 0)], 1), ([(0, 0), (0, 1), (0, 2)], 3),
                                          ([(1, 0), (3, 0)], 2)])
def test_oom_ladder_walks_down_per_fault(monkeypatch, keys, retries):
    """Faults at later iterations and repeated faults: one halving each."""
    monkeypatch.delenv("MMLSPARK_TPU_U_BUDGET", raising=False)
    X, y = _fit_case(seed=43)
    clean = _oom_fit(X, y, use_quantized_grad=True)
    fault = _device_ooms(*keys)
    hit = _oom_fit(X, y, fault, use_quantized_grad=True)
    assert _fired(fault) == keys and hit.stats.oom_retries == retries
    assert hit.stats.u_budget == clean.stats.u_budget >> retries
    assert hit.booster.model_to_string() == clean.booster.model_to_string()


def test_oom_off_the_u_path_is_raised():
    X, y = _fit_case(seed=44)
    with pytest.raises(DeviceOomError):
        _oom_fit(X, y, _device_ooms((0, 0)), histogram_method=None)


def test_oom_at_the_budget_floor_is_raised(monkeypatch):
    """Chunked from the start at the 1 MiB floor: nothing left to shrink."""
    monkeypatch.setenv("MMLSPARK_TPU_U_BUDGET", str(ttrain.OOM_MIN_BUDGET))
    X, y = _fit_case(seed=45, n=3000)
    with pytest.raises(DeviceOomError):
        _oom_fit(X, y, _device_ooms((0, 0)))


def test_oom_ladder_stops_after_its_retry_cap(monkeypatch):
    monkeypatch.delenv("MMLSPARK_TPU_U_BUDGET", raising=False)
    X, y = _fit_case(seed=46)
    fault = _device_ooms(*[(0, a) for a in range(ttrain.OOM_RETRY_CAP + 1)])
    with pytest.raises(DeviceOomError):
        _oom_fit(X, y, fault)
    assert len(_fired(fault)) == ttrain.OOM_RETRY_CAP + 1


# -- on the card ---------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("quant", [True, False], ids=["quant", "bf16"])
@pytest.mark.parametrize("k", [1, 8, 42])
def test_kernels_match_plain_versions_on_card(quant, k):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the kernels have no CPU mode")
    dev = torch.device("cuda")
    rng = np.random.default_rng(k)
    n, f = 100_003, 28
    spec = tu.make_u_spec(256, f)
    bins_t = torch.from_numpy(rng.integers(0, 256, size=(f, n)).astype(np.uint8)).to(dev)
    g, h, c = (torch.from_numpy(a.astype(np.float32)).to(dev) for a in
               (rng.normal(size=n), rng.uniform(0.01, 0.25, size=n), np.ones(n)))
    node = torch.from_numpy(rng.integers(0, k + 1, size=n).astype(np.int32)).to(dev)
    if quant:
        stats, _ = tu.stat_rows_quant(g, h, c, torch.rand((2, n), device=dev))
        scale = None
    else:
        stats = tu.stat_rows(g, h, c)
        scale = tu.stat_scales(stats)
    u = tu.build_u(bins_t, spec)
    out = tu.fused_panel_dot(u, stats, node, k, scale)
    torch.testing.assert_close(out, tu.fused_panel_dot_plain(u, stats, node, k, scale),
                               rtol=0, atol=0)
    torch.testing.assert_close(out, tu.fused_panel_dot(u, stats, node, k, scale), rtol=0, atol=0)
    scattered = hh.bin_scatter(bins_t, stats, node, k, spec, scale)
    torch.testing.assert_close(scattered, hh.bin_scatter_plain(bins_t, stats, node, k, spec,
                                                               scale), rtol=0, atol=0)
    torch.testing.assert_close(scattered, out, rtol=0, atol=0)


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


@pytest.mark.cuda
@pytest.mark.parametrize("n", [100_003, 100_000])
@pytest.mark.parametrize("skew", [False, True], ids=["uniform", "skewed"])
@pytest.mark.parametrize("quant", [True, False], ids=["quant", "bf16"])
@pytest.mark.parametrize("k", [1, 8, 42])
def test_chunk_stack_entry_matches_plain_version_on_card(k, quant, skew, n):
    """The chunked pass's one launch over a stack of 7 row chunks (random
    bins in its padded tail) against the plain version, the flat (F, N)
    entry and a second launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the kernels have no CPU mode")
    bins_t, stats, node, scale = _card_case(n, k, quant, skew, seed=k + n)
    spec = tu.make_u_spec(256, 28)
    cs = tu.chunked_u_spec(n, spec, 2 * spec.k_pad * 16_384)
    stack = tu.prepare_chunked_bins(bins_t, cs)
    assert stack.shape == (7, 28, 16_384)
    stack.view(-1, 16_384)[-28:, n - 6 * 16_384:] = 255  # pad rows: never read
    out = hh.bin_scatter(stack, stats, node, k, cs, scale)
    plain = hh.bin_scatter_plain(stack, stats, node, k, cs, scale)
    torch.testing.assert_close(out, plain, rtol=0, atol=0)
    torch.testing.assert_close(out, hh.bin_scatter(stack, stats, node, k, cs, scale),
                               rtol=0, atol=0)
    torch.testing.assert_close(out, hh.bin_scatter(bins_t, stats, node, k, spec, scale),
                               rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("quant", [True, False], ids=["quant", "bf16"])
@pytest.mark.parametrize("k", [1, 8])
def test_bin_scatter_takes_inputs_off_the_vector_boundary_on_card(k, quant):
    """Bins, stats and keys that start off their vector boundary (views at
    an offset) give the same sums as aligned copies and the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the kernels have no CPU mode")
    n = 100_001
    bins_t, stats, node, scale = _card_case(n, k, quant, False, seed=70 + k)
    spec = tu.make_u_spec(256, 28)
    views = []
    for t in (bins_t, stats, node):
        buf = torch.zeros(t.numel() + 1, dtype=t.dtype, device=t.device)
        buf[1:] = t.reshape(-1)
        views.append(buf[1:].view(t.shape))
    out = hh.bin_scatter(views[0], views[1], views[2], k, spec, scale)
    torch.testing.assert_close(out, hh.bin_scatter(bins_t, stats, node, k, spec, scale),
                               rtol=0, atol=0)
    torch.testing.assert_close(out, hh.bin_scatter_plain(*views, k, spec, scale), rtol=0, atol=0)


def test_sass_atomics_counts_each_atomic_opcode():
    from mmlspark_tpu_torch.kernels import sass_atomics

    sass = """
        /*0a10*/   ATOMS.ADD RZ, [R3], R5 ;
        /*0a20*/   ATOMS.CAST.SPIN.64 P0, [R2], R4, R6 ;
        /*0a30*/   ATOMS.ADD R7, [R3+0x4], R5 ;
        /*0a40*/   REDG.E.ADD.64.STRONG.GPU desc[UR4][R8.64], R10 ;
        /*0a50*/   LDS R4, [R2] ;
    """
    found = sass_atomics._OPCODE.findall(sass)
    assert sorted(found) == ["ATOMS.ADD", "ATOMS.ADD", "ATOMS.CAST.SPIN.64",
                             "REDG.E.ADD.64.STRONG.GPU"]
    assert any(op.startswith(sass_atomics.CAS_LOOP) for op in found)
    assert set(sass_atomics.SOURCES) == {p.name for p in sass_atomics.CSRC_DIR.glob("*.cu")}


@pytest.mark.cuda
def test_kernels_compile_no_compare_and_swap_loop_on_card():
    """The packed-space kernels' 64-bit shared adds are pairs of 32-bit
    ATOMS.ADD, with no ATOMS.CAST.SPIN loop left (needs nvcc)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and its toolkit")
    from mmlspark_tpu_torch.kernels import sass_atomics

    for src, ops in sass_atomics.atomics().items():
        assert ops.get("ATOMS.ADD", 0) > 0, src
        assert not any(op.startswith(sass_atomics.CAS_LOOP) for op in ops), (src, ops)
