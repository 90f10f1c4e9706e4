"""The port's histogram (mmlspark_tpu_torch.ops) against the JAX package.

On the CPU the port's entry points compute the kernel's plain version; it
is held against JAX's ``segment`` formulation and both Pallas entry points
of ``_hist_kernel`` run in interpret mode at ``precision="highest"`` (exact
float32). Counts must be equal; g and h agree within 1e-5 (the port sums in
64-bit fixed point, the references in float32 in another order). The CUDA kernel itself is checked against the plain version
by the ``cuda``-marked test, on a card.
"""

import numpy as np
import pytest
import torch

from mmlspark_tpu_torch.ops import hopper_histogram as hh
from mmlspark_tpu_torch.ops.histogram import build_histograms, build_node_panel


def _import_reference():
    """Import the JAX package's histogram ops through the shim its fit path
    needs on jax 0.9, where ``mmlspark_tpu/ops/u_histogram.py`` fails at
    import (it tests membership in ``batching.primitive_batchers``, which
    jax 0.9 no longer makes iterable). While the module imports, a plain
    dict that already holds the barrier rule stands in; then the original
    table is restored. The JAX package itself is not changed."""
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
except ModuleNotFoundError as err:
    if err.name != "jax":
        raise


def _reference_histograms():
    from mmlspark_tpu.ops import histogram as jh
    from mmlspark_tpu.ops import pallas_histogram as jp

    return jh, jp


def _case(n, f, b, k, seed=0):
    rng = np.random.default_rng(seed)
    bins = rng.integers(0, b, size=(n, f)).astype(np.uint8)
    g = rng.normal(size=n).astype(np.float32)
    h = rng.uniform(0.1, 1.0, size=n).astype(np.float32)
    c = (rng.uniform(size=n) > 0.2).astype(np.float32)
    node = rng.integers(-1, k + 2, size=n).astype(np.int32)  # incl. out-of-range keys
    return bins, g, h, c, node


def _port(bins, g, h, c, node, k, b):
    out = build_histograms(
        torch.from_numpy(np.ascontiguousarray(bins.T)), torch.from_numpy(g),
        torch.from_numpy(h), torch.from_numpy(c), torch.from_numpy(node), k, b,
    )
    return out.numpy()


def _assert_close(port, ref):
    ref = np.asarray(ref)
    assert port.shape == ref.shape
    np.testing.assert_array_equal(port[..., 2], ref[..., 2])
    np.testing.assert_allclose(port[..., :2], ref[..., :2], atol=1e-5, rtol=1e-5)


SHAPES = [(n, b, k) for n in (1000, 3001) for b in (64, 128, 256) for k in (1, 4, 8)]


@pytest.mark.parametrize("n,b,k", SHAPES)
def test_matches_jax_segment(n, b, k):
    jh, _ = _reference_histograms()
    bins, g, h, c, node = _case(n, 5, b, k, seed=n + b + k)
    ref = jh.build_histograms(bins, g, h, c, node, k, b, method="segment")
    _assert_close(_port(bins, g, h, c, node, k, b), ref)


@pytest.mark.parametrize("n,b,k", SHAPES)
def test_matches_jax_panel_kernel(n, b, k):
    _, jp = _reference_histograms()
    bins, g, h, c, node = _case(n, 5, b, k, seed=n * 3 + b + k)
    ref = jp.build_histograms_panel_pallas(
        bins, g, h, c, node, k, b, interpret=True, precision="highest"
    )
    _assert_close(_port(bins, g, h, c, node, k, b), ref)


# The combined-id Pallas kernel refuses K = k*B above its VMEM budget
# (pick_bw(K) == 0), so it is compared where the JAX package runs it.
COMBINED = [(n, b, k) for n, b, k in SHAPES if k * b <= 1536]


@pytest.mark.parametrize("n,b,k", COMBINED)
def test_matches_jax_combined_kernel(n, b, k):
    _, jp = _reference_histograms()
    bins, g, h, c, node = _case(n, 5, b, k, seed=n * 7 + b + k)
    ref = jp.build_histograms_pallas(
        bins, g, h, c, node, k, b, interpret=True, precision="highest"
    )
    _assert_close(_port(bins, g, h, c, node, k, b), ref)


@pytest.mark.parametrize("k", [1, 5, 42])
def test_node_panel_matches_jax(k):
    _, jp = _reference_histograms()
    _, g, h, c, node = _case(777, 1, 8, k, seed=k)
    ref = np.asarray(jp.build_node_panel(g, h, c, node, k))
    port = build_node_panel(torch.from_numpy(g), torch.from_numpy(h),
                            torch.from_numpy(c), torch.from_numpy(node), k).numpy()
    np.testing.assert_array_equal(port, ref)


def test_cpu_tensors_take_the_plain_version():
    bins, g, h, c, node = _case(500, 3, 16, 4)
    before = (hh.build_histograms_cuda.launches, hh.build_histograms_combined_cuda.launches)
    bt = torch.from_numpy(np.ascontiguousarray(bins.T))
    args = (bt, torch.from_numpy(g), torch.from_numpy(h), torch.from_numpy(c),
            torch.from_numpy(node))
    out = hh.build_histograms_cuda(*args, 4, 16)
    plain = hh.build_histograms_plain(*args, 4, 16)
    torch.testing.assert_close(out, plain, rtol=0, atol=0)
    hh.build_histograms_combined_cuda(*args, 1, 16)
    assert (hh.build_histograms_cuda.launches,
            hh.build_histograms_combined_cuda.launches) == before


def test_plain_version_sums_in_float64():
    bins, g, h, c, node = _case(300, 2, 8, 2)
    bt = torch.from_numpy(np.ascontiguousarray(bins.T))
    out = hh.build_histograms_plain(
        bt, torch.from_numpy(g).double(), torch.from_numpy(h).double(),
        torch.from_numpy(c).double(), torch.from_numpy(node), 2, 8,
    )
    assert out.dtype == torch.float64
    keep = (node >= 0) & (node < 2)
    assert out[..., 2].sum().item() == pytest.approx(2 * c[keep].sum())


@pytest.mark.parametrize("k", [1, 8, 42])
def test_plain_version_does_not_depend_on_row_order(k):
    bins, g, h, c, node = _case(4001, 4, 64, k, seed=100 + k)
    perm = np.random.default_rng(k).permutation(4001)
    out = _port(bins, g, h, c, node, k, 64)
    shuffled = _port(bins[perm], g[perm], h[perm], c[perm], node[perm], k, 64)
    np.testing.assert_array_equal(out, shuffled)


@pytest.mark.parametrize("k", [1, 8])
@pytest.mark.parametrize("gscale", [1e-6, 1.0, 1e6])
def test_plain_version_rounds_the_exact_sum(k, gscale):
    """float32 sums in fixed point land within one float32 rounding of the
    float64 sum (the fixed-point rounding is far below it)."""
    bins, g, h, c, node = _case(3001, 3, 32, k, seed=7)
    g = (g * gscale).astype(np.float32)
    bt = torch.from_numpy(np.ascontiguousarray(bins.T))
    args = (torch.from_numpy(g), torch.from_numpy(h), torch.from_numpy(c))
    out = hh.build_histograms_plain(bt, *args, torch.from_numpy(node), k, 32).double()
    ref = hh.build_histograms_plain(bt, *(a.double() for a in args),
                                    torch.from_numpy(node), k, 32)
    torch.testing.assert_close(out[..., 2], ref[..., 2], rtol=0, atol=0)
    err = (out[..., :2] - ref[..., :2]).abs()
    assert bool((err <= 2.0 ** -24 * ref[..., :2].abs() * 1.01 + 1e-30).all())


@pytest.mark.parametrize("n", [1, 1000, 11_000_000])
@pytest.mark.parametrize("top", [0.0, 1e-30, 0.25, 1.0, 3.0, 1e30])
def test_fixed_point_scales_keep_every_sum_in_int64(n, top):
    g = torch.zeros(n)
    g[0] = -top
    h = torch.full((n,), top / 2)
    scale = hh.fixed_point_scales(g, h)
    assert scale.dtype == torch.float64
    mant, _ = torch.frexp(scale)
    assert bool((mant == 0.5).all())  # powers of two: scaling is exact
    for s, m in zip(scale.tolist(), (top, top / 2)):
        assert n * m * s <= 2.0 ** 62
        if m > 0:
            assert n * m * s >= 2.0 ** 60  # and no coarser than it must be


@pytest.mark.parametrize(
    "bad",
    [
        dict(num_nodes=43),
        dict(num_nodes=0),
        dict(num_bins=257),
        dict(grad=torch.zeros(10, dtype=torch.float64)),
        dict(node=torch.zeros(10, dtype=torch.int64)),
        dict(bins_t=torch.zeros((2, 10), dtype=torch.int32)),
        dict(bins_t=torch.zeros((10, 2), dtype=torch.uint8).t()),
    ],
)
def test_wrapper_rejects_inputs_the_kernel_does_not_take(bad):
    args = dict(
        bins_t=torch.zeros((2, 10), dtype=torch.uint8), grad=torch.zeros(10),
        hess=torch.zeros(10), count=torch.zeros(10),
        node=torch.zeros(10, dtype=torch.int32), num_nodes=2, num_bins=16,
    )
    args.update(bad)
    with pytest.raises((TypeError, ValueError)):
        hh.build_histograms_cuda(**args)


@pytest.mark.parametrize("n", [1, 1000, 11_000_000])
@pytest.mark.parametrize("k", [1, 8, 42])
@pytest.mark.parametrize("b", [64, 256])
def test_launch_plan_covers_rows_and_fits_shared_memory(n, k, b):
    plan = hh.launch_plan(n, 28, k, b, num_sms=132)
    assert plan.smem_bytes <= hh.SMEM_MAX
    assert plan.smem_bytes == plan.fg * k * b * hh.CELL_BYTES
    assert plan.fg * plan.grid_y >= 28 > plan.fg * (plan.grid_y - 1)
    assert plan.grid_x * plan.rows_per_block >= n > (plan.grid_x - 1) * plan.rows_per_block


def test_launch_plan_refuses_more_shared_memory_than_a_block_has():
    with pytest.raises(ValueError):
        hh.launch_plan(100, 3, 80, 256, num_sms=132)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 8, 42])
def test_kernel_matches_plain_version_on_card(k):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the kernel has no CPU mode")
    dev = torch.device("cuda")
    bins, g, h, c, node = _case(200_003, 28, 256, k, seed=k)
    args = [torch.from_numpy(a).to(dev) for a in
            (np.ascontiguousarray(bins.T), g, h, c, node)]
    out = build_histograms(*args, k, 256)
    torch.testing.assert_close(out, hh.build_histograms_plain(*args, k, 256), rtol=0, atol=0)
    torch.testing.assert_close(out, build_histograms(*args, k, 256), rtol=0, atol=0)
    ref = hh.build_histograms_plain(args[0], args[1].double(), args[2].double(),
                                    args[3].double(), args[4], k, 256)
    absref = hh.build_histograms_plain(args[0], args[1].double().abs(), args[2].double(),
                                       args[3].double(), args[4], k, 256)
    torch.testing.assert_close(out[..., 2].double(), ref[..., 2], rtol=0, atol=0)
    err = (out[..., :2].double() - ref[..., :2]).abs()
    tol = 1e-5 * absref[..., :2].abs() + 1e-6
    assert bool((err <= tol).all())
