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
        dict(hess=torch.zeros(11)),
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


@pytest.mark.parametrize("n", [1, 3, 1000, 1001, 11_000_000])
@pytest.mark.parametrize("k", [1, 8, 42])
@pytest.mark.parametrize("b", [64, 256])
def test_launch_plan_covers_rows_and_fits_shared_memory(n, k, b):
    plan = hh.launch_plan(n, 28, k, b, num_sms=132)
    assert plan.smem_bytes <= hh.SMEM_MAX
    assert plan.smem_bytes == plan.fg * k * b * hh.CELL_BYTES
    assert plan.fg * plan.groups >= 28 > plan.fg * (plan.groups - 1)
    assert plan.row_blocks * plan.rows_per_block >= n > (plan.row_blocks - 1) * plan.rows_per_block
    assert plan.rows_per_block % hh.ROWS_PER_THREAD == 0  # aligned vector loads
    assert plan.row_blocks <= 65_535  # the grid's second dimension


def test_launch_plan_refuses_more_shared_memory_than_a_block_has():
    with pytest.raises(ValueError):
        hh.launch_plan(100, 3, 80, 256, num_sms=132)


# -- the kernel's arithmetic, mirrored in numpy ------------------------------

MASK32 = (1 << 32) - 1


def _carry_add(word, q):
    """histogram.cu's exact 64-bit add into a shared (lo, hi) word with two
    uint32 atomics: add the low half, carry out of it into the high half,
    and skip the high add when it adds 0. ``word`` is a [lo, hi] list."""
    lo = q & MASK32
    old = word[0]
    word[0] = (old + lo) & MASK32
    hi = ((q >> 32) + (1 if old > MASK32 - lo else 0)) & MASK32
    if hi:
        word[1] = (word[1] + hi) & MASK32


def _signed(word):
    v = word[0] | (word[1] << 32)
    return v - (1 << 64) if v >> 63 else v


def _largest_q(n):
    """The largest ``round(x * 2**s)`` that :func:`fixed_point_scales` lets
    N rows take: x just below a power of two."""
    x = np.float32(np.nextafter(np.float32(1), np.float32(0)))
    scale = hh.fixed_point_scales(torch.full((1,), float(x)).expand(n))[0].item()
    return int(round(float(x) * scale))


Q_MAX = _largest_q(11_000_000)
EDGES = [0, 1, -1, -(2 ** 32), 2 ** 32 - 1, -(2 ** 32 - 1), 2 ** 38, -(2 ** 38), Q_MAX, -Q_MAX]


def test_largest_fixed_point_value_at_full_height_is_below_2_38():
    assert 2 ** 37 < Q_MAX < 2 ** 38
    assert 11_000_000 * Q_MAX < 2 ** 62


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("edge", EDGES)
def test_two_word_carry_add_is_the_exact_sum_in_any_order(edge, seed):
    rng = np.random.default_rng(seed)
    values = ([edge] * 40 + [int(v) for v in rng.choice(EDGES, 60)]
              + [int(v) for v in rng.integers(-Q_MAX, Q_MAX, 60)])
    exact = sum(values)
    for _ in range(3):
        rng.shuffle(values)
        word = [0, 0]
        for v in values:
            _carry_add(word, v & ((1 << 64) - 1))
        assert _signed(word) == exact


@pytest.mark.parametrize("blocks", [1, 3, 7])
def test_block_words_flushed_with_64_bit_adds_give_the_exact_sum(blocks):
    """Per-block words from the carry add, then the flush's native 64-bit
    global adds (mod 2**64): the exact int64 sum whatever the split."""
    rng = np.random.default_rng(blocks)
    values = [int(v) for v in rng.integers(-Q_MAX, Q_MAX, 500)] + [Q_MAX] * 50
    total = 0
    for part in np.array_split(np.array(values, dtype=object), blocks):
        word = [0, 0]
        for v in part:
            _carry_add(word, int(v) & ((1 << 64) - 1))
        total = (total + (word[0] | (word[1] << 32))) & ((1 << 64) - 1)
    assert total - (1 << 64) * (total >> 63) == sum(values)


def _mirror_kernel(bins_t, g, h, c, node, k, b, plan, seed):
    """histogram.cu in numpy at a small size: the plan's blocks, each
    summing its group's cells with the carry add in a shuffled row order
    (atomics land in any order), the flush into int64 and float32
    accumulators, and the finalize. Bins stay below ``b``, as the plain
    version needs."""
    f, n = bins_t.shape
    scale = hh.fixed_point_scales(torch.from_numpy(g), torch.from_numpy(h)).numpy()
    qg = np.round(g.astype(np.float64) * scale[0]).astype(np.int64)
    qh = np.round(h.astype(np.float64) * scale[1]).astype(np.int64)
    acc = {}
    cnt_out = np.zeros((k, f, b), dtype=np.float32)
    rng = np.random.default_rng(seed)
    for group in range(plan.groups):
        feats = range(group * plan.fg, min(f, (group + 1) * plan.fg))
        for block in range(plan.row_blocks):
            r0 = block * plan.rows_per_block
            assert r0 % hh.ROWS_PER_THREAD == 0
            words = {}
            counts = {}
            for i in rng.permutation(np.arange(r0, min(n, r0 + plan.rows_per_block))):
                if not 0 <= node[i] < k:
                    continue
                for j in feats:
                    if bins_t[j, i] >= b:
                        continue
                    cell = (int(node[i]), j, int(bins_t[j, i]))
                    wg, wh = words.setdefault(cell, ([0, 0], [0, 0]))
                    _carry_add(wg, int(qg[i]) & ((1 << 64) - 1))
                    _carry_add(wh, int(qh[i]) & ((1 << 64) - 1))
                    counts[cell] = (counts.get(cell, 0) + int(c[i])) & MASK32
            for cell, (wg, wh) in words.items():
                ag, ah = acc.get(cell, (0, 0))
                acc[cell] = ((ag + (wg[0] | (wg[1] << 32))) % (1 << 64),
                             (ah + (wh[0] | (wh[1] << 32))) % (1 << 64))
                cnt_out[cell] += np.float32(counts[cell])
    sums = np.zeros((k, f, b, 2))
    for cell, words in acc.items():
        sums[cell] = [_signed([w & MASK32, w >> 32]) for w in words]
    sums /= scale
    return np.concatenate([sums.astype(np.float32), cnt_out[..., None]], axis=-1)


@pytest.mark.parametrize("n", [1, 3, 1001])
@pytest.mark.parametrize("k", [1, 3, 42])
def test_kernel_mirror_is_bit_equal_to_the_plain_version(n, k, monkeypatch):
    monkeypatch.setattr(hh, "HIST_THREADS", 8)  # several row blocks at this size
    monkeypatch.setattr(hh, "HIST_SMEM_BUDGET", 2 * k * 16 * hh.CELL_BYTES)  # 2 groups
    bins, g, h, c, node = _case(n, 3, 16, k, seed=n + k)
    bins_t = np.ascontiguousarray(bins.T)
    plan = hh.launch_plan(n, 3, k, 16, num_sms=2)
    mirror = _mirror_kernel(bins_t, g, h, c, node, k, 16, plan, seed=k)
    plain = hh.build_histograms_plain(
        torch.from_numpy(bins_t), torch.from_numpy(g), torch.from_numpy(h),
        torch.from_numpy(c), torch.from_numpy(node), k, 16).numpy()
    np.testing.assert_array_equal(mirror, plain)


def _skewed(n, f, b, k, skew, seed):
    """HIGGS-like skew: every row in one bin, or three distinct bins (the
    b-tag columns) on the first third of the features."""
    bins, g, h, c, node = _case(n, f, b, k, seed=seed)
    rng = np.random.default_rng(seed + 1)
    if skew == "one_bin":
        bins[:] = b - 1
    else:
        bins[:, : max(1, f // 3)] = rng.integers(0, 3, size=(n, max(1, f // 3)))
    return bins, g, h, c, node


SKEWED = [(skew, k, n) for skew in ("one_bin", "three_bins") for k in (1, 8, 42)
          for n in (1001, 2003)]


@pytest.mark.parametrize("skew,k,n", SKEWED)
def test_plain_version_matches_jax_panel_kernel_on_skewed_bins(skew, k, n):
    _, jp = _reference_histograms()
    bins, g, h, c, node = _skewed(n, 5, 32, k, skew, seed=n + k)
    ref = jp.build_histograms_panel_pallas(
        bins, g, h, c, node, k, 32, interpret=True, precision="highest"
    )
    _assert_close(_port(bins, g, h, c, node, k, 32), ref)


@pytest.mark.parametrize("skew,k,n", SKEWED)
def test_plain_version_matches_jax_combined_kernel_on_skewed_bins(skew, k, n):
    _, jp = _reference_histograms()
    bins, g, h, c, node = _skewed(n, 5, 32, k, skew, seed=n * 3 + k)
    ref = jp.build_histograms_pallas(
        bins, g, h, c, node, k, 32, interpret=True, precision="highest"
    )
    _assert_close(_port(bins, g, h, c, node, k, 32), ref)


def test_aligned_copies_only_a_tensor_off_its_boundary():
    t = torch.arange(9, dtype=torch.float32)
    assert hh._aligned(t, 16) is t
    view = t[1:]
    moved = hh._aligned(view, 16)
    assert moved.data_ptr() % 16 == 0
    torch.testing.assert_close(moved, view, rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [200_003, 200_000])
@pytest.mark.parametrize("skew", ["uniform", "one_bin", "three_bins"])
@pytest.mark.parametrize("k", [1, 8, 42])
def test_kernel_matches_plain_version_on_card(k, skew, n):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the kernel has no CPU mode")
    dev = torch.device("cuda")
    if skew == "uniform":
        bins, g, h, c, node = _case(n, 28, 256, k, seed=k)
    else:
        bins, g, h, c, node = _skewed(n, 28, 256, k, skew, seed=k)
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


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 8])
def test_kernel_takes_inputs_off_the_vector_boundary_on_card(k):
    """Stats and bins that start off a 16- or 4-byte boundary (views at an
    offset) give the same sums as aligned copies."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the kernel has no CPU mode")
    dev = torch.device("cuda")
    bins, g, h, c, node = _case(100_001, 28, 256, k, seed=10 + k)
    flat = torch.zeros(28 * 100_001 + 1, dtype=torch.uint8, device=dev)
    bins_t = flat[1:].view(28, 100_001)
    bins_t.copy_(torch.from_numpy(np.ascontiguousarray(bins.T)))
    stats = []
    for a in (g, h, c, node):
        buf = torch.zeros(a.shape[0] + 1, dtype=torch.from_numpy(a).dtype, device=dev)
        buf[1:] = torch.from_numpy(a)
        stats.append(buf[1:])
    out = build_histograms(bins_t, *stats, k, 256)
    aligned = build_histograms(bins_t.clone(), *(t.clone() for t in stats), k, 256)
    torch.testing.assert_close(out, aligned, rtol=0, atol=0)
    torch.testing.assert_close(out, hh.build_histograms_plain(bins_t, *stats, k, 256),
                               rtol=0, atol=0)
