"""Exclusive Feature Bundling in the port against the JAX package.

``mmlspark_tpu_torch.lightgbm.bundling`` (the bundle plan, packing, the
routing and expansion maps), bundled binning, the trainer's expansion and
routing decode, and bundled fits on the three histogram paths. Inputs come
from numpy seeds and go through both packages on the CPU: the port with its
kernels' plain versions, the JAX package as its own tests run it.

- the plan, packed bins and maps: identical (byte for byte);
- expanded histograms: integer-equal on quantized sums, within 1e-5 *
  sum|x| + 1e-6 on float32 sums (counts exact);
- bundled fits: tree structure identical to the reference's bundled fit,
  leaf values within 1e-5; quantized bundled fits write the port's
  unbundled fit's model text byte for byte (the port takes the default
  bin's subtraction on the integers; the reference after dequantization,
  so its leaf values may differ from ours in the last ulp).
"""

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

from _torch_bundling_cases import (
    FIT, JLightGBMClassifier, JTable, PATHS, STRUCTURE, _spec_dict, jbinning, jbund, jnp,
    jtrain, ju, one_hot_case,
)


# -- the plan, packing and maps ------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("rate", [0.0, 0.02, 0.2])
@pytest.mark.parametrize("cats", [(), (0, 7)], ids=["numeric", "cat"])
def test_bundle_plan_and_packed_bins_match_jax(seed, rate, cats):
    X, _ = one_hot_case(seed=seed, conflict=0.05 if seed == 2 else 0.0)
    kw = dict(max_bin=31, categorical_features=list(cats) or None, feature_bundling=True,
              max_conflict_rate=rate)
    bt, mt = tbinning.bin_dataset(X, **kw)
    bj, mj = jbinning.bin_dataset(X, **kw)
    assert _spec_dict(mt.bundles) == _spec_dict(mj.bundles)
    assert bt.dtype == np.uint8 and bt.shape == np.asarray(bj).shape
    np.testing.assert_array_equal(bt, np.asarray(bj))
    if mt.bundles is not None:
        assert mt.bundles.num_columns < X.shape[1]
        for j in cats:
            assert mt.bundles.identity[j]


@pytest.mark.parametrize("blocks,card", [(1, 2), (3, 4), (2, 90), (1, 300)])
def test_plan_limits_match_jax(blocks, card):
    """Bundles at the 256-bin column cap (90 or 300 members of width 4 fill
    bundles of 256) and two-member bundles."""
    X, _ = one_hot_case(n=1500, blocks=blocks, card=card, conts=1, seed=3)
    bt, mt = tbinning.bin_dataset(X, max_bin=255, feature_bundling=True)
    bj, mj = jbinning.bin_dataset(X, max_bin=255, feature_bundling=True)
    assert _spec_dict(mt.bundles) == _spec_dict(mj.bundles)
    np.testing.assert_array_equal(bt, np.asarray(bj))
    if card >= 90:
        assert max(mt.bundles.widths) == tbund.MAX_BUNDLE_BINS


@pytest.mark.parametrize("seed", [0, 4])
def test_unpack_and_route_maps_match_jax(seed):
    X, _ = one_hot_case(seed=seed)
    raw, m = tbinning.bin_dataset(X, max_bin=63)
    spec = tbund.fit_feature_bundles(raw, m.num_bins)
    jspec = jbund.fit_feature_bundles(raw, m.num_bins)
    assert _spec_dict(spec) == _spec_dict(jspec)
    packed = tbund.pack_bundles(raw, spec)
    np.testing.assert_array_equal(packed, jbund.pack_bundles(raw, jspec))
    np.testing.assert_array_equal(tbund.unpack_bins(packed, spec), raw)
    for port, ref in zip(tbund.route_maps(spec), jbund.route_maps(jspec)):
        np.testing.assert_array_equal(port, ref)


@pytest.mark.parametrize("num_bins", [8, 32, 64, 256])
def test_expand_maps_match_jax(num_bins):
    X, _ = one_hot_case(seed=5)
    raw, m = tbinning.bin_dataset(X, max_bin=min(num_bins - 1, 63))
    spec = tbund.fit_feature_bundles(raw, m.num_bins)
    jspec = jbund.fit_feature_bundles(raw, m.num_bins)
    for port, ref in zip(tbund.expand_maps(spec, num_bins), jbund.expand_maps(jspec, num_bins)):
        np.testing.assert_array_equal(port, ref)


@pytest.mark.parametrize("seed", [0, 6])
def test_orig_bins_decode_every_packed_value(seed):
    """The trainer's routing decode (``_orig_bins``) recovers every row's
    original bin from its packed column, as ``unpack_bins`` does."""
    X, _ = one_hot_case(seed=seed)
    raw, m = tbinning.bin_dataset(X, max_bin=63)
    spec = tbund.fit_feature_bundles(raw, m.num_bins)
    consts = ttrain._bundle_route_consts(spec, torch.device("cpu"))
    packed = torch.from_numpy(tbund.pack_bundles(raw, spec))
    n, f = raw.shape
    feats = torch.arange(f)[None, :].expand(n, f)
    cols = packed[:, consts[0]]
    np.testing.assert_array_equal(ttrain._orig_bins(cols, feats, consts).numpy(), raw)


def test_cat_row_maps_bundled_match_jax():
    X, _ = one_hot_case(seed=8)
    X[:, 3] = np.random.default_rng(8).integers(0, 6, len(X))
    _, mt = tbinning.bin_dataset(X, max_bin=31, categorical_features=[3], feature_bundling=True)
    _, mj = jbinning.bin_dataset(X, max_bin=31, categorical_features=[3], feature_bundling=True)
    spec = tu.make_u_spec(mt.bundles.num_bins, mt.bundles.num_columns, mt.bundles.widths)
    jspec = ju.make_u_spec(mj.bundles.num_bins, mj.bundles.num_columns, mj.bundles.widths)
    for port, ref in zip(tbund.cat_row_maps_bundled(spec, mt.bundles, [3]),
                         jbund.cat_row_maps_bundled(jspec, mj.bundles, [3])):
        np.testing.assert_array_equal(port, ref)


@pytest.mark.parametrize("quant", [True, False], ids=["int", "float"])
@pytest.mark.parametrize("k", [1, 4])
def test_expand_bundled_matches_jax(quant, k):
    X, _ = one_hot_case(seed=9)
    raw, m = tbinning.bin_dataset(X, max_bin=31)
    spec = tbund.fit_feature_bundles(raw, m.num_bins)
    packed = tbund.pack_bundles(raw, spec)
    rng = np.random.default_rng(k)
    node = rng.integers(0, k, len(X))
    # a packed histogram of real rows, so that totals - others is a real bin
    stats = (rng.integers(-127, 128, (len(X), 3)) if quant
             else rng.normal(size=(len(X), 3))).astype(np.int64 if quant else np.float32)
    stats[:, 2] = 1
    h = np.zeros((k, spec.num_columns, spec.num_bins, 3), stats.dtype)
    for c in range(spec.num_columns):
        np.add.at(h, (node, c, packed[:, c].astype(np.int64)), stats)
    tot = h[:, 0].sum(axis=1)
    port = ttrain._expand_bundled(torch.from_numpy(h), torch.from_numpy(tot), spec, 32)
    ref = np.asarray(jtrain._expand_bundled(jnp.asarray(h.astype(np.float32)),
                                            jnp.asarray(tot.astype(np.float32)), spec, 32))
    dense = np.zeros((k, raw.shape[1], 32, 3), np.float64)
    for j in range(raw.shape[1]):
        np.add.at(dense, (node, j, raw[:, j].astype(np.int64)), stats)
    if quant:
        assert not port.is_floating_point()
        np.testing.assert_array_equal(port.numpy(), dense)  # exact: the unbundled histogram
        np.testing.assert_array_equal(port.numpy(), ref)
    else:
        np.testing.assert_array_equal(port[..., 2].numpy(), ref[..., 2])
        scale = np.abs(stats).sum()
        assert np.abs(port.numpy() - ref).max() <= 1e-5 * scale + 1e-6
        assert np.abs(port.numpy() - dense).max() <= 1e-5 * scale + 1e-6


@pytest.mark.parametrize("name,method,quant,budget", PATHS, ids=[p[0] for p in PATHS])
def test_bundled_fit_equals_unbundled_fit(monkeypatch, name, method, quant, budget):
    """Zero conflicts: the bundled fit grows the unbundled fit's trees; on
    quantized sums it writes the same model text."""
    X, y = one_hot_case(seed=22)
    if budget is None:
        monkeypatch.delenv("MMLSPARK_TPU_U_BUDGET", raising=False)
    else:
        monkeypatch.setenv("MMLSPARK_TPU_U_BUDGET", budget)
    opts = ttrain.TrainOptions(**FIT, histogram_method=method, use_quantized_grad=quant)
    fits = {}
    for bundling in (False, True):
        b, m = tbinning.bin_dataset(X, max_bin=FIT["max_bin"], feature_bundling=bundling)
        fits[bundling] = ttrain.train(b, y, opts, mapper=m, device="cpu")
    assert m.bundles.num_columns < X.shape[1]
    ub, bb = fits[False].booster, fits[True].booster
    for field in STRUCTURE:
        assert np.array_equal(getattr(ub, field), getattr(bb, field)), field
    np.testing.assert_allclose(ub.leaf_values, bb.leaf_values, atol=1e-6)
    if quant:
        assert bb.model_to_string() == ub.model_to_string()
    if method == "u":
        k_unbundled = tu.make_u_spec(32, X.shape[1], m.num_bins).k
        assert m.bundles.k_packed < k_unbundled


@pytest.mark.parametrize("rate", [0.05, 0.3])
def test_conflicting_bundles_fit_matches_jax(monkeypatch, rate):
    """A conflict budget above zero: packed conflict rows decode as the
    reference decodes them, and the fits agree."""
    X, y = one_hot_case(seed=24, conflict=0.03)
    monkeypatch.delenv("MMLSPARK_TPU_U_BUDGET", raising=False)
    kw = dict(max_bin=31, feature_bundling=True, max_conflict_rate=rate)
    bt, mt = tbinning.bin_dataset(X, **kw)
    bj, mj = jbinning.bin_dataset(X, **kw)
    assert mt.bundles is not None and mt.bundles.conflict_count > 0
    np.testing.assert_array_equal(bt, np.asarray(bj))
    opts = dict(FIT, histogram_method="u")
    rt = ttrain.train(bt, y, ttrain.TrainOptions(**opts), mapper=mt, device="cpu")
    jb = jtrain.train(bj, y, jtrain.TrainOptions(**opts), mapper=mj).booster
    for field in STRUCTURE:
        assert np.array_equal(getattr(rt.booster, field), getattr(jb, field)), field
    np.testing.assert_allclose(rt.booster.leaf_values, jb.leaf_values, atol=1e-5)


def test_unpacked_bins_with_a_bundled_mapper_are_refused():
    X, y = one_hot_case(seed=25)
    raw, m = tbinning.bin_dataset(X, max_bin=31)
    _, mb = tbinning.bin_dataset(X, max_bin=31, feature_bundling=True)
    with pytest.raises(ValueError, match="packed bins"):
        ttrain.train(raw, y, ttrain.TrainOptions(**FIT), mapper=mb, device="cpu")


def test_carried_bundled_mapper_bins_as_the_reference():
    X, _ = one_hot_case(seed=26)
    Xv, _ = one_hot_case(seed=27)
    bj, mj = jbinning.bin_dataset(X, max_bin=31, feature_bundling=True)
    mt = bin_mapper_from_jax(mj.edges, mj.num_bins, mj.max_bin, mj.cat_values, mj.bundles)
    assert _spec_dict(mt.bundles) == _spec_dict(mj.bundles)
    np.testing.assert_array_equal(tbinning.apply_bins(Xv, mt),
                                  np.asarray(jbinning.apply_bins(Xv, mj)))


@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_estimator_bundling_matches_jax(rate):
    X, y = one_hot_case(n=1200, seed=28)
    params = dict(numIterations=3, numLeaves=7, maxBin=31, featureBundling=True,
                  maxConflictRate=rate)
    port = LightGBMClassifier(device="cpu", **params).fit(Table({"features": X, "label": y}))
    ref = JLightGBMClassifier(**params).fit(JTable({"features": X, "label": y}))
    pb, jb = port.booster, ref.booster
    for field in STRUCTURE:
        assert np.array_equal(getattr(pb, field), getattr(jb, field)), field
    np.testing.assert_allclose(pb.leaf_values, jb.leaf_values, atol=1e-5)
    np.testing.assert_allclose(port.transform(Table({"features": X}))["probability"],
                               np.asarray(ref.transform(JTable({"features": X}))["probability"]),
                               atol=1e-5)


# -- on the card -------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("widths", [(256, 2, 2, 100, 2, 256, 31), (2,) * 40 + (256,)])
@pytest.mark.parametrize("quant", [True, False], ids=["quant", "bf16"])
def test_packed_widths_on_card(widths, quant):
    """The U pass and bin-scatter on per-column widths at both of the
    kernels' limits (256-wide bundles, width-2 columns) equal their plain
    versions bit for bit, and the compare-built kernel on the same columns
    equals its plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the kernels have no CPU mode")
    from mmlspark_tpu_torch.ops import hopper_histogram as hh

    dev = torch.device("cuda")
    rng = np.random.default_rng(len(widths))
    n, k = 200_003, 8
    bins = np.stack([rng.integers(0, w, n) for w in widths]).astype(np.uint8)
    bins_t = torch.from_numpy(bins).to(dev)
    spec = tu.make_u_spec(256, len(widths), widths)
    g, h = (torch.from_numpy(a.astype(np.float32)).to(dev)
            for a in (rng.normal(size=n), rng.uniform(0.01, 0.25, size=n)))
    c = torch.ones(n, device=dev)
    node = torch.from_numpy(rng.integers(0, k + 1, n).astype(np.int32)).to(dev)
    if quant:
        stats, _ = tu.stat_rows_quant(g, h, c, torch.rand((2, n), device=dev))
        scale = None
    else:
        stats = tu.stat_rows(g, h, c)
        scale = tu.stat_scales(stats)
    u = tu.build_u(bins_t, spec)
    out = tu.fused_panel_dot(u, stats, node, k, scale)
    assert torch.equal(out, tu.fused_panel_dot_plain(u, stats, node, k, scale))
    scat = hh.bin_scatter(bins_t, stats, node, k, spec, scale)
    assert torch.equal(scat, hh.bin_scatter_plain(bins_t, stats, node, k, spec, scale))
    assert torch.equal(scat, out)
    hist = hh.build_histograms_cuda(bins_t, g, h, c, node, k, 256)
    assert torch.equal(hist, hh.build_histograms_plain(bins_t, g, h, c, node, k, 256))
