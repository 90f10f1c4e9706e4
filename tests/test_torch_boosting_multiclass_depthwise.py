"""Multiclass and depthwise fits against the JAX package, split off
``tests/test_torch_boosting.py`` so the test workers can run the files side
by side. Tolerances as in that file.
"""

import pytest

from mmlspark_tpu_torch.lightgbm import train as ttrain

from _torch_boosting_cases import _case, _fit_both, _opts, _same_margins, _same_trees
from _torch_boosting_cases import _time_limit, ref  # noqa: F401  (fixtures)


@pytest.mark.parametrize("num_class", [3, 5])
def test_multiclass_fit_matches_jax(ref, num_class):
    X, y, w = _case(seed=10 + num_class, num_class=num_class)
    rt, rj, _, _ = _fit_both(ref, X, y, w, **_opts(num_class))
    tb, jb = rt.booster, rj.booster
    assert tb.num_classes == num_class and tb.num_trees == 5 * num_class
    assert rt.stats.trees == 5 * num_class
    _same_trees(tb, jb)
    _same_margins(tb, jb, X)
    assert ref["texts_close"](tb.model_to_string(), jb.model_to_string())
    assert f"num_class={num_class}" in tb.model_to_string()


@pytest.mark.parametrize("max_bin", [31, 63])
def test_multiclass_quantized_text_is_the_references(ref, max_bin):
    """One stochastic-rounding draw per (iteration, column), integer
    histograms and the reference's gradients: the text byte for byte."""
    X, y, w = _case(seed=20, num_class=3)
    rt, rj, _, _ = _fit_both(ref, X, y, w, **_opts(3, max_bin=max_bin, histogram_method="u",
                                                   use_quantized_grad=True))
    assert rt.stats.quantized and rt.stats.histogram_path == "u"
    assert rt.booster.model_to_string() == rj.booster.model_to_string()


@pytest.mark.parametrize("depth", [3, 7])
@pytest.mark.parametrize("num_class", [2, 3])
def test_depthwise_fit_matches_jax(ref, depth, num_class):
    """Depth 7 has a 64-node level: one plain pass here, two grouped
    launches on the card (``test_wide_level_groups_equal_one_pass``)."""
    X, y, w = _case(seed=100 + depth, num_class=num_class)
    kw = _opts(num_class, growth="depthwise", max_depth=depth)
    rt, rj, _, _ = _fit_both(ref, X, y, w, **kw)
    tb = rt.booster
    assert tb.left_child.shape[1] == 2 ** (depth + 1) - 1 == ttrain.TrainOptions(**kw).num_nodes
    assert rt.stats.passes == depth * tb.num_trees
    assert len(rt.stats.level_launches) == depth
    _same_trees(tb, rj.booster)
    _same_margins(tb, rj.booster, X)
