"""goss, dart, rf and multiclass on the U path against the JAX package,
split off ``tests/test_torch_boosting.py`` so the test workers can run the
two files side by side. Tolerances as in that file.
"""

import pytest

from _torch_boosting_cases import PATHS, _case, _fit_both, _opts, _same_trees
from _torch_boosting_cases import _time_limit, ref  # noqa: F401  (fixtures)


@pytest.mark.parametrize("mode", ["multiclass", "goss", "dart", "rf", "depthwise"])
@pytest.mark.parametrize("path", ["u_bf16", "u_quant"])
def test_modes_on_the_u_path_match_jax(ref, mode, path):
    """Each new mode on the U path, with and without quantized gradients;
    quantized fits write the reference's text byte for byte (depthwise
    leaves take the right child's sums in the reference's fused
    multiply-subtract)."""
    num_class = 3 if mode in ("multiclass", "dart") else 2
    kw = dict(multiclass={}, goss=dict(boosting_type="goss"),
              dart=dict(boosting_type="dart", drop_rate=0.3),
              rf=dict(boosting_type="rf", bagging_fraction=0.7, bagging_freq=1),
              depthwise=dict(growth="depthwise", max_depth=4))[mode]
    X, y, w = _case(seed=30, num_class=num_class)
    rt, rj, _, _ = _fit_both(ref, X, y, w, **_opts(num_class, **PATHS[path], **kw))
    assert rt.stats.histogram_path == "u"
    _same_trees(rt.booster, rj.booster)
    if path == "u_quant":
        assert rt.booster.model_to_string() == rj.booster.model_to_string()
