"""Bagged fits (plain and pos/neg-stratified, with feature_fraction) against
the JAX package, split off ``tests/test_torch_train_options.py`` so the
test workers can run the files side by side. Tolerances as in that file.
"""

import numpy as np
import pytest

from _torch_train_options_cases import SCHEDULES, _case, _fit_both, _same_trees
from _torch_train_options_cases import _time_limit, ref  # noqa: F401  (fixtures)


@pytest.mark.parametrize("path", ["compare", "u_quant"])
@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_bagged_fit_matches_jax(ref, name, path):
    X, y = _case(seed=3 + len(name))
    kw = dict(SCHEDULES[name])
    if path == "u_quant":
        kw.update(histogram_method="u", use_quantized_grad=True)
    rt, rj = _fit_both(ref, X, y, **kw)
    assert rt.stats.histogram_path == ("u" if path == "u_quant" else "compare")
    _same_trees(rt.booster, rj.booster)
    np.testing.assert_allclose(rt.booster.raw_margin(X, device="cpu"), rj.booster.raw_margin(X),
                               atol=1e-5)
