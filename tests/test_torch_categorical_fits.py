"""Categorical fits on every histogram path against the JAX package, split
off ``tests/test_torch_categorical.py`` so the test workers can run the
files side by side. Tolerances as in that file.
"""

import pytest

from _torch_categorical_cases import PATHS, PATH_IDS, _assert_same_forest, _fit_both, cat_case


@pytest.mark.parametrize("subtraction", [True, False], ids=["sub", "nosub"])
@pytest.mark.parametrize("path,method,quant,budget", PATHS, ids=PATH_IDS)
def test_categorical_fit_matches_jax(monkeypatch, path, method, quant, budget, subtraction):
    X, y, cats = cat_case(seed=11)
    rt, jb, _ = _fit_both(monkeypatch, X, y, cats, budget, histogram_method=method,
                          use_quantized_grad=quant, histogram_subtraction=subtraction)
    assert rt.stats.histogram_path == path and rt.stats.quantized == quant
    assert rt.booster.has_categorical
    _assert_same_forest(rt.booster, jb, X)
