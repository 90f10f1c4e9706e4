"""One-vs-rest categorical splits against the JAX package, split off
``tests/test_torch_categorical.py`` so the test workers can run the files
side by side. Tolerances as in that file.
"""

import pytest

from _torch_categorical_cases import _assert_same_forest, _fit_both, cat_case


@pytest.mark.parametrize("leaf_batch", [1, 4])
@pytest.mark.parametrize("max_cat_to_onehot", [4, 13])
def test_one_vs_rest_fit_matches_jax(monkeypatch, leaf_batch, max_cat_to_onehot):
    """max_cat_to_onehot = 13 puts the 12-category feature on one-vs-rest."""
    X, y, cats = cat_case(seed=12)
    rt, jb, _ = _fit_both(monkeypatch, X, y, cats, histogram_method="u",
                          leaf_batch=leaf_batch, max_cat_to_onehot=max_cat_to_onehot)
    _assert_same_forest(rt.booster, jb, X)
