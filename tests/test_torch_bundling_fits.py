"""Bundled fits against the JAX package, split off
``tests/test_torch_bundling.py`` so the test workers can run the two files
side by side. Tolerances as in that file.
"""

import numpy as np
import pytest

from _torch_bundling_cases import PATHS, STRUCTURE, _fit_both, one_hot_case


@pytest.mark.parametrize("subtraction", [True, False], ids=["sub", "nosub"])
@pytest.mark.parametrize("name,method,quant,budget", PATHS, ids=[p[0] for p in PATHS])
def test_bundled_fit_matches_jax(monkeypatch, name, method, quant, budget, subtraction):
    X, y = one_hot_case(seed=21)
    rt, jb, mt = _fit_both(monkeypatch, X, y, budget, histogram_method=method,
                           use_quantized_grad=quant, histogram_subtraction=subtraction)
    assert mt.bundles is not None and mt.bundles.conflict_count == 0
    assert rt.stats.histogram_path == name.split("_")[0].replace("chunked", "u_chunked")
    assert rt.stats.quantized == quant
    tb = rt.booster
    for field in STRUCTURE:
        assert np.array_equal(getattr(tb, field), getattr(jb, field)), field
    np.testing.assert_allclose(tb.leaf_values, jb.leaf_values, atol=1e-5)
    np.testing.assert_allclose(tb.raw_margin(X, device="cpu"), jb.raw_margin(X), atol=1e-5)
