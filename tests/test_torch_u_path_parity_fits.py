"""Quantized and bf16 fits on the U path against the JAX package, split off
``tests/test_torch_u_histogram.py`` so the test workers can run them beside
the rest. Tolerances as in that file.
"""

import numpy as np
import pytest

from _torch_u_histogram_cases import STRUCTURE, _fit_case, _fit_port, _fit_reference, auc


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
