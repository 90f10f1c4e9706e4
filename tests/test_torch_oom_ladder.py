"""The U path's out-of-memory ladder against the JAX package's model text,
split off ``tests/test_torch_u_histogram.py`` so the test workers can run
the files side by side. Tolerances as in that file.
"""

import numpy as np
import pytest

from _torch_u_histogram_cases import _device_ooms, _fired, _fit_case, _oom_fit


@pytest.mark.parametrize("subtraction", [True, False], ids=["sub", "nosub"])
@pytest.mark.parametrize("quant", [True, False], ids=["quant", "bf16"])
def test_oom_ladder_degrades_to_identical_model_text(monkeypatch, quant, subtraction):
    """An out-of-memory error at the first pass halves the U budget once,
    re-plans chunked passes and retries the iteration: the model text is the
    undisturbed fit's, byte for byte (the reference's
    ``tests/test_pressure.py`` degraded-fit parity)."""
    monkeypatch.delenv("MMLSPARK_TPU_U_BUDGET", raising=False)
    X, y = _fit_case(seed=41)
    kw = dict(use_quantized_grad=quant, histogram_subtraction=subtraction)
    clean = _oom_fit(X, y, **kw)
    fault = _device_ooms((0, 0))
    hit = _oom_fit(X, y, fault, **kw)
    assert _fired(fault) == [(0, 0)]
    assert clean.stats.histogram_path == "u" and clean.stats.oom_retries == 0
    assert hit.stats.histogram_path == "u_chunked" and hit.stats.oom_retries == 1
    assert hit.stats.u_budget == clean.stats.u_budget // 2
    assert hit.booster.model_to_string() == clean.booster.model_to_string()


@pytest.mark.parametrize("data", ["categorical", "bundled"])
def test_oom_ladder_on_categorical_and_bundled_fits(monkeypatch, data):
    monkeypatch.delenv("MMLSPARK_TPU_U_BUDGET", raising=False)
    X, y = _fit_case(seed=42)
    kw = dict(use_quantized_grad=True)
    if data == "categorical":
        X[:, 0] = np.floor(np.abs(X[:, 0]) * 4)
        kw["cats"] = [0]
    else:
        hot = np.random.default_rng(42).integers(0, 5, len(X))
        X = np.hstack([X, np.eye(5)[hot]])
        kw["bundling"] = True
    clean = _oom_fit(X, y, **kw)
    hit = _oom_fit(X, y, _device_ooms((0, 0)), **kw)
    assert hit.stats.histogram_path == "u_chunked" and hit.stats.oom_retries == 1
    assert hit.booster.model_to_string() == clean.booster.model_to_string()


@pytest.mark.parametrize("keys,retries", [([(2, 0)], 1), ([(0, 0), (0, 1), (0, 2)], 3),
                                          ([(1, 0), (3, 0)], 2)])
def test_oom_ladder_walks_down_per_fault(monkeypatch, keys, retries):
    """Faults at later iterations and repeated faults: one halving each."""
    monkeypatch.delenv("MMLSPARK_TPU_U_BUDGET", raising=False)
    X, y = _fit_case(seed=43)
    clean = _oom_fit(X, y, use_quantized_grad=True)
    fault = _device_ooms(*keys)
    hit = _oom_fit(X, y, fault, use_quantized_grad=True)
    assert _fired(fault) == keys and hit.stats.oom_retries == retries
    assert hit.stats.u_budget == clean.stats.u_budget >> retries
    assert hit.booster.model_to_string() == clean.booster.model_to_string()
