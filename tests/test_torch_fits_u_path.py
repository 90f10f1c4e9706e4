"""Fits on the U path against the JAX package (quantized, bf16, without
subtraction, the fall-backs), split off ``tests/test_torch_u_histogram.py``
so the test workers can run the two files side by side. Tolerances as in
that file.
"""

import logging

import numpy as np
import pytest
import torch

from mmlspark_tpu_torch.data.table import Table
from mmlspark_tpu_torch.lightgbm import LightGBMClassifier
from mmlspark_tpu_torch.lightgbm import binning as tbinning
from mmlspark_tpu_torch.lightgbm import train as ttrain

from _torch_u_histogram_cases import (
    STRUCTURE, _fit_case, _fit_port, _jax_uniforms, jax, jbinning, jtrain,
)


@pytest.mark.parametrize("objective", ["binary", "regression"])
def test_compare_built_fit_without_subtraction_matches_jax(objective):
    """The grower's no-subtraction branch on the default path: both children
    of every split keyed in one pass (``2*lane + went_right``, k <= 21)."""
    # Small leaves make near-tied gains common at 31 leaves; this case has
    # none within float32 noise, with or without subtraction.
    X, y = _fit_case(seed=23, n=2000, f=6)
    if objective == "regression":
        y = X[:, 0] * 2 + X[:, 1] * X[:, 2]
    kw = dict(objective=objective, num_iterations=5, num_leaves=31, max_bin=63,
              leaf_batch=30, histogram_subtraction=False)
    bt, mt = tbinning.bin_dataset(X, max_bin=63)
    bj, mj = jbinning.bin_dataset(X, max_bin=63)
    rt = ttrain.train(bt, y, ttrain.TrainOptions(**kw), mapper=mt, device="cpu")
    jb = jtrain.train(bj, y, jtrain.TrainOptions(**kw), mapper=mj).booster
    tb = rt.booster
    for field in STRUCTURE:
        assert np.array_equal(getattr(tb, field), getattr(jb, field)), field
    np.testing.assert_allclose(tb.leaf_values, jb.leaf_values, atol=1e-5)


def test_quantized_model_text_is_identical_across_subtraction_and_chunking(monkeypatch):
    X, y = _fit_case(seed=17)
    kw = dict(histogram_method="u", use_quantized_grad=True, num_iterations=8)
    texts = {}
    for name, sub, budget in (("resident", True, None), ("nosub", False, None),
                              ("chunked", True, "120000"), ("chunked_nosub", False, "120000")):
        if budget is None:
            monkeypatch.delenv("MMLSPARK_TPU_U_BUDGET", raising=False)
        else:
            monkeypatch.setenv("MMLSPARK_TPU_U_BUDGET", budget)
        r = _fit_port(X, y, histogram_subtraction=sub, **kw)
        assert r.stats.histogram_path == ("u_chunked" if budget else "u")
        assert r.stats.u_chunks == (3 if budget else 1)
        texts[name] = r.booster.model_to_string()
    assert len(set(texts.values())) == 1


def test_subtraction_cache_gate_takes_the_no_subtraction_branch(monkeypatch):
    X, y = _fit_case(seed=23)
    kw = dict(histogram_method="u", use_quantized_grad=True)
    off = _fit_port(X, y, histogram_subtraction=False, **kw)
    monkeypatch.setattr(ttrain, "SUBTRACTION_CACHE_BYTES", 0)
    gated = _fit_port(X, y, histogram_subtraction=True, **kw)
    assert gated.booster.model_to_string() == off.booster.model_to_string()
    assert gated.stats.passes == off.stats.passes


def test_quantized_fits_repeat_and_follow_the_seed():
    X, y = _fit_case(seed=29)
    kw = dict(histogram_method="u", use_quantized_grad=True)
    a, b = (_fit_port(X, y, **kw).booster.model_to_string() for _ in range(2))
    assert a == b
    assert _fit_port(X, y, seed=1, **kw).booster.model_to_string() != a
    noise = ttrain.quant_noise(0, 3, 0, 1000, torch.device("cpu"))
    assert noise.shape == (2, 1000) and noise.dtype == torch.float32
    assert 0.0 <= float(noise.min()) and float(noise.max()) < 1.0
    assert not torch.equal(noise, ttrain.quant_noise(0, 4, 0, 1000, torch.device("cpu")))
    # the reference's draws: the g and h keys of the per-tree key
    key = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(0 ^ 0x51AB51AB), 3), 1)[0]
    np.testing.assert_array_equal(noise.numpy(), _jax_uniforms(key, 1000))


def test_quantized_fit_falls_back_with_a_warning_when_u_is_inactive(caplog):
    X, y = _fit_case(seed=31)
    with caplog.at_level(logging.WARNING, logger="mmlspark_tpu_torch.lightgbm"):
        r = _fit_port(X, y, use_quantized_grad=True)
    assert any("use_quantized_grad" in m for m in caplog.messages)
    assert not r.stats.quantized and r.stats.histogram_path == "compare"
    exact = _fit_port(X, y)
    assert r.booster.model_to_string() == exact.booster.model_to_string()


def test_quantized_row_cap_falls_back_with_a_warning(caplog):
    opts = ttrain.TrainOptions(histogram_method="u", use_quantized_grad=True)
    with caplog.at_level(logging.WARNING, logger="mmlspark_tpu_torch.lightgbm"):
        spec, quant = ttrain._histogram_path(opts, ttrain.QUANT_ROW_CAP + 1, 28, 256, None)
    assert spec is not None and spec.chunk_rows and not quant
    assert any("2^24" in m for m in caplog.messages)
    assert ttrain._histogram_path(opts, ttrain.QUANT_ROW_CAP, 28, 256, None)[1]


def test_estimator_with_quantized_grad_warns_and_trains_exact(caplog):
    X, y = _fit_case(seed=37, n=900)
    params = dict(numIterations=3, numLeaves=7, maxBin=31, device="cpu")
    with caplog.at_level(logging.WARNING, logger="mmlspark_tpu_torch.lightgbm"):
        quant = LightGBMClassifier(useQuantizedGrad=True, **params).fit(
            Table({"features": X, "label": y}))
    assert any("use_quantized_grad" in m for m in caplog.messages)
    exact = LightGBMClassifier(**params).fit(Table({"features": X, "label": y}))
    assert quant.get_model_string() == exact.get_model_string()
    assert not quant.fit_stats.quantized
