"""Categorical fits mixed with bundles, quantized categorical text across
paths and the estimator's categorical slots against the JAX package, split
off ``tests/test_torch_categorical.py`` so the test workers can run the
files side by side. Tolerances as in that file.
"""

import numpy as np
import pytest

from mmlspark_tpu_torch.data.table import Table
from mmlspark_tpu_torch.lightgbm import LightGBMClassifier
from mmlspark_tpu_torch.lightgbm import binning as tbinning
from mmlspark_tpu_torch.lightgbm import train as ttrain

from _torch_categorical_cases import (
    FIT, JLightGBMClassifier, JTable, PATHS, PATH_IDS, STRUCTURE, _assert_same_forest,
    _fit_both, cat_case,
)


@pytest.mark.parametrize("path,method,quant,budget", PATHS, ids=PATH_IDS)
def test_mixed_categorical_and_bundled_fit_matches_jax(monkeypatch, path, method, quant,
                                                       budget):
    """Categorical columns beside one-hot blocks that bundle: categoricals
    stay identity columns of the packed matrix."""
    X, y, cats = cat_case(seed=13, n=2000)
    rng = np.random.default_rng(13)
    hot = rng.integers(0, 6, len(X))
    onehot = np.zeros((len(X), 6))
    onehot[np.arange(len(X)), hot] = 1.0
    X = np.hstack([X, onehot])
    y = np.where(hot == 2, 1.0 - y, y)
    rt, jb, mt = _fit_both(monkeypatch, X, y, cats, budget, bundling=True,
                           histogram_method=method, use_quantized_grad=quant)
    assert mt.bundles is not None and mt.bundles.num_columns < X.shape[1]
    assert rt.stats.histogram_path == path
    _assert_same_forest(rt.booster, jb, X)


def test_quantized_categorical_text_matches_across_paths(monkeypatch):
    """Resident, chunked and no-subtraction quantized categorical fits write
    one model text (chunked and resident passes sum the same integers)."""
    X, y, cats = cat_case(seed=14)
    b, m = tbinning.bin_dataset(X, max_bin=31, categorical_features=cats)
    texts = set()
    for sub, budget in ((True, None), (False, None), (True, "40000"), (False, "40000")):
        if budget is None:
            monkeypatch.delenv("MMLSPARK_TPU_U_BUDGET", raising=False)
        else:
            monkeypatch.setenv("MMLSPARK_TPU_U_BUDGET", budget)
        r = ttrain.train(b, y, ttrain.TrainOptions(**FIT, histogram_method="u",
                                                   use_quantized_grad=True,
                                                   histogram_subtraction=sub),
                         mapper=m, device="cpu")
        texts.add(r.booster.model_to_string())
    assert len(texts) == 1


@pytest.mark.parametrize("by", ["index", "name", "both"])
def test_estimator_categorical_slots_match_jax(by):
    X, y, cats = cat_case(seed=18, n=1500)
    slots = {"index": dict(categoricalSlotIndexes=cats),
             "name": dict(categoricalSlotNames=[f"f{j}" for j in cats]),
             "both": dict(categoricalSlotIndexes=cats[:1],
                          categoricalSlotNames=[f"f{j}" for j in cats[1:]])}[by]
    params = dict(numIterations=3, numLeaves=7, maxBin=31, minDataPerGroup=20, catSmooth=5.0,
                  catL2=5.0, maxCatThreshold=8, maxCatToOnehot=4, **slots)
    port = LightGBMClassifier(device="cpu", **params).fit(Table({"features": X, "label": y}))
    ref = JLightGBMClassifier(**params).fit(JTable({"features": X, "label": y}))
    pb, jb = port.booster, ref.booster
    assert pb.has_categorical
    for field in STRUCTURE:
        assert np.array_equal(getattr(pb, field), getattr(jb, field)), field
    np.testing.assert_allclose(port.transform(Table({"features": X}))["probability"],
                               np.asarray(ref.transform(JTable({"features": X}))["probability"]),
                               atol=1e-5)
    assert port.get_model_string().count("num_cat=") == 3
