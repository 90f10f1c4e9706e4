"""TrainClassifier and TrainRegressor against the JAX package's, split off
``tests/test_torch_trainers.py`` so the test workers can run the two files
side by side. Tolerances as in that file.
"""

import numpy as np
import pytest

from mmlspark_tpu_torch.core.pipeline import PipelineStage
from mmlspark_tpu_torch.data.table import Table
from mmlspark_tpu_torch.train import TrainedClassifierModel, TrainedRegressorModel

from _torch_trainers_cases import _check, _fit_both, _raw
from _torch_trainers_cases import ref  # noqa: F401  (fixtures)


@pytest.mark.parametrize("labels", ["strings", "numbers", "indices", "bools"])
def test_train_classifier_equals_the_reference(ref, labels):
    cols, _, noisy = _raw()
    cols["label"] = {
        "strings": np.where(noisy > 0.5, "Y", "N").astype(object),
        "numbers": np.where(noisy > 0.5, 7.0, -2.0),
        "indices": (noisy > 0.5).astype(np.int64),
        "bools": noisy > 0.5,
    }[labels]
    port, want = _fit_both(ref, "clf", "clf", "label", cols)
    assert port.getLabelLevels() == want.getLabelLevels()
    got, _ = _check(ref, port, want, cols, "label")
    assert set(np.unique(got["prediction"].astype(str))) <= {
        "strings": {"N", "Y"}, "numbers": {"7.0", "-2.0"}, "indices": {"0.0", "1.0"},
        "bools": {"0.0", "1.0"}}[labels]


def test_multiclass_and_unindexed_labels_equal_the_reference(ref):
    cols, _, noisy = _raw(seed=1)
    cols["label"] = np.array(["lo", "mid", "hi"], dtype=object)[np.digitize(noisy, [0.0, 1.0])]
    port, want = _fit_both(ref, "clf", "clf", "label", cols)
    assert port.getLabelLevels() == ["hi", "lo", "mid"]
    _check(ref, port, want, cols, "label")
    cols["label"] = (noisy > 0.5).astype(np.float64)
    port, want = _fit_both(ref, "clf", "clf", "label", cols, reindexLabel=False,
                           numFeatures=64, featuresCol="feats")
    assert port.getLabelLevels() is None and port.getFeaturesCol() == "feats"
    _check(ref, port, want, cols, "label")


def test_train_regressor_equals_the_reference(ref):
    cols, latent, _ = _raw(seed=2)
    cols["y"] = (10 * latent + np.random.default_rng(9).normal(size=len(latent))).astype(np.float32)
    port, want = _fit_both(ref, "reg", "reg", "y", cols)
    assert isinstance(port, TrainedRegressorModel)
    got, exp = _check(ref, port, want, cols, "y", pred_equal=False)
    np.testing.assert_allclose(got["prediction"], exp["prediction"], rtol=1e-5, atol=1e-5)


def test_trained_models_move_between_the_packages(ref, tmp_path):
    cols, latent, noisy = _raw(seed=3)
    cols["label"] = np.where(noisy > 0.5, "Y", "N").astype(object)
    port, want = _fit_both(ref, "clf", "clf", "label", cols)
    test = {k: v for k, v in cols.items() if k != "label"}
    port.save(str(tmp_path / "port"))
    want.save(str(tmp_path / "ref"))
    from_ref = PipelineStage.load(str(tmp_path / "ref"))
    assert isinstance(from_ref, TrainedClassifierModel)
    from_ref.getFittedModel().setDevice("cpu")
    from_port = ref.pipeline.PipelineStage.load(str(tmp_path / "port"))
    for a, b in ((from_ref.transform(Table(test)), want.transform(ref.Table(test))),
                 (port.transform(Table(test)), from_port.transform(ref.Table(test)))):
        assert list(a["prediction"]) == list(b["prediction"])
        np.testing.assert_allclose(a["probability"], b["probability"], rtol=1e-6, atol=1e-7)
    cols["y"] = latent
    reg, _ = _fit_both(ref, "reg", "reg", "y", {k: v for k, v in cols.items() if k != "label"})
    reg.save(str(tmp_path / "reg"))
    loaded = PipelineStage.load(str(tmp_path / "reg"))
    loaded.getFittedModel().setDevice("cpu")
    np.testing.assert_array_equal(loaded.transform(Table(test))["prediction"],
                                  reg.transform(Table(test))["prediction"])
