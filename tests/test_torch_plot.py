"""The port's plot helpers (``mmlspark_tpu_torch.plot``) against the JAX
package's, on the CPU: every case of ``tests/test_plot.py`` as a parity
case. Counts and ROC points are host numpy in both, so they are compared
bit for bit; the drawings are smoke-run headless on the Agg backend and
compared by their texts, images and lines.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

# the card's machine has no matplotlib: the drawings' tests skip there
matplotlib = pytest.importorskip("matplotlib")
matplotlib.use("Agg")

import matplotlib.pyplot as plt  # noqa: E402

from mmlspark_tpu_torch import plot  # noqa: E402
from mmlspark_tpu_torch.data.table import Table  # noqa: E402

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def ref():
    from mmlspark_tpu import plot as jplot
    from mmlspark_tpu.data.table import Table as JTable

    return dict(plot=jplot, Table=JTable)


@pytest.fixture(autouse=True)
def _close_figures():
    yield
    plt.close("all")


def _bits(got, want):
    for g, w in zip(got, want):
        g, w = np.asarray(g), np.asarray(w)
        assert g.dtype == w.dtype and g.tobytes() == w.tobytes()


def test_roc_points_matches_sklearn_and_the_reference(ref):
    from sklearn.metrics import roc_curve

    rng = np.random.default_rng(3)
    y = (rng.random(200) > 0.6).astype(np.int64)
    scores = np.clip(y * 0.4 + rng.random(200) * 0.6, 0, 1)
    fpr, tpr, thr = plot.roc_points(y, scores)
    _bits((fpr, tpr, thr), ref["plot"].roc_points(y, scores))
    fpr_sk, tpr_sk, thr_sk = roc_curve(y, scores, drop_intermediate=False)
    np.testing.assert_allclose(fpr, fpr_sk, atol=1e-12)
    np.testing.assert_allclose(tpr, tpr_sk, atol=1e-12)
    np.testing.assert_allclose(thr[1:], thr_sk[1:], atol=1e-12)


@pytest.mark.parametrize("case", ["ties", "empty", "one_class_positive", "one_row"])
def test_roc_points_edge_cases(ref, case):
    rng = np.random.default_rng(11)
    y, s = {
        "ties": (rng.integers(0, 2, 300), np.round(rng.random(300), 1)),
        "empty": (np.zeros(0), np.zeros(0)),
        "one_class_positive": (np.ones(7), rng.random(7)),
        "one_row": (np.ones(1), np.array([0.3])),
    }[case]
    _bits(plot.roc_points(y, s), ref["plot"].roc_points(y, s))


def test_roc_points_degenerate_single_class(ref):
    fpr, tpr, thr = plot.roc_points(np.zeros(5), np.linspace(0, 1, 5))
    _bits((fpr, tpr, thr), ref["plot"].roc_points(np.zeros(5), np.linspace(0, 1, 5)))
    assert np.all(tpr == 0.0)
    assert fpr[-1] == pytest.approx(1.0)


def test_confusion_matrix_counts_match_sklearn_and_the_reference(ref):
    from sklearn.metrics import confusion_matrix as sk_cm

    rng = np.random.default_rng(7)
    y = rng.integers(0, 3, size=120)
    y_hat = np.where(rng.random(120) < 0.7, y, rng.integers(0, 3, size=120))
    cm = plot._confusion_counts(np.asarray(y), np.asarray(y_hat), [0, 1, 2])
    np.testing.assert_array_equal(cm, sk_cm(y, y_hat, labels=[0, 1, 2]))
    _bits([cm], [ref["plot"]._confusion_counts(y, y_hat, [0, 1, 2])])


@pytest.mark.parametrize("labels", [[2, 0, 1], ["b", "a"], [1]])
def test_confusion_counts_drop_rows_outside_the_labels(ref, labels):
    rng = np.random.default_rng(8)
    pool = np.array(["a", "b", "c"]) if isinstance(labels[0], str) else np.arange(4)
    y, y_hat = rng.choice(pool, 90), rng.choice(pool, 90)
    _bits([plot._confusion_counts(y, y_hat, labels)],
          [ref["plot"]._confusion_counts(y, y_hat, labels)])


def _texts(ax):
    return [t.get_text() for t in ax.texts]


def test_confusion_matrix_renders_from_table(ref):
    cols = {"label": np.array([0.0, 0.0, 1.0, 1.0, 1.0]),
            "prediction": np.array([0.0, 1.0, 1.0, 1.0, 0.0])}
    ax = plot.confusion_matrix(Table(cols), "label", "prediction")
    assert len(ax.images) == 1
    texts = _texts(ax)
    assert any("Accuracy" in s for s in texts)
    assert {"1", "2"} <= set(texts)
    assert plot.confusionMatrix is plot.confusion_matrix
    plt.figure()
    jax_ = ref["plot"].confusion_matrix(ref["Table"](cols), "label", "prediction")
    assert texts == _texts(jax_)
    assert np.array_equal(ax.images[0].get_array(), jax_.images[0].get_array())


def test_roc_renders_and_binarizes_labels(ref):
    cols = {"label": np.array([0.1, 0.2, 0.9, 0.8]), "score": np.array([0.3, 0.1, 0.7, 0.9])}
    ax = plot.roc(Table(cols), "label", "score")
    (line,) = ax.lines
    xs, ys = line.get_data()
    assert xs[0] == 0.0 and ys[0] == 0.0
    assert xs[-1] == 1.0 and ys[-1] == 1.0
    assert 1.0 in ys[xs == 0.0]
    plt.figure()
    (jline,) = ref["plot"].roc(ref["Table"](cols), "label", "score").lines
    _bits(line.get_data(), jline.get_data())


def test_drawing_accepts_plain_mappings():
    ax = plot.roc({"y": np.array([0, 1, 1]), "s": np.array([0.2, 0.9, 0.4])}, "y", "s")
    assert len(ax.lines) == 1


def test_importing_plot_loads_no_matplotlib():
    code = ("import sys\nimport mmlspark_tpu_torch.plot\n"
            "assert 'matplotlib' not in sys.modules\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    subprocess.run([sys.executable, "-c", code], check=True, env=env, cwd=str(REPO),
                   timeout=120)
