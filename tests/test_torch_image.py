"""The port's image pipeline (``mmlspark_tpu_torch.image``) against the JAX
package's, on the CPU: every case of ``tests/test_image.py`` as a port
case, every resize method and every ``ImageTransformer`` op on the same
seeded images through both packages.

Bit for bit: nearest indices, crops, flips, channel swaps, thresholds,
gray (the reference's compiled fused multiply-add chain over B, G, R),
unroll/roll, augmentation. The resize weight matrices (read off the
reference by resizing an identity) within ``WEIGHT_TOL``: its jitted
program fuses the weights' float32 arithmetic and sums, and parts from the
port's numpy float32 by up to 6e-8 on small images and 1.0e-5 at 320 ->
224, where a float32 sample position near 320 carries an ulp of 3e-5.
Float results within ``TOL`` of the largest magnitude (einsum and
depthwise-convolution sums in each library's order). uint8 results equal, except where the float result lies
within ``TOL`` of the largest magnitude of a .5 rounding boundary.
ImageFeaturizer features within ``TOL``. Tests marked ``cuda`` need the
card and hold it within ``CARD_TOL`` of the CPU port.

The reference's ``io/files.py`` (``read_images``, ``read_binary_files``)
is not ported yet (ROADMAP Queue 1 item 7): their two cases read through
the reference and hold the port's pipeline on what it read.
"""

import numpy as np
import pytest
import torch


def _import_reference():
    """Import the JAX package through the u_histogram shim (see
    ``tests/test_torch_gbdt.py``). The JAX package itself is not changed."""
    from jax._src.lax import lax as lax_internal
    from jax.interpreters import batching

    saved = batching.primitive_batchers
    batching.primitive_batchers = {lax_internal.optimization_barrier_p: None}
    try:
        import mmlspark_tpu.ops.u_histogram  # noqa: F401
    finally:
        batching.primitive_batchers = saved


try:
    _import_reference()
except ModuleNotFoundError as err:
    if err.name != "jax":
        raise

from mmlspark_tpu_torch.data.table import Table
from mmlspark_tpu_torch.image import (
    ImageFeaturizer,
    ImageSetAugmenter,
    ImageTransformer,
    UnrollImage,
    roll_image,
    unroll_image,
)
from mmlspark_tpu_torch.image.transforms import nearest_indices, resize_weights

TOL = 1e-5  # float images and features, of the largest magnitude
WEIGHT_TOL = 2e-5  # resize weights against the reference's compiled ones, absolute
CARD_TOL = 1e-4  # the card's cuDNN float32 (TF32 off) against the CPU port

METHODS = ("nearest", "linear", "bilinear", "triangle", "cubic", "bicubic", "lanczos3",
           "lanczos5")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """torch on one thread for this file (the full run's 6 workers share
    the cores; default thread pools oversubscribe them)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def ref():
    from mmlspark_tpu import image as jimage
    from mmlspark_tpu.data.table import Table as JTable

    return dict(image=jimage, Table=JTable)


@pytest.fixture()
def image_table(rng):
    images = np.empty(3, dtype=object)
    for i in range(3):
        images[i] = rng.integers(0, 256, size=(20, 24, 3), dtype=np.uint8)
    return Table({"id": np.arange(3), "image": images})


def _objects(arrays):
    col = np.empty(len(arrays), dtype=object)
    for i, a in enumerate(arrays):
        col[i] = a
    return col


def _both(ref, images, stages, to_float, col="image"):
    """One stage list through both packages' ImageTransformer."""
    port = ImageTransformer(inputCol=col, outputCol="out", stages=stages, toFloat=to_float,
                            device="cpu").transform(Table({col: _objects(images)}))["out"]
    want = ref["image"].ImageTransformer(
        inputCol=col, outputCol="out", stages=stages, toFloat=to_float,
    ).transform(ref["Table"]({col: _objects(images)}))["out"]
    return list(port), [np.asarray(w) for w in want]


def _assert_float_close(got, want):
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype == np.float32
        scale = max(float(np.abs(w).max()), 1e-30)
        assert float(np.abs(g - w).max()) <= TOL * scale


def _assert_uint8_equal(got, want, floats):
    """uint8 images equal, but where the float result sits within ``TOL``
    of the largest magnitude of a .5 boundary (rint may go either way)."""
    for g, w, f in zip(got, want, floats):
        assert g.shape == w.shape and g.dtype == w.dtype == np.uint8
        diff = g != w
        if diff.any():
            tol = TOL * max(float(np.abs(f).max()), 1.0)
            near = np.abs(np.abs(f - np.floor(f)) - 0.5) <= tol
            assert (near[diff] & (np.abs(g.astype(int) - w.astype(int))[diff] == 1)).all()


def _stage_case(ref, images, stages):
    got_f, want_f = _both(ref, images, stages, True)
    _assert_float_close(got_f, want_f)
    got, want = _both(ref, images, stages, False)
    _assert_uint8_equal(got, want, want_f)


def test_resize_crop(image_table, ref):
    t = (
        ImageTransformer(inputCol="image", outputCol="out", device="cpu")
        .resize(10, 12)
        .crop(2, 1, 8, 8)
        .transform(image_table)
    )
    assert t["out"][0].shape == (8, 8, 3)
    assert t["out"][0].dtype == np.uint8
    _stage_case(ref, list(image_table["image"]),
                [{"op": "ResizeImage", "height": 10, "width": 12},
                 {"op": "CropImage", "x": 2, "y": 1, "height": 8, "width": 8}])


def test_flip_matches_numpy(image_table, ref):
    out = (
        ImageTransformer(inputCol="image", outputCol="out", device="cpu")
        .flip(1)
        .transform(image_table)
    )
    np.testing.assert_array_equal(out["out"][0], image_table["image"][0][:, ::-1, :])
    out = (
        ImageTransformer(inputCol="image", outputCol="out", device="cpu")
        .flip(0)
        .transform(image_table)
    )
    np.testing.assert_array_equal(out["out"][0], image_table["image"][0][::-1, :, :])
    for code in (0, 1, -1):
        got, want = _both(ref, list(image_table["image"]), [{"op": "Flip", "flipCode": code}],
                          False)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


def test_gray_threshold(image_table, ref):
    out = (
        ImageTransformer(inputCol="image", outputCol="out", device="cpu")
        .color_format("gray")
        .threshold(127.0)
        .transform(image_table)
    )
    img = out["out"][0]
    assert img.shape == (20, 24, 1)
    assert set(np.unique(img)) <= {0, 255}
    # gray adds B, G, R in the reference's order: its float bits
    for stages in ([{"op": "ColorFormat", "format": "gray"}],
                   [{"op": "ColorFormat", "format": "bgr2rgb"}],
                   [{"op": "ColorFormat", "format": "gray"},
                    {"op": "Threshold", "threshold": 127.0}]):
        for to_float in (True, False):
            got, want = _both(ref, list(image_table["image"]), stages, to_float)
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g, w)


def test_blur_constant_image(ref):
    images = np.empty(1, dtype=object)
    images[0] = np.full((8, 8, 3), 100, dtype=np.uint8)
    t = Table({"image": images})
    out = (
        ImageTransformer(inputCol="image", outputCol="out", device="cpu")
        .blur(3, 3)
        .transform(t)
    )
    # Box blur of a constant image keeps the interior constant.
    np.testing.assert_array_equal(out["out"][0][2:-2, 2:-2], 100)


@pytest.mark.parametrize("kh,kw", [(3, 3), (2, 2), (4, 3), (1, 6)])
def test_blur_matches_reference(ref, kh, kw):
    """Odd and even box kernels: an even one pads "SAME" with the odd cell
    behind, as jax does."""
    rng = np.random.default_rng(kh * 10 + kw)
    images = [rng.integers(0, 256, size=(11, 14, 3), dtype=np.uint8) for _ in range(2)]
    _stage_case(ref, images, [{"op": "Blur", "height": kh, "width": kw}])


def test_gaussian_kernel_smooths(ref):
    images = np.empty(1, dtype=object)
    img = np.zeros((9, 9, 1), dtype=np.uint8)
    img[4, 4, 0] = 255
    images[0] = img
    t = Table({"image": images})
    out = (
        ImageTransformer(inputCol="image", outputCol="out", toFloat=True, device="cpu")
        .gaussian_kernel(5, 1.0)
        .transform(t)
    )
    res = out["out"][0][..., 0]
    assert res[4, 4] == res.max() and res[4, 4] < 255
    assert res[2, 4] > 0
    rng = np.random.default_rng(5)
    noisy = [rng.integers(0, 256, size=(12, 10, 3), dtype=np.uint8) for _ in range(2)]
    for size, sigma in ((5, 1.0), (4, 0.0), (3, 0.0)):
        _stage_case(ref, noisy, [{"op": "GaussianKernel", "apertureSize": size,
                                  "sigma": sigma}])


def test_normalize_and_chains_match_reference(ref):
    rng = np.random.default_rng(8)
    images = [rng.integers(0, 256, size=(16, 18, 3), dtype=np.uint8) for _ in range(3)]
    got, want = _both(ref, images, [{"op": "Normalize", "mean": [0.485, 0.456, 0.406],
                                     "std": [0.229, 0.224, 0.225], "scale": 1 / 255.0}], True)
    _assert_float_close(got, want)
    _stage_case(ref, images, [{"op": "ResizeImage", "height": 9, "width": 25,
                               "method": "cubic"},
                              {"op": "Flip", "flipCode": -1},
                              {"op": "GaussianKernel", "apertureSize": 3},
                              {"op": "ColorFormat", "format": "gray"}])


@pytest.mark.parametrize("method", METHODS)
def test_resize_every_method_matches_reference(ref, method):
    """Downsampling (antialiased), upsampling and one unchanged dimension,
    on uint8 and on float images; the weights are jax's bit for bit."""
    rng = np.random.default_rng(len(method))
    for in_hw, out_hw in (((20, 24), (7, 11)), ((9, 6), (16, 13)), ((12, 15), (12, 5))):
        images = [rng.integers(0, 256, size=in_hw + (3,), dtype=np.uint8) for _ in range(2)]
        _stage_case(ref, images, [{"op": "ResizeImage", "height": out_hw[0],
                                   "width": out_hw[1], "method": method}])
    import jax.numpy as jnp
    from jax import image as jax_image

    for n_in, n_out in ((20, 7), (9, 16), (224, 256), (256, 224), (320, 224)):
        eye = jnp.eye(n_in, dtype=jnp.float32)
        # the weights the reference's jitted resize applies (resizing an
        # identity reads them off exactly)
        want = np.asarray(jax_image.resize(eye, (n_out, n_in), method=method))
        if method == "nearest":
            np.testing.assert_array_equal(np.eye(n_in, dtype=np.float32)[
                nearest_indices(n_in, n_out)], want)
            continue
        assert float(np.abs(resize_weights(n_in, n_out, method).T - want).max()) <= WEIGHT_TOL


def test_resize_unknown_method_raises(ref):
    with pytest.raises(ValueError, match="Unknown resize method"):
        ImageTransformer(inputCol="image", outputCol="out", device="cpu",
                         stages=[{"op": "ResizeImage", "height": 2, "width": 2,
                                  "method": "bogus"}]).transform(
            Table({"image": _objects([np.zeros((4, 4, 3), np.uint8)])}))


def test_mixed_shapes_grouped(rng, ref):
    images = np.empty(4, dtype=object)
    images[0] = rng.integers(0, 255, (16, 16, 3), dtype=np.uint8)
    images[1] = rng.integers(0, 255, (20, 10, 3), dtype=np.uint8)
    images[2] = rng.integers(0, 255, (16, 16, 3), dtype=np.uint8)
    images[3] = rng.integers(0, 255, (20, 10, 3), dtype=np.uint8)
    t = Table({"image": images})
    out = ImageTransformer(inputCol="image", outputCol="out",
                           device="cpu").resize(8, 8).transform(t)
    assert all(im.shape == (8, 8, 3) for im in out["out"])
    gray = [rng.integers(0, 255, (10 + i % 2, 12), dtype=np.uint8) for i in range(4)]
    _stage_case(ref, list(images), [{"op": "ResizeImage", "height": 8, "width": 8}])
    _stage_case(ref, gray, [{"op": "ResizeImage", "height": 8, "width": 8}])
    got, _ = _both(ref, gray, [{"op": "ResizeImage", "height": 8, "width": 8}], False)
    assert all(g.shape == (8, 8) for g in got)


def test_augmenter(image_table, ref):
    out = ImageSetAugmenter(inputCol="image", outputCol="image",
                            device="cpu").transform(image_table)
    assert out.num_rows == 6
    np.testing.assert_array_equal(out["image"][3], image_table["image"][0][:, ::-1, :])
    both = ImageSetAugmenter(inputCol="image", outputCol="aug", flipUpDown=True,
                             device="cpu").transform(image_table)
    jt = ref["Table"]({"id": np.arange(3), "image": image_table["image"]})
    want = ref["image"].ImageSetAugmenter(inputCol="image", outputCol="aug",
                                          flipUpDown=True).transform(jt)
    assert both.num_rows == want.num_rows == 9
    for g, w in zip(both["aug"], want["aug"]):
        np.testing.assert_array_equal(g, np.asarray(w))


def test_unroll_roll_roundtrip(image_table, ref):
    out = UnrollImage(inputCol="image", outputCol="vec").transform(image_table)
    vec = out["vec"]
    assert vec.shape == (3, 20 * 24 * 3)
    rolled = roll_image(vec[0], 20, 24, 3)
    np.testing.assert_array_equal(rolled, image_table["image"][0].astype(np.float64))
    # Single-image helper agrees with the column path.
    np.testing.assert_array_equal(unroll_image(image_table["image"][0]), vec[0])
    jt = ref["Table"]({"image": image_table["image"]})
    np.testing.assert_array_equal(
        vec, ref["image"].UnrollImage(inputCol="image", outputCol="vec").transform(jt)["vec"])


def test_image_featurizer(image_table, ref):
    from mmlspark_tpu_torch.models import init_resnet

    params = init_resnet(variant="resnet18", num_classes=6, small_inputs=True)
    feat = ImageFeaturizer(
        inputCol="image",
        outputCol="features",
        modelParams=params,
        inputHeight=32,
        inputWidth=32,
        batchSize=4,
        device="cpu",
    )
    out = feat.transform(image_table)
    assert out["features"].shape == (3, 512)
    assert np.isfinite(out["features"]).all()
    assert "__resized__" not in out.columns
    # Headful: cut=0 emits class scores.
    logits = feat.copy({"cutOutputLayers": 0}).transform(image_table)
    assert logits["features"].shape == (3, 6)
    jt = ref["Table"]({"id": np.arange(3), "image": image_table["image"]})
    jfeat = ref["image"].ImageFeaturizer(inputCol="image", outputCol="features",
                                         modelParams=params, inputHeight=32, inputWidth=32,
                                         batchSize=4)
    for got, cut in ((out, 1), (logits, 0)):
        want = np.asarray(jfeat.copy({"cutOutputLayers": cut}).transform(jt)["features"])
        scale = float(np.abs(want).max())
        assert float(np.abs(got["features"] - want).max()) <= TOL * scale


@pytest.mark.cuda
def test_featurizer_on_the_card_rebuilds_a_cpu_resnet(image_table, monkeypatch):
    """A ``ResNet`` built on the CPU and handed to a featurizer on the card
    runs on the card (its tree rebuilt there once), not on the CPU: every
    backbone forward sees card tensors, and the features hold the CPU
    port's within ``CARD_TOL``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from mmlspark_tpu_torch.models import ResNet, init_resnet
    from mmlspark_tpu_torch.models import resnet as tresnet

    net = ResNet(init_resnet(variant="resnet18", num_classes=6, small_inputs=True), device="cpu")
    seen = []
    forward = tresnet._forward

    def recorded(params, x, *a):
        seen.append((x.device.type, params["fc"]["w"].device.type))
        return forward(params, x, *a)

    monkeypatch.setattr(tresnet, "_forward", recorded)
    feat = ImageFeaturizer(inputCol="image", outputCol="features", modelParams=net,
                           inputHeight=32, inputWidth=32, batchSize=4, device="cuda")
    card = feat.transform(image_table)["features"]
    assert seen and set(seen) == {("cuda", "cuda")}
    assert net.device.type == "cpu"  # the caller's network is left where it was
    cpu = feat.copy({"device": "cpu"}).transform(image_table)["features"]
    scale = float(np.abs(cpu).max())
    assert float(np.abs(np.asarray(card) - np.asarray(cpu)).max()) <= CARD_TOL * scale


def test_read_images(tmp_path, rng, ref):
    from PIL import Image

    from mmlspark_tpu.io import read_images

    for i in range(3):
        arr = rng.integers(0, 255, (10, 12, 3), dtype=np.uint8)
        Image.fromarray(arr).save(tmp_path / f"img_{i}.png")
    (tmp_path / "notes.txt").write_text("not an image")
    imgs = read_images(str(tmp_path), pattern="*.png")
    assert imgs.num_rows == 3 and imgs["image"][0].shape == (10, 12, 3)
    # the decoded images through the port's pipeline, as the reference's
    table = Table({"path": np.asarray(imgs["path"]), "image": imgs["image"]})
    stages = [{"op": "ResizeImage", "height": 6, "width": 7}, {"op": "Flip", "flipCode": 1}]
    got = ImageTransformer(inputCol="image", outputCol="out", stages=stages,
                           toFloat=True, device="cpu").transform(table)["out"]
    want = ref["image"].ImageTransformer(inputCol="image", outputCol="out", stages=stages,
                                         toFloat=True).transform(imgs)["out"]
    _assert_float_close(list(got), [np.asarray(w) for w in want])


def test_read_zip(tmp_path, ref):
    import zipfile

    with zipfile.ZipFile(tmp_path / "archive.zip", "w") as zf:
        zf.writestr("a.txt", "alpha")
        zf.writestr("sub/b.txt", "beta")
    from mmlspark_tpu.io import read_binary_files

    t = read_binary_files(str(tmp_path))
    assert t.num_rows == 2
    # the rows the reference read hold in a port Table as they are
    port = Table({"path": np.asarray(t["path"]), "bytes": t["bytes"]})
    assert any(p.endswith("!a.txt") for p in port["path"])
    assert b"beta" in list(port["bytes"])
    assert list(port["bytes"]) == list(t["bytes"])
