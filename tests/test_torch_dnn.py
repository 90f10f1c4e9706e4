"""The port's deep-inference stack (``mmlspark_tpu_torch.dnn``,
``mmlspark_tpu_torch.models.resnet``) against the JAX package's, on the
CPU: every case of ``tests/test_dnn.py`` as a port case, with the same
seeded inputs through both packages.

Bit for bit: ``init_resnet``, DNNModel's padded batches and the outputs of
exact networks (a scale, a shift) through padding, single-feed, sharded
and tensor-parallel modes, the ``from_torch`` params dict. Within ``TOL``
of the largest magnitude: ResNet logits, pooled features and feature maps
(resnet18 and resnet50 with the small-input stem at 32x32, the ImageNet
stem at 64x64, whose strided convolutions pad asymmetrically), and
``from_torch`` outputs against the reference's and the module's own
forward. Float32 convolutions sum in each library's order: the gaps
measured 2.8e-7 to 1.5e-6 of the largest. Tests marked ``cuda`` need the
card.
"""

import os
import subprocess
import sys

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
from mmlspark_tpu_torch.dnn import DNNModel, from_torch
from mmlspark_tpu_torch.dnn.model import _stack_batch
from mmlspark_tpu_torch.models import ResNet, init_resnet, resnet_apply
from mmlspark_tpu_torch.parallel.mesh import MeshConfig, make_mesh

TOL = 1e-5  # float32 network outputs, of the largest magnitude
CARD_TOL = 1e-4  # the card's cuDNN float32 (TF32 off) against the CPU port


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
    from mmlspark_tpu import dnn as jdnn
    from mmlspark_tpu import models as jmodels
    from mmlspark_tpu.data.table import Table as JTable

    return dict(dnn=jdnn, models=jmodels, Table=JTable)


def _close(got, want, tol=TOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max()) / scale
    assert err <= tol, err


def _torch_cnn():
    import torch.nn as nn

    return nn.Sequential(
        nn.Conv2d(3, 8, 3, stride=1, padding=1),
        nn.BatchNorm2d(8),
        nn.ReLU(),
        nn.MaxPool2d(2),
        nn.Conv2d(8, 16, 3, stride=2, padding=1, groups=2),
        nn.ReLU(),
        nn.AdaptiveAvgPool2d((1, 1)),
        nn.Flatten(),
        nn.Linear(16, 5),
        nn.Softmax(dim=-1),
    )


def _residual_net():
    import torch.nn as nn
    import torch.nn.functional as F

    class Block(nn.Module):
        def __init__(self):
            super().__init__()
            self.conv1 = nn.Conv2d(4, 4, 3, padding=1)
            self.conv2 = nn.Conv2d(4, 4, 3, padding=1)
            self.fc = nn.Linear(4, 3)

        def forward(self, x):
            h = F.relu(self.conv1(x))
            h = self.conv2(h) + x  # residual add
            h = torch.flatten(F.adaptive_avg_pool2d(h, (1, 1)), 1)
            return self.fc(h)

    return Block()


def _seeded_bn(net, seed):
    """Running stats and affine of every BatchNorm drawn from a seed, so the
    eval-mode BatchNorm is not the identity."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.copy_(torch.randn(m.num_features, generator=g) * 0.1)
                m.running_var.copy_(torch.rand(m.num_features, generator=g) + 0.5)
                m.weight.copy_(torch.rand(m.num_features, generator=g) + 0.5)
                m.bias.copy_(torch.randn(m.num_features, generator=g) * 0.1)
    return net


def _import_case(ref, net, x):
    """``from_torch`` in both packages on one module: the params dicts are
    equal bit for bit, and each apply function takes the other's params."""
    fn, params = from_torch(net)
    jfn, jparams = ref["dnn"].from_torch(net)
    assert list(params) == list(jparams)
    for k in params:
        assert list(params[k]) == list(jparams[k])
        for p in params[k]:
            np.testing.assert_array_equal(params[k][p], jparams[k][p])
    got = fn(jparams, {"input": torch.from_numpy(x)})["output"].numpy()
    want = np.asarray(jfn(params, {"input": x})["output"])
    with torch.no_grad():
        own = net(torch.from_numpy(x)).numpy()
    return got, want, own


def test_torch_import_matches_torch(ref):
    torch.manual_seed(0)
    net = _seeded_bn(_torch_cnn(), 0).eval()
    x = np.random.default_rng(0).standard_normal((4, 3, 16, 16)).astype(np.float32)
    got, want, own = _import_case(ref, net, x)
    np.testing.assert_allclose(got, own, rtol=1e-4, atol=1e-5)
    _close(got, want)


def test_torch_import_residual(ref):
    torch.manual_seed(1)
    net = _residual_net().eval()
    x = np.random.default_rng(1).standard_normal((2, 4, 8, 8)).astype(np.float32)
    got, want, own = _import_case(ref, net, x)
    np.testing.assert_allclose(got, own, rtol=1e-4, atol=1e-5)
    _close(got, want)


def test_dnn_model_transform_batched(ref):
    torch.manual_seed(0)
    net = _torch_cnn().eval()
    fn, params = from_torch(net)
    n = 23  # deliberately not a multiple of batchSize: exercises padding
    images = np.random.default_rng(2).standard_normal((n, 3, 16, 16)).astype(np.float32)
    t = Table({"id": np.arange(n), "images": [img for img in images]})
    model = DNNModel(
        applyFn=fn,
        modelParams=params,
        feedDict={"input": "images"},
        fetchDict={"scores": "output"},
        batchSize=8,
        device="cpu",
    )
    out = model.transform(t)
    assert out["scores"].shape == (n, 5)
    with torch.no_grad():
        expected = net(torch.from_numpy(images)).numpy()
    np.testing.assert_allclose(out["scores"], expected, rtol=1e-4, atol=1e-5)
    jfn, jparams = ref["dnn"].from_torch(net)
    want = ref["dnn"].DNNModel(
        applyFn=jfn, modelParams=jparams, feedDict={"input": "images"},
        fetchDict={"scores": "output"}, batchSize=8,
    ).transform(ref["Table"]({"id": np.arange(n), "images": [img for img in images]}))
    _close(out["scores"], want["scores"])


def _exact_case(ref, **kw):
    """One exact network (x * 2 + 1, exact with or without a fused
    multiply-add) through both packages' DNNModel: the outputs must be equal
    bit for bit, whatever the batching."""
    n = kw.pop("n", 23)
    X = np.random.default_rng(9).standard_normal((n, 3)).astype(np.float64)
    port = DNNModel(applyFn=lambda p, i: {"output": i["x"] * p["a"] + p["b"]},
                    modelParams={"a": np.float32(2.0), "b": np.float32(1.0)},
                    feedDict={"x": "f"}, fetchDict={"y": "output"}, device="cpu", **kw)
    jkw = {k: v for k, v in kw.items() if k != "meshConfig"}
    jmodel = ref["dnn"].DNNModel(applyFn=lambda p, i: {"output": i["x"] * p["a"] + p["b"]},
                                 modelParams={"a": np.float32(2.0), "b": np.float32(1.0)},
                                 feedDict={"x": "f"}, fetchDict={"y": "output"}, **jkw)
    got = port.transform(Table({"f": X}))["y"]
    want = np.asarray(jmodel.transform(ref["Table"]({"f": X}))["y"])
    if kw.get("inputDtype") == "float64":
        # jax without x64 computes a float64 batch in float32; the port
        # keeps the float64 asked for (ROADMAP Queue 3)
        assert want.dtype == np.float32 and got.dtype == np.float64
        np.testing.assert_array_equal(got, X * 2.0 + 1.0)
        return got
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    return got


@pytest.mark.parametrize("kw", [
    dict(batchSize=8), dict(batchSize=5, n=5), dict(batchSize=64, n=3),
    dict(miniBatcher=False), dict(batchSize=4, inputDtype="float64"),
], ids=["pad-last", "exact-fit", "one-short-batch", "unbatched", "float64"])
def test_dnn_model_padding_bit_for_bit(ref, kw):
    from mmlspark_tpu.dnn.model import _stack_batch as j_stack

    col = np.random.default_rng(4).standard_normal((7, 3))
    for pad_to in (7, 8, 16):
        np.testing.assert_array_equal(_stack_batch(col, pad_to, np.float32),
                                      j_stack(col, pad_to, np.float32))
    _exact_case(ref, **kw)


def test_dnn_model_sharded(ref):
    fn = lambda params, inputs: {"output": inputs["x"] * params["scale"]}
    n = 40
    t = Table({"x": np.arange(n, dtype=np.float32)})
    mesh8 = make_mesh(MeshConfig(), devices=["cpu"] * 8)
    model = DNNModel(
        applyFn=fn,
        modelParams={"scale": np.float32(3.0)},
        feedDict={"x": "x"},
        fetchDict={"y": "output"},
        batchSize=16,
        shardOverMesh=True,
        meshConfig=mesh8,
        device="cpu",
    )
    out = model.transform(t)
    np.testing.assert_allclose(out["y"], np.arange(n) * 3.0)
    # the reference on its 8 virtual devices: the same values, bit for bit
    _exact_case(ref, batchSize=16, n=40, shardOverMesh=True, meshConfig=mesh8)


def test_dnn_model_tensor_parallel(ref):
    """paramShardings over a (data=2, model=2) mesh: each data slot gathers
    the weight's model blocks; the output equals the unsharded apply's, and
    the reference's validation errors are raised word for word."""
    rng = np.random.default_rng(5)
    w = rng.standard_normal((6, 4)).astype(np.float32)
    X = rng.standard_normal((10, 6)).astype(np.float32)
    fn = lambda p, i: {"output": i["x"] @ p["w"]}
    mesh = make_mesh(MeshConfig(data=2, model=2), devices=["cpu"] * 4)
    kw = dict(applyFn=fn, modelParams={"w": w}, feedDict={"x": "f"},
              fetchDict={"y": "output"}, batchSize=4, shardOverMesh=True)
    got = DNNModel(paramShardings={"w": 1}, meshConfig=mesh, device="cpu",
                   **kw).transform(Table({"f": X}))["y"]
    plain = DNNModel(applyFn=fn, modelParams={"w": w}, feedDict={"x": "f"},
                     fetchDict={"y": "output"}, batchSize=4,
                     device="cpu").transform(Table({"f": X}))["y"]
    np.testing.assert_array_equal(got, plain)
    for shardings, params in (({"v": 0}, {"w": w}), ({"w": 2}, {"w": w}),
                              ({"w": 0}, (w,))):
        errs = []
        for model in (
            DNNModel(**{**kw, "modelParams": params}, paramShardings=shardings,
                     meshConfig=mesh, device="cpu"),
            ref["dnn"].DNNModel(**{**kw, "modelParams": params}, paramShardings=shardings),
        ):
            with pytest.raises(ValueError) as e:
                model.transform(Table({"f": X}) if isinstance(model, DNNModel)
                                else ref["Table"]({"f": X}))
            errs.append(str(e.value))
        assert errs[0] == errs[1]


def test_dnn_model_single_io_convenience():
    fn = lambda params, inputs: inputs["input"] + 1.0
    model = (
        DNNModel(applyFn=fn, modelParams={}, batchSize=4, device="cpu")
        .setInputCol("x")
        .setOutputCol("y")
    )
    t = Table({"x": np.arange(6, dtype=np.float32)})
    out = model.transform(t)
    np.testing.assert_allclose(out["y"], np.arange(6) + 1.0)
    assert model.getInputCol() == "x" and model.getOutputCol() == "y"


def test_dnn_model_missing_feed(ref):
    model = DNNModel(applyFn=lambda p, i: i, modelParams={}, device="cpu")
    with pytest.raises(ValueError) as e:
        model.transform(Table({"x": np.arange(3.0)}))
    with pytest.raises(ValueError) as je:
        ref["dnn"].DNNModel(applyFn=lambda p, i: i, modelParams={}).transform(
            ref["Table"]({"x": np.arange(3.0)}))
    assert str(e.value) == str(je.value)


def test_dnn_model_runs_on_the_card_by_default():
    model = DNNModel(applyFn=lambda p, i: i, modelParams={}, feedDict={"x": "x"},
                     fetchDict={"y": "output"})
    assert model.getDevice() == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            model.transform(Table({"x": np.arange(3.0)}))


@pytest.fixture(scope="module")
def resnet_cases(ref):
    """ResNet forwards of both packages, computed once: (variant, small
    stem, input size) x cut 0, 1, 2, on 2 seeded images."""
    out = {}
    for variant, small, hw in (("resnet18", True, 32), ("resnet50", True, 32),
                               ("resnet18", False, 64)):
        params = init_resnet(seed=0, variant=variant, num_classes=7, small_inputs=small)
        x = np.random.default_rng(1).standard_normal((2, 3, hw, hw)).astype(np.float32)
        net = ResNet(params, device="cpu")
        for cut in (0, 1, 2):
            with torch.no_grad():
                got = resnet_apply(params, x, cut=cut).numpy()
                mod = net(torch.from_numpy(x), cut=cut).numpy()
            want = np.asarray(ref["models"].resnet_apply(params, x, cut=cut))
            out[(variant, small, cut)] = (got, mod, want)
    return out


@pytest.mark.parametrize("variant,small", [("resnet18", True), ("resnet50", True),
                                           ("resnet18", False)],
                         ids=["resnet18-small", "resnet50-small", "resnet18-imagenet-64"])
@pytest.mark.parametrize("cut", [0, 1, 2])
def test_resnet_matches_reference(resnet_cases, variant, small, cut):
    got, mod, want = resnet_cases[(variant, small, cut)]
    _close(got, want)
    # the module folds BatchNorm once, to the bits resnet_apply computes
    np.testing.assert_array_equal(mod, got)


def test_resnet_shapes_and_cut(resnet_cases):
    params = init_resnet(variant="resnet18", num_classes=7, small_inputs=True)
    x = np.random.default_rng(0).standard_normal((2, 3, 32, 32)).astype(np.float32)
    with torch.no_grad():
        logits = resnet_apply(params, x)
        assert logits.shape == (2, 7)
        feats = resnet_apply(params, x, cut=1)
        assert feats.shape == (2, 512)
        fmap = resnet_apply(params, x, cut=2)
        assert fmap.shape == (2, 512, 4, 4)
    assert resnet_cases[("resnet18", False, 2)][0].shape == (2, 512, 2, 2)


def test_resnet50_bottleneck(resnet_cases):
    params = init_resnet(variant="resnet50", num_classes=3, small_inputs=True)
    x = np.zeros((1, 3, 32, 32), np.float32)
    with torch.no_grad():
        feats = resnet_apply(params, x, cut=1)
    assert feats.shape == (1, 2048)
    assert resnet_cases[("resnet50", True, 1)][0].shape == (2, 2048)


def test_imagenet_stem_pads_like_jax():
    """jax's "SAME" at stride 2: the 7x7 stem pads 2 in front and 3 behind
    on an even size, a 3x3 conv on 56 pads 0 and 1, a 1x1 pads nothing."""
    from mmlspark_tpu_torch.models.resnet import same_pads

    assert same_pads(224, 7, 2) == (2, 3)
    assert same_pads(56, 3, 2) == (0, 1)
    assert same_pads(56, 1, 2) == (0, 0)
    assert same_pads(7, 3, 1) == (1, 1)


def test_resnet_bf16_when_asked(resnet_cases):
    params = init_resnet(variant="resnet18", num_classes=7, small_inputs=True)
    x = np.random.default_rng(1).standard_normal((2, 3, 32, 32)).astype(np.float32)
    with torch.no_grad():
        out = resnet_apply(params, x, cut=1, dtype=torch.bfloat16)
    assert out.dtype == torch.bfloat16
    want = resnet_cases[("resnet18", True, 1)][2]
    _close(out.float().numpy(), want, tol=5e-2)


def test_resnet_in_dnn_model(ref):
    params = init_resnet(variant="resnet18", num_classes=4, small_inputs=True)
    fn = lambda p, inputs: {"output": resnet_apply(p, inputs["input"])}
    images = np.random.default_rng(3).standard_normal((5, 3, 32, 32)).astype(np.float32)
    t = Table({"images": [im for im in images]})
    model = DNNModel(
        applyFn=fn,
        modelParams=params,
        feedDict={"input": "images"},
        fetchDict={"scores": "output"},
        batchSize=4,
        device="cpu",
    )
    out = model.transform(t)
    assert out["scores"].shape == (5, 4)
    assert np.isfinite(out["scores"]).all()
    jfn = lambda p, inputs: {"output": ref["models"].resnet_apply(p, inputs["input"])}
    want = ref["dnn"].DNNModel(applyFn=jfn, modelParams=params, feedDict={"input": "images"},
                               fetchDict={"scores": "output"}, batchSize=4).transform(
        ref["Table"]({"images": [im for im in images]}))
    _close(out["scores"], want["scores"])


def test_onnx_gate():
    from mmlspark_tpu_torch.dnn import onnx_import

    assert onnx_import.onnx_available()
    if not onnx_import.onnx_available():
        with pytest.raises(ImportError):
            onnx_import.from_onnx("/nonexistent/nope.onnx")


def test_carry_resnet_and_featurizer_from_jax(ref):
    from mmlspark_tpu.image import ImageFeaturizer as JFeaturizer

    from mmlspark_tpu_torch.image import ImageFeaturizer
    from mmlspark_tpu_torch.lightgbm.convert import dnn_model_from_jax, resnet_params_from_jax

    jp = ref["models"].init_resnet(seed=2, variant="resnet18", num_classes=5,
                                   small_inputs=True)
    tree, net = resnet_params_from_jax(jp, device="cpu")
    x = np.random.default_rng(6).standard_normal((2, 3, 32, 32)).astype(np.float32)
    with torch.no_grad():
        _close(net(torch.from_numpy(x)).numpy(), ref["models"].resnet_apply(jp, x))
    jf = JFeaturizer(modelParams=jp, inputHeight=32, inputWidth=32, cutOutputLayers=0,
                     batchSize=8)
    f = dnn_model_from_jax(jf, device="cpu")
    assert isinstance(f, ImageFeaturizer) and f.getCutOutputLayers() == 0
    assert f.getBatchSize() == 8 and f.getDevice() == "cpu"
    with pytest.raises(ValueError, match="cannot cross"):
        dnn_model_from_jax(ref["dnn"].DNNModel(applyFn=lambda p, i: i, modelParams={}))
    with pytest.raises(ValueError, match="cannot cross"):
        dnn_model_from_jax(JFeaturizer(modelParams=jp, applyFn=lambda p, x, c: x))


def test_deep_model_modules_import_neither_jax_nor_the_jax_package():
    code = (
        "import sys\n"
        "class _Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in ('jax', 'mmlspark_tpu', 'optax', 'onnx', 'PIL',"
        " 'cv2'):\n"
        "            raise ImportError('blocked: ' + name)\n"
        "sys.meta_path.insert(0, _Block())\n"
        "import mmlspark_tpu_torch.dnn, mmlspark_tpu_torch.dnn.onnx_proto\n"
        "import mmlspark_tpu_torch.image, mmlspark_tpu_torch.models\n"
        "import mmlspark_tpu_torch.downloader, mmlspark_tpu_torch.core.pytree\n"
        "import mmlspark_tpu_torch.ops.pipeline_parallel\n"
        "import mmlspark_tpu_torch.ops.expert_parallel\n"
        "import mmlspark_tpu_torch.lightgbm.convert\n"
        "print('ok')\n"
    )
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_resnet_is_held_on_the_card_by_default():
    """``ResNet(params)`` holds its tree on the card; without one it
    raises rather than build on the CPU."""
    params = init_resnet(seed=0, variant="resnet18", num_classes=3, small_inputs=True)
    if torch.cuda.is_available():
        net = ResNet(params)
        assert net.device.type == "cuda" and net.tree["fc"]["w"].device == net.device
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            ResNet(params)


def test_resnet_refuses_an_input_held_elsewhere():
    """The forward never moves its input to the weights' device: an input
    on another device raises, and ``on`` gives the network there (itself
    when it is held there already). ``DNNModel`` places a ResNet through
    ``on``, since ``Module.to`` does not move its plain-dict tree."""
    from mmlspark_tpu_torch.dnn.model import _place

    params = init_resnet(seed=0, variant="resnet18", num_classes=3, small_inputs=True)
    net = ResNet(params, device="cpu")
    with pytest.raises(ValueError, match="weights on cpu"):
        net(torch.zeros((1, 3, 8, 8), device="meta"))
    assert net.on("cpu") is net and _place(net, torch.device("cpu")) is net
    x = np.random.default_rng(4).standard_normal((2, 3, 16, 16)).astype(np.float32)
    with torch.no_grad():
        np.testing.assert_array_equal(net(x, cut=1).numpy(),
                                      net(torch.from_numpy(x), cut=1).numpy())


@pytest.mark.cuda
def test_resnet_and_resize_on_the_card_match_the_cpu_port():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from mmlspark_tpu_torch.image.transforms import resize_nhwc

    params = init_resnet(seed=0, variant="resnet50", num_classes=10, small_inputs=False)
    x = np.random.default_rng(2).standard_normal((4, 3, 64, 64)).astype(np.float32)
    from mmlspark_tpu_torch.device import float32_exact

    with torch.no_grad(), float32_exact():
        for cut in (0, 1, 2):
            card = ResNet(params, device="cuda")(torch.from_numpy(x).cuda(), cut=cut).cpu().numpy()
            cpu = ResNet(params, device="cpu")(torch.from_numpy(x), cut=cut).numpy()
            _close(card, cpu, tol=CARD_TOL)
        img = torch.from_numpy(
            np.random.default_rng(3).uniform(0, 255, (3, 40, 50, 3)).astype(np.float32))
        for method in ("nearest", "linear", "cubic", "lanczos3", "lanczos5"):
            card = resize_nhwc(img.cuda(), 24, 70, method).cpu().numpy()
            _close(card, resize_nhwc(img, 24, 70, method).numpy(), tol=CARD_TOL)
