"""The port's ONNX import (``mmlspark_tpu_torch.dnn.onnx_import``, with its
copy of the vendored protobuf codec) against the JAX package's, on the
CPU: every case of ``tests/test_onnx_import.py`` as a port case, the same
encoded models through both packages.

Bit for bit: the codec (each package decodes the other's encoding to the
same graph, and encodes the same bytes), the params dict, shapes, errors
(op name, output count, ``auto_pad``). Within ``TOL`` of the largest
magnitude: model outputs against the reference's and against torch's own
forward with the same weights (float32 sums in each library's order).
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
from mmlspark_tpu_torch.dnn import DNNModel
from mmlspark_tpu_torch.dnn.onnx_import import from_onnx
from mmlspark_tpu_torch.dnn.onnx_proto import (
    decode_model,
    decode_tensor,
    encode_model,
    encode_node,
    encode_tensor,
)

TOL = 1e-5  # float32 outputs, of the largest magnitude


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
    from mmlspark_tpu.data.table import Table as JTable
    from mmlspark_tpu.dnn import DNNModel as JDNNModel
    from mmlspark_tpu.dnn import onnx_import as jimport
    from mmlspark_tpu.dnn import onnx_proto as jproto

    return dict(from_onnx=jimport.from_onnx, proto=jproto, DNNModel=JDNNModel, Table=JTable)


def _close(got, want, tol=TOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    assert float(np.abs(got - want).max()) <= tol * scale


def _run_both(ref, buf, inputs):
    """One encoded model through both packages: the port's outputs (numpy)
    and the reference's, output by output."""
    fn, params = from_onnx(buf)
    jfn, jparams = ref["from_onnx"](buf)
    assert list(params) == list(jparams)
    for k in params:
        np.testing.assert_array_equal(params[k], jparams[k])
    got = fn(params, {k: torch.from_numpy(v) for k, v in inputs.items()})
    want = jfn(jparams, inputs)
    assert list(got) == list(want)
    return {k: got[k].numpy() for k in got}, {k: np.asarray(want[k]) for k in want}


class TestProtoCodec:
    def test_tensor_roundtrip(self, ref):
        for arr in (
            np.arange(12, dtype=np.float32).reshape(3, 4),
            np.array([1, -2, 3], dtype=np.int64),
            np.float32(2.5).reshape(()),
        ):
            buf = encode_tensor("w", np.atleast_1d(arr))
            assert buf == ref["proto"].encode_tensor("w", np.atleast_1d(arr))
            name, back = decode_tensor(buf)
            assert name == "w"
            np.testing.assert_array_equal(back, np.atleast_1d(arr))

    def test_model_roundtrip(self, ref):
        w = np.random.default_rng(0).normal(size=(4, 3)).astype(np.float32)
        node = encode_node("MatMul", ["x", "w"], ["y"])
        buf = encode_model([node], {"w": w}, ["x", "w"], ["y"], opset=13)
        assert buf == ref["proto"].encode_model([node], {"w": w}, ["x", "w"], ["y"], opset=13)
        model = decode_model(buf)
        assert model["opset"] == 13
        g = model["graph"]
        assert g["nodes"][0]["op_type"] == "MatMul"
        assert g["nodes"][0]["input"] == ["x", "w"]
        np.testing.assert_array_equal(g["initializers"]["w"], w)
        assert g["outputs"] == ["y"]

    def test_attributes_roundtrip(self, ref):
        node_buf = encode_node(
            "Conv", ["x", "w"], ["y"],
            attrs={"strides": [2, 2], "pads": [1, 1, 1, 1], "alpha": 0.5},
        )
        buf = encode_model([node_buf], {}, ["x"], ["y"])
        node = decode_model(buf)["graph"]["nodes"][0]
        assert node["attrs"]["strides"] == [2, 2]
        assert node["attrs"]["pads"] == [1, 1, 1, 1]
        assert abs(node["attrs"]["alpha"] - 0.5) < 1e-7
        assert node == ref["proto"].decode_model(buf)["graph"]["nodes"][0]


def _mlp_onnx_and_torch(seed=0):
    import torch.nn as nn

    rng = np.random.default_rng(seed)
    w1 = rng.normal(size=(16, 10)).astype(np.float32) * 0.3
    b1 = rng.normal(size=16).astype(np.float32)
    w2 = rng.normal(size=(4, 16)).astype(np.float32) * 0.3
    b2 = rng.normal(size=4).astype(np.float32)

    nodes = [
        encode_node("Gemm", ["x", "w1", "b1"], ["h"], attrs={"transB": 1}),
        encode_node("Relu", ["h"], ["hr"]),
        encode_node("Gemm", ["hr", "w2", "b2"], ["logits"], attrs={"transB": 1}),
        encode_node("Softmax", ["logits"], ["probs"], attrs={"axis": -1}),
    ]
    buf = encode_model(
        nodes, {"w1": w1, "b1": b1, "w2": w2, "b2": b2}, ["x"], ["probs"]
    )

    tm = nn.Sequential(nn.Linear(10, 16), nn.ReLU(), nn.Linear(16, 4), nn.Softmax(-1))
    with torch.no_grad():
        tm[0].weight.copy_(torch.from_numpy(w1))
        tm[0].bias.copy_(torch.from_numpy(b1))
        tm[2].weight.copy_(torch.from_numpy(w2))
        tm[2].bias.copy_(torch.from_numpy(b2))
    return buf, tm.eval()


def _cnn_onnx_and_torch(seed=1, conv_attrs=None, pool_attrs=None):
    import torch.nn as nn

    rng = np.random.default_rng(seed)
    wc = rng.normal(size=(6, 3, 3, 3)).astype(np.float32) * 0.2
    bc = rng.normal(size=6).astype(np.float32)
    scale = rng.random(6).astype(np.float32) + 0.5
    bias = rng.normal(size=6).astype(np.float32)
    mean = rng.normal(size=6).astype(np.float32) * 0.1
    var = rng.random(6).astype(np.float32) + 0.5
    wl = rng.normal(size=(5, 6 * 8 * 8)).astype(np.float32) * 0.1
    bl = rng.normal(size=5).astype(np.float32)

    nodes = [
        encode_node(
            "Conv", ["x", "wc", "bc"], ["c"],
            attrs=conv_attrs or {"pads": [1, 1, 1, 1], "strides": [1, 1],
                                 "kernel_shape": [3, 3]},
        ),
        encode_node(
            "BatchNormalization",
            ["c", "scale", "bias", "mean", "var"], ["bn"],
            attrs={"epsilon": 1e-5},
        ),
        encode_node("Relu", ["bn"], ["r"]),
        encode_node(
            "MaxPool", ["r"], ["p"],
            attrs=pool_attrs or {"kernel_shape": [2, 2], "strides": [2, 2]},
        ),
        encode_node("Flatten", ["p"], ["fl"], attrs={"axis": 1}),
        encode_node("Gemm", ["fl", "wl", "bl"], ["y"], attrs={"transB": 1}),
    ]
    inits = {
        "wc": wc, "bc": bc, "scale": scale, "bias": bias,
        "mean": mean, "var": var, "wl": wl, "bl": bl,
    }
    buf = encode_model(nodes, inits, ["x"], ["y"])

    tm = nn.Sequential(
        nn.Conv2d(3, 6, 3, padding=1),
        nn.BatchNorm2d(6),
        nn.ReLU(),
        nn.MaxPool2d(2),
        nn.Flatten(),
        nn.Linear(6 * 8 * 8, 5),
    )
    with torch.no_grad():
        tm[0].weight.copy_(torch.from_numpy(wc))
        tm[0].bias.copy_(torch.from_numpy(bc))
        tm[1].weight.copy_(torch.from_numpy(scale))
        tm[1].bias.copy_(torch.from_numpy(bias))
        tm[1].running_mean.copy_(torch.from_numpy(mean))
        tm[1].running_var.copy_(torch.from_numpy(var))
        tm[5].weight.copy_(torch.from_numpy(wl))
        tm[5].bias.copy_(torch.from_numpy(bl))
    return buf, tm.eval()


class TestFromOnnx:
    def test_mlp_matches_torch(self, ref):
        buf, tm = _mlp_onnx_and_torch()
        x = np.random.default_rng(2).normal(size=(7, 10)).astype(np.float32)
        ours, want = _run_both(ref, buf, {"x": x})
        with torch.no_grad():
            theirs = tm(torch.from_numpy(x)).numpy()
        np.testing.assert_allclose(ours["probs"], theirs, rtol=1e-4, atol=1e-5)
        _close(ours["probs"], want["probs"])

    def test_cnn_matches_torch(self, ref):
        buf, tm = _cnn_onnx_and_torch()
        x = np.random.default_rng(3).normal(size=(2, 3, 16, 16)).astype(np.float32)
        ours, want = _run_both(ref, buf, {"x": x})
        with torch.no_grad():
            theirs = tm(torch.from_numpy(x)).numpy()
        np.testing.assert_allclose(ours["y"], theirs, rtol=1e-3, atol=1e-4)
        _close(ours["y"], want["y"])

    @pytest.mark.parametrize("conv_attrs,pool_attrs", [
        ({"auto_pad": "SAME_UPPER", "kernel_shape": [3, 3]}, None),
        ({"pads": [0, 1, 2, 1], "kernel_shape": [3, 3]},
         {"kernel_shape": [2, 2], "strides": [2, 2], "pads": [1, 0, 0, 1]}),
        ({"auto_pad": "VALID", "kernel_shape": [3, 3]},
         {"kernel_shape": [3, 3], "strides": [2, 2], "auto_pad": "VALID"}),
    ], ids=["same-upper", "asymmetric-pads", "valid"])
    def test_padding_forms_match_reference(self, ref, conv_attrs, pool_attrs):
        buf, _ = _cnn_onnx_and_torch(conv_attrs=conv_attrs, pool_attrs=pool_attrs)
        # the final Gemm wants 6 x 8 x 8; read the pooled map's size instead
        dec = decode_model(buf)
        nodes = [n for n in dec["graph"]["nodes"]][:5]
        x = np.random.default_rng(4).normal(size=(2, 3, 16, 16)).astype(np.float32)
        enc = [encode_node(n["op_type"], n["input"], n["output"], attrs=n["attrs"])
               for n in nodes]
        inits = {k: v for k, v in dec["graph"]["initializers"].items() if k not in ("wl", "bl")}
        sub = encode_model(enc, inits, ["x"], ["fl"])
        ours, want = _run_both(ref, sub, {"x": x})
        _close(ours["fl"], want["fl"])

    def test_same_lower_and_same_pool_refused(self, ref):
        for attrs in ({"auto_pad": "SAME_LOWER", "kernel_shape": [3, 3]},):
            buf = encode_model([encode_node("Conv", ["x", "w"], ["y"], attrs=attrs)],
                               {"w": np.ones((1, 1, 3, 3), np.float32)}, ["x"], ["y"])
            errs = []
            for fn_params in (from_onnx(buf), ref["from_onnx"](buf)):
                fn, params = fn_params
                with pytest.raises(ValueError) as e:
                    fn(params, {"x": np.zeros((1, 1, 4, 4), np.float32)})
                errs.append(str(e.value))
            assert errs[0] == errs[1]
        buf = encode_model([encode_node("AveragePool", ["x"], ["y"], attrs={
            "kernel_shape": [2, 2], "auto_pad": "SAME_UPPER"})], {}, ["x"], ["y"])
        with pytest.raises(ValueError, match="SAME pooling unsupported"):
            from_onnx(buf)[0]({}, {"x": torch.zeros((1, 1, 4, 4))})

    def test_op_table_matches_reference(self, ref):
        """Every lowered op the tests above do not reach, on seeded inputs."""
        rng = np.random.default_rng(11)
        a = rng.normal(size=(2, 3, 4, 5)).astype(np.float32)
        b = (rng.random(size=(2, 3, 4, 5)).astype(np.float32) + 0.5)
        cases = [
            ("Add", ["a", "b"], {}), ("Sub", ["a", "b"], {}), ("Mul", ["a", "b"], {}),
            ("Div", ["a", "b"], {}), ("Pow", ["b", "b"], {}), ("Sqrt", ["b"], {}),
            ("Exp", ["a"], {}), ("Neg", ["a"], {}), ("LeakyRelu", ["a"], {"alpha": 0.2}),
            ("Sigmoid", ["a"], {}), ("Tanh", ["a"], {}), ("Erf", ["a"], {}),
            ("Softmax", ["a"], {"axis": 1}), ("LogSoftmax", ["a"], {"axis": -1}),
            ("GlobalAveragePool", ["a"], {}), ("Transpose", ["a"], {"perm": [0, 2, 1, 3]}),
            ("Transpose", ["a"], {}), ("Concat", ["a", "b"], {"axis": 1}),
            ("Identity", ["a"], {}), ("Dropout", ["a"], {}),
            ("ReduceMean", ["a"], {"axes": [2, 3], "keepdims": 0}),
            ("ReduceMean", ["a"], {"axes": [1]}), ("Clip", ["a"], {"min": -0.5, "max": 0.5}),
            ("AveragePool", ["b"], {"kernel_shape": [2, 2], "strides": [1, 2],
                                    "pads": [1, 1, 0, 1]}),
            ("AveragePool", ["b"], {"kernel_shape": [2, 2], "pads": [1, 1, 1, 1],
                                    "count_include_pad": 1}),
            ("MaxPool", ["a"], {"kernel_shape": [3, 2], "strides": [2, 1],
                                "pads": [1, 0, 1, 1]}),
            ("Flatten", ["a"], {"axis": 2}), ("Squeeze", ["c"], {"axes": [1]}),
            ("Unsqueeze", ["a"], {"axes": [0, -1]}),
        ]
        c = a[:, :1]
        for op, ins, attrs in cases:
            buf = encode_model([encode_node(op, ins, ["y"], attrs=attrs)], {}, ins, ["y"])
            feeds = {k: {"a": a, "b": b, "c": c}[k] for k in ins}
            ours, want = _run_both(ref, buf, feeds)
            _close(ours["y"], want["y"])
        # opset 11's Softmax normalises over every dim from the axis on
        buf = encode_model([encode_node("Softmax", ["a"], ["y"], attrs={"axis": 1})], {},
                           ["a"], ["y"], opset=11)
        ours, want = _run_both(ref, buf, {"a": a})
        _close(ours["y"], want["y"])
        # shapes and indices from initializers: Reshape (allowzero), Gather
        inits = {"shape": np.array([0, -1, 5], np.int64), "idx": np.array([[2, -1]], np.int64)}
        nodes = [encode_node("Reshape", ["a", "shape"], ["r"]),
                 encode_node("Gather", ["r", "idx"], ["y"], attrs={"axis": 1})]
        ours, want = _run_both(ref, encode_model(nodes, inits, ["a"], ["y"]), {"a": a})
        _close(ours["y"], want["y"])

    def test_file_roundtrip(self, tmp_path):
        buf, _ = _mlp_onnx_and_torch()
        p = tmp_path / "mlp.onnx"
        p.write_bytes(buf)
        fn, params = from_onnx(str(p))
        x = torch.zeros((1, 10))
        out = fn(params, {"x": x})["probs"]
        np.testing.assert_allclose(out.numpy().sum(), 1.0, rtol=1e-5)

    def test_unsupported_op_raises(self, ref):
        buf = encode_model(
            [encode_node("FancyCustomOp", ["x"], ["y"])], {}, ["x"], ["y"]
        )
        errs = []
        for fn, params in (from_onnx(buf), ref["from_onnx"](buf)):
            with pytest.raises(NotImplementedError, match="FancyCustomOp") as e:
                fn(params, {"x": np.zeros((1, 2), np.float32)})
            errs.append(str(e.value))
        assert errs[0] == errs[1]

    def test_dnnmodel_integration(self, ref):
        buf, _ = _mlp_onnx_and_torch()
        fn, params = from_onnx(buf)
        rng = np.random.default_rng(4)
        X = rng.normal(size=(9, 10)).astype(np.float64)
        t = Table({"feats": X})
        model = DNNModel(
            applyFn=fn,
            modelParams=params,
            feedDict={"x": "feats"},
            fetchDict={"scores": "probs"},
            batchSize=4,
            device="cpu",
        )
        out = model.transform(t)
        scores = out.column("scores")
        assert scores.shape == (9, 4)
        np.testing.assert_allclose(np.sum(scores, axis=1), 1.0, rtol=1e-4)
        jfn, jparams = ref["from_onnx"](buf)
        want = ref["DNNModel"](applyFn=jfn, modelParams=jparams, feedDict={"x": "feats"},
                               fetchDict={"scores": "probs"}, batchSize=4).transform(
            ref["Table"]({"feats": X}))
        _close(scores, want.column("scores"))


def test_default_valued_attrs_decode(ref):
    """proto3 omits default-valued scalars: an attribute carrying axis=0
    arrives as name+type only and must decode to 0, not None."""
    from mmlspark_tpu_torch.dnn.onnx_proto import _ld, _tag, _varint, decode_attribute

    # name="axis", type=INT(2), no 'i' field on the wire
    buf = _ld(1, b"axis") + _tag(20, 0) + _varint(2)
    name, val = decode_attribute(buf)
    assert name == "axis" and val == 0
    buf_f = _ld(1, b"beta") + _tag(20, 0) + _varint(1)
    assert decode_attribute(buf_f) == ("beta", 0.0)
    assert decode_attribute(buf_f) == ref["proto"].decode_attribute(buf_f)


def test_concat_axis_zero_via_wire_default(ref):
    from mmlspark_tpu_torch.dnn.onnx_proto import _ld, _tag, _varint

    # Hand-build Concat with the axis attribute omitted-as-default.
    attr = _ld(1, b"axis") + _tag(20, 0) + _varint(2)
    node = (
        _ld(1, b"a") + _ld(1, b"b") + _ld(2, b"y")
        + _ld(3, b"c0") + _ld(4, b"Concat") + _ld(5, attr)
    )
    buf = encode_model([node], {}, ["a", "b"], ["y"])
    a = np.ones((2, 3), np.float32)
    b = np.zeros((1, 3), np.float32)
    ours, want = _run_both(ref, buf, {"a": a, "b": b})
    assert ours["y"].shape == (3, 3)
    np.testing.assert_array_equal(ours["y"], want["y"])


def test_multi_output_node_raises(ref):
    node = encode_node(
        "MaxPool", ["x"], ["y", "indices"],
        attrs={"kernel_shape": [2, 2], "strides": [2, 2]},
    )
    buf = encode_model([node], {}, ["x"], ["y"])
    errs = []
    for fn, params in (from_onnx(buf), ref["from_onnx"](buf)):
        with pytest.raises(NotImplementedError, match="2 outputs") as e:
            fn(params, {"x": np.zeros((1, 1, 4, 4), np.float32)})
        errs.append(str(e.value))
    assert errs[0] == errs[1]


def test_unsqueeze_mixed_negative_axes(ref):
    """ONNX Unsqueeze axes refer to the OUTPUT rank: axes=[-3, 1] on a 1-D
    input must produce shape (1, 1, S) like numpy's expand_dims on the
    normalized axes, not raise or misplace dims."""
    for axes, in_shape, want in [
        ([-3, 1], (5,), (1, 1, 5)),
        ([0, -1], (5,), (1, 5, 1)),
        ([1], (2, 3), (2, 1, 3)),
        ([-1], (2, 3), (2, 3, 1)),
    ]:
        buf = encode_model(
            [encode_node("Unsqueeze", ["x"], ["y"], attrs={"axes": axes})], {}, ["x"], ["y"]
        )
        x = np.arange(np.prod(in_shape), dtype=np.float32).reshape(in_shape)
        ours, theirs = _run_both(ref, buf, {"x": x})
        assert ours["y"].shape == want, (axes, ours["y"].shape, want)
        np.testing.assert_array_equal(ours["y"], theirs["y"])
