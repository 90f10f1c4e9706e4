"""The port's downloader and model zoo (``mmlspark_tpu_torch.downloader``,
``mmlspark_tpu_torch.models.zoo``) against the JAX package's, on the CPU:
every case of ``tests/test_downloader.py`` as a port case, and the two
packages holding each other's artifacts.

Bit for bit: schema JSON, repository layout and hashes (either package's
downloader reads the other's repository), zoo payloads (the npz members'
names, order and bytes; only the zip's own timestamps differ between two
writes), ``init_resnet`` params and the retry policy's seeded sleeps.
Within ``TRAIN_TOL``: three Adam steps of ``train_resnet_classifier``
against the reference's optax run, as the L2 norm of the params' difference
over the L2 norm of the reference's movement (Adam's first steps move each
weight by about the learning rate with the sign of its gradient, so a
weight whose gradient lies within float32 noise of zero moves the other
way; on a random resnet18 the loss jumps from 2.4 to 129 at step 2, which
amplifies that: 0.47%, 1.1% and 3.1% after steps 1-3, the losses within
1.6e-4 and 7e-4 relative). Features of loaded weights within ``FEAT_TOL`` of the
largest magnitude (float32 convolutions summed in each library's order).
"""

import io
import os
import zipfile

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

from mmlspark_tpu_torch.core.pytree import tree_leaves
from mmlspark_tpu_torch.data.table import Table
from mmlspark_tpu_torch.downloader import (
    FaultToleranceUtils,
    LocalRepo,
    ModelDownloader,
    ModelSchema,
)
from mmlspark_tpu_torch.models import (
    init_resnet,
    load_zoo_params,
    params_from_bytes,
    params_to_bytes,
    publish_model,
    train_resnet_classifier,
)

TRAIN_TOL = 0.05  # three Adam steps: params' L2 gap over the reference's L2 movement
FEAT_TOL = 1e-5  # features, of the largest magnitude


@pytest.fixture(scope="module")
def ref():
    from mmlspark_tpu import downloader as jdl
    from mmlspark_tpu import models as jmodels
    from mmlspark_tpu.data.table import Table as JTable
    from mmlspark_tpu.image import ImageFeaturizer as JFeaturizer

    return dict(dl=jdl, models=jmodels, Table=JTable, Featurizer=JFeaturizer)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """torch on one thread for this file: under the full run's 6 workers a
    default thread pool per worker oversubscribes the cores (three training
    steps took 40 s against 1.8 s)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _members(payload: bytes):
    """An npz payload's members: (name, bytes) in order."""
    with zipfile.ZipFile(io.BytesIO(payload)) as z:
        return [(i.filename, z.read(i.filename)) for i in z.infolist()]


def _assert_trees_equal(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert np.asarray(x).dtype == np.asarray(y).dtype
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def test_schema_roundtrip(ref):
    s = ModelSchema(name="resnet50", uri="resnet50.bin", inputNode="input",
                    layerNames=["fc", "pool"])
    s2 = ModelSchema.from_json(s.to_json())
    assert s2 == s
    js = ref["dl"].ModelSchema(name="resnet50", uri="resnet50.bin", inputNode="input",
                               layerNames=["fc", "pool"])
    assert s.to_json() == js.to_json()
    assert ModelSchema.from_json(js.to_json()) == s


def test_local_repo_add_list_download(tmp_path, ref):
    repo_dir = str(tmp_path / "repo")
    cache_dir = str(tmp_path / "cache")
    repo = LocalRepo(repo_dir)
    repo.add(ModelSchema(name="m1", uri=""), b"payload-bytes")
    dl = ModelDownloader(cache_dir, repo)
    models = dl.list_models()
    assert [m.name for m in models] == ["m1"]
    path = dl.download_by_name("m1")
    with open(path, "rb") as f:
        assert f.read() == b"payload-bytes"
    # cached second call returns same file without re-fetching
    assert dl.download_by_name("m1") == path
    # the reference's repository of the same payload: the same files, byte
    # for byte, and each package's downloader reads the other's repository
    jrepo_dir = str(tmp_path / "jrepo")
    ref["dl"].LocalRepo(jrepo_dir).add(ref["dl"].ModelSchema(name="m1", uri=""),
                                       b"payload-bytes")
    assert sorted(os.listdir(jrepo_dir)) == sorted(os.listdir(repo_dir))
    for name in os.listdir(repo_dir):
        with open(os.path.join(repo_dir, name), "rb") as a, \
                open(os.path.join(jrepo_dir, name), "rb") as b:
            assert a.read() == b.read(), name
    jpath = ref["dl"].ModelDownloader(str(tmp_path / "jcache"), ref["dl"].LocalRepo(repo_dir)
                                      ).download_by_name("m1")
    path2 = ModelDownloader(str(tmp_path / "cache2"), LocalRepo(jrepo_dir)).download_by_name("m1")
    with open(jpath, "rb") as a, open(path2, "rb") as b:
        assert a.read() == b.read() == b"payload-bytes"


def test_hash_mismatch_raises(tmp_path, ref):
    repo_dir = str(tmp_path / "repo")
    repo = LocalRepo(repo_dir)
    repo.add(ModelSchema(name="m", uri=""), b"data")
    # corrupt the payload after hashing
    with open(os.path.join(repo_dir, "m.bin"), "wb") as f:
        f.write(b"tampered")
    dl = ModelDownloader(str(tmp_path / "cache"), repo)
    with pytest.raises(IOError) as port_err:
        dl.download_by_name("m")
    jdl = ref["dl"].ModelDownloader(str(tmp_path / "jcache"), ref["dl"].LocalRepo(repo_dir))
    with pytest.raises(IOError) as ref_err:
        jdl.download_by_name("m")
    assert str(port_err.value) == str(ref_err.value)


def test_missing_model_raises(tmp_path, ref):
    dl = ModelDownloader(str(tmp_path / "cache"), LocalRepo(str(tmp_path / "repo")))
    with pytest.raises(KeyError) as port_err:
        dl.download_by_name("nope")
    jdl = ref["dl"].ModelDownloader(str(tmp_path / "cache"),
                                    ref["dl"].LocalRepo(str(tmp_path / "repo")))
    with pytest.raises(KeyError) as ref_err:
        jdl.download_by_name("nope")
    assert str(port_err.value) == str(ref_err.value)


def test_retry_with_timeout(ref):
    def run(utils):
        calls = {"n": 0}
        slept = []

        def flaky():
            calls["n"] += 1
            if calls["n"] < 3:
                raise IOError("transient")
            return "ok"

        assert utils.retry_with_timeout(flaky, times=3, backoff=0.01,
                                        sleep=slept.append) == "ok"
        with pytest.raises(IOError):
            utils.retry_with_timeout(
                lambda: (_ for _ in ()).throw(IOError("always")), times=2, backoff=0.01,
                sleep=slept.append,
            )
        return calls["n"], slept

    port = run(FaultToleranceUtils)
    assert port[0] == 3 and len(port[1]) == 3
    # the seeded full-jitter sleeps are the reference's, draw for draw
    assert port == run(ref["dl"].FaultToleranceUtils)


class TestZooArtifacts:
    """Trained-weight artifacts through the repository (the reference's
    ModelDownloader -> ImageFeaturizer flow with real learned weights),
    crossing between the packages."""

    def test_params_npz_round_trip(self, ref):
        p = init_resnet(variant="resnet18", num_classes=3, small_inputs=True,
                        in_channels=1)
        p2 = params_from_bytes(params_to_bytes(p))
        _assert_trees_equal(p, p2)
        # init_resnet is the reference's bit for bit, and the payloads hold
        # the same members, in the same order, byte for byte
        jp = ref["models"].init_resnet(variant="resnet18", num_classes=3, small_inputs=True,
                                       in_channels=1)
        _assert_trees_equal(p, jp)
        assert _members(params_to_bytes(p)) == _members(ref["models"].params_to_bytes(jp))
        # a tree of tensors writes the same payload
        tp = {"stem": {"w": torch.from_numpy(p["stem"]["conv"]["w"])}}
        assert _members(params_to_bytes(tp)) == _members(
            params_to_bytes({"stem": {"w": p["stem"]["conv"]["w"]}}))

    @pytest.mark.parametrize("variant,small", [("resnet18", False), ("resnet34", True),
                                               ("resnet50", True), ("resnet50", False)])
    def test_init_resnet_bit_for_bit(self, ref, variant, small):
        kw = dict(seed=3, variant=variant, num_classes=10, small_inputs=small)
        _assert_trees_equal(init_resnet(**kw), ref["models"].init_resnet(**kw))

    def test_publish_download_featurize(self, tmp_path, ref):
        rng = np.random.default_rng(0)
        X = rng.uniform(size=(32, 1, 16, 16)).astype(np.float32)
        y = (X[:, 0, :8].mean(axis=(1, 2)) > X[:, 0, 8:].mean(axis=(1, 2))).astype(int)
        p0 = init_resnet(variant="resnet18", num_classes=2, small_inputs=True,
                         in_channels=1)
        trained, _ = train_resnet_classifier(p0, X, y, num_steps=2, batch_size=8,
                                             device="cpu")
        schema = publish_model(str(tmp_path / "repo"), "tiny", trained, (16, 16))
        assert schema.hash and schema.numLayers

        dl = ModelDownloader(str(tmp_path / "cache"), LocalRepo(str(tmp_path / "repo")))
        loaded = load_zoo_params(dl, "tiny")
        _assert_trees_equal(trained, loaded)
        # the reference's downloader loads the port's artifact, bit for bit
        jdl = ref["dl"].ModelDownloader(str(tmp_path / "jcache"),
                                        ref["dl"].LocalRepo(str(tmp_path / "repo")))
        _assert_trees_equal(trained, ref["models"].load_zoo_params(jdl, "tiny"))

        imgs = np.empty(4, dtype=object)
        for i in range(4):
            imgs[i] = X[i, 0][:, :, None]
        from mmlspark_tpu_torch.image import ImageFeaturizer

        out = ImageFeaturizer(
            inputCol="image", outputCol="features", modelParams=loaded,
            inputHeight=16, inputWidth=16, scale=1.0, batchSize=4, device="cpu",
        ).transform(Table({"image": imgs}))
        feats = np.asarray(out["features"])
        assert feats.shape == (4, 512) and np.isfinite(feats).all()
        want = np.asarray(ref["Featurizer"](
            inputCol="image", outputCol="features", modelParams=loaded,
            inputHeight=16, inputWidth=16, scale=1.0, batchSize=4,
        ).transform(ref["Table"]({"image": imgs}))["features"])
        assert np.abs(feats - want).max() <= FEAT_TOL * np.abs(want).max()

    def test_reference_artifact_loads_in_the_port(self, tmp_path, ref):
        jp = ref["models"].init_resnet(seed=5, variant="resnet18", num_classes=4,
                                       small_inputs=True)
        jschema = ref["models"].publish_model(str(tmp_path / "repo"), "ref", jp, (32, 32))
        dl = ModelDownloader(str(tmp_path / "cache"), LocalRepo(str(tmp_path / "repo")))
        _assert_trees_equal(jp, load_zoo_params(dl, "ref"))
        # the port publishes the same schema for the same tree
        schema = publish_model(str(tmp_path / "repo2"), "ref", jp, (32, 32))
        assert schema.to_json() == jschema.to_json()

    def test_train_three_steps_match_optax(self, ref):
        rng = np.random.default_rng(7)
        X = rng.uniform(size=(48, 3, 16, 16)).astype(np.float32)
        y = rng.integers(0, 3, size=48)
        p0 = init_resnet(seed=1, variant="resnet18", num_classes=3, small_inputs=True)
        losses = []
        got, acc = train_resnet_classifier(p0, X, y, num_steps=3, batch_size=16, device="cpu",
                                           losses=losses)
        want, jacc = ref["models"].train_resnet_classifier(p0, X, y, num_steps=3,
                                                           batch_size=16)
        assert len(losses) == 3 and np.isfinite(losses).all()
        assert acc == jacc
        from chip_smoke import _train_gap

        assert _train_gap(got, want, p0) <= TRAIN_TOL

    def test_corrupted_payload_rejected(self, tmp_path):
        p = init_resnet(variant="resnet18", num_classes=2, small_inputs=True,
                        in_channels=1)
        publish_model(str(tmp_path / "repo"), "tiny2", p, (16, 16))
        # corrupt the payload behind the schema's hash
        with open(tmp_path / "repo" / "tiny2.bin", "ab") as f:
            f.write(b"x")
        dl = ModelDownloader(str(tmp_path / "cache2"), LocalRepo(str(tmp_path / "repo")))
        with pytest.raises(IOError, match="hash mismatch"):
            dl.download_by_name("tiny2")

    def test_digit_keyed_dicts_round_trip(self, ref):
        tree = {"blocks": {"0": np.ones(2), "2": np.zeros(3)},
                "layers": [np.arange(2.0), {"w": np.eye(2)}]}
        out = params_from_bytes(params_to_bytes(tree))
        assert isinstance(out["blocks"], dict)  # digit keys stay a dict
        np.testing.assert_array_equal(out["blocks"]["2"], np.zeros(3))
        assert isinstance(out["layers"], list)
        np.testing.assert_array_equal(out["layers"][1]["w"], np.eye(2))
        with pytest.raises(ValueError, match="may not contain"):
            params_to_bytes({"a/b": np.ones(1)})
        # each package reads the other's payload of the same tree
        jout = ref["models"].params_from_bytes(params_to_bytes(tree))
        _assert_trees_equal(out, jout)
        _assert_trees_equal(out, params_from_bytes(ref["models"].params_to_bytes(tree)))


def test_downloader_modules_import_neither_jax_nor_the_jax_package():
    import subprocess
    import sys

    code = (
        "import sys\n"
        "class _Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in ('jax', 'mmlspark_tpu', 'optax', 'onnx', 'PIL',"
        " 'cv2'):\n"
        "            raise ImportError('blocked: ' + name)\n"
        "sys.meta_path.insert(0, _Block())\n"
        "import mmlspark_tpu_torch.downloader, mmlspark_tpu_torch.models\n"
        "import mmlspark_tpu_torch.models.zoo, mmlspark_tpu_torch.models.resnet\n"
        "print('ok')\n"
    )
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
