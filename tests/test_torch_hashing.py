"""The port's MurmurHash3 (mmlspark_tpu_torch.ops.hashing) against the JAX
package's, bit for bit, with the reference's host C++ library on and with
``MMLSPARK_TPU_NATIVE=off`` (its numpy fallback): bytes (non-ASCII utf-8
and empty strings), seeds, prefixes of 0-7 bytes, float, negative and
uint32 integer inputs, string columns with a cache. When the in-tree
library is not built, the fixture compiles it into a temp directory, so the
``native`` cases run in a fresh checkout.
"""

import os
import subprocess

import numpy as np
import pytest


def _import_reference():
    """Import the JAX package's fit path through the u_histogram shim (see
    ``tests/test_torch_gbdt.py``). The JAX package itself is not changed."""
    from jax._src.lax import lax as lax_internal
    from jax.interpreters import batching

    saved = batching.primitive_batchers
    batching.primitive_batchers = {lax_internal.optimization_barrier_p: None}
    try:
        import mmlspark_tpu.ops.u_histogram  # noqa: F401
    finally:
        batching.primitive_batchers = saved


# At import, so that every pytest worker has the module before it collects
# the JAX package's own test files.
try:
    _import_reference()
except ModuleNotFoundError as err:
    if err.name != "jax":
        raise

import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from mmlspark_tpu_torch.ops import hashing as th


def _build_native_library(tmp_path_factory):
    """The reference's host library: the in-tree build when one exists,
    else ``native/mmlspark_native.cpp`` compiled with the Makefile's flags
    into this process's temp directory (never ``make -C native``, which
    another test worker may be running). None without ``g++``."""
    import shutil

    import mmlspark_tpu.native as native

    lib = native.load_library()
    if lib is not None:
        return lib
    if shutil.which("g++") is None:
        return None
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = str(tmp_path_factory.mktemp("native") / "libmmlspark_native.so")
    subprocess.run(["g++", "-O3", "-fPIC", "-std=c++17", "-Wall", "-Wextra", "-shared", "-o",
                    out, os.path.join(root, "native", "mmlspark_native.cpp")],
                   check=True, capture_output=True, timeout=300)
    return native.load_library(out)


@pytest.fixture(scope="session")
def native_library(tmp_path_factory):
    return _build_native_library(tmp_path_factory)


@pytest.fixture(params=["native", "off"])
def ref(request, monkeypatch, native_library):
    """The reference's hashing module under one of its two paths; the
    library reads ``MMLSPARK_TPU_NATIVE`` at each load."""
    import mmlspark_tpu.native as native
    from mmlspark_tpu.ops import hashing as jh

    if request.param == "off":
        monkeypatch.setenv("MMLSPARK_TPU_NATIVE", "off")
        assert native.load_library() is None
    elif native_library is None:
        pytest.skip("no g++ to build the reference's host library")
    else:
        assert native.load_library() is not None
    return jh


def _pack(strings):
    bs = [s.encode("utf-8") for s in strings]
    lens = np.array([len(b) for b in bs], dtype=np.int64)
    starts = np.concatenate([[0], np.cumsum(lens[:-1])]).astype(np.int64)
    return np.frombuffer(b"".join(bs), dtype=np.uint8), starts, lens


_TEXT = st.text(alphabet=st.characters(codec="utf-8"), max_size=13)


@settings(max_examples=40, deadline=None,
          suppress_health_check=[HealthCheck.function_scoped_fixture])
@given(strings=st.lists(_TEXT, min_size=1, max_size=24),
       seed=st.integers(0, 2 ** 32 - 1), prefix=st.binary(max_size=7))
def test_bytes_and_batches_equal_the_reference(ref, strings, seed, prefix):
    buf, starts, lens = _pack(strings)
    got = th.murmur32_bytes_batch(buf, starts, lens, seed, prefix)
    np.testing.assert_array_equal(got, ref.murmur32_bytes_batch(buf, starts, lens, seed, prefix))
    for s in strings[:4]:
        data = prefix + s.encode("utf-8")
        assert th.murmur32_bytes(data, seed) == ref.murmur32_bytes(data, seed)
    assert th.namespace_seed(strings[0], seed) == ref.namespace_seed(strings[0], seed)


@pytest.mark.parametrize("values", [
    np.array([0.0, 1.0, -1.0, 2.5, -2.5, 255.0, 4294967295.0, -2147483648.0, 1e10]),
    np.array([0, -1, 7, 2 ** 31, -(2 ** 40)], dtype=np.int64),
    np.array([0, 1, 2 ** 32 - 1, 12345], dtype=np.uint32),
    np.arange(-50, 50, dtype=np.int32).reshape(10, 10),
    np.zeros(0, dtype=np.float32),
], ids=["float64", "int64", "uint32", "int32_2d", "empty"])
@pytest.mark.parametrize("seed", [0, 5, 0xCAFEBABE])
def test_ints_equal_the_reference(ref, values, seed):
    got = th.murmur32_ints(values, seed)
    assert got.dtype == np.uint32 and got.shape == values.shape
    np.testing.assert_array_equal(got, ref.murmur32_ints(values, seed))
    np.testing.assert_array_equal(th._coerce_u32(values), ref._coerce_u32(values))
    # a tensor is copied to the host and hashed there
    np.testing.assert_array_equal(th.murmur32_ints(torch.as_tensor(values), seed), got)


def test_strings_cache_and_masks_equal_the_reference(ref):
    rng = np.random.default_rng(3)
    values = [f"tok{i}" for i in rng.integers(0, 50, 300)] + [
        "", "é™", "🎉", None, 1, 1.0, True, np.float64(2.5), np.int64(7), float("nan"), "1"]
    for seed in (0, 11):
        got_cache, want_cache = {}, {}
        got = th.murmur32_strings(values, seed, cache=got_cache)
        np.testing.assert_array_equal(got, ref.murmur32_strings(values, seed, cache=want_cache))
        assert {repr(k): v for k, v in got_cache.items()} == \
            {repr(k): int(v) for k, v in want_cache.items()}
        again = th.murmur32_strings(values[::-1], seed, cache=got_cache)
        np.testing.assert_array_equal(again, got[::-1])
        for bits in (1, 8, 18, 30):
            np.testing.assert_array_equal(th.mask_bits(got, bits), ref.mask_bits(got, bits))
    assert th.murmur32_strings([]).dtype == np.uint32
    z = np.zeros(0, dtype=np.int64)
    assert th.murmur32_bytes_batch(np.zeros(0, np.uint8), z, z, 9, b"p").size == 0
    assert th.batch_hash_is_native() is False
