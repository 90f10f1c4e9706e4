"""The port's threefry2x32 (mmlspark_tpu_torch.random) against jax.random.

Keys, folds, splits and float32 uniforms must equal jax's bit for bit under
jax's defaults (x64 off, partitionable threefry), for seeds that need the
32-bit cut (2**31 + 5, -1, 2**40 + 3) and for odd draw lengths. The
quantized fit's noise (``train.quant_noise``) must be the draws the
reference's ``stat_rows_quant`` makes.
"""

import signal

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmlspark_tpu_torch import random as trandom
from mmlspark_tpu_torch.lightgbm import train as ttrain

SEEDS = [0, 1, 2**31 + 5, -1, 2**40 + 3]
SEED_IDS = ["0", "1", "2^31+5", "-1", "2^40+3"]
LENGTHS = [1, 7, 4096, 100_003]
#: (iteration, column, columns) of the keys drawn from
KEY_PATHS = [(0, 0, 1), (3, 1, 2), (17, 2, 3)]
TIME_LIMIT_S = 60


@pytest.fixture(autouse=True)
def _time_limit():
    """Each test of this file fails after TIME_LIMIT_S seconds."""

    def expire(signum, frame):
        raise TimeoutError(f"test ran past its {TIME_LIMIT_S} s limit")

    saved = signal.signal(signal.SIGALRM, expire)
    signal.alarm(TIME_LIMIT_S)
    try:
        yield
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, saved)


def _data(key):
    return np.asarray(jax.random.key_data(key), dtype=np.uint32)


@pytest.mark.parametrize("seed", SEEDS, ids=SEED_IDS)
def test_prng_key_matches_jax(seed):
    key = trandom.PRNGKey(seed)
    assert key.dtype == np.uint32 and key.shape == (2,)
    np.testing.assert_array_equal(key, _data(jax.random.PRNGKey(seed)))


def test_prng_key_keeps_the_low_32_bits():
    assert trandom.PRNGKey(2**31 + 5).tolist() == [0, 2147483653]
    assert trandom.PRNGKey(-1).tolist() == [0, 4294967295]
    assert trandom.PRNGKey(2**40 + 3).tolist() == [0, 3]


@pytest.mark.parametrize("data", [0, 1, 9, 2**31 + 1])
@pytest.mark.parametrize("seed", SEEDS, ids=SEED_IDS)
def test_fold_in_matches_jax(seed, data):
    got = trandom.fold_in(trandom.PRNGKey(seed), data)
    np.testing.assert_array_equal(got, _data(jax.random.fold_in(jax.random.PRNGKey(seed), data)))


@pytest.mark.parametrize("num", [1, 2, 5])
@pytest.mark.parametrize("seed", SEEDS, ids=SEED_IDS)
def test_split_matches_jax(seed, num):
    got = trandom.split(trandom.fold_in(trandom.PRNGKey(seed), 4), num)
    want = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(seed), 4), num)
    assert got.shape == (num, 2)
    np.testing.assert_array_equal(got, _data(want))


@pytest.mark.parametrize("n", LENGTHS)
@pytest.mark.parametrize("seed", SEEDS, ids=SEED_IDS)
def test_uniform_matches_jax_bit_for_bit(seed, n):
    for it, col, cols in KEY_PATHS:
        key = trandom.split(trandom.fold_in(trandom.PRNGKey(seed), it), cols)[col]
        jkey = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(seed), it), cols)[col]
        got = trandom.uniform(key, n, device="cpu")
        want = np.asarray(jax.random.uniform(jkey, (n,), dtype=jnp.float32))
        assert got.dtype == torch.float32 and got.shape == (n,)
        np.testing.assert_array_equal(got.numpy().view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("seed", SEEDS, ids=SEED_IDS)
def test_random_bits_match_jax(seed):
    key = trandom.fold_in(trandom.PRNGKey(seed), 2)
    jkey = jax.random.fold_in(jax.random.PRNGKey(seed), 2)
    got = trandom.random_bits(key, 1001, device="cpu").numpy()
    want = np.asarray(jax.random.bits(jkey, (1001,), dtype=jnp.uint32))
    assert got.min() >= 0 and got.max() < 2**32
    np.testing.assert_array_equal(got.astype(np.uint32), want)


def _reference_noise(seed, iteration, column, n):
    """The reference's draws for (iteration, margin column): the uniforms
    of ``stat_rows_quant`` (g key, then h key) under ``train.py``'s
    per-tree key."""
    key = jax.random.split(
        jax.random.fold_in(jax.random.PRNGKey(seed ^ 0x51AB51AB), iteration), column + 1
    )[column]
    kg, kh = jax.random.split(key)
    return np.stack([np.asarray(jax.random.uniform(k, (n,), dtype=jnp.float32))
                     for k in (kg, kh)])


@pytest.mark.parametrize("seed,iteration,column,n", [
    (0, 0, 0, 1), (0, 3, 0, 1000), (7, 11, 1, 4097), (2**31 + 5, 2, 0, 513),
    (-1, 5, 2, 64), (2**40 + 3, 1, 0, 100_003),
])
def test_quant_noise_is_the_references_draw(seed, iteration, column, n):
    got = ttrain.quant_noise(seed, iteration, column, n, torch.device("cpu"))
    assert got.shape == (2, n) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  _reference_noise(seed, iteration, column, n).view(np.uint32))
