"""jax's threefry2x32 counter PRNG, as the reference's ``jax.random`` draws
use it, without jax.

The JAX package draws the quantized path's stochastic rounding (and GOSS's
row sample) from ``jax.random``: ``PRNGKey``, ``fold_in``, ``split`` and
``uniform`` over float32, under jax's defaults (``jax_enable_x64`` off,
``jax_threefry_partitionable`` on). This module computes the same bits:

- a key is two uint32 words; ``PRNGKey(seed)`` keeps the seed's low 32
  bits with a zero high word (a 64-bit seed is cut to 32 bits with x64
  off, and a negative one taken in two's complement);
- ``fold_in(key, d)`` hashes the counts ``(0, d)`` under ``key``;
- ``split(key, num)`` is the fold-like split: key ``i`` is the hash of the
  counts ``(0, i)``;
- 32 random bits of element ``i`` are ``b1 ^ b2`` of the hash of the counts
  ``(i >> 32, i & 0xFFFFFFFF)``;
- ``uniform`` puts the top 23 of those bits under the exponent of 1.0 and
  subtracts 1.0.

Keys live on the host as numpy uint32 pairs. Draws run on a torch device in
int64 tensors that hold uint32 values (masked after every add), so CPU and
CUDA give the same bits.
"""

from __future__ import annotations

import numpy as np
import torch

from mmlspark_tpu_torch.device import DeviceLike, resolve_device

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_KS_PARITY = 0x1BD11BDA


def _threefry2x32(k1: int, k2: int, x0, x1):
    """The Threefry-2x32 hash (20 rounds) of the count pairs ``(x0, x1)``
    under the key ``(k1, k2)``. ``x0``/``x1``: numpy uint64 arrays or torch
    int64 tensors holding uint32 values; returns the two output words in
    the same type."""
    ks = (k1, k2, k1 ^ k2 ^ _KS_PARITY)
    x0 = (x0 + ks[0]) & _MASK
    x1 = (x1 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = (((x1 << r) | (x1 >> (32 - r))) & _MASK) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _MASK
    return x0, x1


def _words(key) -> tuple:
    k = np.asarray(key, dtype=np.uint32)
    if k.shape != (2,):
        raise ValueError(f"a threefry key is two uint32 words, got shape {k.shape}")
    return int(k[0]), int(k[1])


def PRNGKey(seed: int) -> np.ndarray:
    """``jax.random.key_data(jax.random.PRNGKey(seed))`` with x64 off."""
    return np.array([0, int(seed) & _MASK], dtype=np.uint32)


def fold_in(key, data: int) -> np.ndarray:
    """``jax.random.fold_in``: the key hashed with the counts (0, data)."""
    k1, k2 = _words(key)
    x0, x1 = _threefry2x32(k1, k2, np.zeros(1, np.uint64),
                           np.array([int(data) & _MASK], np.uint64))
    return np.array([x0[0], x1[0]], dtype=np.uint32)


def split(key, num: int = 2) -> np.ndarray:
    """``jax.random.split`` (fold-like): (num, 2) keys, key i the hash of
    the counts (0, i)."""
    k1, k2 = _words(key)
    x0, x1 = _threefry2x32(k1, k2, np.zeros(num, np.uint64), np.arange(num, dtype=np.uint64))
    return np.stack([x0, x1], axis=1).astype(np.uint32)


def random_bits(key, n: int, device: DeviceLike = None) -> torch.Tensor:
    """(n,) 32-bit draws of ``key`` as int64 values in [0, 2**32), on
    ``device``."""
    k1, k2 = _words(key)
    idx = torch.arange(n, dtype=torch.int64, device=resolve_device(device))
    b1, b2 = _threefry2x32(k1, k2, idx >> 32, idx & _MASK)
    return b1 ^ b2


def uniform(key, n: int, device: DeviceLike = None) -> torch.Tensor:
    """``jax.random.uniform(key, (n,), float32)``: (n,) float32 in [0, 1)
    on ``device``."""
    bits = random_bits(key, n, device)
    one = (bits >> 9) | 0x3F800000  # 23 mantissa bits under 1.0's exponent
    return torch.clamp(one.to(torch.int32).view(torch.float32) - 1.0, min=0.0)
