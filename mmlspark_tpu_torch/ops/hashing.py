"""MurmurHash3 (x86 32-bit) on the host, the port's copy of
``mmlspark_tpu/ops/hashing.py``.

Hashing stays on the host: only integer bucket indices go on to the card.
The reference runs its hashes in a host C++ library with a numpy fallback;
the port has no host library and hashes in vectorized numpy, with the
reference's own fallback block mixer, so every hash equals the reference's
bit for bit whichever path the reference took. Strings are hashed as one
packed buffer per call (:func:`murmur32_strings` packs the utf-8 bytes of
the distinct strings), never one token at a time in Python.

``murmur32_ints`` is VW's hash of integer feature ids; ``murmur32_bytes``
hashes a feature name's utf-8 bytes; ``namespace_seed`` hashes a namespace
once so that it seeds its features' hashes (``VowpalWabbitMurmurWithPrefix``).
"""

from __future__ import annotations

from typing import Iterable, Optional

import numpy as np

_C1 = np.uint32(0xCC9E2D51)
_C2 = np.uint32(0x1B873593)


def _require_host(values):
    """``values`` as a host array. A ``torch.Tensor`` (on any device) is
    copied to the host: hashing runs only there, and the caller gets host
    hashes back. Anything else passes unchanged."""
    if type(values).__module__.startswith("torch"):
        return values.detach().cpu().numpy()
    return values


def _rotl32(x: np.ndarray, r: int) -> np.ndarray:
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def _mix_k(k: np.ndarray) -> np.ndarray:
    k = (k * _C1).astype(np.uint32)
    k = _rotl32(k, 15)
    return (k * _C2).astype(np.uint32)


def _mix_h(h: np.ndarray, k: np.ndarray) -> np.ndarray:
    h = h ^ k
    h = _rotl32(h, 13)
    return (h * np.uint32(5) + np.uint32(0xE6546B64)).astype(np.uint32)


def _fmix(h: np.ndarray) -> np.ndarray:
    h = h ^ (h >> np.uint32(16))
    h = (h * np.uint32(0x85EBCA6B)).astype(np.uint32)
    h = h ^ (h >> np.uint32(13))
    h = (h * np.uint32(0xC2B2AE35)).astype(np.uint32)
    return h ^ (h >> np.uint32(16))


def _coerce_u32(values) -> np.ndarray:
    """Integer inputs as uint32: through int64 first, so that float and
    negative inputs take the reference's values (a direct float to unsigned
    conversion is undefined for negatives in C)."""
    arr = np.asarray(values)
    if arr.dtype == np.uint32:
        return arr
    with np.errstate(over="ignore", invalid="ignore"):
        return arr.astype(np.int64).astype(np.uint32)


def murmur32_ints(values, seed: int = 0) -> np.ndarray:
    """Hash each value as one 4-byte murmur3 block (VW's ``hash_uniform``
    over integer feature ids)."""
    k = _coerce_u32(_require_host(values))
    with np.errstate(over="ignore"):
        h = np.full(k.shape, np.uint32(seed & 0xFFFFFFFF), dtype=np.uint32)
        h = _mix_h(h, _mix_k(k))
        h = h ^ np.uint32(4)  # the length
        return _fmix(h)


def murmur32_bytes(data: bytes, seed: int = 0) -> int:
    """murmur3_x86_32 of one byte string (a feature name)."""
    buf = np.frombuffer(data, dtype=np.uint8)
    return int(murmur32_bytes_batch(buf, np.zeros(1, np.int64), np.array([len(data)]), seed)[0])


def batch_hash_is_native() -> bool:
    """Whether :func:`murmur32_bytes_batch` runs in a host C++ library:
    never in the port, which hashes a whole batch in one numpy pass."""
    return False


def murmur32_bytes_batch(buf: np.ndarray, starts: np.ndarray, lens: np.ndarray, seed: int = 0,
                         prefix: bytes = b"") -> np.ndarray:
    """murmur3_x86_32 of many byte strings packed in one buffer: string i is
    ``buf[starts[i] : starts[i] + lens[i]]``, with ``prefix`` (a namespace
    or column name) read in front of every string without being copied.
    Equal to ``murmur32_bytes(prefix + s, seed)`` for every string. The
    mixer walks murmur's 4-byte blocks across all strings at once."""
    starts = np.asarray(starts, dtype=np.int64)
    lens = np.asarray(lens, dtype=np.int64)
    if starts.size == 0:
        return np.zeros(0, dtype=np.uint32)
    buf = np.ascontiguousarray(buf, dtype=np.uint8)
    if buf.size == 0:
        buf = np.zeros(1, dtype=np.uint8)  # keeps the masked gathers in bounds
    pre = np.frombuffer(prefix, dtype=np.uint8)
    P = len(prefix)
    last = buf.size - 1
    with np.errstate(over="ignore"):
        total = lens + P
        h = np.full(starts.shape, np.uint32(seed & 0xFFFFFFFF), dtype=np.uint32)
        # Whole blocks, one vectorized pass per block position: position
        # p = 4b + j is one scalar for every string, so prefix bytes mix in
        # as scalars and only string bytes are gathered; a string too short
        # for block b keeps its state.
        for b in range(int(total.max()) // 4):
            active = total >= 4 * (b + 1)
            if not active.any():
                break
            k = np.zeros(starts.shape, dtype=np.uint32)
            for j in range(4):
                p = 4 * b + j
                if p < P:
                    k |= np.uint32(pre[p]) << np.uint32(8 * j)
                else:
                    g = buf[np.minimum(starts + (p - P), last)]
                    k |= np.where(active, g, 0).astype(np.uint32) << np.uint32(8 * j)
            h = np.where(active, _mix_h(h, _mix_k(k)), h)
        # the 1-3 byte tails, which may hold prefix bytes when P % 4 != 0
        # and the string is short
        tail_len = (total & 3).astype(np.int64)
        tail_base = total - tail_len
        k = np.zeros(starts.shape, dtype=np.uint32)
        for j in range(3):
            has = tail_len > j
            p = tail_base + j
            g = buf[np.minimum(np.maximum(starts + (p - P), 0), last)]
            if P:
                g = np.where(p < P, pre[np.minimum(np.maximum(p, 0), P - 1)], g)
            k = np.where(has, k ^ (g.astype(np.uint32) << np.uint32(8 * j)), k)
        h = np.where(tail_len > 0, h ^ _mix_k(k), h)
        h = h ^ total.astype(np.uint32)
        return _fmix(h)


def murmur32_strings(values: Iterable, seed: int = 0, cache: Optional[dict] = None
                     ) -> np.ndarray:
    """Hash each value's ``str()`` as utf-8 bytes. The distinct values not
    in ``cache`` are packed into one buffer and hashed in one call; ``cache``
    (value -> hash) keeps them for later calls, so a column's recurring
    tokens hash once. Values that compare equal share the first one's hash,
    as a dict lookup gives them."""
    values = list(values)
    if cache is None:
        cache = {}
    new = [v for v in dict.fromkeys(values) if v not in cache]
    if new:
        encoded = [str(v).encode("utf-8") for v in new]
        lens = np.fromiter(map(len, encoded), dtype=np.int64, count=len(encoded))
        starts = np.concatenate([[0], np.cumsum(lens[:-1])])
        buf = np.frombuffer(b"".join(encoded), dtype=np.uint8)
        cache.update(zip(new, murmur32_bytes_batch(buf, starts, lens, seed).tolist()))
    return np.fromiter((cache[v] for v in values), dtype=np.uint32, count=len(values))


def namespace_seed(namespace: str, seed: int = 0) -> int:
    """A namespace's hash, the seed of its features' hashes."""
    return murmur32_bytes(namespace.encode("utf-8"), seed)


def mask_bits(h: np.ndarray, num_bits: int) -> np.ndarray:
    """The low ``num_bits`` of each hash as int32 (exact for num_bits <= 30)."""
    return (h & np.uint32((1 << num_bits) - 1)).view(np.int32)
