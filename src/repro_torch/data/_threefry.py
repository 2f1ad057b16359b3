"""Threefry-2x32 in numpy: the counter-mode generator behind the data
stream, computed as the reference's random-number stream computes it
with partitionable threefry (the default of the JAX it pins), so the
port's batches are the reference's without importing it.

  * ``key(seed)``: the pair (seed >> 32, seed & 0xffffffff);
  * ``fold_in(key, d)``: threefry_2x32(key, (0, d));
  * ``split(key, n)``: threefry_2x32(key, (hi(i), lo(i))) over the
    64-bit counters i = 0 .. n-1, row i the pair (bits1[i], bits2[i]);
  * ``random_bits(key, n)``: bits1 ^ bits2 over the same counters;
  * ``uniform(key, n)``: the float32 of ``bits >> 9 | 0x3f800000``,
    minus 1 (in [0, 1)).
"""
from __future__ import annotations

import numpy as np

_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = np.uint32(0x1BD11BDA)


def _rotl(x, d: int):
    return (x << np.uint32(d)) | (x >> np.uint32(32 - d))


def threefry2x32(k1, k2, x1, x2):
    """The 20-round hash of the counter pairs (x1, x2) under the key
    (k1, k2); uint32 arrays, wrapping arithmetic."""
    k1, k2 = np.uint32(k1), np.uint32(k2)
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x = [np.atleast_1d(np.asarray(x1, np.uint32)) + ks[0],
         np.atleast_1d(np.asarray(x2, np.uint32)) + ks[1]]
    for i in range(5):
        for r in _ROT[i % 2]:
            x[0] = x[0] + x[1]
            x[1] = _rotl(x[1], r)
            x[1] = x[0] ^ x[1]
        x[0] = x[0] + ks[(i + 1) % 3]
        x[1] = x[1] + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x[0], x[1]


def key(seed: int) -> tuple[int, int]:
    seed = int(seed) & 0xFFFFFFFFFFFFFFFF
    return seed >> 32, seed & 0xFFFFFFFF


def fold_in(k, data: int) -> tuple[int, int]:
    a, b = threefry2x32(k[0], k[1], 0, int(data) & 0xFFFFFFFF)
    return int(a[0]), int(b[0])


def _counters(n: int):
    i = np.arange(n, dtype=np.uint64)
    return ((i >> np.uint64(32)).astype(np.uint32),
            (i & np.uint64(0xFFFFFFFF)).astype(np.uint32))


def split(k, n: int) -> np.ndarray:
    """[n, 2] uint32 keys."""
    hi, lo = _counters(n)
    b1, b2 = threefry2x32(k[0], k[1], hi, lo)
    return np.stack([b1, b2], axis=1)


def random_bits(k, n: int) -> np.ndarray:
    hi, lo = _counters(n)
    b1, b2 = threefry2x32(k[0], k[1], hi, lo)
    return b1 ^ b2


def uniform(k, n: int) -> np.ndarray:
    bits = (random_bits(k, n) >> np.uint32(9)) | np.uint32(0x3F800000)
    return bits.view(np.float32) - np.float32(1.0)
