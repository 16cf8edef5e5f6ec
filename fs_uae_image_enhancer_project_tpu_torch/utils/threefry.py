"""``jax.random``'s threefry draws without jax: the scalar ``randint`` of the
k-means seeding and the numpy-vectorised ``split``, 32-bit ``random_bits``,
``uniform`` and ``normal`` of the fixed-seed random VGG and the VGG
self-training's decoder.

The JAX package draws the first k-means centre with
``jax.random.randint(jax.random.key(seed), (), 0, n)``, its random VGG basis
with ``jax.random.normal`` and its conv init with ``jax.random.uniform``; the
port must draw the same numbers to give the same palettes, the same
perceptual loss and the same initial weights. This module copies the
arithmetic jax 0.9 runs for them, with the default
``jax_threefry_partitionable=True``:

- ``key(seed)`` is the pair of 32-bit words (0, seed) for a 32-bit seed;
- ``split(k, n)`` hashes the counters (0, i), i < n, with threefry2x32 under
  the key, one new key from each;
- ``random_bits(k, shape)`` hashes the counters (hi, lo) of each element's
  flat index under the key and xors the two output words;
- ``uniform`` puts the top 23 bits of each draw in the mantissa of a float
  in [1, 2), subtracts 1 and scales to ``[minval, maxval)`` with one fused
  multiply-add in float32, as XLA compiles it;
- ``normal`` is ``sqrt(2) * erf_inv(u)`` for u uniform in
  ``[nextafter(-1, 0), 1)``, with XLA's float32 ``erf_inv`` (Giles'
  polynomials in ``w = -log1p(-x^2)``, one for w < 5 and one above),
  evaluated in float32: within a few ulp of jax's (the log1p and the fused
  multiply-adds of XLA's CPU code round apart from numpy's);
- ``randint`` draws 32 random bits from each of the two keys of
  ``split(key(seed))``, then maps the 64 bits to ``[0, n)`` as
  ``((hi % n) * m + lo % n) % n`` with ``m = (2^16 % n)^2 % n``, every step
  in uint32 arithmetic that wraps, as jax's does.

A key is a pair of 32-bit words, a tuple of two ints.
Pure Python and numpy: no torch, no jax.
"""
from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import numpy as np

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))

# XLA's float32 erf_inv (Giles, "Approximating the erfinv function"): the
# coefficients for w < 5 and for w >= 5, highest degree first
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
               0.00021858087, -0.00125372503, -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
               0.00573950773, -0.0076224613, 0.00943887047, 1.00167406, 2.83297682)


def _rotl(x: int, r: int) -> int:
    return ((x << r) | (x >> (32 - r))) & _MASK


def threefry2x32(key, count):
    """The Threefry-2x32 hash (20 rounds) of the word pair ``count`` under
    the word pair ``key``; returns a word pair."""
    ks = (key[0], key[1], key[0] ^ key[1] ^ 0x1BD11BDA)
    x0 = (count[0] + ks[0]) & _MASK
    x1 = (count[1] + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _MASK
    return x0, x1


def threefry2x32_np(key, c0: np.ndarray, c1: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """:func:`threefry2x32` over uint32 arrays of counter words ``(c0, c1)``
    under one key (uint32 arithmetic wraps); returns two uint32 arrays."""
    k0, k1 = (int(w) & _MASK for w in key)
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = c0.astype(np.uint32) + np.uint32(ks[0])
    x1 = c1.astype(np.uint32) + np.uint32(ks[1])
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 += x1
            x1 = (x1 << np.uint32(r)) | (x1 >> np.uint32(32 - r))
            x1 ^= x0
        x0 += np.uint32(ks[(i + 1) % 3])
        x1 += np.uint32((ks[(i + 2) % 3] + i + 1) & _MASK)
    return x0, x1


def key(seed: int):
    """``jax.random.key(seed)``'s words for a seed in 0..2^32-1 (with jax's
    default 32-bit integers, larger seeds are cut to 32 bits first)."""
    if not 0 <= seed < 1 << 32:
        raise ValueError(f"seed {seed} is outside 0..2^32-1")
    return 0, seed


def _counters(n: int) -> Tuple[np.ndarray, np.ndarray]:
    """The flat indices 0..n-1 as (hi, lo) uint32 words (jax's
    ``iota_2x32_shape``)."""
    idx = np.arange(n, dtype=np.uint64)
    return (idx >> np.uint64(32)).astype(np.uint32), (idx & np.uint64(_MASK)).astype(np.uint32)


def split(k, n: int = 2) -> List[Tuple[int, int]]:
    """``jax.random.split(k, n)``: n keys, each a pair of words (the rows of
    ``jax.random.key_data`` of jax's)."""
    b0, b1 = threefry2x32_np(k, *_counters(n))
    return [(int(a), int(b)) for a, b in zip(b0, b1)]


def random_bits(k, shape: Sequence[int]) -> np.ndarray:
    """``jax.random.bits(k, shape, uint32)``: 32 random bits an element."""
    b0, b1 = threefry2x32_np(k, *_counters(math.prod(shape)))
    return (b0 ^ b1).reshape(tuple(shape))


def uniform(k, shape: Sequence[int], minval: float = 0.0, maxval: float = 1.0) -> np.ndarray:
    """``jax.random.uniform(k, shape, float32, minval, maxval)``."""
    lo, hi = np.float32(minval), np.float32(maxval)
    bits = (random_bits(k, shape) >> np.uint32(9)) | np.uint32(0x3F800000)
    floats = bits.view(np.float32) - np.float32(1.0)
    # XLA fuses floats * (hi - lo) + lo into one multiply-add: the float64
    # sum of the exact product is exact for the ranges drawn here (lo and hi
    # of one binade's magnitude), so one rounding to float32 is the fma's
    fma = floats.astype(np.float64) * np.float64(hi - lo) + np.float64(lo)
    return np.maximum(lo, fma.astype(np.float32))


def erf_inv(x: np.ndarray) -> np.ndarray:
    """XLA's float32 ``erf_inv``, evaluated in float32."""
    x = np.asarray(x, np.float32)
    with np.errstate(divide="ignore", invalid="ignore"):
        w = -np.log1p(-x * x)
        lt = w < np.float32(5.0)
        w = np.where(lt, w - np.float32(2.5), np.sqrt(w) - np.float32(3.0))
        p = np.where(lt, np.float32(_ERFINV_LT5[0]), np.float32(_ERFINV_GE5[0]))
        for a, b in zip(_ERFINV_LT5[1:], _ERFINV_GE5[1:]):
            p = np.where(lt, np.float32(a), np.float32(b)) + p * w
        out = p * x
    return np.where(np.abs(x) == 1, x * np.float32(np.inf), out).astype(np.float32)


def normal(k, shape: Sequence[int]) -> np.ndarray:
    """``jax.random.normal(k, shape, float32)``."""
    lo = np.nextafter(np.float32(-1.0), np.float32(0.0), dtype=np.float32)
    u = uniform(k, shape, lo, 1.0)
    return np.float32(np.sqrt(2)) * erf_inv(u)


def random_bits32(k) -> int:
    """32 random bits of a scalar draw under key ``k``."""
    b0, b1 = threefry2x32(k, (0, 0))
    return b0 ^ b1


def randint(seed: int, n: int) -> int:
    """``int(jax.random.randint(jax.random.key(seed), (), 0, n))`` for
    ``1 <= n < 2^31``."""
    if not 1 <= n < 1 << 31:
        raise ValueError(f"n {n} is outside 1..2^31-1")
    k1, k2 = (threefry2x32(key(seed), (0, i)) for i in (0, 1))
    hi, lo = random_bits32(k1), random_bits32(k2)
    m = (1 << 16) % n
    m = (m * m & _MASK) % n
    return ((hi % n) * m + lo % n & _MASK) % n
