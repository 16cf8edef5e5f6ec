"""``jax.random.randint(jax.random.key(seed), (), 0, n)`` without jax.

The JAX package draws the first k-means centre with that call, and the port
must start from the same point to give the same palettes. This module is a
pure-Python copy of the arithmetic jax 0.9 runs for it, with the default
``jax_threefry_partitionable=True``:

- ``key(seed)`` is the pair of 32-bit words (0, seed) for a 32-bit seed;
- ``split`` hashes the counters (0, 0) and (0, 1) with threefry2x32 under
  the key, one new key from each;
- ``randint`` draws 32 random bits from each of the two new keys (threefry
  of counter (0, 0), the two output words xor-ed), then maps the 64 bits to
  ``[0, n)`` as ``((hi % n) * m + lo % n) % n`` with ``m = (2^16 % n)^2 % n``,
  every step in uint32 arithmetic that wraps, as jax's does.
"""
from __future__ import annotations

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


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


def key(seed: int):
    """``jax.random.key(seed)``'s words for a seed in 0..2^32-1 (with jax's
    default 32-bit integers, larger seeds are cut to 32 bits first)."""
    if not 0 <= seed < 1 << 32:
        raise ValueError(f"seed {seed} is outside 0..2^32-1")
    return 0, seed


def split(k):
    """``jax.random.split(k)``: two keys."""
    return threefry2x32(k, (0, 0)), threefry2x32(k, (0, 1))


def random_bits32(k) -> int:
    """32 random bits of a scalar draw under key ``k``."""
    b0, b1 = threefry2x32(k, (0, 0))
    return b0 ^ b1


def randint(seed: int, n: int) -> int:
    """``int(jax.random.randint(jax.random.key(seed), (), 0, n))`` for
    ``1 <= n < 2^31``."""
    if not 1 <= n < 1 << 31:
        raise ValueError(f"n {n} is outside 1..2^31-1")
    k1, k2 = split(key(seed))
    hi, lo = random_bits32(k1), random_bits32(k2)
    m = (1 << 16) % n
    m = (m * m & _MASK) % n
    return ((hi % n) * m + lo % n & _MASK) % n
