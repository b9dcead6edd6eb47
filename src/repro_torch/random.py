"""Threefry-2x32 keys, bit-exact with ``jax.random`` under the JAX
package's configuration (``jax_threefry_partitionable=True``, impl
``threefry2x32``, 64-bit mode off).

The port draws its own random numbers from ``torch.Generator``s; this
module exists for one reason: the round's MPC mask seed is derived from
the round's merge key (``core.secure_agg.seed_from_key``), and the same
seed must reach the masks in both packages.  Keys are host-side numpy
``uint32`` arrays of shape (2,), stacks of keys (n, 2).
"""
from __future__ import annotations

import numpy as np

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_KS_PARITY = np.uint32(0x1BD11BDA)


def _rotl(x: np.ndarray, r: int) -> np.ndarray:
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def threefry2x32(key: np.ndarray, x0: np.ndarray, x1: np.ndarray):
    """The Threefry-2x32 block cipher (20 rounds) of ``key`` (2,) uint32
    over counter words ``(x0, x1)``; returns the two output word arrays."""
    k0, k1 = np.uint32(key[0]), np.uint32(key[1])
    ks = (k0, k1, k0 ^ k1 ^ _KS_PARITY)
    x = [np.asarray(x0, np.uint32) + ks[0], np.asarray(x1, np.uint32) + ks[1]]
    for step in range(5):
        for r in _ROTATIONS[step % 2]:
            x[0] = x[0] + x[1]
            x[1] = _rotl(x[1], r) ^ x[0]
        x[0] = x[0] + ks[(step + 1) % 3]
        x[1] = x[1] + ks[(step + 2) % 3] + np.uint32(step + 1)
    return x[0], x[1]


def _counters(n: int):
    """The 64-bit iota 0..n-1 split into (hi, lo) uint32 words."""
    idx = np.arange(n, dtype=np.uint64)
    return ((idx >> np.uint64(32)).astype(np.uint32),
            (idx & np.uint64(0xFFFFFFFF)).astype(np.uint32))


def PRNGKey(seed: int) -> np.ndarray:
    """``jax.random.PRNGKey(seed)``: the seed's low 32 bits (two's
    complement for negative seeds) behind a zero high word."""
    seed = int(seed)
    if not -(2 ** 31) <= seed < 2 ** 32:
        raise ValueError(f"seed {seed} does not fit in 32 bits")
    return np.array([0, seed & 0xFFFFFFFF], np.uint32)


def split(key: np.ndarray, num: int = 2) -> np.ndarray:
    """``jax.random.split(key, num)`` -> (num, 2) uint32 keys."""
    hi, lo = _counters(num)
    b0, b1 = threefry2x32(np.asarray(key, np.uint32), hi, lo)
    return np.stack([b0, b1], axis=1)


def bits(key: np.ndarray, shape=(1,)) -> np.ndarray:
    """``jax.random.bits(key, shape, jnp.uint32)``."""
    shape = tuple(shape)
    hi, lo = _counters(int(np.prod(shape, dtype=np.int64)))
    b0, b1 = threefry2x32(np.asarray(key, np.uint32), hi, lo)
    return (b0 ^ b1).reshape(shape)
