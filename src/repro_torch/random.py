"""Threefry-2x32 keys, bit-exact with ``jax.random`` under the JAX
package's configuration (``jax_threefry_partitionable=True``, impl
``threefry2x32``, 64-bit mode off).

The port draws its own random numbers from ``torch.Generator``s; this
module exists because two streams must be the JAX package's own: the
round's MPC mask seed, derived from the round's merge key
(``core.secure_agg.seed_from_key``), and the legacy MPC round's pairwise
masks (``core.secure_agg.mask_for``: `fold_in` keys and `normal` draws).
Keys are host-side numpy ``uint32`` arrays of shape (2,), stacks of keys
(n, 2).

`normal` draws on a torch device: the legacy masks are full-size arrays
(P (P - 1) draws of N values a round), far too many for numpy threefry on
the host.  Its threefry runs on int64 tensors holding uint32 values (torch
has too few uint32 operations), one chunk of counters at a time; under
the partitionable config element i is a function of (key, i) alone, so
the chunk size changes no bit.
"""
from __future__ import annotations

import math

import numpy as np
import torch

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


def fold_in(key: np.ndarray, data: int) -> np.ndarray:
    """``jax.random.fold_in(key, data)``: threefry of the counter pair
    (0, data mod 2^32) under `key` -> (2,) uint32."""
    b0, b1 = threefry2x32(np.asarray(key, np.uint32),
                          np.zeros(1, np.uint32),
                          np.array([int(data) & 0xFFFFFFFF], np.uint32))
    return np.concatenate([b0, b1])


_M32 = 0xFFFFFFFF
# jax.random.normal's uniform lies in [nextafter(-1, 0), 1), and f32
# (1 - lo) rounds to 2.0
_NORMAL_LO = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
_NORMAL_SPAN = float(np.float32(1.0) - np.float32(_NORMAL_LO))
_SQRT2_F32 = float(np.float32(math.sqrt(2.0)))
_ONE_F32_BITS = 0x3F800000
NORMAL_CHUNK = 1 << 25   # counters per chunk: ~1.5 GB of int64 transients


def _threefry2x32_torch(key, x0: torch.Tensor, x1: torch.Tensor):
    """`threefry2x32` on int64 tensors of uint32 values (consumed)."""
    k0, k1 = int(key[0]), int(key[1])
    ks = (k0, k1, k0 ^ k1 ^ int(_KS_PARITY))
    x0.add_(ks[0]).bitwise_and_(_M32)
    x1.add_(ks[1]).bitwise_and_(_M32)
    for step in range(5):
        for r in _ROTATIONS[step % 2]:
            x0.add_(x1).bitwise_and_(_M32)
            hi = (x1 << r).bitwise_and_(_M32)
            x1.bitwise_right_shift_(32 - r).bitwise_or_(hi).bitwise_xor_(x0)
        x0.add_(ks[(step + 1) % 3]).bitwise_and_(_M32)
        x1.add_(ks[(step + 2) % 3] + step + 1).bitwise_and_(_M32)
    return x0, x1


def _bits_range(key, start: int, stop: int, device) -> torch.Tensor:
    """``bits(key, shape)`` flattened, elements [start, stop), as int64
    on `device`."""
    idx = torch.arange(start, stop, dtype=torch.int64, device=device)
    b0, b1 = _threefry2x32_torch(np.asarray(key, np.uint32), idx >> 32,
                                 idx & _M32)
    return b0.bitwise_xor_(b1)


def _normal_uniform(bits: torch.Tensor) -> torch.Tensor:
    """The uniform in [nextafter(-1, 0), 1) that ``jax.random.normal``
    feeds to erf_inv, from its uint32 bits (int64): 23 mantissa bits under
    the exponent of 1.0, minus 1, scaled and shifted in float32."""
    f = ((bits >> 9) | _ONE_F32_BITS).to(torch.int32).view(torch.float32)
    u = (f - 1.0) * _NORMAL_SPAN + _NORMAL_LO
    return torch.clamp_min(u, _NORMAL_LO)


def normal(key: np.ndarray, shape, *, device=None,
           chunk: int = NORMAL_CHUNK) -> torch.Tensor:
    """``jax.random.normal(key, shape, float32)`` on `device` (default the
    CPU): sqrt(2) * erfinv(u) of the uniform above.  The bits and u equal
    JAX's bit for bit; erfinv is torch's, another polynomial than XLA's,
    so the normals agree within a tolerance (tests/test_torch_legacy_agg.py
    states it)."""
    shape = tuple(int(d) for d in shape)
    n = math.prod(shape)
    out = torch.empty(n, dtype=torch.float32, device=device)
    for start in range(0, n, chunk):
        stop = min(start + chunk, n)
        u = _normal_uniform(_bits_range(key, start, stop, out.device))
        out[start:stop] = torch.erfinv(u).mul_(_SQRT2_F32)
    return out.reshape(shape)
