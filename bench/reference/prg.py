"""The random words a federation round derives from its key, in NumPy.

The overlay turns a round's key into its merge seed through Threefry-2x32
(``jax.random.split`` and ``jax.random.bits`` under
``jax_threefry_partitionable``), and the DP mechanism draws each
(institution, column) normal from a counter hash of that seed through
Box-Muller.  The reference needs the same noise to follow a DP round, so
the arithmetic is written here again from its definition: Threefry-2x32
with 20 rounds, the lowbias32 finalizer over a Weyl counter, and
Box-Muller over two tagged uniform streams.  The fault schedule's
dropout draws, which decide the hospitals up in a round, come from the
same finalizer folded over (seed, stream, round, hospital).
"""
from __future__ import annotations

import math

import numpy as np

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_KS_PARITY = 0x1BD11BDA
GOLDEN = 0x9E3779B9
MUL_A = 0x7FEB352D
MUL_B = 0x846CA68B
PAIR_MUL = 0x85EBCA6B
DP_TAG_A = 0xD9A11E5
DP_TAG_B = 0x5E11A9D
DROPOUT_STREAM = 0x0D0D
_U24 = np.float32(2.0 ** -24)
_TWO_PI = np.float32(2.0 * math.pi)


def _u32(x):
    return np.asarray(x, dtype=np.uint64).astype(np.uint32) \
        if not isinstance(x, np.ndarray) or x.dtype != np.uint32 else x


def _rotl(x, r):
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def threefry2x32(key, x0, x1):
    """Threefry-2x32 (20 rounds) of the (2,) uint32 `key` over the counter
    words (x0, x1)."""
    with np.errstate(over="ignore"):
        k0, k1 = np.uint32(key[0]), np.uint32(key[1])
        ks = (k0, k1, np.uint32(k0 ^ k1 ^ np.uint32(_KS_PARITY)))
        x = [_u32(x0) + ks[0], _u32(x1) + ks[1]]
        for step in range(5):
            for r in _ROTATIONS[step % 2]:
                x[0] = x[0] + x[1]
                x[1] = _rotl(x[1], r) ^ x[0]
            x[0] = x[0] + ks[(step + 1) % 3]
            x[1] = x[1] + ks[(step + 2) % 3] + np.uint32(step + 1)
    return x[0], x[1]


def split(key, num=2):
    """(num, 2) uint32 keys: Threefry of the counters 0..num-1."""
    idx = np.arange(num, dtype=np.uint64)
    hi = (idx >> np.uint64(32)).astype(np.uint32)
    lo = (idx & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    b0, b1 = threefry2x32(np.asarray(key, np.uint32), hi, lo)
    return np.stack([b0, b1], axis=1)


def first_word(key) -> int:
    """The first uint32 of the key's bit stream (counter 0, words xored)."""
    b0, b1 = threefry2x32(np.asarray(key, np.uint32),
                          np.zeros(1, np.uint32), np.zeros(1, np.uint32))
    return int((b0 ^ b1)[0])


def merge_seed(round_key) -> int:
    """The round's MPC seed: the first word of the second half of the
    round key's split."""
    return first_word(split(round_key)[1])


def _mix32(x):
    with np.errstate(over="ignore"):
        x = x ^ (x >> np.uint32(16))
        x = x * np.uint32(MUL_A)
        x = x ^ (x >> np.uint32(15))
        x = x * np.uint32(MUL_B)
        return x ^ (x >> np.uint32(16))


def counter_words(seed, stream, offs):
    """uint32 words of (seed, stream, counter), broadcast together."""
    with np.errstate(over="ignore"):
        h = _mix32(np.uint32(seed) ^ np.uint32(GOLDEN))
        h = _mix32(h ^ (_u32(stream) * np.uint32(PAIR_MUL)))
        return _mix32(h ^ (_u32(offs) * np.uint32(GOLDEN)))


def dp_normals(seed: int, rows: int, cols: int) -> np.ndarray:
    """(rows, cols) float32 standard normals of the DP mechanism: row p,
    column n from the counter words of (seed ^ tag, p, n), u1 in (0, 1],
    u2 in [0, 1), sqrt(-2 log u1) cos(2 pi u2), each step in float32."""
    row = np.arange(rows, dtype=np.uint32)[:, None]
    col = np.arange(cols, dtype=np.uint32)[None, :]
    b1 = counter_words(np.uint32(seed) ^ np.uint32(DP_TAG_A), row, col)
    b2 = counter_words(np.uint32(seed) ^ np.uint32(DP_TAG_B), row, col)
    u1 = ((b1 >> np.uint32(8)) + np.uint32(1)).astype(np.float32) * _U24
    u2 = (b2 >> np.uint32(8)).astype(np.float32) * _U24
    r = np.sqrt(np.float32(-2.0) * np.log(u1))
    return (r * np.cos(_TWO_PI * u2)).astype(np.float32)


def fault_uniform(seed, *counters) -> np.ndarray:
    """float64 uniforms in [0, 1) of the fault schedules: the top 24 bits
    of the lowbias32 finalizer folded over the seed and then each counter
    times the Weyl increment; counters broadcast together."""
    with np.errstate(over="ignore"):
        h = _mix32(np.uint32(seed) ^ np.uint32(GOLDEN))
        for c in counters:
            h = _mix32(h ^ (_u32(c) * np.uint32(GOLDEN)))
    return (h >> np.uint32(8)).astype(np.float64) * 2.0 ** -24


def dropout_up(seed: int, rate: float, round_index: int, n: int
               ) -> np.ndarray:
    """(n,) bool: the hospitals up in a round when each misses it on its
    own with probability `rate`."""
    return fault_uniform(seed, DROPOUT_STREAM, round_index,
                         np.arange(n)) >= rate
