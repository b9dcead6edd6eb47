"""Counter-based host-side RNG for fault schedules: numpy copies of the
JAX package's ``chaos/rng.py`` host functions, bit-exact.

Fault decisions ("does hospital i drop out of round r?") are pure
functions of (seed, stream, counters), so two runs with the same seed
produce bit-identical fault traces, the overlay and the consensus
simulator re-derive the same decision without shared RNG state, and
composed schedules never perturb each other's streams.  The hash is the
lowbias32 avalanche finalizer over a Weyl sequence, the construction of
the secure-aggregation PRG (`kernels/secure_agg/masking.py`).  NOT
cryptographically secure; it does not need to be.

The JAX package's traced twins (`hash_u32_traced`, `uniform_traced`)
serve the device tier, which is not ported yet.
"""
from __future__ import annotations

import numpy as np

_GOLDEN = np.uint32(0x9E3779B9)   # 2^32 / phi — Weyl increment
_MUL_A = np.uint32(0x7FEB352D)    # lowbias32 (Walker) finalizer constants
_MUL_B = np.uint32(0x846CA68B)


def _mix32(x: np.ndarray) -> np.ndarray:
    """Bijective 32-bit avalanche finalizer (lowbias32), numpy uint32."""
    x = np.asarray(x, np.uint32)
    with np.errstate(over="ignore"):
        x = x ^ (x >> np.uint32(16))
        x = x * _MUL_A
        x = x ^ (x >> np.uint32(15))
        x = x * _MUL_B
        x = x ^ (x >> np.uint32(16))
    return x


def hash_u32(seed, *counters) -> np.ndarray:
    """uint32 hash of (seed, c0, c1, ...); counters broadcast against each
    other, so e.g. hash_u32(s, round, np.arange(P)) vectorizes over P."""
    h = _mix32(np.uint32(seed) ^ _GOLDEN)
    for c in counters:
        with np.errstate(over="ignore"):
            h = _mix32(h ^ (np.asarray(c, np.uint32) * _GOLDEN))
    return h


def uniform(seed, *counters) -> np.ndarray:
    """float64 uniform in [0, 1) — top 24 bits of the counter hash."""
    bits = hash_u32(seed, *counters)
    return (bits >> np.uint32(8)).astype(np.float64) * 2.0 ** -24
