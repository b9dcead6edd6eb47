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

The `_traced` twins are the same hash on tensors, for the draws that must
happen on the device: the device tier draws one participation decision
and one shard per simulated device per sweep, and at 10^6 devices those
draws run inside the sweep's chunk loop (under `torch.func.vmap` over
institutions) rather than on the host.  The tensor arithmetic is the
masking PRG's own (`masking._mix32`, `masking._mul32`: int64 tensors
holding uint32 values, each product split so that no int64 product
overflows).  Counters may be Python ints, numpy values, 0-d tensors
or (C,) tensors, broadcast against each other; a negative counter wraps
mod 2^32, as the JAX package's uint32 conversion of an int32 does.
Counters that are not tensors are folded on the host as Python ints, so
a draw never copies a host value to the device.
`hash_u32_traced(s, *cs)` is bit-equal to `hash_u32(s, *cs)`, and
`uniform_traced` returns the same top-24-bit value as `uniform` as a
float32 (exactly representable, so host and device threshold decisions
agree when the threshold is a float32).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels.secure_agg import masking

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


# ----------------------------------------------------------------------
# the same hash on tensors (int64 holding uint32), for device-side draws

_M32 = masking.M32


def _u32_tensor(c, device) -> torch.Tensor:
    """A counter as an int64 tensor of its value mod 2^32."""
    if isinstance(c, torch.Tensor):
        return c.to(device=device, dtype=torch.int64) & _M32
    return torch.as_tensor(np.asarray(c).astype(np.int64) & _M32,
                           device=device)


def _u32_host(c):
    """A host counter mod 2^32: a Python int for a scalar, else an int64
    array of the values."""
    v = np.asarray(c).astype(np.int64) & _M32
    return int(v) if v.ndim == 0 else v


def hash_u32_traced(seed, *counters) -> torch.Tensor:
    """`hash_u32` on tensors: bit-equal for every (seed, counters) tuple,
    as an int64 tensor of uint32 values on the counters' device (the CPU
    when none is a tensor).

    The seed and the leading host counters fold on the host, and a scalar
    host counter after a tensor is folded as a Python int, so no call
    copies a host value to the device: on the card the hash adds no
    stream synchronization to the sweep's chunk loop."""
    args = (seed,) + counters
    device = next((c.device for c in args if isinstance(c, torch.Tensor)),
                  torch.device("cpu"))
    k = 0
    while k < len(args) and not isinstance(args[k], torch.Tensor):
        k += 1
    if k:
        h = hash_u32(*[_u32_host(a) for a in args[:k]])
        h = int(h) if h.ndim == 0 else _u32_tensor(h, device)
    else:
        h = masking._mix32(_u32_tensor(seed, device) ^ masking.GOLDEN)
        k = 1
    for c in args[k:]:
        c = _u32_host(c) if not isinstance(c, torch.Tensor) else c
        if isinstance(c, int):
            cg = (c * masking.GOLDEN) & _M32
        else:
            cg = masking._mul32(_u32_tensor(c, device), masking.GOLDEN)
        h = masking._mix32(h ^ cg)
    if isinstance(h, int):
        h = torch.tensor(h, dtype=torch.int64)
    return h


def uniform_traced(seed, *counters) -> torch.Tensor:
    """float32 uniform in [0, 1): the top 24 bits of `hash_u32_traced`,
    the value `uniform` returns, exactly."""
    bits = hash_u32_traced(seed, *counters)
    return (bits >> 8).to(torch.float32) * (2.0 ** -24)
