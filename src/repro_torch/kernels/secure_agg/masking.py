"""Counter-based pairwise-mask PRG, plain-PyTorch version.

The mask value is a pure function of (seed, stream, element counter): a
splitmix32-style finalizer over a Weyl sequence, the same construction as
the JAX package's ``kernels/secure_agg/masking.py`` and as the CUDA kernels
in ``csrc/secure_agg.cu``, so all three produce the same uint32 words.

uint32 arithmetic runs in int64 tensors holding values in [0, 2^32):
torch has too few uint32 operations on the CPU.  Every product is split
into two 16-bit halves of the constant so that no int64 product
overflows, and every result is masked back to 32 bits.

NOT cryptographically secure: a deployment would swap `_mix32` for an
AES/ChaCha counter block keyed by the pairwise Diffie-Hellman secret.
"""
from __future__ import annotations

import math

import numpy as np
import torch

MASK_SCALE = 1.0   # masks ~ U[-MASK_SCALE, MASK_SCALE)

M32 = 0xFFFFFFFF
GOLDEN = 0x9E3779B9     # 2^32 / phi, the Weyl increment
MUL_A = 0x7FEB352D      # lowbias32 (Walker) finalizer constants
MUL_B = 0x846CA68B
PAIR_MUL = 0x85EBCA6B   # murmur3 c2, decorrelates the pair streams

# Domain-separation tags of the two DP Box-Muller streams (kernels/dp).
DP_TAG_A = 0xD9A11E5
DP_TAG_B = 0x5E11A9D

_TWO_PI_F32 = float(np.float32(2.0 * math.pi))
_U24 = 2.0 ** -24


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for int64 x in [0, 2^32) and a uint32 constant c,
    with every int64 product below 2^48."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & M32


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """Bijective 32-bit avalanche finalizer (lowbias32)."""
    x = x ^ (x >> 16)
    x = _mul32(x, MUL_A)
    x = x ^ (x >> 15)
    x = _mul32(x, MUL_B)
    return x ^ (x >> 16)


def _as_u32(v, device) -> torch.Tensor:
    if isinstance(v, torch.Tensor):
        return v.to(device=device, dtype=torch.int64) & M32
    return torch.as_tensor(np.asarray(v, np.int64) & M32, device=device)


def mask_bits(seed, pair, offs, device=None) -> torch.Tensor:
    """uint32 PRG word (as int64) for (seed, pair stream, element counter);
    the three arguments broadcast against each other."""
    if device is None:
        device = next((t.device for t in (seed, pair, offs)
                       if isinstance(t, torch.Tensor)), torch.device("cpu"))
    seed, pair, offs = (_as_u32(v, device) for v in (seed, pair, offs))
    h = _mix32(seed ^ GOLDEN)
    h = _mix32(h ^ _mul32(pair, PAIR_MUL))
    return _mix32(h ^ _mul32(offs, GOLDEN))


def mask_block(seed, pair, offs, scale: float = MASK_SCALE,
               device=None) -> torch.Tensor:
    """f32 mask values in [-scale, scale); `pair` (npairs, 1) with offs
    (1, bn) gives (npairs, bn)."""
    bits = mask_bits(seed, pair, offs, device)
    u = (bits >> 8).to(torch.float32) * _U24
    return scale * (2.0 * u - 1.0)


# On the CPU, torch hands float32 log, sqrt and cos to MKL's vector math
# library, split across its OpenMP pool.  A process's first such pooled
# call now and then returns one thread's share at about 5e-5 relative error
# (9 of 400 fresh processes run 12 at a time on 8 cores; ROADMAP queue C).
# A call on fewer elements than the pool's grain (2048) runs on the
# calling thread alone and gives the same bits every time, so the CPU
# computes them in chunks of SERIAL_CHUNK; the card runs each in one call.
SERIAL_CHUNK = 1024


def _serial(fn, x: torch.Tensor) -> torch.Tensor:
    """fn(x) for an elementwise torch function; on the CPU in chunks of
    SERIAL_CHUNK elements (the same values, each call on one thread)."""
    if x.device.type != "cpu" or x.numel() <= SERIAL_CHUNK:
        return fn(x)
    flat = x.reshape(-1)
    out = torch.empty_like(flat)
    for start in range(0, flat.numel(), SERIAL_CHUNK):
        stop = start + SERIAL_CHUNK
        fn(flat[start:stop], out=out[start:stop])
    return out.reshape(x.shape)


def box_muller(u1: torch.Tensor, u2: torch.Tensor) -> torch.Tensor:
    """sqrt(-2 log u1) cos(2 pi u2) in f32, each operation rounded as the
    DP kernel rounds it."""
    r = _serial(torch.sqrt, -2.0 * _serial(torch.log, u1))
    return r * _serial(torch.cos, _TWO_PI_F32 * u2)


def normal_block(seed, row, offs, device=None) -> torch.Tensor:
    """f32 standard-normal noise for a block of counters, the DP kernel's
    PRG: Box-Muller over two tagged uniform streams, u1 in (0, 1] (finite
    log) and u2 in [0, 1)."""
    seed = int(seed) & M32
    b1 = mask_bits(seed ^ DP_TAG_A, row, offs, device)
    b2 = mask_bits(seed ^ DP_TAG_B, row, offs, device)
    u1 = ((b1 >> 8) + 1).to(torch.float32) * _U24
    u2 = (b2 >> 8).to(torch.float32) * _U24
    return box_muller(u1, u2)


def pair_list(n: int):
    """The (i, j), i < j, pairs in lexicographic order: pair k's stream
    index is its position here."""
    return [(i, j) for i in range(n) for j in range(i + 1, n)]


def pair_sign_matrix(n: int) -> np.ndarray:
    """(P, npairs) f32 with S[i, k] = +1, S[j, k] = -1 for pair k = (i, j).
    Columns sum to 0, so the net masks S @ m cancel in the share-sum."""
    idx = pair_list(n)
    s = np.zeros((n, max(len(idx), 1)), np.float32)
    for k, (i, j) in enumerate(idx):
        s[i, k] = 1.0
        s[j, k] = -1.0
    return s
