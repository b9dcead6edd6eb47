"""Fixed-point Z_2^32 codec for exact secure aggregation, plain PyTorch.

  encode  round(x * 2^frac_bits) (half to even), saturated at the int32
          edge, embedded two's-complement into uint32;
  decode  the centred lift of a uint32 share-sum (a bitcast to int32, not
          a value cast: the wrap IS the sign), times 2^-frac_bits, divided
          by the survivor count.

Field words travel as int64 tensors holding values in [0, 2^32) (see
`masking`); a share-sum travels as int32 bit patterns, the CUDA kernel's
own output, whose value cast to f32 is the centred lift.  The decoded mean
equals the true fixed-point mean while sum_{p alive} |u_p| <
2^(31 - frac_bits) per element.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels.secure_agg.masking import M32

FRAC_BITS = 16

# int32-edge saturation bounds: -2^31 is exact in f32, and 2^31 - 128 is
# the largest f32 below 2^31.
I32_MIN_F = float(np.float32(-(2.0 ** 31)))
I32_MAX_F = float(np.nextafter(np.float32(2.0 ** 31), np.float32(0.0)))


def encode_rows(x: torch.Tensor, frac_bits: int = FRAC_BITS) -> torch.Tensor:
    """f32 values -> uint32 field elements (as int64)."""
    scaled = torch.round(x.to(torch.float32) * float(2.0 ** frac_bits))
    scaled = torch.clamp(scaled, I32_MIN_F, I32_MAX_F)
    return scaled.to(torch.int64) & M32


def to_int32(words: torch.Tensor) -> torch.Tensor:
    """uint32 words (as int64) -> the same 32 bits as int32."""
    w = words & M32
    return torch.where(w >= 2 ** 31, w - 2 ** 32, w).to(torch.int32)


def decode_mean(word_sum: torch.Tensor, count,
                frac_bits: int = FRAC_BITS) -> torch.Tensor:
    """int32 share-sum bit patterns -> f32 survivor mean."""
    if word_sum.dtype != torch.int32:
        raise ValueError(f"share-sums are int32 bit patterns, got "
                         f"{word_sum.dtype}")
    return word_sum.to(torch.float32) * float(2.0 ** -frac_bits) / count


def decode_value(word: torch.Tensor, frac_bits: int = FRAC_BITS) -> torch.Tensor:
    """Single-element decode (count = 1) of int32 bit patterns."""
    return decode_mean(word, 1.0, frac_bits)
