"""Wrappers of the hand-written Hopper secure-aggregation kernels
(``csrc/secure_agg.cu``).

A wrapper given CPU tensors computes its kernel's plain PyTorch version
(`ref.py`): that is the CPU path the tests run.  Given CUDA tensors it
launches the kernel or raises; there is no fallback.  Each wrapper counts
its launches in its ``launches`` attribute, so a run can show that it went
through the kernel.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _cuda
from repro_torch.kernels.secure_agg import field
from repro_torch.kernels.secure_agg import ref as _ref


def masked_rolling_update_flat(updates: torch.Tensor, seed: int, alpha,
                               mask=None) -> torch.Tensor:
    """Fused float MPC round.  updates: (P, N) raw rows; seed: uint32 int;
    alpha: float; mask: optional (P,) participation -> (P, N) blended rows
    in updates.dtype.  Replaces the TPU kernel
    ``repro/kernels/secure_agg/kernel.py:masked_rolling_update_flat``."""
    if updates.device.type == "cpu":
        return _ref.masked_rolling_update_reference(updates, seed, alpha, mask)
    P, N = _cuda.check_rows(updates)
    out = torch.empty_like(updates)
    if N == 0:
        return out
    m = _cuda.mask_arg(mask, P, updates.device)
    _cuda.launch("masked_rolling_update_f32", updates.device,
                 updates.data_ptr(), out.data_ptr(), _cuda.ptr(m), P, N,
                 int(seed), float(alpha))
    masked_rolling_update_flat.launches += 1
    return out


masked_rolling_update_flat.launches = 0


def masked_field_wsum_flat(updates: torch.Tensor, seed: int, mask=None, *,
                           frac_bits: int = field.FRAC_BITS) -> torch.Tensor:
    """Z_2^32 MPC share-sum.  updates: (P, N) raw rows -> (N,) exact
    survivor share-sums as int32 bit patterns.  Replaces the TPU kernel
    ``repro/kernels/secure_agg/kernel.py:masked_field_wsum_flat``."""
    if updates.device.type == "cpu":
        return _ref.masked_field_wsum_reference(updates, seed, mask,
                                                frac_bits=frac_bits)
    P, N = _cuda.check_rows(updates)
    # the kernel writes uint32 words; int32 holds their bits unchanged
    words = torch.empty((N,), dtype=torch.int32, device=updates.device)
    if N == 0:
        return words
    m = _cuda.mask_arg(mask, P, updates.device)
    _cuda.launch("masked_field_wsum_f32", updates.device,
                 updates.data_ptr(), words.data_ptr(), _cuda.ptr(m), P, N,
                 int(seed), float(2.0 ** frac_bits))
    masked_field_wsum_flat.launches += 1
    return words


masked_field_wsum_flat.launches = 0
