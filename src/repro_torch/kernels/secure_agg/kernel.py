"""Wrappers of the hand-written Hopper secure-aggregation kernels
(``csrc/secure_agg.cu``): the fused MPC round in both domains, and the
legacy two-stage round's aggregate of pre-masked shares in both domains.

A wrapper given CPU tensors computes its kernel's plain PyTorch version
(`ref.py`): that is the CPU path the tests run.  Given CUDA tensors it
launches the kernel or raises; there is no fallback.  Each wrapper counts
its launches in its ``launches`` attribute, so a run can show that it went
through the kernel; a fused wrapper counts the launches of its P > 16
kernel in ``launches_wide``.
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
    work = _cuda.wide_accumulators(P, N, 0, updates.device)
    _cuda.launch("masked_rolling_update_f32", updates.device,
                 updates.data_ptr(), out.data_ptr(), _cuda.ptr(m), P, N,
                 int(seed), float(alpha), _cuda.ptr(work))
    if P <= _cuda.FUSED_MAX_ROWS:
        masked_rolling_update_flat.launches += 1
    else:
        masked_rolling_update_flat.launches_wide += 1
    return out


masked_rolling_update_flat.launches = 0
masked_rolling_update_flat.launches_wide = 0


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
    work = _cuda.wide_accumulators(P, N, 1, updates.device)
    _cuda.launch("masked_field_wsum_f32", updates.device,
                 updates.data_ptr(), words.data_ptr(), _cuda.ptr(m), P, N,
                 int(seed), float(2.0 ** frac_bits), _cuda.ptr(work))
    if P <= _cuda.FUSED_MAX_ROWS:
        masked_field_wsum_flat.launches += 1
    else:
        masked_field_wsum_flat.launches_wide += 1
    return words


masked_field_wsum_flat.launches = 0
masked_field_wsum_flat.launches_wide = 0


# params dtype -> the kernel's dtype code (csrc/secure_agg.cu)
_PARAM_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def rolling_update_flat(shares: torch.Tensor, params: torch.Tensor,
                        alpha) -> torch.Tensor:
    """Legacy float round.  shares: (P, N) f32 pre-masked shares, any P;
    params: (N,) f32/bf16/f16; alpha: scalar -> (N,) in params.dtype,
    ``p + alpha * (mean_p shares - p)``.  Replaces the TPU kernel
    ``repro/kernels/secure_agg/kernel.py:rolling_update_flat``."""
    if shares.device.type == "cpu":
        return _ref.rolling_update_reference(shares, params, alpha)
    P, N = _cuda.check_rows(shares, "shares")
    if params.dtype not in _PARAM_DTYPES:
        raise ValueError(f"params must be float32, bfloat16 or float16, "
                         f"got {params.dtype}")
    if params.shape != (N,) or params.device != shares.device:
        raise ValueError(f"params must be ({N},) on {shares.device}, got "
                         f"{tuple(params.shape)} on {params.device}")
    if not params.is_contiguous():
        raise ValueError("params must be contiguous")
    out = torch.empty_like(params)
    if N == 0:
        return out
    _cuda.launch("rolling_update_f32", shares.device, shares.data_ptr(),
                 params.data_ptr(), out.data_ptr(), P, N, float(alpha),
                 _PARAM_DTYPES[params.dtype])
    rolling_update_flat.launches += 1
    return out


rolling_update_flat.launches = 0


def field_wsum_flat(shares: torch.Tensor) -> torch.Tensor:
    """Legacy int round's share-sum.  shares: (P, N) uint32 field shares,
    any P -> (N,) int32 bit patterns of the wrapping column sum.  Replaces
    the TPU kernel ``repro/kernels/secure_agg/kernel.py:field_wsum_flat``."""
    if shares.device.type == "cpu":
        return _ref.field_wsum_reference(shares)
    P, N = _cuda.check_rows(shares, "shares", dtype=torch.uint32)
    words = torch.empty((N,), dtype=torch.int32, device=shares.device)
    if N == 0:
        return words
    _cuda.launch("field_wsum_u32", shares.device, shares.data_ptr(),
                 words.data_ptr(), P, N)
    field_wsum_flat.launches += 1
    return words


field_wsum_flat.launches = 0
