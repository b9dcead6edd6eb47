"""Wrapper of the hand-written Hopper DP clip-and-noise kernel
(``csrc/secure_agg.cu:clip_noise_kernel``).

CPU tensors get the plain PyTorch version; CUDA tensors launch the kernel
or raise.  ``clip_noise_flat.launches`` counts the launches of the P <= 16
kernel, ``clip_noise_flat.launches_wide`` those of the P > 16 one.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _cuda
from repro_torch.kernels.dp import ref as _ref


def clip_noise_flat(updates: torch.Tensor, row_norms: torch.Tensor,
                    seed: int, clip: float, sigma: float,
                    mask=None) -> torch.Tensor:
    """updates: (P, N) raw rows; row_norms: (P, 1) f32 from
    `ref._row_norms`; seed: uint32 int -> (P, N) clipped and noised rows,
    dead rows passed through.  Replaces the TPU kernel
    ``repro/kernels/dp/kernel.py:clip_noise_flat``."""
    if updates.device.type == "cpu":
        return _ref.clip_noise_reference(updates, seed, clip, sigma, mask,
                                         row_norms)
    P, N = _cuda.check_rows(updates)
    norms = row_norms.to(device=updates.device,
                         dtype=torch.float32).reshape(P).contiguous()
    out = torch.empty_like(updates)
    if N == 0:
        return out
    m = _cuda.mask_arg(mask, P, updates.device)
    _cuda.launch("clip_noise_f32", updates.device, updates.data_ptr(),
                 out.data_ptr(), norms.data_ptr(), _cuda.ptr(m), P, N,
                 int(seed), float(clip), float(sigma))
    if P <= _cuda.FUSED_MAX_ROWS:
        clip_noise_flat.launches += 1
    else:
        clip_noise_flat.launches_wide += 1
    return out


clip_noise_flat.launches = 0
clip_noise_flat.launches_wide = 0
