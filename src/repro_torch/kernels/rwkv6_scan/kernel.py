"""Wrapper of the hand-written Hopper WKV6 kernel (``csrc/wkv6.cu``).

CPU tensors get the plain PyTorch version (`ref.wkv6_reference`); CUDA
tensors launch the kernel or raise: there is no fallback.  The kernel
has no backward: a CUDA call whose output autograd or a ``torch.func``
grad transform would track raises (`_cuda.refuse_transforms`); train
through ``impl="ref"``.  ``wkv6_bthd.launches`` counts the launches.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _cuda
from repro_torch.kernels.rwkv6_scan import ref as _ref

HEAD_DIMS = (16, 32, 64, 128)
DTYPES = (torch.bfloat16, torch.float32)


def _check(r, k, v, w, u, s0) -> None:
    for name, t in (("r", r), ("k", k), ("v", v), ("w", w), ("u", u),
                    ("s0", s0)):
        if t.device.type != "cuda" or t.device != r.device:
            raise ValueError(f"{name} must be a CUDA tensor on {r.device}, "
                             f"got {t.device}")
    if r.dtype not in DTYPES:
        raise ValueError(f"r, k, v dtype must be one of {DTYPES}, got "
                         f"{r.dtype}")
    for name, t in (("k", k), ("v", v)):
        if t.dtype != r.dtype:
            raise ValueError(f"{name} must be {r.dtype} like r, got "
                             f"{t.dtype}")
    if w.dtype not in (torch.float32, r.dtype):
        raise ValueError(f"w must be float32 or {r.dtype}, got {w.dtype}")
    if r.dim() != 4:
        raise ValueError(f"r must be 4-d (B, T, H, hd), got shape "
                         f"{tuple(r.shape)}")
    B, T, H, hd = r.shape
    if hd not in HEAD_DIMS:
        raise ValueError(f"head_dim must be one of {HEAD_DIMS}, got {hd}")
    for name, t in (("k", k), ("v", v), ("w", w)):
        if tuple(t.shape) != tuple(r.shape):
            raise ValueError(f"{name} must be {tuple(r.shape)} like r, got "
                             f"{tuple(t.shape)}")
    for name, t in (("r", r), ("k", k), ("v", v), ("w", w)):
        if t.stride(3) != 1:
            raise ValueError(f"{name} needs a unit stride along hd, got "
                             f"strides {t.stride()}")
    if tuple(u.shape) != (H, hd):
        raise ValueError(f"u must be (H={H}, hd={hd}), got "
                         f"{tuple(u.shape)}")
    if tuple(s0.shape) != (B, H, hd, hd):
        raise ValueError(f"s0 must be {(B, H, hd, hd)}, got "
                         f"{tuple(s0.shape)}")
    for name, t in (("u", u), ("s0", s0)):
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous float32")
    if T < 1 or T >= 2 ** 31 or B * H >= 2 ** 31:
        raise ValueError("T must be in [1, 2^31) and B * H fit the grid")


def wkv6_bthd(r, k, v, w, u, s0, *, block_t: int = 128):
    """r, k, v: (B, T, H, hd) of one dtype (bf16 or fp32); w: the same
    shape in fp32 or r's dtype; u: (H, hd) fp32; s0: (B, H, hd, hd) fp32.
    Returns (y (B, T, H, hd) in r.dtype, s_final (B, H, hd, hd) fp32).
    Any T >= 1; r, k, v, w may be strided views with a unit stride along
    hd.  `block_t` is the TPU kernel's time tile, accepted for signature
    parity: the CUDA kernel takes any T and its own chunk does not change
    the result.  Replaces the TPU kernel
    ``repro/kernels/rwkv6_scan/kernel.py:wkv6_bthd``."""
    if r.device.type == "cpu":
        return _ref.wkv6_reference(r, k, v, w, u, s0)
    _cuda.refuse_transforms("wkv6_bthd", r, k, v, w, u, s0)
    _check(r, k, v, w, u, s0)
    B, T, H, hd = r.shape
    y = torch.empty((B, T, H, hd), dtype=r.dtype, device=r.device)
    s_final = torch.empty_like(s0)
    strides = [s for t in (r, k, v, w) for s in t.stride()[:3]]
    _cuda.launch("wkv6_fwd", r.device, r.data_ptr(), k.data_ptr(),
                 v.data_ptr(), w.data_ptr(), u.data_ptr(), s0.data_ptr(),
                 y.data_ptr(), s_final.data_ptr(),
                 int(r.dtype == torch.bfloat16),
                 int(w.dtype == torch.bfloat16), B, T, H, hd, *strides)
    wkv6_bthd.launches += 1
    return y, s_final


wkv6_bthd.launches = 0
