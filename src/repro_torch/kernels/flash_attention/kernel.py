"""Wrapper of the hand-written Hopper flash attention kernel
(``csrc/flash_attention.cu``).

CPU tensors get the plain PyTorch version (`ref.attention_reference`);
CUDA tensors launch the kernel or raise: there is no fallback.  The
kernel has no backward: a CUDA call whose output autograd or a
``torch.func`` grad transform would track raises
(`_cuda.refuse_transforms`); train through ``impl="ref"``.
``flash_attention_bhsd.launches`` counts the launches.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import _cuda
from repro_torch.kernels.flash_attention import ref as _ref

HEAD_DIMS = (32, 64, 80, 128)
DTYPES = (torch.bfloat16, torch.float32)


def _check(q, k, v, out) -> None:
    for name, t in (("q", q), ("k", k), ("v", v), ("out", out)):
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError(f"{name} must be a CUDA tensor on {q.device}, "
                             f"got {t.device}")
        if t.dtype != q.dtype:
            raise ValueError(f"{name} must be {q.dtype}, got {t.dtype}")
        if t.dim() != 4:
            raise ValueError(f"{name} must be 4-d (B, H, S, hd), got shape "
                             f"{tuple(t.shape)}")
        if t.shape[3] > 1 and t.stride(3) != 1:
            raise ValueError(f"{name} needs a unit stride along hd, got "
                             f"strides {t.stride()}")
    if q.dtype not in DTYPES:
        raise ValueError(f"dtype must be one of {DTYPES}, got {q.dtype}")
    B, Hq, Sq, hd = q.shape
    if hd not in HEAD_DIMS:
        raise ValueError(f"head_dim must be one of {HEAD_DIMS}, got {hd}")
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != hd:
        raise ValueError(f"k and v must be (B={B}, Hkv, Skv, hd={hd}) "
                         f"alike, got {tuple(k.shape)} and {tuple(v.shape)}")
    if Hq % k.shape[1]:
        raise ValueError(f"q heads {Hq} must be a multiple of kv heads "
                         f"{k.shape[1]}")
    if tuple(out.shape) != tuple(q.shape):
        raise ValueError(f"out must be {tuple(q.shape)}, got "
                         f"{tuple(out.shape)}")
    if max(Sq, k.shape[2]) >= 2 ** 31 or B >= 2 ** 16 or Hq >= 2 ** 16:
        raise ValueError("sequence lengths must fit int32 and B, H the "
                         "launch grid")


def flash_attention_bhsd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True, window: int = 0,
                         block_q: int = 256, block_k: int = 512,
                         out: torch.Tensor | None = None) -> torch.Tensor:
    """q: (B, Hq, Sq, hd); k, v: (B, Hkv, Skv, hd) -> (B, Hq, Sq, hd) in
    q.dtype.  Any Sq and Skv; inputs may be strided views (unit stride
    along hd).  `out`, if given, is a (B, Hq, Sq, hd) view to write into.
    `block_q` and `block_k` are the TPU kernel's tiles, accepted for
    signature parity: the CUDA kernel's own tiles do not change the
    result.  Replaces the TPU kernel
    ``repro/kernels/flash_attention/kernel.py:flash_attention_bhsd``."""
    if q.device.type == "cpu":
        o = _ref.attention_reference(q, k, v, causal=causal, window=window)
        if out is None:
            return o
        out.copy_(o)
        return out
    _cuda.refuse_transforms("flash_attention_bhsd", q, k, v)
    if out is None:
        out = torch.empty_like(q, memory_format=torch.contiguous_format)
    _check(q, k, v, out)
    B, Hq, Sq, hd = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    strides = [s for t in (q, k, v, out) for s in t.stride()[:3]]
    _cuda.launch("flash_attention_fwd", q.device, q.data_ptr(), k.data_ptr(),
                 v.data_ptr(), out.data_ptr(), int(q.dtype == torch.bfloat16),
                 B, Hq, Hkv, Sq, Skv, hd, *strides, int(bool(causal)),
                 int(window), 1.0 / math.sqrt(hd))
    flash_attention_bhsd.launches += 1
    return out


flash_attention_bhsd.launches = 0
