"""Wrapper of the hand-written Hopper selective-scan kernel
(``csrc/ssm_scan.cu``).

CPU tensors get the plain PyTorch version (`ref.ssm_scan_reference`);
CUDA tensors launch the kernel or raise: there is no fallback.  The
kernel has no backward: a CUDA call whose output autograd or a
``torch.func`` grad transform would track raises
(`_cuda.refuse_transforms`); train through ``impl="ref"``.
``ssm_scan_btd.launches`` counts the calls that launch it.  A call with
T <= DECODE_T launches the decode kernel; a longer one clears the
look-back's flags in a workspace the C source sizes (one
cudaMemsetAsync) and launches the chunked kernel, one block per CHUNK
tokens of a channel group (`ref.ssm_scan_lookback` mirrors its
arithmetic).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _cuda
from repro_torch.kernels.ssm_scan import ref as _ref

DTYPES = (torch.bfloat16, torch.float32)
MAX_STATE = 32
# csrc/ssm_scan.cu's kChunk, kAnchor and kDecodeT, which the CPU mirror
# `ref.ssm_scan_lookback` is tested with
CHUNK, ANCHOR, DECODE_T = 128, 32, 8


def _check(a, bx, B, C, h0) -> None:
    for name, t in (("a", a), ("bx", bx), ("B", B), ("C", C), ("h0", h0)):
        if t.device.type != "cuda" or t.device != a.device:
            raise ValueError(f"{name} must be a CUDA tensor on {a.device}, "
                             f"got {t.device}")
    if a.dtype not in DTYPES:
        raise ValueError(f"dtype must be one of {DTYPES}, got {a.dtype}")
    for name, t in (("bx", bx), ("B", B), ("C", C)):
        if t.dtype != a.dtype:
            raise ValueError(f"{name} must be {a.dtype} like a, got "
                             f"{t.dtype}")
    if a.dim() != 3 or B.dim() != 3:
        raise ValueError(f"a must be (Bz, T, di) and B (Bz, T, N), got "
                         f"shapes {tuple(a.shape)} and {tuple(B.shape)}")
    Bz, T, di = a.shape
    N = B.shape[2]
    if tuple(bx.shape) != tuple(a.shape):
        raise ValueError(f"bx must be {tuple(a.shape)} like a, got "
                         f"{tuple(bx.shape)}")
    if tuple(B.shape[:2]) != (Bz, T) or tuple(C.shape) != tuple(B.shape):
        raise ValueError(f"B and C must be (Bz={Bz}, T={T}, N) alike, got "
                         f"{tuple(B.shape)} and {tuple(C.shape)}")
    if not 1 <= N <= MAX_STATE:
        raise ValueError(f"the state size N must be in [1, {MAX_STATE}], "
                         f"got {N}")
    for name, t in (("a", a), ("bx", bx), ("B", B), ("C", C)):
        if t.shape[2] > 1 and t.stride(2) != 1:
            raise ValueError(f"{name} needs a unit stride along its last "
                             f"axis, got strides {t.stride()}")
    if tuple(h0.shape) != (Bz, di, N):
        raise ValueError(f"h0 must be {(Bz, di, N)}, got {tuple(h0.shape)}")
    if h0.dtype != torch.float32 or not h0.is_contiguous():
        raise ValueError("h0 must be contiguous float32")
    if not (1 <= Bz < 2 ** 31 and 1 <= T < 2 ** 31 and 1 <= di < 2 ** 31):
        raise ValueError("Bz, T and di must be in [1, 2^31)")


def ssm_scan_btd(a, bx, B, C, h0, *, block_t: int = 256,
                 block_d: int = 512):
    """a, bx: (Bz, T, di); B, C: (Bz, T, N); all bf16 or all fp32, with a
    unit stride along the last axis; h0: (Bz, di, N) fp32, N <= 32.
    Returns (y (Bz, T, di) in a.dtype, h_last (Bz, di, N) fp32).  Any
    T >= 1 and any di.  `block_t` and `block_d` are the TPU kernel's
    tiles, accepted for signature parity: the CUDA kernel's own tiles do
    not change the result.  Replaces the TPU kernel
    ``repro/kernels/ssm_scan/kernel.py:ssm_scan_btd``."""
    if a.device.type == "cpu":
        return _ref.ssm_scan_reference(a, bx, B, C, h0)
    _cuda.refuse_transforms("ssm_scan_btd", a, bx, B, C, h0)
    _check(a, bx, B, C, h0)
    Bz, T, di = a.shape
    N = B.shape[2]
    y = torch.empty((Bz, T, di), dtype=a.dtype, device=a.device)
    h_last = torch.empty_like(h0)
    nbytes = _cuda.query("ssm_scan_workspace_bytes", Bz, T, di, N)
    if nbytes < 0:
        raise ValueError(f"(Bz, T, di) = {(Bz, T, di)} needs 2^31 or more "
                         f"blocks of the chunked kernel")
    ws = (torch.empty(nbytes, dtype=torch.uint8, device=a.device)
          if nbytes else None)
    strides = [s for t in (a, bx, B, C) for s in t.stride()[:2]]
    _cuda.launch("ssm_scan_fwd", a.device, a.data_ptr(), bx.data_ptr(),
                 B.data_ptr(), C.data_ptr(), h0.data_ptr(), y.data_ptr(),
                 h_last.data_ptr(), _cuda.ptr(ws), nbytes,
                 int(a.dtype == torch.bfloat16), Bz, T, di, N, *strides)
    ssm_scan_btd.launches += 1
    return y, h_last


ssm_scan_btd.launches = 0
