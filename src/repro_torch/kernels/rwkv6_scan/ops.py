"""Public WKV6 op: backend dispatch.

``impl``: "pallas" and "fused" name the hand-written kernel (its plain
version for CPU tensors), "ref" the plain version, "plain" the plain
version on any device (what the reference picks off the TPU: its
``lax.scan`` oracle), "auto" the kernel for CUDA tensors and the plain
version on the CPU.  The reference quietly takes the plain path when T
is not a multiple of its time tile; the CUDA kernel takes any T, so
there is no such branch here."""
from __future__ import annotations

from repro_torch.kernels.rwkv6_scan import kernel as _k
from repro_torch.kernels.rwkv6_scan import ref as _ref

IMPLS = ("auto", "plain", "pallas", "fused", "ref")


def wkv6(r, k, v, w, u, s0, *, impl: str = "auto", block_t: int = 128):
    """r, k, v, w: (B, T, H, hd); u: (H, hd); s0: (B, H, hd, hd) fp32 ->
    (y, s_final).  `block_t` is accepted for signature parity only."""
    if impl not in IMPLS:
        raise ValueError(f"unknown wkv6 impl {impl!r}; valid impls: {IMPLS}")
    if impl == "auto":
        impl = "pallas" if r.device.type == "cuda" else "ref"
    if impl in ("ref", "plain"):
        return _ref.wkv6_reference(r, k, v, w, u, s0)
    return _k.wkv6_bthd(r, k, v, w, u, s0, block_t=block_t)
