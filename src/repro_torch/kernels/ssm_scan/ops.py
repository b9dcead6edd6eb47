"""Public selective-scan op: backend dispatch.

``impl``: "pallas" and "fused" name the hand-written kernel (its plain
version for CPU tensors), "chunked" and "ref" the plain versions,
"plain" "chunked" on any device (what the reference picks off the TPU),
"auto" the kernel for CUDA tensors and "chunked" on the CPU.  The
reference fits its tiles to divisors of T and di; the CUDA kernel takes
any T and di, so nothing is fitted here.  Under a step count
(`launch.op_cost`) "ref" is counted as its token loop and every other
impl as "chunked"."""
from __future__ import annotations

from repro_torch.kernels.ssm_scan import kernel as _k
from repro_torch.kernels.ssm_scan import ref as _ref
from repro_torch.launch import op_cost

IMPLS = ("auto", "plain", "pallas", "fused", "chunked", "ref")


def ssm_scan(a, bx, B, C, h0, *, impl: str = "auto", block_t: int = 256,
             block_d: int = 512):
    """a, bx: (Bz, T, di); B, C: (Bz, T, N); h0: (Bz, di, N) -> (y,
    h_last).  `block_t` and `block_d` are accepted for signature parity
    only."""
    if impl not in IMPLS:
        raise ValueError(f"unknown ssm_scan impl {impl!r}; valid impls: "
                         f"{IMPLS}")
    counter = op_cost.active()
    if counter is not None:
        return _counted(counter, impl, a, bx, B, C, h0)
    if impl == "auto":
        impl = "pallas" if a.device.type == "cuda" else "chunked"
    if impl in ("chunked", "plain"):
        return _ref.ssm_scan_chunked(a, bx, B, C, h0)
    if impl == "ref":
        return _ref.ssm_scan_reference(a, bx, B, C, h0)
    return _k.ssm_scan_btd(a, bx, B, C, h0, block_t=block_t,
                           block_d=block_d)


def _counted(counter, impl, a, bx, B, C, h0):
    """The scan as a counted region: the token loop, or the chunked scan
    one chunk at a time."""
    if impl == "ref":
        return counter.region("ssm", _ref.ssm_scan_reference,
                              (a, bx, B, C, h0), time_args=(0, 1, 2, 3),
                              layout="ssm")
    from repro_torch.models.layers import _fit_chunk
    chunk = _fit_chunk(a.shape[1], 256)
    return counter.region("ssm", _ref.ssm_scan_chunked, (a, bx, B, C, h0),
                          {"chunk": chunk}, time_args=(0, 1, 2, 3),
                          unit=chunk, layout="ssm")

