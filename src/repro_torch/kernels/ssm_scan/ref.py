"""Plain PyTorch versions of the selective scan.

`ssm_scan_reference`: a Python loop over time (exact, O(T) sequential),
the reference's ``lax.scan`` oracle step for step.
`ssm_scan_chunked`: an associative scan within chunks and a sequential
carry across them, the plain path the reference picks on a CPU.
"""
from __future__ import annotations

import torch


def ssm_scan_reference(a, bx, B, C, h0):
    """a, bx: (Bz, T, di); B, C: (Bz, T, N); h0: (Bz, di, N) fp32 ->
    y (Bz, T, di) in a.dtype, h_last (Bz, di, N) fp32, where per token
    h = a_t[:, None] * h + bx_t[:, None] * B_t[None, :] and
    y_t = Σ_n h[:, n] * C_t[n]."""
    af, bxf, Bf, Cf = (x.float() for x in (a, bx, B, C))
    h = h0.float()
    ys = []
    for t in range(a.shape[1]):
        h = af[:, t, :, None] * h + bxf[:, t, :, None] * Bf[:, t, None, :]
        ys.append(torch.einsum("bdn,bn->bd", h, Cf[:, t]))
    return torch.stack(ys, dim=1).to(a.dtype), h


def _associative_scan(a, b):
    """Inclusive scan along dim 1 of the pairs (a_t, b_t) under
    (a1, b1) . (a2, b2) = (a1 a2, a2 b1 + b2), in log2(length) doubling
    steps: afterwards b_t is the state reached from 0 and a_t the product
    of the decays up to t."""
    d, length = 1, a.shape[1]
    while d < length:
        b = torch.cat([b[:, :d], a[:, d:] * b[:, :-d] + b[:, d:]], dim=1)
        a = torch.cat([a[:, :d], a[:, d:] * a[:, :-d]], dim=1)
        d *= 2
    return a, b


def ssm_scan_chunked(a, bx, B, C, h0, chunk: int = 256):
    """The same function as `ssm_scan_reference`: T is cut into chunks of
    the largest divisor of T up to `chunk`; within a chunk the states come
    from an associative scan over (Bz, chunk, di, N) intermediates, and
    the last state carries into the next chunk."""
    from repro_torch.models.layers import _fit_chunk
    Bz, T, di = a.shape
    N = B.shape[-1]
    chunk = _fit_chunk(T, chunk)
    nc = T // chunk
    af = a.float().reshape(Bz, nc, chunk, di, 1)
    bf = (bx.float()[..., None] * B.float()[:, :, None, :]).reshape(
        Bz, nc, chunk, di, N)
    Cc = C.float().reshape(Bz, nc, chunk, N)
    h = h0.float()
    ys = []
    for ci in range(nc):
        aa, bb = _associative_scan(af[:, ci], bf[:, ci])
        hs = aa * h[:, None] + bb
        ys.append(torch.einsum("btdn,btn->btd", hs, Cc[:, ci]))
        h = hs[:, -1]
    return torch.cat(ys, dim=1).to(a.dtype), h
