"""Plain PyTorch versions of the selective scan.

`ssm_scan_reference`: a Python loop over time (exact, O(T) sequential),
the reference's ``lax.scan`` oracle step for step.
`ssm_scan_chunked`: an associative scan within chunks and a sequential
carry across them, the plain path the reference picks on a CPU.
`ssm_scan_lookback`: the CUDA kernel's decomposition, step for step, for
the tests.
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


def ssm_scan_lookback(a, bx, B, C, h0, *, chunk: int = 128,
                      anchor: int = 32, decode_t: int = 8):
    """The same function as `ssm_scan_reference`, in the order the CUDA
    kernel (``csrc/ssm_scan.cu``) computes it.  T <= `decode_t` is a
    token loop (the decode kernel).  Else each chunk of `chunk` tokens is
    scanned from a zero state to its pair (A, b), A the product of its
    decays and b the state reached; every `anchor`-th chunk is an anchor,
    and the state entering chunk k composes the pairs of the chunks after
    the anchor below it (chunk stop = k // anchor * anchor - 1), from the
    back, onto that anchor's inclusive state A h_in + b (h0 when
    stop < 0); the chunk is scanned again from h_in for y."""
    Bz, T, di = a.shape
    if T <= decode_t:
        return ssm_scan_reference(a, bx, B, C, h0)
    af, bxf, Bf, Cf = (x.float() for x in (a, bx, B, C))
    h0 = h0.float()

    def scan(h, lo, hi):
        ys = []
        for t in range(lo, hi):
            h = af[:, t, :, None] * h + bxf[:, t, :, None] * Bf[:, t, None, :]
            ys.append(torch.einsum("bdn,bn->bd", h, Cf[:, t]))
        return h, ys

    bounds = [(t0, min(t0 + chunk, T)) for t0 in range(0, T, chunk)]
    pairs, inclusive, ys = [], [], []
    for k, (lo, hi) in enumerate(bounds):
        b_k, _ = scan(torch.zeros_like(h0), lo, hi)
        A_k = torch.ones_like(af[:, 0])
        for t in range(lo, hi):
            A_k = A_k * af[:, t]
        pairs.append((A_k[..., None], b_k))
        stop = k // anchor * anchor - 1
        PA, Pb = torch.ones_like(A_k[..., None]), torch.zeros_like(h0)
        for j in range(k - 1, stop, -1):
            Aj, bj = pairs[j]
            PA, Pb = PA * Aj, PA * bj + Pb
        h_in = PA * (inclusive[stop] if stop >= 0 else h0) + Pb
        inclusive.append(pairs[k][0] * h_in + b_k)
        h, chunk_ys = scan(h_in, lo, hi)
        ys += chunk_ys
    return torch.stack(ys, dim=1).to(a.dtype), h
