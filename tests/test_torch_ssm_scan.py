"""The port's selective scan (plain versions and dispatch) held against
the JAX package on the CPU: `ssm_scan_reference` and `ssm_scan_chunked`
against JAX's oracles and against its Pallas kernel run in interpret
mode, in fp32 (what hymba feeds it) and in bf16; `ssm_scan_lookback`, the
CUDA kernel's chunk decomposition, against JAX's oracle at the kernel's
edges of T.

Tolerances: atol = rtol = 3e-2 for bf16 y and 1e-4 for fp32 y and for
the fp32 states, the JAX package's own bounds for its kernel against its
oracles (`test_kernels_ssm_scan.py`).  The CUDA kernel is held against
the same plain version on the card (`test_torch_cuda.py`).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.kernels.ssm_scan import ssm_scan_chunked as jax_ssm_scan_chunked
from repro.kernels.ssm_scan import (
    ssm_scan_reference as jax_ssm_scan_reference,
)
from repro.kernels.ssm_scan.kernel import ssm_scan_btd as jax_ssm_scan_btd
from repro_torch.kernels.ssm_scan import (
    ssm_scan, ssm_scan_chunked, ssm_scan_reference,
)
from repro_torch.kernels.ssm_scan import kernel as ssm_kernel
from repro_torch.kernels.ssm_scan.ref import ssm_scan_lookback
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

TOL = {"float32": 1e-4, "bfloat16": 3e-2}


def _inputs(Bz, T, di, N, dtype, seed=0, h0_scale=0.0):
    """(jax, torch) pairs of the same values: a in (0.45, 0.95), bx, B, C
    normal, all rounded once to `dtype`; h0 fp32."""
    rng = np.random.default_rng([seed, Bz, T, di, N])
    a = (1 / (1 + np.exp(-rng.standard_normal((Bz, T, di))))) * 0.5 + 0.45
    xs = [a.astype(np.float32)] + [
        rng.standard_normal(s).astype(np.float32)
        for s in ((Bz, T, di), (Bz, T, N), (Bz, T, N))]
    out = []
    for x in xs:
        j = jnp.asarray(x).astype(dtype)
        out.append((j, torch.from_numpy(np.array(j, np.float32)).to(
            getattr(torch, dtype))))
    h0 = (rng.standard_normal((Bz, di, N)) * h0_scale).astype(np.float32)
    out.append((jnp.asarray(h0), torch.from_numpy(h0)))
    return out


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _close(got, want, tol):
    np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("h0_scale", [0.0, 0.5])
def test_reference_and_chunked_match_jax(dtype, h0_scale):
    pairs = _inputs(2, 96, 24, 8, dtype, h0_scale=h0_scale)
    jargs, targs = [j for j, _ in pairs], [t for _, t in pairs]
    jy, jh = jax_ssm_scan_reference(*jargs)
    ty, th = ssm_scan_reference(*targs)
    assert ty.dtype == getattr(torch, dtype) and th.dtype == torch.float32
    _close(ty, jy, TOL[dtype])
    _close(th, jh, 1e-4)
    jy, jh = jax_ssm_scan_chunked(*jargs, chunk=32)
    ty, th = ssm_scan_chunked(*targs, chunk=32)
    _close(ty, jy, TOL[dtype])
    _close(th, jh, 1e-4)
    _close(ty, ssm_scan_reference(*targs)[0], TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ops_match_jax_pallas_kernel_in_interpret_mode(dtype):
    pairs = _inputs(1, 48, 24, 16, dtype, seed=1, h0_scale=0.3)
    jy, jh = jax_ssm_scan_btd(*(j for j, _ in pairs), block_t=16,
                              block_d=8, interpret=True)
    for impl in ("auto", "pallas", "fused", "chunked", "ref"):
        ty, th = ssm_scan(*(t for _, t in pairs), impl=impl)
        _close(ty, jy, TOL[dtype])
        _close(th, jh, 1e-4)


def test_state_chaining_and_decode_equals_scan_tail():
    """Two parts with the state carried equal one pass (T = 45 has no
    divisor near the chunk, so `chunked` fits chunks of 15 and 9); T = 1
    steps (a decode loop) equal the same pass token by token."""
    a, bx, B, C, h0 = (t for _, t in _inputs(1, 45, 16, 4, "float32",
                                             seed=3, h0_scale=0.2))
    y, h = ssm_scan_reference(a, bx, B, C, h0)
    for impl in ("chunked", "auto"):
        y1, h1 = ssm_scan(a[:, :27], bx[:, :27], B[:, :27], C[:, :27], h0,
                          impl=impl)
        y2, h2 = ssm_scan(a[:, 27:], bx[:, 27:], B[:, 27:], C[:, 27:], h1,
                          impl=impl)
        _close(torch.cat([y1, y2], dim=1), y, 1e-5)
        _close(h2, h, 1e-5)
    ht = h0
    for t in range(a.shape[1]):
        yt, ht = ssm_scan(a[:, t:t + 1], bx[:, t:t + 1], B[:, t:t + 1],
                          C[:, t:t + 1], ht)
        _close(yt[:, 0], y[:, t], 1e-5)
    _close(ht, h, 1e-5)


def test_dispatch_and_cpu_wrapper():
    a, bx, B, C, h0 = (t for _, t in _inputs(1, 6, 8, 4, "float32"))
    before = ssm_kernel.ssm_scan_btd.launches
    y, _ = ssm_kernel.ssm_scan_btd(a, bx, B, C, h0, block_t=4, block_d=3)
    assert ssm_kernel.ssm_scan_btd.launches == before  # CPU: plain version
    _close(y, ssm_scan_reference(a, bx, B, C, h0)[0], 0)
    with pytest.raises(ValueError, match="unknown ssm_scan impl"):
        ssm_scan(a, bx, B, C, h0, impl="scan")


# the kernel's edges: T = 2, the decode threshold and each side of it, a
# chunk and each side of it, several chunks composed onto an anchor every
# `anchor` chunks (1: every chunk's inclusive state; ANCHOR: the kernel's,
# all from h0 at these T); a = 1 (decays of 1 carried through the
# composition) and a near 0 (a chunk's decay product underflows to 0)
CHUNK, ANCHOR, DECODE_T = (ssm_kernel.CHUNK, ssm_kernel.ANCHOR,
                           ssm_kernel.DECODE_T)
LOOKBACK_CASES = [
    (2, 1, ""), (DECODE_T - 1, 1, ""), (DECODE_T, 1, ""),
    (DECODE_T + 1, 1, ""), (CHUNK - 1, 1, ""), (CHUNK, 1, ""),
    (CHUNK + 1, 1, ""), (CHUNK + 1, 2, ""), (4 * CHUNK + 5, 1, ""),
    (4 * CHUNK + 5, 4, ""), (4 * CHUNK + 5, 3, "a1"),
    (4 * CHUNK + 5, 3, "a0"), (4 * CHUNK + 5, ANCHOR, ""),
]
LOOKBACK_T = max(T for T, _, _ in LOOKBACK_CASES)
# JAX's oracle, compiled once for every case: each case's inputs are
# padded to LOOKBACK_T with a = 1, bx = 0, which carries the state at T
# unchanged to the end
_JAX_REFERENCE = jax.jit(jax_ssm_scan_reference)


@pytest.mark.parametrize("T,anchor,kind", LOOKBACK_CASES, ids=str)
def test_kernel_decomposition_matches_jax(T, anchor, kind):
    Bz, di, N = 2, 16, 8
    rng = np.random.default_rng([T, anchor, len(kind)])
    a = rng.uniform(0.45, 0.95, (Bz, T, di))
    if kind == "a1":
        a = np.ones_like(a)
    elif kind == "a0":
        a = rng.uniform(1e-4, 1e-2, (Bz, T, di))
    bx = rng.standard_normal((Bz, T, di))
    B, C = rng.standard_normal((2, Bz, T, N))
    h0 = rng.standard_normal((Bz, di, N)).astype(np.float32)
    pad = ((0, 0), (0, LOOKBACK_T - T), (0, 0))
    jy, jh = _JAX_REFERENCE(
        *(jnp.asarray(np.pad(x, pad, constant_values=v), jnp.float32)
          for x, v in ((a, 1.0), (bx, 0.0), (B, 0.0), (C, 0.0))),
        jnp.asarray(h0))
    ty, th = ssm_scan_lookback(
        *(torch.from_numpy(x.astype(np.float32)) for x in (a, bx, B, C)),
        torch.from_numpy(h0), chunk=CHUNK, anchor=anchor,
        decode_t=DECODE_T)
    _close(ty, np.asarray(jy)[:, :T], TOL["float32"])
    _close(th, jh, TOL["float32"])
