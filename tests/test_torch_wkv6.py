"""The port's WKV6 recurrence (plain version and dispatch) held against
the JAX package on the CPU: `wkv6_reference` and `ops.wkv6` against JAX's
``lax.scan`` oracle and against its Pallas kernel run in interpret mode,
with bf16 r, k, v and fp32 w (the mix the rwkv6 model feeds it) and in
fp32 throughout.

Tolerances: atol = rtol = 3e-2 for bf16 y and 1e-4 for fp32 y and for
the fp32 states, the JAX package's own bounds for its kernel against its
oracle (`test_kernels_rwkv6.py`).  The CUDA kernel is held against the
same plain version on the card (`test_torch_cuda.py`).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels.rwkv6_scan import wkv6_reference as jax_wkv6_reference
from repro.kernels.rwkv6_scan.kernel import wkv6_bthd as jax_wkv6_bthd
from repro_torch.kernels.rwkv6_scan import kernel as wkv_kernel
from repro_torch.kernels.rwkv6_scan import wkv6, wkv6_reference
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

TOL = {"float32": 1e-4, "bfloat16": 3e-2}


def _inputs(B, T, H, hd, dtype, seed=0, s0_scale=0.0):
    """(jax, torch) pairs of the same values: r, k, v rounded once to
    `dtype`, w = exp(-exp(.)) in (0, 1) in fp32, u and s0 in fp32."""
    rng = np.random.default_rng([seed, B, T, H, hd])
    rkv = [rng.standard_normal((B, T, H, hd)).astype(np.float32)
           for _ in range(3)]
    w = np.exp(-np.exp(rng.standard_normal((B, T, H, hd)) - 1.0)).astype(
        np.float32)
    u = (rng.standard_normal((H, hd)) * 0.1).astype(np.float32)
    s0 = (rng.standard_normal((B, H, hd, hd)) * s0_scale).astype(np.float32)
    out = []
    for x in rkv:
        j = jnp.asarray(x).astype(dtype)
        out.append((j, torch.from_numpy(np.array(j, np.float32)).to(
            getattr(torch, dtype))))
    for x in (w, u, s0):
        out.append((jnp.asarray(x), torch.from_numpy(x)))
    return out


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _close(got, want, tol):
    np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("s0_scale", [0.0, 0.5])
def test_reference_matches_jax(dtype, s0_scale):
    pairs = _inputs(2, 24, 3, 32, dtype, s0_scale=s0_scale)
    jy, js = jax_wkv6_reference(*(j for j, _ in pairs))
    ty, ts = wkv6_reference(*(t for _, t in pairs))
    assert ty.dtype == getattr(torch, dtype) and ts.dtype == torch.float32
    _close(ty, jy, TOL[dtype])
    _close(ts, js, 1e-4)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_ops_match_jax_pallas_kernel_in_interpret_mode(dtype):
    pairs = _inputs(1, 32, 2, 32, dtype, seed=1, s0_scale=0.3)
    jy, js = jax_wkv6_bthd(*(j for j, _ in pairs), block_t=8,
                           interpret=True)
    for impl in ("auto", "pallas", "fused", "ref"):
        ty, ts = wkv6(*(t for _, t in pairs), impl=impl)
        _close(ty, jy, TOL[dtype])
        _close(ts, js, 1e-4)


def test_state_chaining_and_decode_equals_scan_tail():
    """Two halves with the state carried equal one pass; T = 1 steps (a
    decode loop) equal the same pass token by token."""
    (r, k, v, w, u, s0) = (t for _, t in _inputs(2, 20, 2, 16, "float32",
                                                 seed=2, s0_scale=0.2))
    y, s = wkv6(r, k, v, w, u, s0)
    y1, s1 = wkv6(r[:, :9], k[:, :9], v[:, :9], w[:, :9], u, s0)
    y2, s2 = wkv6(r[:, 9:], k[:, 9:], v[:, 9:], w[:, 9:], u, s1)
    _close(torch.cat([y1, y2], dim=1), y, 1e-5)
    _close(s2, s, 1e-5)
    st = s0
    for t in range(r.shape[1]):
        yt, st = wkv6(r[:, t:t + 1], k[:, t:t + 1], v[:, t:t + 1],
                      w[:, t:t + 1], u, st)
        _close(yt[:, 0], y[:, t], 1e-5)
    _close(st, s, 1e-5)


def test_dispatch_and_cpu_wrapper():
    (r, k, v, w, u, s0) = (t for _, t in _inputs(1, 5, 1, 16, "float32"))
    before = wkv_kernel.wkv6_bthd.launches
    y, _ = wkv_kernel.wkv6_bthd(r, k, v, w, u, s0, block_t=3)
    assert wkv_kernel.wkv6_bthd.launches == before     # CPU: plain version
    _close(y, wkv6_reference(r, k, v, w, u, s0)[0], 0)
    with pytest.raises(ValueError, match="unknown wkv6 impl"):
        wkv6(r, k, v, w, u, s0, impl="chunked")
