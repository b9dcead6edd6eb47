"""The port's flash attention plain path held against the JAX package on
the CPU: `flash_attention` (model layout) against the JAX Pallas kernel
run in interpret mode, and `attention_reference` (kernel layout) against
JAX's `attention_reference`, on the JAX kernel tests' shapes (GQA group 2
and 3, MQA, head_dim 32 / 64 / 80, a ragged 192, windows 16 and 100, a
non-causal ragged case).

Tolerances: atol = rtol = 2e-2 in bf16 and 2e-5 in fp32, the JAX
package's own bounds for its kernel against its plain version
(`test_kernels_flash_attention.py`).  The CUDA kernel itself is held
against the same plain version on the card (`test_torch_cuda.py`).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels.flash_attention import flash_attention as jax_flash
from repro.kernels.flash_attention.kernel import (
    flash_attention_bhsd as jax_flash_bhsd,
)
from repro.kernels.flash_attention.ref import (
    attention_reference as jax_attention_reference,
)
from repro_torch.kernels.flash_attention import (
    attention_reference, flash_attention,
)
from repro_torch.kernels.flash_attention import kernel as fa_kernel
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

# (B, S, Hq, Hkv, hd, dtype, causal, window)
CASES = [
    (2, 192, 6, 3, 32, "float32", True, 0),     # ragged: the JAX op pads
    (2, 192, 6, 3, 32, "bfloat16", True, 0),
    (1, 512, 4, 1, 80, "float32", True, 0),     # MQA, hd 80
    (1, 96, 15, 5, 64, "bfloat16", True, 0),    # group 3 (smollm's 15/5)
    (2, 256, 4, 2, 64, "float32", True, 16),
    (2, 256, 4, 2, 64, "float32", True, 100),
    (1, 200, 4, 2, 64, "float32", False, 0),    # non-causal ragged
]
TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def _inputs(B, S, Hq, Hkv, hd, dtype, seed=0):
    """Model-layout (B, S, H, hd) q, k, v as (jax, torch) pairs of the same
    values, rounded once to `dtype`."""
    rng = np.random.default_rng([seed, B, S, Hq, Hkv, hd])
    out = []
    for h in (Hq, Hkv, Hkv):
        x = jnp.asarray(rng.standard_normal((B, S, h, hd)).astype(
            np.float32)).astype(dtype)
        out.append((x, torch.from_numpy(np.array(x, np.float32)).to(
            getattr(torch, dtype))))
    return out


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("case", CASES, ids=str)
def test_flash_attention_matches_jax_kernel(case):
    B, S, Hq, Hkv, hd, dtype, causal, window = case
    (jq, tq), (jk, tk), (jv, tv) = _inputs(B, S, Hq, Hkv, hd, dtype)
    want = jax_flash(jq, jk, jv, causal=causal, window=window, block_q=64,
                     block_k=128, interpret=True)
    got = flash_attention(tq, tk, tv, causal=causal, window=window,
                          block_q=64, block_k=128)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    tol = TOL[dtype]
    np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=tol)


@pytest.mark.parametrize("case", CASES, ids=str)
def test_attention_reference_matches_jax(case):
    B, S, Hq, Hkv, hd, dtype, causal, window = case
    (jq, tq), (jk, tk), (jv, tv) = _inputs(B, S, Hq, Hkv, hd, dtype, seed=1)
    t = jnp.einsum
    want = jax_attention_reference(t("bshd->bhsd", jq), t("bshd->bhsd", jk),
                                   t("bshd->bhsd", jv), causal=causal,
                                   window=window)
    got = attention_reference(tq.transpose(1, 2), tk.transpose(1, 2),
                              tv.transpose(1, 2), causal=causal,
                              window=window)
    tol = TOL[dtype]
    np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=tol)


def test_kernel_layout_entry_matches_jax_kernel():
    """The (B, H, S, hd) entry, non-causal, against the JAX kernel called
    directly; plus rows with no key to attend to (Sq > Skv under a
    window) come back 0, as JAX's plain version returns them."""
    rng = np.random.default_rng(2)
    q, k, v = (rng.standard_normal((1, 2, 128, 64)).astype(np.float32)
               for _ in range(3))
    want = jax_flash_bhsd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                          causal=False, block_q=64, block_k=64,
                          interpret=True)
    got = fa_kernel.flash_attention_bhsd(*map(torch.from_numpy, (q, k, v)),
                                         causal=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=2e-5)
    q2 = rng.standard_normal((1, 2, 96, 64)).astype(np.float32)
    k2, v2 = k[:, :, :40], v[:, :, :40]
    want = jax_attention_reference(jnp.asarray(q2), jnp.asarray(k2),
                                   jnp.asarray(v2), causal=True, window=8)
    got = attention_reference(*map(torch.from_numpy, (q2, k2, v2)),
                              causal=True, window=8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=2e-5)
    assert bool((got[:, :, 48:] == 0).all())


def test_cpu_wrapper_takes_the_plain_path_and_counts_no_launch():
    q = torch.zeros((1, 2, 8, 48))       # a head_dim the kernel refuses
    before = fa_kernel.flash_attention_bhsd.launches
    out = torch.empty_like(q)
    assert fa_kernel.flash_attention_bhsd(q, q, q, out=out) is out
    assert fa_kernel.flash_attention_bhsd.launches == before
