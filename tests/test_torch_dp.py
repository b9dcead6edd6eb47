"""The port's DP clip-and-noise held against the JAX package.

The uint32 words under the noise are bit-exact.  The noise itself goes
through log / sqrt / cos (Box-Muller), whose last bits differ between
libraries, and the clip factor through a row-norm sum in another order:
the output is held within rtol = 1e-5, atol = 1e-6.  Dead rows pass
through bit-identically.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.kernels.dp import ops as jdp_ops
from repro.kernels.dp import ref as jdp_ref
from repro.kernels.secure_agg import masking as jmasking
from repro_torch.kernels.dp import kernel as tkernel
from repro_torch.kernels.dp import ops, ref
from repro_torch.kernels.secure_agg import masking
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

MASKS = ["all", "one_dead", "two_dead"]


def _case(P, N, mask_kind, seed=0):
    rng = np.random.default_rng([seed, P, N, MASKS.index(mask_kind)])
    u = (rng.standard_normal((P, N)) * rng.uniform(0.01, 3.0, (P, 1))
         ).astype(np.float32)
    if mask_kind == "all":
        return u, None
    mask = np.ones(P, np.float32)
    dead = [P - 1] if mask_kind == "one_dead" else [0, P // 2]
    mask[dead] = 0.0
    u[dead[0]] = np.inf
    if len(dead) > 1:
        u[dead[1]] = np.nan
    return u, mask


@pytest.mark.parametrize("seed", [0, 77, 2 ** 32 - 1])
def test_noise_words_bitexact_and_normals_close(seed):
    row = np.arange(10, dtype=np.uint32)[:, None]
    offs = np.arange(5000, dtype=np.uint32)[None, :]
    for tag in (masking.DP_TAG_A, masking.DP_TAG_B):
        want = np.asarray(jmasking.mask_bits(np.uint32(seed ^ tag), row, offs))
        got = masking.mask_bits(seed ^ tag, row, offs).numpy()
        np.testing.assert_array_equal(got.astype(np.uint32), want)
    z = masking.normal_block(seed, row, offs).numpy()
    want = np.asarray(jmasking.normal_block(np.uint32(seed), row, offs))
    np.testing.assert_allclose(z, want, rtol=1e-5, atol=1e-6)
    assert abs(z.mean()) < 0.02 and abs(z.std() - 1.0) < 0.02


@pytest.mark.parametrize("mask_kind", MASKS)
@pytest.mark.parametrize("N", [1, 777, 4096])
@pytest.mark.parametrize("P", [2, 5, 10])
def test_clip_noise_within_tolerance(P, N, mask_kind):
    u, mask = _case(P, N, mask_kind)
    seed, clip, sigma = 4242 + N, 0.5, 1.0
    want = np.asarray(jdp_ref.clip_noise_reference(
        jnp.asarray(u), jnp.asarray([seed], jnp.uint32), clip, sigma,
        None if mask is None else jnp.asarray(mask)))
    got = ops.dp_clip_noise(torch.from_numpy(u), seed, clip, sigma,
                            mask=None if mask is None
                            else torch.from_numpy(mask))
    alive = np.ones(P, bool) if mask is None else mask > 0
    np.testing.assert_allclose(got.numpy()[alive], want[alive], rtol=1e-5,
                               atol=1e-6)
    assert np.array_equal(got.numpy()[~alive], u[~alive], equal_nan=True)


def test_clip_bounds_norm_without_noise():
    u, _ = _case(4, 1000, "all", seed=1)
    out = ops.dp_clip_noise(torch.from_numpy(u), 3, 0.5, 0.0)
    norms = out.norm(dim=1)
    assert bool((norms <= 0.5 * (1 + 1e-6)).all())
    small = ops.dp_clip_noise(torch.from_numpy(u * 1e-4), 3, 100.0, 0.0)
    assert torch.equal(small, torch.from_numpy(u * 1e-4))


def test_dp_tree_and_jax_tree_agree():
    rng = np.random.default_rng(2)
    tree = {"w": rng.standard_normal((3, 4, 5)).astype(np.float32),
            "b": [rng.standard_normal((3, 7)).astype(np.float32)]}
    want = jdp_ops.dp_clip_noise_tree(jax.tree.map(jnp.asarray, tree), 11,
                                      1.0, 0.3)
    got = ops.dp_clip_noise_tree(
        {"w": torch.from_numpy(tree["w"]),
         "b": [torch.from_numpy(tree["b"][0])]}, 11, 1.0, 0.3)
    np.testing.assert_allclose(got["w"].numpy(), np.asarray(want["w"]),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got["b"][0].numpy(), np.asarray(want["b"][0]),
                               rtol=1e-5, atol=1e-6)


def test_cpu_wrapper_takes_the_plain_version():
    u, mask = _case(5, 300, "one_dead", seed=3)
    t, m = torch.from_numpy(u), torch.from_numpy(mask)
    before = tkernel.clip_noise_flat.launches
    assert torch.equal(
        ops.dp_clip_noise(t, 8, 1.0, 0.5, mask=m, impl="fused"),
        ops.dp_clip_noise(t, 8, 1.0, 0.5, mask=m, impl="ref"))
    assert tkernel.clip_noise_flat.launches == before


# ----------------------------------------------------------------------
# the kernel's own arithmetic (ref.clip_noise_kernel_order): split stream
# keys and counter, each row's factor once.  The card tests hold the
# kernel against it.

@pytest.mark.parametrize("P", [1, 10, 16])
@pytest.mark.parametrize("seed", [0, 77, 2 ** 32 - 1])
def test_split_dp_words_bitexact(seed, P):
    """mix32_tail(key' ^ c') of both tags == masking.mask_bits(seed ^ tag,
    p, col) == the JAX package's words, counters 0..299, random counters
    and 2^32 - 1."""
    rng = np.random.default_rng(seed & 0xFFFF)
    offs = np.concatenate([np.arange(300), rng.integers(0, 2 ** 32, 300),
                           [2 ** 32 - 1]]).astype(np.uint32)
    row = np.arange(P, dtype=np.uint32)[:, None]
    t_offs = torch.from_numpy(offs.astype(np.int64))
    words = ref.split_dp_words(seed, P, t_offs)
    for tag, got in zip((masking.DP_TAG_A, masking.DP_TAG_B), words):
        assert got.shape == (P, offs.size)
        assert torch.equal(got, masking.mask_bits(
            seed ^ tag, torch.from_numpy(row.astype(np.int64)),
            t_offs[None, :]))
        want = np.asarray(jmasking.mask_bits(np.uint32(seed ^ tag), row,
                                             offs[None, :]))
        np.testing.assert_array_equal(got.numpy().astype(np.uint32), want)


@pytest.mark.parametrize("mask_kind", MASKS)
@pytest.mark.parametrize("N", [1, 129, 4097])
@pytest.mark.parametrize("P", [1, 10, 16, 17, 40])
def test_kernel_order_equals_plain_and_matches_jax(P, N, mask_kind):
    """The kernel's order == the port's plain version bit for bit, within
    rtol 1e-5, atol 1e-6 of JAX's reference; dead rows (inf, NaN) bit-
    untouched."""
    u, mask = _case(P, N, mask_kind, seed=5)
    seed, clip, sigma = 99 + N, 0.5, 1.0
    t = torch.from_numpy(u)
    m = None if mask is None else torch.from_numpy(mask)
    got = ref.clip_noise_kernel_order(t, seed, clip, sigma, m)
    assert got.dtype == torch.float32 and got.shape == (P, N)
    plain = ref.clip_noise_reference(t, seed, clip, sigma, m)
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  plain.numpy().view(np.uint32))
    want = np.asarray(jdp_ref.clip_noise_reference(
        jnp.asarray(u), jnp.asarray([seed], jnp.uint32), clip, sigma,
        None if mask is None else jnp.asarray(mask)))
    alive = np.ones(P, bool) if mask is None else mask > 0
    np.testing.assert_allclose(got.numpy()[alive], want[alive], rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_array_equal(got.numpy()[~alive].view(np.uint32),
                                  u[~alive].view(np.uint32))
