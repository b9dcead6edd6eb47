"""The port's legacy two-stage MPC round held against the JAX package:
`fold_in` keys and threefry normal draws, the masked shares, the
aggregate of pre-masked shares (TPU kernels `rolling_update_flat` and
`field_wsum_flat`, run here in interpret mode) and `secure_rolling_update`.

Tolerances:
  * `fold_in`, the threefry bits and the uniform under ``normal``: equal.
    ``normal`` is sqrt(2) * erfinv(u), with XLA's erfinv polynomial in
    torch ops; XLA may contract its multiply-adds into FMAs and log1p may
    differ in the last bit, so normals agree within rtol = 1e-5, atol =
    1e-6 (measured: at most 3 ulps, 2.4e-7 relative); a net mask, a sum
    of up to P - 1 of them, within (P - 1) times that.
  * The int-domain share words and share-sums: equal, at every block_n.
  * `secure_rolling_update`: float domain within the reference's own
    cancellation bound, atol = P * 1e-6 (tests/test_secure_agg_fused.py);
    int domain equal at power-of-two P with alpha = 1 and within atol =
    1e-6 otherwise (XLA turns x / P into x * (1 / P) and may contract the
    blend into an FMA; ROADMAP queue C).
  * Narrow params: the f32 result's tolerance plus one ulp of the output
    type (2^-7 relative for bf16, 2^-10 for f16).
"""
import numpy as np
import pytest
import torch

import jax
import jax.flatten_util  # noqa: F401 (the reference's rolling_update_tree
import jax.numpy as jnp  # reaches it as an attribute of jax)

from repro.core import secure_agg as jsa
from repro.kernels.secure_agg import kernel as jkernel
from repro.kernels.secure_agg import ops as jops
from repro_torch import random as prng
from repro_torch.core import secure_agg as tsa
from repro_torch.kernels.secure_agg import kernel as tkernel
from repro_torch.kernels.secure_agg import ops, ref
from repro_torch.pytree import tree_flatten, treedef_str
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

SEEDS = [0, 7, 2 ** 31 + 3, 2 ** 32 - 1]
ULP_RTOL = {torch.float32: 0.0, torch.bfloat16: 2.0 ** -7,
            torch.float16: 2.0 ** -10}
JAX_DTYPES = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16,
              torch.float16: jnp.float16}


def _updates(P, N, seed=0):
    rng = np.random.default_rng([seed, P, N])
    return [rng.standard_normal(N).astype(np.float32) for _ in range(P)]


def _u32(words: torch.Tensor) -> np.ndarray:
    return words.numpy().view(np.uint32)


# ----------------------------------------------------------------------
# keys and draws

@pytest.mark.parametrize("seed", SEEDS)
def test_fold_in_bitexact(seed):
    key, ours = jax.random.PRNGKey(seed), prng.PRNGKey(seed)
    for data in (0, 1, 9, 2 ** 31, 2 ** 32 - 1):
        want = np.asarray(jax.random.fold_in(key, data))
        got = prng.fold_in(ours, data)
        assert got.dtype == np.uint32 and got.shape == (2,)
        np.testing.assert_array_equal(got, want)
    for i, j in ((0, 1), (3, 1), (2, 9)):
        np.testing.assert_array_equal(tsa.pairwise_seed(ours, i, j),
                                      np.asarray(jsa.pairwise_seed(key, i,
                                                                   j)))
        np.testing.assert_array_equal(tsa.pairwise_seed(ours, i, j),
                                      tsa.pairwise_seed(ours, j, i))


@pytest.mark.parametrize("shape", [(1,), (7,), (300, 3), (40001,)])
@pytest.mark.parametrize("seed", SEEDS)
def test_bits_and_uniform_bitexact(seed, shape):
    key, ours = jax.random.PRNGKey(seed), prng.PRNGKey(seed)
    n = int(np.prod(shape))
    want = np.asarray(jax.random.bits(key, shape, jnp.uint32)).ravel()
    got = prng._bits_range(ours, 0, n, "cpu")
    np.testing.assert_array_equal(got.numpy().astype(np.uint32), want)
    np.testing.assert_array_equal(prng.bits(ours, shape).ravel(), want)
    # a chunk of counters is the same slice of the stream
    mid = n // 3
    np.testing.assert_array_equal(
        prng._bits_range(ours, mid, n, "cpu").numpy().astype(np.uint32),
        want[mid:])
    lo = np.nextafter(np.float32(-1.0), np.float32(0.0))
    u_jax = np.asarray(jax.random.uniform(key, shape, jnp.float32, lo, 1.0))
    u = prng._normal_uniform(got).numpy()
    np.testing.assert_array_equal(u.view(np.uint32),
                                  u_jax.ravel().view(np.uint32))


@pytest.mark.parametrize("seed", SEEDS)
def test_normal_within_tolerance_and_chunk_invariant(seed):
    key, ours = jax.random.PRNGKey(seed), prng.PRNGKey(seed)
    shape = (333, 301)
    want = np.asarray(jax.random.normal(key, shape, jnp.float32))
    got = prng.normal(ours, shape)
    assert got.dtype == torch.float32 and tuple(got.shape) == shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    assert torch.equal(prng.normal(ours, shape, chunk=1000), got)


@pytest.mark.parametrize("P", [2, 3, 6])
def test_mask_for_within_tolerance_and_masks_cancel(P):
    key, ours = jax.random.PRNGKey(11 + P), prng.PRNGKey(11 + P)
    N = 2000
    total = torch.zeros(N)
    for i in range(P):
        want = np.asarray(jsa.mask_for(key, i, P, (N,)))
        got = tsa.mask_for(ours, i, P, (N,))
        np.testing.assert_allclose(got.numpy(), want,
                                   rtol=(P - 1) * 1e-5,
                                   atol=(P - 1) * 1e-6)
        total += got
    # the pairwise pads cancel in the sum (the JAX package's own bound)
    np.testing.assert_allclose(total.numpy(), 0.0, atol=P * 1e-5)


def test_individual_share_is_masked():
    ups = [torch.ones(128) * i for i in range(4)]
    shares = tsa.make_shares(ups, prng.PRNGKey(7))
    assert shares.dtype == torch.float32 and shares.shape == (4, 128)
    for i in range(4):
        assert float((shares[i] - ups[i]).abs().max()) > 0.1
    words = tsa.make_shares_int(ups, prng.PRNGKey(7))
    assert words.dtype == torch.uint32
    enc = np.round(np.arange(4) * 2.0 ** 16).astype(np.uint32)
    for i in range(4):
        assert not np.array_equal(_u32(words.view(torch.int32))[i],
                                  np.full(128, enc[i]))


# ----------------------------------------------------------------------
# the int domain: exact

@pytest.mark.parametrize("P,N", [(1, 50), (2, 777), (5, 4096), (10, 1001),
                                 (17, 300)])
def test_int_share_words_and_sums_bitexact(P, N, monkeypatch):
    ups = _updates(P, N, seed=1)
    key, ours = jax.random.PRNGKey(3 * P), prng.PRNGKey(3 * P)
    want = np.asarray(jsa.make_shares_int([jnp.asarray(u) for u in ups],
                                          key))
    got = tsa.make_shares_int([torch.from_numpy(u) for u in ups], ours)
    assert got.dtype == torch.uint32 and got.shape == (P, N)
    np.testing.assert_array_equal(got.numpy(), want)
    # the shares built one column chunk at a time are the same words
    monkeypatch.setattr(tsa, "SHARES_CHUNK", 97)
    assert torch.equal(tsa.make_shares_int([torch.from_numpy(u)
                                            for u in ups], ours).view(
        torch.int32), got.view(torch.int32))
    sums = np.asarray(jnp.sum(jnp.asarray(want), axis=0))
    wsum = tkernel.field_wsum_flat(got)
    assert wsum.dtype == torch.int32
    np.testing.assert_array_equal(_u32(wsum), sums)
    np.testing.assert_array_equal(_u32(ref.field_wsum_reference(got,
                                                                chunk=64)),
                                  sums)
    for bn in (64, 256, 1024, 65536):
        b = min(bn, N)
        pad = (-N) % b
        padded = jnp.pad(jnp.asarray(want), ((0, 0), (0, pad)))
        pallas = np.asarray(jkernel.field_wsum_flat(
            padded, block_n=b, interpret=True))[:N]
        np.testing.assert_array_equal(pallas, sums)


# ----------------------------------------------------------------------
# the round against the reference

@pytest.mark.parametrize("alpha", [1.0, 0.3])
@pytest.mark.parametrize("P", [1, 2, 3, 4, 10])
@pytest.mark.parametrize("domain", ["float", "int"])
def test_secure_rolling_update_matches_jax(domain, P, alpha):
    N = 1000
    ups = _updates(P, N, seed=2)
    params = np.random.default_rng(P).standard_normal(N).astype(np.float32)
    key, ours = jax.random.PRNGKey(40 + P), prng.PRNGKey(40 + P)
    jups = [jnp.asarray(u) for u in ups]
    want = np.asarray(jsa.secure_rolling_update(
        jups, jnp.asarray(params), alpha, key, impl="ref", domain=domain))
    pallas = np.asarray(jsa.secure_rolling_update(
        jups, jnp.asarray(params), alpha, key, impl="pallas",
        domain=domain))
    got = tsa.secure_rolling_update([torch.from_numpy(u) for u in ups],
                                    torch.from_numpy(params), alpha, ours,
                                    domain=domain)
    assert got.dtype == torch.float32 and got.shape == (N,)
    for theirs in (want, pallas):
        if domain == "float":
            np.testing.assert_allclose(got.numpy(), theirs, atol=P * 1e-6,
                                       rtol=0)
        elif P & (P - 1) == 0 and alpha == 1.0:
            np.testing.assert_array_equal(got.numpy(), theirs)
        else:
            np.testing.assert_allclose(got.numpy(), theirs, atol=1e-6,
                                       rtol=0)
    assert torch.equal(got, tsa.secure_rolling_update(
        [torch.from_numpy(u) for u in ups], torch.from_numpy(params), alpha,
        ours, impl="ref", domain=domain))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("domain", ["float", "int"])
def test_rolling_update_dtype_contract(domain, dtype):
    P, N = 3, 513
    ups = _updates(P, N, seed=4)
    key, ours = jax.random.PRNGKey(5), prng.PRNGKey(5)
    p32 = np.random.default_rng(9).standard_normal(N).astype(np.float32)
    params = torch.from_numpy(p32).to(dtype)
    jparams = jnp.asarray(p32).astype(JAX_DTYPES[dtype])
    if domain == "int":
        shares = tsa.make_shares_int([torch.from_numpy(u) for u in ups], ours)
        jshares = jsa.make_shares_int([jnp.asarray(u) for u in ups], key)
    else:
        shares = tsa.make_shares([torch.from_numpy(u) for u in ups], ours)
        jshares = jsa.make_shares([jnp.asarray(u) for u in ups], key)
    got = ops.rolling_update_flat(shares, params, 0.5, domain=domain)
    assert got.dtype == dtype and got.shape == (N,)
    want = np.array(jops.rolling_update_flat(jshares, jparams, 0.5,
                                             impl="ref", domain=domain)
                    .astype(jnp.float32))
    torch.testing.assert_close(got.float(), torch.from_numpy(want),
                               atol=P * 1e-6, rtol=ULP_RTOL[dtype])


def test_rolling_update_tree_matches_jax():
    rng = np.random.default_rng(3)
    P = 4

    def tree():
        return {"w": rng.standard_normal((3, 5)).astype(np.float32),
                "b": [rng.standard_normal(2).astype(np.float32)]}
    share_trees = [tree() for _ in range(P)]
    params = tree()
    want = jops.rolling_update_tree(
        [jax.tree.map(jnp.asarray, t) for t in share_trees],
        jax.tree.map(jnp.asarray, params), 0.7, impl="ref")
    to_t = lambda t: jax.tree.map(torch.from_numpy, t)   # noqa: E731
    got = ops.rolling_update_tree([to_t(t) for t in share_trees],
                                  to_t(params), 0.7)
    leaves, spec = tree_flatten(got)
    assert treedef_str(spec) == str(jax.tree.structure(params))
    for a, b in zip(leaves, jax.tree.leaves(want)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=P * 1e-6,
                                   rtol=0)


# ----------------------------------------------------------------------
# dispatch

def test_dispatch_contract():
    ups = _updates(3, 100, seed=6)
    ours = prng.PRNGKey(1)
    shares = tsa.make_shares([torch.from_numpy(u) for u in ups], ours)
    words = tsa.make_shares_int([torch.from_numpy(u) for u in ups], ours)
    params = torch.linspace(-1, 1, 100)
    launches = (tkernel.rolling_update_flat.launches,
                tkernel.field_wsum_flat.launches)
    for domain, sh in (("float", shares), ("int", words)):
        base = ops.rolling_update_flat(sh, params, 0.4, impl="ref",
                                       domain=domain)
        for impl in ("fused", "pallas", "auto"):
            for bn in (8, 65536):
                assert torch.equal(base, ops.rolling_update_flat(
                    sh, params, 0.4, impl=impl, block_n=bn, domain=domain))
    # CPU tensors take the plain versions: no kernel launched
    assert launches == (tkernel.rolling_update_flat.launches,
                        tkernel.field_wsum_flat.launches)
    with pytest.raises(ValueError, match="uint32"):
        ops.rolling_update_flat(shares, params, 0.4, domain="int")
    with pytest.raises(ValueError, match="valid impls"):
        ops.rolling_update_flat(shares, params, 0.4, impl="xla")
    with pytest.raises(ValueError, match="valid domains"):
        ops.rolling_update_flat(shares, params, 0.4, domain="fixed")
