"""The port's threefry keys are bit-exact against jax.random, and so is the
MPC seed derived from a round's merge key."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

from repro.core.secure_agg import seed_from_key as jax_seed_from_key
from repro_torch import random as prng
from repro_torch.core.secure_agg import seed_from_key

SEEDS = [0, 1, 7, 999, 12345, 2 ** 31 - 1, 2 ** 31 + 3, 2 ** 32 - 1, -1, -5]


@pytest.mark.parametrize("seed", SEEDS)
def test_prng_key_split_bits_bitexact(seed):
    key = jax.random.PRNGKey(seed)
    ours = prng.PRNGKey(seed)
    np.testing.assert_array_equal(ours, np.asarray(key))
    for num in (2, 3, 10):
        np.testing.assert_array_equal(prng.split(ours, num),
                                      np.asarray(jax.random.split(key, num)))
    for shape in ((1,), (7,), (2, 3)):
        np.testing.assert_array_equal(
            prng.bits(ours, shape),
            np.asarray(jax.random.bits(key, shape, jnp.uint32)))


@pytest.mark.parametrize("seed", [0, 3, 41])
def test_round_mpc_seed_bitexact(seed):
    """The federation's round key is PRNGKey(seed*1000 + rnd); the merge
    key is its second split; the MPC seed is bits of that key."""
    for rnd in range(5):
        k2 = jax.random.split(jax.random.PRNGKey(seed * 1000 + rnd))[1]
        ours = prng.split(prng.PRNGKey(seed * 1000 + rnd))[1]
        got = seed_from_key(ours)
        assert got.dtype == np.uint32 and got.shape == (1,)
        np.testing.assert_array_equal(got, np.asarray(jax_seed_from_key(k2)))


def test_nested_split_chain_bitexact():
    key, ours = jax.random.PRNGKey(2024), prng.PRNGKey(2024)
    for _ in range(6):
        key = jax.random.split(key, 3)[2]
        ours = prng.split(ours, 3)[2]
    np.testing.assert_array_equal(ours, np.asarray(key))


def test_prng_key_rejects_wide_seed():
    with pytest.raises(ValueError):
        prng.PRNGKey(2 ** 32)
