"""The port's `core.gossip` shim held against the JAX package's.

Each of the five shim functions, masked and unmasked, on the same seeded
numpy rows as the JAX shim, within the tolerances
`test_torch_merges.py` and `test_torch_secure_agg.py` use for those
merges: atol = rtol = 1e-6 for the float merges, atol = P * 1e-6 for the
float MPC round (its pads cancel to fp32 rounding).  Then the
reference's own pins of the shim (`tests/test_gossip_shim.py`), on the
port: shim == registry bit for bit, ``group_size`` honoured, a shadowed
registration followed, ``bits`` and ``impl`` falling through, and the
re-exports.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.core import gossip as jax_gossip
from repro_torch import random as prng
from repro_torch.convert import params_from_jax
from repro_torch.core import gossip
from repro_torch.core.merges import MergeContext, get_merge, register_merge
from repro_torch.core.merges import base as merges_base
from repro_torch.core.merges import strategies as strategies_fn
from repro_torch.pytree import tree_flatten, tree_map
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

P = 6
_SEED = 77


def _rows(seed=0):
    rng = np.random.default_rng([seed, P])
    return {"w": rng.standard_normal((P, 5)).astype(np.float32),
            "b": {"c": rng.standard_normal((P, 3, 2)).astype(np.float32)}}


def _stacked(seed=0):
    return params_from_jax(_rows(seed))


_MASK = np.array([True, False, True, True, False, True])


def _mask(masked):
    return torch.from_numpy(_MASK) if masked else None


def _leaves(tree):
    return [x.numpy() for x in tree_flatten(tree)[0]]


def _assert_bit_equal(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.tobytes() == y.tobytes()


# name -> (port shim call, JAX shim call, port registry context, atol)
_CALLS = {
    "mean": (
        lambda s, m: gossip.mean_merge(s, True, alpha=0.7, mask=m),
        lambda s, m: jax_gossip.mean_merge(s, True, alpha=0.7, mask=m),
        lambda m: MergeContext(commit=True, mask=m, alpha=0.7), 1e-6),
    "ring": (
        lambda s, m: gossip.ring_merge(s, True, shift=2, alpha=0.4, mask=m),
        lambda s, m: jax_gossip.ring_merge(s, True, shift=2, alpha=0.4,
                                           mask=m),
        lambda m: MergeContext(commit=True, mask=m, alpha=0.4, shift=2),
        1e-6),
    "hierarchical": (
        lambda s, m: gossip.hierarchical_merge(s, True, group_size=3,
                                               alpha=0.7, mask=m),
        lambda s, m: jax_gossip.hierarchical_merge(s, True, group_size=3,
                                                   alpha=0.7, mask=m),
        lambda m: MergeContext(commit=True, mask=m, alpha=0.7,
                               group_size=3), 1e-6),
    "quantized": (
        lambda s, m: gossip.quantized_mean_merge(s, True, alpha=0.7, mask=m),
        lambda s, m: jax_gossip.quantized_mean_merge(s, True, alpha=0.7,
                                                     mask=m),
        lambda m: MergeContext(commit=True, mask=m, alpha=0.7), 1e-6),
    "secure_mean": (
        lambda s, m: gossip.secure_mean_merge(
            s, True, alpha=0.7, key=prng.PRNGKey(_SEED), mask=m),
        lambda s, m: jax_gossip.secure_mean_merge(
            s, True, alpha=0.7, key=jax.random.PRNGKey(_SEED), mask=m),
        lambda m: MergeContext(commit=True, mask=m, alpha=0.7,
                               key=prng.PRNGKey(_SEED)), P * 1e-6),
}


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("name", sorted(_CALLS))
def test_shim_matches_the_jax_shim(name, masked):
    ours, theirs, _, atol = _CALLS[name]
    rows = _rows(seed=11)
    got = _leaves(ours(_stacked(11), _mask(masked)))
    want = [np.asarray(x) for x in jax.tree.leaves(theirs(
        jax.tree.map(jnp.asarray, rows),
        jnp.asarray(_MASK) if masked else None))]
    rtol = 0 if name == "secure_mean" else 1e-6
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_allclose(a, b, atol=atol, rtol=rtol)
    if masked:        # dead institutions keep their rows bit for bit
        for a, leaf in zip(got, jax.tree.leaves(rows)):
            for d in np.flatnonzero(~_MASK):
                assert a[d].tobytes() == leaf[d].tobytes()


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("name", sorted(_CALLS))
def test_shim_bit_identical_to_registry(name, masked):
    call, _, make_ctx, _ = _CALLS[name]
    m = _mask(masked)
    _assert_bit_equal(call(_stacked(11), m),
                      get_merge(name).merge(_stacked(11), make_ctx(m)))


def test_shim_honors_group_size_not_context_default():
    """group_size=3 must differ from the context default of 2: the kwarg
    travels through the context instead of being dropped."""
    g3 = gossip.hierarchical_merge(_stacked(3), True, group_size=3,
                                   alpha=1.0)
    g2 = get_merge("hierarchical").merge(
        _stacked(3), MergeContext(commit=True, alpha=1.0, group_size=2))
    assert any(a.tobytes() != b.tobytes()
               for a, b in zip(_leaves(g3), _leaves(g2)))


def test_shim_follows_a_shadowed_registration():
    """Re-registering "mean" redirects gossip.mean_merge too."""
    original = merges_base._REGISTRY["mean"]

    @register_merge("mean")
    class Negate:
        def merge(self, stacked, ctx):
            return tree_map(torch.negative, stacked)

    try:
        out = gossip.mean_merge(_stacked(5), True, alpha=0.7)
        _assert_bit_equal(out, tree_map(torch.negative, _stacked(5)))
    finally:
        merges_base._REGISTRY["mean"] = original
    _assert_bit_equal(gossip.mean_merge(_stacked(5), True, alpha=1.0),
                      strategies_fn.mean_merge(_stacked(5), True, alpha=1.0))


def test_shim_non_context_kwargs_still_honored():
    """`bits` and `impl` have no MergeContext field: the shim falls
    through to the strategy function rather than dropping them."""
    b4 = gossip.quantized_mean_merge(_stacked(7), True, alpha=1.0, bits=4)
    b8 = gossip.quantized_mean_merge(_stacked(7), True, alpha=1.0, bits=8)
    assert any(a.tobytes() != b.tobytes()
               for a, b in zip(_leaves(b4), _leaves(b8)))
    _assert_bit_equal(b4, strategies_fn.quantized_mean_merge(
        _stacked(7), True, alpha=1.0, bits=4))
    key = prng.PRNGKey(_SEED)
    _assert_bit_equal(
        gossip.secure_mean_merge(_stacked(7), True, alpha=0.7, key=key,
                                 impl="ref"),
        strategies_fn.secure_mean_merge(_stacked(7), True, alpha=0.7,
                                        key=key, impl="ref"))
    with pytest.raises(ValueError):
        gossip.secure_mean_merge(_stacked(7), True, alpha=0.7, key=key,
                                 impl="no-such-impl")


def test_shim_reexports_toolkit_helpers():
    mask = torch.tensor([True, False, True, True, False])
    nbr = gossip.ring_neighbor_indices(mask, shift=1)
    assert nbr.tolist() == [3, 1, 0, 2, 4]
    assert gossip._gate is strategies_fn.gate
    assert gossip._mask_nd is strategies_fn.mask_nd
