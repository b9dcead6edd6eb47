"""The port's secure-aggregation path held against the JAX package.

Inputs come from numpy seeds and go through both packages.  Integer and
PRG-word results must be array_equal; the float domain is held within the
JAX package's own cancellation bound, atol = P * 1e-6
(test_secure_agg_fused.py::test_fused_masks_cancel_to_plain_mean): its mask
sum runs in another order than XLA's dot.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.flatten_util import ravel_pytree

from repro.kernels.secure_agg import field as jfield
from repro.kernels.secure_agg import kernel as jkernel
from repro.kernels.secure_agg import masking as jmasking
from repro.kernels.secure_agg import ops as jops
from repro.kernels.secure_agg import ref as jref
from repro_torch.core.secure_agg import ravel_stacked
from repro_torch.pytree import tree_flatten, treedef_str
from repro_torch.kernels.secure_agg import field, masking, ops, ref
from repro_torch.kernels.secure_agg import kernel as tkernel
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

PS = [2, 5, 10]
NS = [1, 777, 4096]
MASKS = ["all", "one_dead", "two_dead"]


def _case(P, N, mask_kind, seed=0):
    """(P, N) f32 rows and an optional (P,) mask; a dead row holds inf and,
    with two dead rows, another holds NaN."""
    rng = np.random.default_rng([seed, P, N, MASKS.index(mask_kind)])
    u = rng.standard_normal((P, N)).astype(np.float32)
    if mask_kind == "all":
        return u, None
    mask = np.ones(P, np.float32)
    dead = [P - 1] if mask_kind == "one_dead" else [0, P // 2]
    mask[dead] = 0.0
    u[dead[0]] = np.inf
    if len(dead) > 1:
        u[dead[1]] = np.nan
    return u, mask


def _jax_mask(mask):
    return None if mask is None else jnp.asarray(mask)


def _torch_mask(mask):
    return None if mask is None else torch.from_numpy(mask)


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().astype(np.uint32)


# ----------------------------------------------------------------------
# PRG words and the field codec: bit-exact

@pytest.mark.parametrize("seed", [0, 1, 0xDEADBEEF, 2 ** 32 - 1])
def test_mask_bits_words_bitexact(seed):
    rng = np.random.default_rng(seed & 0xFFFF)
    pair = np.arange(120, dtype=np.uint32)[:, None]
    offs = np.concatenate([np.arange(300), rng.integers(0, 2 ** 32, 300),
                           [2 ** 32 - 1]]).astype(np.uint32)[None, :]
    want = np.asarray(jmasking.mask_bits(np.uint32(seed), pair, offs))
    got = _u32(masking.mask_bits(seed, pair, offs))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        masking.mask_block(seed, pair, offs).numpy(),
        np.asarray(jmasking.mask_block(np.uint32(seed), pair, offs)))


@pytest.mark.parametrize("P", [1, 2, 5, 10, 16])
def test_pair_sign_matrix_equal(P):
    np.testing.assert_array_equal(masking.pair_sign_matrix(P),
                                  jmasking.pair_sign_matrix(P))


@pytest.mark.parametrize("frac_bits", [8, 16, 20])
def test_encode_decode_bitexact(frac_bits):
    rng = np.random.default_rng(frac_bits)
    step = 2.0 ** -frac_bits
    x = np.concatenate([
        rng.standard_normal(2000) * 4,
        (np.arange(-40, 40) + 0.5) * step,          # half-way: ties to even
        [0.0, -0.0, 1e30, -1e30, 2.0 ** (31 - frac_bits),
         -2.0 ** (31 - frac_bits), np.inf, -np.inf],
    ]).astype(np.float32)
    want = np.asarray(jfield.encode_rows(jnp.asarray(x), frac_bits))
    got = field.encode_rows(torch.from_numpy(x), frac_bits)
    np.testing.assert_array_equal(_u32(got), want)
    inside = np.abs(x) < 2.0 ** (30 - frac_bits)
    back = field.decode_value(field.to_int32(got), frac_bits).numpy()
    assert np.all(np.abs(back[inside] - x[inside]) <= 2.0 ** -(frac_bits + 1))
    words = rng.integers(0, 2 ** 32, 3000, dtype=np.uint64)
    np.testing.assert_array_equal(
        field.to_int32(torch.from_numpy(words.astype(np.int64))).numpy(),
        words.astype(np.uint32).view(np.int32))
    for count in (1.0, 3.0, 7.0):
        np.testing.assert_array_equal(
            field.decode_mean(torch.from_numpy(
                words.astype(np.uint32).view(np.int32)),
                count, frac_bits).numpy(),
            np.asarray(jfield.decode_mean(
                jnp.asarray(words.astype(np.uint32)), jnp.float32(count),
                frac_bits)))


# ----------------------------------------------------------------------
# the plain versions against the JAX references

@pytest.mark.parametrize("mask_kind", MASKS)
@pytest.mark.parametrize("N", NS)
@pytest.mark.parametrize("P", PS)
def test_int_share_sum_bitexact(P, N, mask_kind):
    """Port plain == JAX reference == JAX fused kernel (interpret mode)."""
    u, mask = _case(P, N, mask_kind)
    seed = 0x5EED + P + N
    want = np.asarray(jref.masked_field_wsum_reference(
        jnp.asarray(u), jnp.asarray([seed], jnp.uint32), _jax_mask(mask)))
    got = ref.masked_field_wsum_reference(torch.from_numpy(u), seed,
                                          _torch_mask(mask))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(_u32(got), want)
    fused = np.asarray(jkernel.masked_field_wsum_flat(
        jnp.asarray(u), jnp.asarray([seed], jnp.uint32), _jax_mask(mask),
        block_n=N, interpret=True))
    np.testing.assert_array_equal(fused, want)


@pytest.mark.parametrize("chunk", [1, 100, 1 << 20])
def test_int_share_sum_chunk_invariant(chunk):
    u, mask = _case(5, 777, "one_dead", seed=3)
    base = ref.masked_field_wsum_reference(torch.from_numpy(u), 9,
                                           _torch_mask(mask))
    got = ref.masked_field_wsum_reference(torch.from_numpy(u), 9,
                                          _torch_mask(mask), chunk=chunk)
    assert torch.equal(got, base)


@pytest.mark.parametrize("mask_kind", MASKS)
def test_field_shares_sum_to_encode_sum(mask_kind):
    """The published shares equal JAX's, and their survivor sum is the
    encode sum: the pads cancel exactly."""
    u, mask = _case(5, 300, mask_kind, seed=1)
    shares = ref.field_shares_reference(torch.from_numpy(u), 77,
                                        _torch_mask(mask))
    want = np.asarray(jref.field_shares_reference(
        jnp.asarray(u), jnp.asarray([77], jnp.uint32), _jax_mask(mask)))
    np.testing.assert_array_equal(_u32(shares), want)
    alive = np.ones(5, bool) if mask is None else mask > 0
    enc = field.encode_rows(torch.from_numpy(u[alive])).sum(0) & 0xFFFFFFFF
    assert torch.equal(shares[torch.from_numpy(alive)].sum(0) & 0xFFFFFFFF,
                       enc)


@pytest.mark.parametrize("mask_kind", MASKS)
@pytest.mark.parametrize("N", NS)
@pytest.mark.parametrize("P", PS)
def test_float_round_within_tolerance(P, N, mask_kind):
    u, mask = _case(P, N, mask_kind)
    seed, alpha = 1234 + P, 0.7
    want = np.asarray(jref.masked_rolling_update_reference(
        jnp.asarray(u), jnp.asarray([seed], jnp.uint32), alpha,
        _jax_mask(mask)))
    got = ops.masked_rolling_update(torch.from_numpy(u), seed, alpha,
                                    mask=_torch_mask(mask), impl="ref")
    assert got.dtype == torch.float32 and got.shape == (P, N)
    np.testing.assert_allclose(got.numpy(), want, atol=P * 1e-6, rtol=0)
    if mask is not None:
        dead = mask == 0
        np.testing.assert_array_equal(got.numpy()[dead], u[dead])


@pytest.mark.parametrize("mask_kind", MASKS)
@pytest.mark.parametrize("P", PS)
def test_int_round_matches_jax(P, mask_kind):
    """Decode + blend of the exact share-sum: equal to JAX's up to the
    blend's single rounding (XLA may contract it into an FMA)."""
    u, mask = _case(P, 777, mask_kind, seed=2)
    want = np.asarray(jops.masked_rolling_update(
        jnp.asarray(u), 31, 0.5, mask=_jax_mask(mask), impl="ref",
        domain="int"))
    got = ops.masked_rolling_update(torch.from_numpy(u), 31, 0.5,
                                    mask=_torch_mask(mask), domain="int")
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)


def test_fused_masks_cancel_to_plain_mean():
    u, _ = _case(10, 4096, "all", seed=5)
    got = ops.masked_rolling_update(torch.from_numpy(u), 17, 0.3)
    plain = u + 0.3 * (u.mean(0, keepdims=True) - u)
    np.testing.assert_allclose(got.numpy(), plain, atol=10 * 1e-6)


def test_cpu_wrappers_take_the_plain_version():
    u, mask = _case(5, 777, "one_dead", seed=4)
    t, m = torch.from_numpy(u), _torch_mask(mask)
    launches = (tkernel.masked_rolling_update_flat.launches,
                tkernel.masked_field_wsum_flat.launches)
    for domain in ("float", "int"):
        assert torch.equal(
            ops.masked_rolling_update(t, 3, 0.5, mask=m, impl="fused",
                                      domain=domain),
            ops.masked_rolling_update(t, 3, 0.5, mask=m, impl="ref",
                                      domain=domain))
    assert launches == (tkernel.masked_rolling_update_flat.launches,
                        tkernel.masked_field_wsum_flat.launches)


def test_output_dtype_contract():
    u = torch.from_numpy(_case(3, 50, "all")[0]).to(torch.bfloat16)
    for domain in ("float", "int"):
        out = ops.masked_rolling_update(u, 1, 1.0, domain=domain)
        assert out.dtype == torch.bfloat16 and out.shape == u.shape


# ----------------------------------------------------------------------
# the fused kernels' own arithmetic (ref.*_kernel_order): the split hash,
# integer pad sums, survivors summed in row order, IEEE division, a blend
# without contraction.  The card tests hold the kernels equal to these.

@pytest.mark.parametrize("seed", [0, 1, 0xDEADBEEF, 2 ** 32 - 1])
def test_split_hash_words_bitexact(seed):
    """mix32_tail(key' ^ c') == mask_bits for 120 pairs, counters 0..299,
    random counters and 2^32 - 1."""
    rng = np.random.default_rng(seed & 0xFFFF)
    offs = np.concatenate([np.arange(300), rng.integers(0, 2 ** 32, 300),
                           [2 ** 32 - 1]]).astype(np.uint32)
    want = np.asarray(jmasking.mask_bits(
        np.uint32(seed), np.arange(120, dtype=np.uint32)[:, None],
        offs[None, :]))
    got = ref.split_mask_bits(seed, 120,
                              torch.from_numpy(offs.astype(np.int64)))
    np.testing.assert_array_equal(_u32(got), want)


# past 16 rows the kernels (csrc/secure_agg.cu, the *_wide kernels) keep
# the same arithmetic, the net pad summed in wrapping int32 up to 256 rows
# and int64 past them: |net| < P 2^23
WIDE_PS = [17, 33, 64]


@pytest.mark.parametrize("mask_kind", MASKS)
@pytest.mark.parametrize("P", WIDE_PS)
def test_integer_net_equals_float64_net_past_16_rows(P, mask_kind):
    """At P > 16 the exact integer net, converted once, still equals the
    plain version's float64 product rounded once."""
    _, mask = _case(P, 1, mask_kind)
    m = _torch_mask(mask)
    offs = torch.arange(300, dtype=torch.int64)
    sign = torch.as_tensor(masking.pair_sign_matrix(P))
    alive = ref._alive(m, P, "cpu")
    sign_alive = sign * ref._pair_alive(sign, alive).to(torch.float32)
    pads = masking.mask_block(7, torch.arange(sign.shape[1])[:, None],
                              offs[None, :])
    want = (sign_alive.double() @ pads.double()).to(torch.float32)
    assert torch.equal(ref.float_net_pads(7, P, offs, m), want)
    assert int(ref.int_net_pads(7, P, offs, m).abs().max()) < P * 2 ** 23


@pytest.mark.parametrize("mask_kind", MASKS)
@pytest.mark.parametrize("P", WIDE_PS)
def test_kernel_orders_past_16_rows_match_jax(P, mask_kind):
    """The float round's kernel order within atol = P * 1e-6 of JAX's
    reference, the share-sum's equal to it, at P > 16; dead rows
    untouched."""
    u, mask = _case(P, 301, mask_kind)
    seed = 0xFEED + P
    got = ref.masked_rolling_update_kernel_order(
        torch.from_numpy(u), seed, 0.7, _torch_mask(mask))
    want = np.asarray(jref.masked_rolling_update_reference(
        jnp.asarray(u), jnp.asarray([seed], jnp.uint32), 0.7,
        _jax_mask(mask)))
    np.testing.assert_allclose(got.numpy(), want, atol=P * 1e-6, rtol=0)
    if mask is not None:
        dead = mask == 0
        np.testing.assert_array_equal(got.numpy()[dead].view(np.uint32),
                                      u[dead].view(np.uint32))
    words = ref.masked_field_wsum_kernel_order(torch.from_numpy(u), seed,
                                               _torch_mask(mask))
    np.testing.assert_array_equal(_u32(words), np.asarray(
        jref.masked_field_wsum_reference(
            jnp.asarray(u), jnp.asarray([seed], jnp.uint32),
            _jax_mask(mask))))


# the P > 16 kernels' tile walk (ref.wide_pair_tiles, wide_int_net_pads,
# wide_field_pads): each side of a 16-row tile's edge, and P = 128; all
# rows alive, rows 0 and 4 dead, or a whole tile dead (the middle one, or
# tile 0 where the middle one is the ragged last)
WALK_PS = [17, 31, 32, 33, 47, 48, 49, 128]
WALK_ALIVE = ["all", "rows_0_4_dead", "tile_dead"]
WALK_N = 129


def _walk_case(P, alive):
    """(P, WALK_N) f32 rows and their (P,) mask, always an array (so JAX
    compiles one reference per P); the first dead row holds inf, the
    second NaN."""
    rng = np.random.default_rng([P, WALK_ALIVE.index(alive)])
    u = rng.standard_normal((P, WALK_N)).astype(np.float32)
    mask = np.ones(P, np.float32)
    if alive == "rows_0_4_dead":
        mask[[0, 4]] = 0.0
    elif alive == "tile_dead":
        T = -(-P // 16)
        t = T // 2 if 16 * (T // 2 + 1) <= P else 0
        mask[16 * t:16 * t + 16] = 0.0
    dead = np.nonzero(mask == 0)[0]
    if dead.size:
        u[dead[0]] = np.inf
        u[dead[1]] = np.nan
    return u, mask


@pytest.mark.parametrize("alive", WALK_ALIVE)
@pytest.mark.parametrize("P", WALK_PS)
def test_tile_walk_matches_exact_nets_and_jax(P, alive):
    """The walk visits every pair (i < j < P) exactly once, tile pairs (I,
    J), I <= J, I outer, each pair inside its rows' tiles; its float nets
    (int32 wrapping) equal `int_net_pads` and `float_net_pads` bit for
    bit, its int pads the plain shares less their encodes; the kernel-
    order rounds built on them equal JAX's share-sum and hold JAX's float
    round within atol = P * 1e-6, dead rows bit-untouched."""
    walk = ref.wide_pair_tiles(P)
    T = -(-P // 16)
    assert [(I, J) for I, J, _ in walk] == [
        (I, J) for I in range(T) for J in range(I, T)]
    seen = [pair for _, _, pairs in walk for pair in pairs]
    assert len(seen) == len(set(seen))
    assert sorted(seen) == masking.pair_list(P)
    assert all(i // 16 == I and j // 16 == J
               for I, J, pairs in walk for i, j in pairs)

    u, mask = _walk_case(P, alive)
    t, m = torch.from_numpy(u), torch.from_numpy(mask)
    seed = 0xA11CE + P
    offs = torch.arange(WALK_N)
    nets = ref.wide_int_net_pads(seed, P, offs, m)
    assert torch.equal(nets, ref.int_net_pads(seed, P, offs, m))
    assert torch.equal(nets.to(torch.float32) * 2.0 ** -23,
                       ref.float_net_pads(seed, P, offs, m))
    pads = (ref.field_shares_reference(t, seed, m)
            - field.encode_rows(t)) & masking.M32
    assert torch.equal(ref.wide_field_pads(seed, P, offs, m), pads)

    jseed = jnp.asarray([seed], jnp.uint32)
    words = ref.masked_field_wsum_kernel_order(t, seed, m)
    np.testing.assert_array_equal(_u32(words), np.asarray(
        jref.masked_field_wsum_reference(jnp.asarray(u), jseed,
                                         jnp.asarray(mask))))
    got = ref.masked_rolling_update_kernel_order(t, seed, 0.7, m)
    want = np.asarray(jref.masked_rolling_update_reference(
        jnp.asarray(u), jseed, 0.7, jnp.asarray(mask)))
    dead = mask == 0
    np.testing.assert_allclose(got.numpy()[~dead], want[~dead],
                               atol=P * 1e-6, rtol=0)
    np.testing.assert_array_equal(got.numpy()[dead].view(np.uint32),
                                  u[dead].view(np.uint32))


@pytest.mark.parametrize("mask_kind", MASKS)
@pytest.mark.parametrize("P", [1, 2, 5, 10, 16])
def test_integer_net_equals_float64_net(P, mask_kind):
    """The net pad summed in int32 and converted once equals, bit for bit,
    the plain version's float64 product rounded once to f32."""
    _, mask = _case(P, 1, mask_kind)
    m = _torch_mask(mask)
    rng = np.random.default_rng(P)
    offs = torch.from_numpy(np.concatenate([
        np.arange(500), rng.integers(0, 2 ** 32, 500),
        [2 ** 32 - 1]]).astype(np.int64))
    sign = torch.as_tensor(masking.pair_sign_matrix(P))
    alive = ref._alive(m, P, "cpu")
    sign_alive = sign * ref._pair_alive(sign, alive).to(torch.float32)
    pads = masking.mask_block(0xC0FFEE, torch.arange(sign.shape[1])[:, None],
                              offs[None, :])
    want = (sign_alive.double() @ pads.double()).to(torch.float32)
    got = ref.float_net_pads(0xC0FFEE, P, offs, m)
    assert torch.equal(got, want)
    assert int(ref.int_net_pads(0xC0FFEE, P, offs, m).abs().max()) < 2 ** 28


@pytest.mark.parametrize("mask_kind", MASKS)
@pytest.mark.parametrize("P", PS)
def test_float_kernel_order_within_tolerance(P, mask_kind):
    """The float kernel's order against JAX's reference (the same inputs
    as test_float_round_within_tolerance at N = 777) within atol = P *
    1e-6, and against the port's plain version; dead rows, inf and NaN
    included, bit-identical."""
    u, mask = _case(P, 777, mask_kind)
    seed, alpha = 1234 + P, 0.7
    want = np.asarray(jref.masked_rolling_update_reference(
        jnp.asarray(u), jnp.asarray([seed], jnp.uint32), alpha,
        _jax_mask(mask)))
    got = ref.masked_rolling_update_kernel_order(
        torch.from_numpy(u), seed, alpha, _torch_mask(mask))
    assert got.dtype == torch.float32 and got.shape == (P, 777)
    np.testing.assert_allclose(got.numpy(), want, atol=P * 1e-6, rtol=0)
    plain = ref.masked_rolling_update_reference(
        torch.from_numpy(u), seed, alpha, _torch_mask(mask))
    torch.testing.assert_close(got, plain, atol=P * 1e-6, rtol=0,
                               equal_nan=True)
    if mask is not None:
        dead = mask == 0
        np.testing.assert_array_equal(got.numpy()[dead].view(np.uint32),
                                      u[dead].view(np.uint32))


@pytest.mark.parametrize("mask_kind", MASKS)
@pytest.mark.parametrize("P", PS)
def test_int_kernel_order_equals_jax(P, mask_kind):
    """The int kernel's order (clamp before one rounding, pads from 0,
    encodes added last) == JAX's reference == the port's plain version."""
    u, mask = _case(P, 777, mask_kind)
    seed = 0x5EED + P + 777
    want = np.asarray(jref.masked_field_wsum_reference(
        jnp.asarray(u), jnp.asarray([seed], jnp.uint32), _jax_mask(mask)))
    got = ref.masked_field_wsum_kernel_order(torch.from_numpy(u), seed,
                                             _torch_mask(mask))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(_u32(got), want)
    assert torch.equal(got, ref.masked_field_wsum_reference(
        torch.from_numpy(u), seed, _torch_mask(mask)))


@pytest.mark.parametrize("frac_bits", [8, 16, 20])
def test_clamp_first_encode_equals_encode(frac_bits):
    """Clamp then round == round then clamp, at ties, the int32 edge and
    +-inf."""
    rng = np.random.default_rng(frac_bits)
    step = 2.0 ** -frac_bits
    edge = 2.0 ** (31 - frac_bits)
    x = np.concatenate([
        rng.standard_normal(2000) * 4, (np.arange(-40, 40) + 0.5) * step,
        [0.0, -0.0, 1e30, -1e30, edge, -edge, np.inf, -np.inf],
        np.nextafter(np.float32(edge), np.float32(0)) * np.array([1, -1]),
    ]).astype(np.float32)
    t = torch.from_numpy(x)
    assert torch.equal(ref.encode_rows_clamp_first(t, frac_bits),
                       field.encode_rows(t, frac_bits))


# ----------------------------------------------------------------------
# seed and dispatch contracts (same as the JAX package's)

@pytest.mark.parametrize("seed,want", [(5, 5), (-1, 2 ** 32 - 1),
                                       (2 ** 32 + 7, 7),
                                       (np.int64(-2), 2 ** 32 - 2)])
def test_normalize_seed_wraps_ints(seed, want):
    assert ops.normalize_seed(seed) == want
    assert int(np.asarray(jops.normalize_seed(seed))[0]) == want


def test_normalize_seed_arrays_and_errors():
    assert ops.normalize_seed(np.array([9], np.uint32)) == 9
    assert ops.normalize_seed(torch.tensor([9], dtype=torch.uint32)) == 9
    for bad in (True, 1.5, np.array([1], np.int32),
                np.array([1, 2], np.uint32), "7"):
        with pytest.raises(ValueError):
            ops.normalize_seed(bad)


def test_unknown_impl_and_domain_raise():
    u = torch.zeros((2, 3))
    with pytest.raises(ValueError, match="valid impls"):
        ops.masked_rolling_update(u, 0, 1.0, impl="xla")
    with pytest.raises(ValueError, match="valid domains"):
        ops.masked_rolling_update(u, 0, 1.0, domain="fixed")


# ----------------------------------------------------------------------
# pytree ravel in JAX leaf order

def _tree(P, rng):
    return {"conv": [{"w": rng.standard_normal((P, 3, 3, 2, 4)),
                      "b": rng.standard_normal((P, 4))} for _ in range(2)],
            "head": {"w": rng.standard_normal((P, 8, 2)),
                     "b": rng.standard_normal((P, 2))},
            "a": (rng.standard_normal((P, 5)),)}


def test_ravel_stacked_matches_jax_order():
    rng = np.random.default_rng(0)
    tree = jax.tree.map(lambda x: x.astype(np.float32), _tree(3, rng))
    rows, unravel = ravel_stacked(jax.tree.map(torch.from_numpy, tree))
    for p in range(3):
        want = ravel_pytree(jax.tree.map(lambda x: x[p], tree))[0]
        np.testing.assert_array_equal(rows[p].numpy(), np.asarray(want))
    back = unravel(rows)
    assert tree_flatten(back)[1] == tree_flatten(tree)[1]
    for a, b in zip(tree_flatten(back)[0], jax.tree.leaves(tree)):
        np.testing.assert_array_equal(a.numpy(), b)
    assert treedef_str(tree_flatten(tree)[1]) == str(
        jax.tree.structure(tree))
