"""Multi-party secure aggregation (paper §4.1.3).

Additive-mask MPC in the Bonawitz-style construction: for every pair
(i, j), i < j, both parties derive the same PRG pad m_ij; institution i
publishes ``update_i + sum_{j>i} m_ij - sum_{j<i} m_ji``.  The pads cancel
in the sum, so every peer learns only the mean of the updates.

Two execution paths:

  * FUSED (the overlay's): the whole round (mask, publish, aggregate,
    blend) is one pass of the ``kernels/secure_agg`` masked kernel over
    the stacked raw updates (P, N); the pads are regenerated inside the
    kernel from a counter-based PRG and never reach device memory.
  * LEGACY (`make_shares` / `make_shares_int`, then
    `kernels.secure_agg.ops.rolling_update_flat`): the shares are
    materialized first, each float pad a full-size ``jax.random.normal``
    draw under `pairwise_seed` (`repro_torch.random`, on the updates'
    device), each int pad the raw counter-PRG words; the aggregate kernel
    then blends their mean into one params row.  Kept as the
    explicit-dataflow oracle the fused path is compared against: about
    P + 4 memory passes over N against the fused path's 2.
"""
from __future__ import annotations

from typing import Any, Callable, Sequence, Tuple

import numpy as np
import torch

from repro_torch import random as prng
from repro_torch.pytree import tree_flatten, tree_unflatten
from repro_torch.kernels.secure_agg import field as agg_field
from repro_torch.kernels.secure_agg import ops as agg_ops
from repro_torch.kernels.secure_agg import ref as agg_ref
from repro_torch.kernels.secure_agg.masking import MASK_SCALE

Pytree = Any

# columns per chunk of the int shares: bounds the (P, chunk) int64 words
SHARES_CHUNK = 1 << 24


# ----------------------------------------------------------------------
# Legacy masking (explicit-dataflow oracle; O(P^2) full-size draws)

def pairwise_seed(base_key: np.ndarray, i: int, j: int) -> np.ndarray:
    """Both parties of the pair (i, j) derive the identical key."""
    lo, hi = (i, j) if i < j else (j, i)
    return prng.fold_in(prng.fold_in(base_key, lo), hi)


def mask_for(base_key: np.ndarray, i: int, n: int, shape,
             device=None) -> torch.Tensor:
    """Net f32 mask institution i of n adds to its flat update of
    `shape`, drawn on `device`: + the pad of every pair (i, j > i), - the
    pad of every pair (j < i, i), accumulated in j order."""
    total = torch.zeros(tuple(shape), dtype=torch.float32, device=device)
    for j in range(n):
        if j == i:
            continue
        m = prng.normal(pairwise_seed(base_key, i, j), shape,
                        device=total.device).mul_(MASK_SCALE)
        if i < j:
            total.add_(m)
        else:
            total.sub_(m)
    return total


def make_shares(updates: Sequence[torch.Tensor],
                base_key: np.ndarray) -> torch.Tensor:
    """updates: P flat (N,) tensors -> masked f32 shares (P, N) on the
    first update's device."""
    n = len(updates)
    out = torch.empty((n,) + tuple(updates[0].shape), dtype=torch.float32,
                      device=updates[0].device)
    for i, u in enumerate(updates):
        out[i] = u.to(torch.float32) + mask_for(base_key, i, n, u.shape,
                                                device=out.device)
    return out


def make_shares_int(updates: Sequence[torch.Tensor], base_key: np.ndarray,
                    *, frac_bits: int = agg_field.FRAC_BITS) -> torch.Tensor:
    """Int-domain `make_shares`: each flat (N,) update fixed-point encoded
    into Z_2^32 and padded with the raw counter-PRG words of the round
    seed, the same streams the fused kernel regenerates, so the legacy and
    fused int rounds see the same shares -> (P, N) torch.uint32."""
    u = torch.stack([torch.as_tensor(r).to(torch.float32) for r in updates])
    seed = int(seed_from_key(base_key)[0])
    N = u.shape[1]
    out = torch.empty(u.shape, dtype=torch.int32, device=u.device)
    for start in range(0, N, SHARES_CHUNK):
        stop = min(start + SHARES_CHUNK, N)
        out[:, start:stop] = agg_field.to_int32(agg_ref.field_shares_reference(
            u[:, start:stop], seed, frac_bits=frac_bits, start=start))
    return out.view(torch.uint32)


def secure_rolling_update(updates: Sequence[torch.Tensor],
                          params: torch.Tensor, alpha, base_key: np.ndarray,
                          *, impl: str = "auto",
                          domain: str = "float") -> torch.Tensor:
    """Legacy MPC round: mask -> publish shares -> aggregate + blend ONE
    params row -> (N,) in params.dtype.  domain="int" publishes Z_2^32
    field shares instead of float ones and aggregates them exactly."""
    if domain == "int":
        shares = make_shares_int(updates, base_key)
    else:
        shares = make_shares(updates, base_key)
    return agg_ops.rolling_update_flat(shares, params, alpha, impl=impl,
                                       domain=domain)


# ----------------------------------------------------------------------
# Fused path: one (P, N) ravel, in-kernel masks


def seed_from_key(key: np.ndarray) -> np.ndarray:
    """Collapse a round key to the (1,) uint32 MPC seed, bit-exact with
    the JAX package's ``jax.random.bits(key, (1,), uint32)``."""
    return prng.bits(key, (1,))


def ravel_stacked(stacked: Pytree) -> Tuple[torch.Tensor,
                                            Callable[[torch.Tensor], Pytree]]:
    """Flatten a stacked pytree (leaves (P, ...)) into one (P, N) f32
    matrix with its unravel.  Column order is the JAX package's
    ``ravel_pytree`` order of one institution's tree."""
    leaves, spec = tree_flatten(stacked)
    P = leaves[0].shape[0]
    # only shapes and dtypes in the closure: holding the leaves would pin
    # the input tree alive next to the rows matrix
    specs = [(l.shape, l.dtype, int(np.prod(l.shape[1:], dtype=np.int64)))
             for l in leaves]
    rows = torch.cat([l.reshape(P, -1).to(torch.float32) for l in leaves],
                     dim=1)

    def unravel(mat: torch.Tensor) -> Pytree:
        out, off = [], 0
        for shape, dtype, sz in specs:
            out.append(mat[:, off:off + sz].reshape(shape).to(dtype))
            off += sz
        return tree_unflatten(spec, out)

    return rows, unravel


def fused_secure_rolling_update(updates: torch.Tensor, alpha, key, *,
                                mask=None, impl: str = "auto",
                                domain: str = "float") -> torch.Tensor:
    """Full MPC round on the raw stacked updates (P, N) -> all P blended
    rows (P, N).  `mask`: optional (P,) participation; `domain`: "float"
    or the exact "int" Z_2^32 pads."""
    return agg_ops.masked_rolling_update(updates, seed_from_key(key), alpha,
                                         mask=mask, impl=impl, domain=domain)


def secure_rolling_update_tree(stacked_updates: Pytree, alpha, base_key, *,
                               mask=None, impl: str = "auto",
                               domain: str = "float") -> Pytree:
    """Pytree front end the overlay calls: stacked (P, ...) tree in, stacked
    blended tree out."""
    rows, unravel = ravel_stacked(stacked_updates)
    return unravel(fused_secure_rolling_update(rows, alpha, base_key,
                                               mask=mask, impl=impl,
                                               domain=domain))
