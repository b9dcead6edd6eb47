"""Multi-party secure aggregation (paper §4.1.3), fused path.

Additive-mask MPC in the Bonawitz-style construction: for every pair
(i, j), i < j, both parties derive the same PRG pad m_ij; institution i
publishes ``update_i + sum_{j>i} m_ij - sum_{j<i} m_ji``.  The pads cancel
in the sum, so every peer learns only the mean of the updates.

The whole round (mask, publish, aggregate, blend) is one pass of the
``kernels/secure_agg`` kernel over the stacked raw updates (P, N); the
pads are regenerated inside the kernel from a counter-based PRG and never
reach device memory.
"""
from __future__ import annotations

from typing import Any, Callable, Tuple

import numpy as np
import torch

from repro_torch import random as prng
from repro_torch.pytree import tree_flatten, tree_unflatten
from repro_torch.kernels.secure_agg import ops as agg_ops

Pytree = Any


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
