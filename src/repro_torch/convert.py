"""Weights carried across from the JAX package.

`params_from_jax` takes a param tree of numpy arrays (``jax.device_get`` of
the JAX package's params, single or stacked (P, ...)) and returns the same
tree of torch tensors: same keys, same layout (HWIO conv weights), same
dtype, same bytes.  It needs no JAX itself.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.pytree import tree_map


def params_from_jax(tree, device=None):
    """Tree of numpy arrays -> tree of tensors on `device` (default CPU)."""
    return tree_map(lambda x: torch.from_numpy(np.array(x)).to(device), tree)
