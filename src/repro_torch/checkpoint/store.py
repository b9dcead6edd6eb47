"""Verified checkpoints: an npz payload and a JSON manifest.

The on-disk format is the JAX package's (``checkpoint/store.py``), so each
package reads the other's checkpoints: ``arrays.npz`` holds one array per
leaf, keyed by its path (`pytree.leaf_path`, e.g. ``conv/0/w``), and
``manifest.json`` records the step, ``str(treedef)`` of the JAX pytree
(`pytree.treedef_str`), the ledger fingerprint of the whole tree
(`core.registry.fingerprint_pytree`), each leaf's shape and dtype, and
the caller's metadata.

Restore is verified: `load_checkpoint` refuses a missing leaf, a shape or
dtype that drifted from the manifest or from the restore target (it never
casts: a cast would change the bytes the ledger fingerprinted), and a
payload whose recomputed fingerprint disagrees with the manifest's, so a
bit flip or a torn ``arrays.npz`` raises instead of loading.  Each error
names the leaf.  Restored leaves come back as tensors on the device of
the matching leaf of the restore target.
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.registry import fingerprint_pytree
from repro_torch.pytree import (
    leaf_path, tree_flatten, tree_flatten_with_path, tree_unflatten,
    treedef_str,
)

Pytree = Any


class CheckpointError(ValueError):
    """A checkpoint failed verification (corrupt, truncated, or mismatched
    against its own manifest or the restore target)."""


def _host(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _np_dtype(leaf) -> np.dtype:
    """A leaf's numpy dtype, without copying a tensor to the host."""
    if isinstance(leaf, torch.Tensor):
        return torch.empty((), dtype=leaf.dtype).numpy().dtype
    return np.asarray(leaf).dtype


def _paths(tree: Pytree):
    return [(leaf_path(p), leaf) for p, leaf in
            tree_flatten_with_path(tree)[0]]


def save_checkpoint(path: str, params: Pytree, *, step: int = 0,
                    metadata: Optional[dict] = None) -> str:
    """Write `params` (tensors or arrays) to the directory `path`; returns
    the tree's fingerprint, which the manifest records."""
    os.makedirs(path, exist_ok=True)
    arrays: Dict[str, np.ndarray] = {k: _host(v) for k, v in _paths(params)}
    np.savez(os.path.join(path, "arrays.npz"), **arrays)
    spec = tree_flatten(params)[1]
    manifest = {
        "step": step,
        "treedef": treedef_str(spec),
        # over the host copies: a device tree is copied to the host once
        "fingerprint": fingerprint_pytree(
            tree_unflatten(spec, list(arrays.values()))),
        "leaves": {k: {"shape": list(v.shape), "dtype": str(v.dtype)}
                   for k, v in arrays.items()},
        "metadata": metadata or {},
    }
    with open(os.path.join(path, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=2)
    return manifest["fingerprint"]


def load_checkpoint(path: str, like: Pytree) -> Tuple[Pytree, dict]:
    """Restore into the structure of `like`, verified end to end: every
    leaf of `like` must be in the manifest and the payload, with the
    shape of `like`'s leaf and the dtype both of the manifest's record and
    of `like`'s leaf, and the restored tree's recomputed fingerprint must
    equal the manifest's.  Returns ``(tree, manifest)``."""
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    ref = _paths(like)
    out = []
    with np.load(os.path.join(path, "arrays.npz")) as data:
        for k, v in ref:
            rec = manifest["leaves"].get(k)
            if rec is None:
                raise CheckpointError(f"leaf {k!r} missing from manifest "
                                      f"(have: {sorted(manifest['leaves'])})")
            if k not in data.files:
                raise CheckpointError(f"leaf {k!r} missing from arrays.npz "
                                      f"(manifest records it — torn write?)")
            arr = data[k]
            if tuple(arr.shape) != tuple(v.shape):
                raise CheckpointError(
                    f"shape mismatch at {k}: {arr.shape} vs {tuple(v.shape)}")
            if str(arr.dtype) != rec["dtype"]:
                raise CheckpointError(
                    f"dtype mismatch at {k}: payload {arr.dtype} vs manifest "
                    f"{rec['dtype']}")
            if arr.dtype != _np_dtype(v):
                raise CheckpointError(
                    f"dtype mismatch at {k}: checkpoint {arr.dtype} vs "
                    f"restore target {_np_dtype(v)} (load_checkpoint never "
                    f"casts)")
            out.append(arr)
    spec = tree_flatten(like)[1]
    got = fingerprint_pytree(tree_unflatten(spec, out))
    if got != manifest["fingerprint"]:
        raise CheckpointError(
            f"fingerprint mismatch: restored tree hashes to {got[:16]}… but "
            f"manifest records {manifest['fingerprint'][:16]}… — corrupted "
            f"or partially written checkpoint")
    devices = [v.device if isinstance(v, torch.Tensor) else
               torch.device("cpu") for _, v in ref]
    return tree_unflatten(spec, [torch.from_numpy(a).to(d)
                                 for a, d in zip(out, devices)]), manifest
