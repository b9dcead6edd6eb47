"""STIGMA decentralized-ML overlay in PyTorch, with hand-written Hopper
kernels for the secure-aggregation and DP hot loops.

The package mirrors the JAX package's layout module for module (each
module sits at the same path as its JAX counterpart) and holds the same
contracts: bit-exact where the JAX package's contract is integer or hash
arithmetic, within a stated tolerance for float training.  It imports
torch, numpy and the standard library only.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
without a CUDA device the default raises instead of falling back.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` by default, and an
    error (never a silent CPU fallback) when no CUDA device exists."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch path on the CPU")
        return torch.device("cuda")
    return torch.device(device)
