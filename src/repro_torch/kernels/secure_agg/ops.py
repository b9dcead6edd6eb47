"""Public secure-aggregation ops: seed contract and backend dispatch.

  rolling_update_flat     legacy two-stage round: the caller supplies the
                          already masked SHARES (P, N) and one params row
                          (N,); the mean of the shares is blended into it.
  masked_rolling_update   fused MPC round: the raw stacked updates (P, N)
                          and a uint32 seed; pairwise masks are derived
                          inside the kernel, all P blended rows come back.

``impl``: "fused" and "pallas" (aliases, the spellings the JAX package
accepts) name the CUDA kernel; "ref" the plain PyTorch version; "auto" the
kernel for a CUDA tensor and the plain version for a CPU tensor.  The
kernel wrappers themselves compute the plain version for CPU tensors, so
"fused" on the CPU equals "ref".  `force_impl` overrides what "auto"
resolves to, here and in the DP ops; an explicit impl always wins.

``domain``: "float" cancels the pairwise masks to fp32 rounding; "int"
runs the fixed-point Z_2^32 one-time pads (`field.py`), whose share-sum is
exact for any reduction order.  In the int domain the impl only picks how
the exact share-sum is computed; decode and blend run through the one
shared `ref.int_blend_rows`.
"""
from __future__ import annotations

import contextlib
import threading

import numpy as np
import torch

from repro_torch.pytree import tree_flatten, tree_unflatten
from repro_torch.kernels.secure_agg import field as _field
from repro_torch.kernels.secure_agg import kernel as _k
from repro_torch.kernels.secure_agg import ref as _ref

_dispatch = threading.local()

_VALID_IMPLS = ("fused", "pallas", "ref", "auto")
_VALID_DOMAINS = ("float", "int")


def unknown_impl(impl) -> ValueError:
    """Uniform dispatch error for every secure-agg/dp entry point."""
    return ValueError(f"unknown impl {impl!r}; valid impls: "
                      f"'fused'/'pallas' (aliases), 'ref', 'auto'")


def normalize_seed(seed) -> int:
    """One seed contract for every impl and domain -> int in [0, 2^32).

    Python/numpy ints of any sign or width are reduced mod 2^32; arrays and
    tensors must hold exactly one uint32 element; anything else raises
    instead of silently casting into a different stream."""
    if isinstance(seed, (bool, np.bool_)):
        raise ValueError(f"seed must be an int or a uint32 array, got "
                         f"{seed!r}")
    if isinstance(seed, (int, np.integer)):
        return int(seed) & 0xFFFFFFFF
    if isinstance(seed, (np.ndarray, torch.Tensor)):
        if seed.dtype not in (np.uint32, torch.uint32):
            raise ValueError(f"seed arrays must be uint32, got dtype "
                             f"{seed.dtype} (pass a Python int for the "
                             f"mod-2^32 wrap, or cast explicitly)")
        n = seed.size if isinstance(seed, np.ndarray) else seed.numel()
        if n != 1:
            raise ValueError(f"seed must hold one element, got shape "
                             f"{tuple(seed.shape)}")
        return int(seed.reshape(-1)[0].item()) & 0xFFFFFFFF
    raise ValueError(f"seed must be an int or a uint32 array, got "
                     f"{type(seed).__name__}")


def _check_domain(domain: str) -> None:
    if domain not in _VALID_DOMAINS:
        raise ValueError(f"unknown domain {domain!r}; valid domains: "
                         f"{_VALID_DOMAINS}")


@contextlib.contextmanager
def force_impl(impl):
    """Thread-local override of what ``impl="auto"`` resolves to, for the
    secure-agg and DP ops alike; an explicit `impl` argument always wins,
    `None` is a no-op (caller code stays unconditional), and the outer
    override comes back on the way out, an exception included.  The JAX
    package's mesh engine forces "ref" once the institution axis spans
    devices (its kernel needs the whole (P, N) in one core's VMEM); the
    port's mesh engine gathers the whole (P, N) on every rank, so it
    forces nothing.  On CUDA tensors, "ref" runs the plain PyTorch
    version on the card, with no kernel, and the call site does not show
    it: nothing in the port may set it (the tests use it)."""
    prev = getattr(_dispatch, "forced", None)
    _dispatch.forced = impl if impl is not None else prev
    try:
        yield
    finally:
        _dispatch.forced = prev


def _auto_impl(default: str) -> str:
    forced = getattr(_dispatch, "forced", None)
    return forced if forced is not None else default


def resolve_impl(impl: str) -> str:
    """"fused" or "ref" for a valid impl spelling ("auto": the forced
    impl, else "fused")."""
    if impl == "auto":
        impl = _auto_impl("fused")
    if impl not in _VALID_IMPLS:
        raise unknown_impl(impl)
    return "ref" if impl == "ref" else "fused"


def rolling_update_flat(shares: torch.Tensor, params: torch.Tensor, alpha,
                        *, impl: str = "auto", block_n: int = 65536,
                        domain: str = "float",
                        frac_bits: int = _field.FRAC_BITS) -> torch.Tensor:
    """Legacy two-stage round.  shares: (P, N); params: (N,); alpha:
    scalar -> (N,) in params.dtype.

    domain="float": shares are f32 masked shares (`core.secure_agg
    .make_shares`), their mean blended by the kernel.  domain="int": shares
    are uint32 field shares (`make_shares_int`), summed exactly mod 2^32
    (kernel or plain version, the same bits) and decoded + blended once by
    the shared `ref.int_blend_params`.  `block_n` is the TPU kernel's
    column block; it is accepted for the JAX package's signature and no
    result depends on it."""
    _check_domain(domain)
    impl = resolve_impl(impl)
    del block_n
    if domain == "int":
        if shares.dtype != torch.uint32:
            raise ValueError(f"domain='int' takes uint32 field shares "
                             f"(make_shares_int), got dtype {shares.dtype}")
        if impl == "fused":
            wsum = _k.field_wsum_flat(shares)
        else:
            wsum = _ref.field_wsum_reference(shares)
        return _ref.int_blend_params(params, wsum, shares.shape[0], alpha,
                                     frac_bits=frac_bits)
    if impl == "fused":
        return _k.rolling_update_flat(shares, params, alpha)
    return _ref.rolling_update_reference(shares, params, alpha)


def masked_rolling_update(updates: torch.Tensor, seed, alpha, *, mask=None,
                          impl: str = "auto", domain: str = "float",
                          frac_bits: int = _field.FRAC_BITS) -> torch.Tensor:
    """Fused MPC round.  updates: (P, N) raw rows; seed: int (wrapped mod
    2^32) or single-element uint32 array; alpha: scalar; mask: optional
    (P,) participation -> (P, N) in updates.dtype.  Surviving row p becomes
    ``u_p + alpha * (masked survivor mean - u_p)``; dropped rows pass
    through and only survivor-survivor pairs exchange masks."""
    _check_domain(domain)
    impl = resolve_impl(impl)
    seed = normalize_seed(seed)
    if domain == "int":
        if impl == "fused":
            wsum = _k.masked_field_wsum_flat(updates, seed, mask,
                                             frac_bits=frac_bits)
        else:
            wsum = _ref.masked_field_wsum_reference(updates, seed, mask,
                                                    frac_bits=frac_bits)
        return _ref.int_blend_rows(updates, wsum, alpha, mask,
                                   frac_bits=frac_bits)
    if impl == "fused":
        return _k.masked_rolling_update_flat(updates, seed, alpha, mask)
    return _ref.masked_rolling_update_reference(updates, seed, alpha, mask)


def _ravel(tree) -> tuple:
    """One tree -> (flat (N,) tensor in the leaves' promoted dtype, its
    unravel), in the JAX package's ``ravel_pytree`` leaf order."""
    leaves, spec = tree_flatten(tree)
    dtype = leaves[0].dtype
    for leaf in leaves[1:]:
        dtype = torch.promote_types(dtype, leaf.dtype)
    flat = torch.cat([leaf.reshape(-1).to(dtype) for leaf in leaves])
    specs = [(leaf.shape, leaf.dtype, leaf.numel()) for leaf in leaves]

    def unravel(vec: torch.Tensor):
        out, off = [], 0
        for shape, dt, sz in specs:
            out.append(vec[off:off + sz].reshape(shape).to(dt))
            off += sz
        return tree_unflatten(spec, out)

    return flat, unravel


def rolling_update_tree(share_trees, params, alpha, *, impl: str = "auto",
                        domain: str = "float"):
    """`rolling_update_flat` across a list of P pytrees of shares into one
    params pytree."""
    shares = torch.stack([_ravel(t)[0] for t in share_trees])
    flat_p, unravel = _ravel(params)
    return unravel(rolling_update_flat(shares, flat_p, alpha, impl=impl,
                                       domain=domain))
