"""Built-in merge strategies: ``mean``, ``ring`` (one gossip hop),
``hierarchical`` (group means, then a ring of groups),
``hierarchical_device`` (the device-weighted institution mean of a
two-tier federation), ``quantized`` (int8 operands on the wire) and the
paper's MPC ``secure_mean``.

Each exists as a keyword-argument function and as a registered
`MergeStrategy` adapting `MergeContext` onto it.  Every one is
consensus-gated (`ctx.commit`: a rejected round is the identity) and
participation-masked (`ctx.mask`: dead institutions are left out of the
reduction and keep their params bit for bit).
"""
from __future__ import annotations

from typing import Any, Optional

import torch

from repro_torch.core.merges.base import MergeContext, register_merge
from repro_torch.core.merges.toolkit import (
    gate, mask_nd, masked_abs_max, masked_mean, ring_neighbor_indices,
    rolling, survivor_count,
)
from repro_torch.core.secure_agg import secure_rolling_update_tree
from repro_torch.pytree import tree_flatten, tree_map

Pytree = Any


def mean_merge(stacked: Pytree, commit=True, *, alpha: float = 1.0,
               mask: Optional[torch.Tensor] = None) -> Pytree:
    """Consensus-gated rolling update toward the federation mean (over the
    survivors when `mask` is given; non-survivors pass through)."""
    if mask is None:
        def merge(x):
            return rolling(x, x.mean(dim=0, keepdim=True), alpha)
        return gate(tree_map(merge, stacked), stacked, commit)

    m = torch.as_tensor(mask)
    count = survivor_count(m)

    def merge(x):
        mb = mask_nd(m.to(x.device), x).to(torch.bool)
        mean = masked_mean(x, mb, count.to(x.device))
        return torch.where(mb, rolling(x, mean, alpha), x)
    return gate(tree_map(merge, stacked), stacked, commit)


def ring_merge(stacked: Pytree, commit=True, *, shift=1,
               alpha: float = 0.5,
               mask: Optional[torch.Tensor] = None) -> Pytree:
    """One gossip hop: blend with the neighbour `shift` places away.
    Repeated with the overlay's `gossip_shift` schedule it converges to
    the mean without an all-reduce a round.  With `mask` the ring is
    re-stitched around the dead institutions, which keep their params."""
    if mask is None:
        def merge(x):
            neighbor = torch.roll(x, shift, dims=0)
            return (1 - alpha) * x + alpha * neighbor
        return gate(tree_map(merge, stacked), stacked, commit)

    m = torch.as_tensor(mask).to(torch.bool)
    nbr = ring_neighbor_indices(m, shift)

    def merge(x):
        neighbor = x.index_select(0, nbr.to(x.device))
        out = (1 - alpha) * x + alpha * neighbor
        return torch.where(mask_nd(m.to(x.device), x), out, x)
    return gate(tree_map(merge, stacked), stacked, commit)


def _check_group_size(P: int, group_size) -> None:
    """The hierarchical group layout, checked when the merge is called:
    P must split into whole groups (the message is the JAX package's)."""
    if group_size is None or int(group_size) < 1 or P % int(group_size):
        raise ValueError(
            f"hierarchical merge needs n_institutions divisible by "
            f"group_size; got P={P}, group_size={group_size}")


def hierarchical_merge(stacked: Pytree, commit=True, *,
                       group_size: int, alpha: float = 1.0,
                       mask: Optional[torch.Tensor] = None) -> Pytree:
    """Two levels: the mean within groups of `group_size` institutions,
    then each group's mean blended halfway with the previous group's (a
    ring hop between group leaders).  P % group_size must be 0.  With
    `mask` each group averages its survivors, and the ring of groups is
    re-stitched around groups whose members all dropped (those pass
    through unchanged)."""
    if mask is None:
        P = tree_flatten(stacked)[0][0].shape[0]
        _check_group_size(P, group_size)

        def merge(x):
            g = x.reshape(P // group_size, group_size, *x.shape[1:])
            intra = g.mean(dim=1, keepdim=True)
            inter = 0.5 * (intra + torch.roll(intra, 1, dims=0))
            merged = inter.expand(g.shape).reshape(x.shape)
            return rolling(x, merged, alpha)
        return gate(tree_map(merge, stacked), stacked, commit)

    m = torch.as_tensor(mask).to(torch.bool)
    P = m.shape[0]
    _check_group_size(P, group_size)
    G = P // group_size
    mg = m.reshape(G, group_size)
    # per-group survivor count (>= 1, so a dead group divides by 1)
    cnt = torch.clamp(mg.sum(dim=1).to(torch.float32), min=1.0)
    nbr = ring_neighbor_indices(mg.any(dim=1), 1)

    def merge(x):
        g = x.reshape(G, group_size, *x.shape[1:])
        tail = (1,) * (x.dim() - 1)
        gb = mg.to(x.device).reshape((G, group_size) + tail)
        c = cnt.to(x.device).reshape((G, 1) + tail)
        intra = masked_mean(g, gb, c, dim=1)                # (G, 1, ...)
        inter = 0.5 * (intra + intra.index_select(0, nbr.to(x.device)))
        merged = inter.expand(g.shape).reshape(x.shape)
        return torch.where(mask_nd(m.to(x.device), x),
                           rolling(x, merged, alpha), x)
    return gate(tree_map(merge, stacked), stacked, commit)


def quantize_leaf(x: torch.Tensor, mask_b: Optional[torch.Tensor],
                  bits: int = 8):
    """(q, scale): a leaf's int8 wire operands and its one scale.  The
    scale is max |x| over the surviving rows (`mask_b`, broadcast against
    x; None = all) over qmax = (2^(bits-1) - 1) // P, at least 1, so that
    P operands sum without overflow while P <= 2^(bits-1) - 1; a dead
    row's operands are 0."""
    P = x.shape[0]
    qmax = max((2 ** (bits - 1) - 1) // P, 1)
    absx_max = x.abs().max() if mask_b is None else \
        masked_abs_max(x, mask_b)
    scale = torch.clamp(absx_max, min=1e-12) / qmax
    q = torch.clamp(torch.round(x / scale), -qmax, qmax).to(torch.int8)
    if mask_b is not None:
        q = torch.where(mask_b, q, torch.zeros((), dtype=torch.int8,
                                               device=q.device))
    return q, scale


def quantized_mean_merge(stacked: Pytree, commit=True, *,
                         alpha: float = 1.0, bits: int = 8,
                         mask: Optional[torch.Tensor] = None) -> Pytree:
    """The mean over int8 wire operands: each leaf quantized with one
    scale of its own (`quantize_leaf`; a leaf of tiny biases is not
    crushed by a leaf of large kernels), the operands summed, dequantized
    and blended.  While P <= qcap = 2^(bits-1) - 1 the sum runs in int8
    and cannot wrap; past it the per-row budget is already 1 and P
    operands could exceed 127, so the accumulator widens to int32 (each
    operand still one int8): both hold the same integer wherever int8
    does not wrap.  `bits` outside [2, 8] cannot ship as int8 and raises.
    With `mask`, dead institutions send zero operands, the mean divides
    by the survivor count, and they keep their params."""
    if not 2 <= int(bits) <= 8:
        raise ValueError(
            f"quantized_mean_merge ships int8 operands; bits must be in "
            f"[2, 8], got bits={bits}")
    qcap = 2 ** (bits - 1) - 1
    m = None if mask is None else torch.as_tensor(mask)

    def merge(x):
        P = x.shape[0]
        mb = None if m is None else mask_nd(m.to(x.device), x).to(torch.bool)
        q, scale = quantize_leaf(x, mb, bits)
        acc = torch.int8 if P <= qcap else torch.int32
        sum_q = q.sum(dim=0, keepdim=True, dtype=acc)
        count = P if m is None else survivor_count(m).to(x.device)
        out = rolling(x, scale * sum_q.to(torch.float32) / count, alpha)
        return out if mb is None else torch.where(mb, out, x)
    return gate(tree_map(merge, stacked), stacked, commit)


def hierarchical_device_merge(stacked: Pytree, commit=True, *,
                              alpha: float = 1.0,
                              weights: Optional[torch.Tensor] = None,
                              mask: Optional[torch.Tensor] = None) -> Pytree:
    """The institution-level half of the two-tier federation: each row is
    already the FedAvg of an institution's device sub-federation
    (`core.device_tier`), so the cross-institution reduction is a mean
    WEIGHTED by each institution's device-weight total, and the two levels
    together are one device-weighted FedAvg over P x D devices.

    ``weights=None`` (no device tier) is `mean_merge`, bit for bit.  With
    `mask`, dropped institutions weigh zero and pass through untouched; a
    round whose surviving weights are all zero is the identity (decided on
    the device, without a host sync)."""
    if weights is None:
        return mean_merge(stacked, commit, alpha=alpha, mask=mask)
    w = torch.as_tensor(weights).to(torch.float32)
    m = None if mask is None else torch.as_tensor(mask).to(torch.bool)
    if m is not None:
        w = torch.where(m.to(w.device), w, 0.0)
    wtot = w.sum()
    wsafe = torch.clamp(wtot, min=1.0)

    def merge(x):
        wb = w.to(x.device).reshape((w.shape[0],) + (1,) * (x.dim() - 1))
        wmean = (x * wb).sum(dim=0, keepdim=True) / wsafe.to(x.device)
        out = rolling(x, wmean, alpha)
        if m is not None:
            out = torch.where(mask_nd(m.to(x.device), x), out, x)
        return torch.where(wtot.to(x.device) > 0, out, x)
    return gate(tree_map(merge, stacked), stacked, commit)


def secure_mean_merge(stacked: Pytree, commit=True, *, alpha: float, key,
                      mask=None, impl: str = "auto",
                      domain: str = "float") -> Pytree:
    """MPC path, fused: one (P, N) ravel of the stacked tree, one
    masked-rolling-update kernel pass (in-kernel PRG pads, aggregate, blend
    all P rows), then the consensus gate."""
    merged = secure_rolling_update_tree(stacked, alpha, key, mask=mask,
                                        impl=impl, domain=domain)
    return gate(merged, stacked, commit)


@register_merge("mean")
class MeanMerge:
    def merge(self, stacked: Pytree, ctx: MergeContext) -> Pytree:
        return mean_merge(stacked, ctx.commit, alpha=ctx.alpha, mask=ctx.mask)


@register_merge("ring")
class RingMerge:
    def merge(self, stacked: Pytree, ctx: MergeContext) -> Pytree:
        return ring_merge(stacked, ctx.commit, shift=ctx.shift,
                          alpha=ctx.alpha, mask=ctx.mask)


@register_merge("hierarchical")
class HierarchicalMerge:
    def merge(self, stacked: Pytree, ctx: MergeContext) -> Pytree:
        return hierarchical_merge(stacked, ctx.commit,
                                  group_size=ctx.group_size,
                                  alpha=ctx.alpha, mask=ctx.mask)


@register_merge("hierarchical_device")
class HierarchicalDeviceMerge:
    def merge(self, stacked: Pytree, ctx: MergeContext) -> Pytree:
        return hierarchical_device_merge(stacked, ctx.commit,
                                         alpha=ctx.alpha,
                                         weights=ctx.device_weights,
                                         mask=ctx.mask)


@register_merge("quantized")
class QuantizedMeanMerge:
    def merge(self, stacked: Pytree, ctx: MergeContext) -> Pytree:
        return quantized_mean_merge(stacked, ctx.commit, alpha=ctx.alpha,
                                    mask=ctx.mask)


@register_merge("secure_mean")
class SecureMeanMerge:
    def merge(self, stacked: Pytree, ctx: MergeContext) -> Pytree:
        if ctx.key is None:
            raise ValueError("secure_mean needs ctx.key (the MPC round key)")
        return secure_mean_merge(stacked, ctx.commit, alpha=ctx.alpha,
                                 key=ctx.key, mask=ctx.mask,
                                 domain=ctx.domain)
