"""Plain-PyTorch version of the DP clip-and-noise kernel, the row-norm
pre-pass that both versions share, and the kernel's own arithmetic."""
from __future__ import annotations

import torch

from repro_torch.kernels.secure_agg import masking
from repro_torch.kernels.secure_agg import ref as _agg_ref
from repro_torch.kernels.secure_agg.ref import _alive


def _row_norms(updates: torch.Tensor) -> torch.Tensor:
    """(P, 1) f32 L2 norm per institution row: a cross-column reduction,
    computed once before either version runs and handed to it."""
    sq = torch.square(updates.to(torch.float32))
    return torch.sqrt(sq.sum(dim=1, keepdim=True))


def clip_factor(row_norms: torch.Tensor, clip) -> torch.Tensor:
    """min(1, C / max(||u_p||, 1e-12)) per row."""
    norm = torch.clamp(row_norms.to(torch.float32), min=1e-12)
    return torch.clamp(torch.as_tensor(clip, dtype=torch.float32,
                                       device=norm.device) / norm, max=1.0)


def clip_noise_reference(updates: torch.Tensor, seed: int, clip, sigma,
                         mask=None, row_norms=None, *,
                         chunk: int = 1 << 20) -> torch.Tensor:
    """Surviving row p -> min(1, C/||u_p||) * u_p + sigma*C * z_p, z from
    ``masking.normal_block(seed, p, column)``; dead rows pass through.
    `chunk` bounds the transient (P, chunk) noise block."""
    P, N = updates.shape
    dev = updates.device
    if row_norms is None:
        row_norms = _row_norms(updates)
    factor = clip_factor(row_norms, clip)
    scale = torch.as_tensor(sigma, dtype=torch.float32, device=dev) * \
        torch.as_tensor(clip, dtype=torch.float32, device=dev)
    alive = _alive(mask, P, dev)
    u = updates.to(torch.float32)
    row = torch.arange(P, device=dev)[:, None]
    outs = []
    for start in range(0, N, chunk):
        stop = min(start + chunk, N)
        offs = torch.arange(start, stop, device=dev)[None, :]
        z = masking.normal_block(seed, row, offs, dev)
        uc = u[:, start:stop]
        noised = factor * uc + scale * z
        # where(), not *: a dropped row's inf/NaN cannot leak via 0 * inf
        outs.append(torch.where(alive > 0.0, noised, uc))
    out = outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)
    return out.to(updates.dtype)


# ----------------------------------------------------------------------
# `clip_noise_kernel`'s own arithmetic (csrc/secure_agg.cu), in PyTorch.
# Nothing on the main path calls it: the CPU tests hold it against the
# plain version and the JAX package, the card tests the kernel against it.

def split_dp_words(seed, P: int, offs: torch.Tensor):
    """(b1, b2): the (P, N) uint32 words (as int64) of the two Box-Muller
    streams of rows 0..P-1 at column counters `offs` (N,), through the
    split hash.  Stream p of tag t is pair stream p of seed ^ t, so its
    split key is ``split_pair_keys(seed ^ t)[p]``; the split counter is
    computed once per column for both streams.  Equal to
    ``masking.mask_bits(seed ^ t, p, offs)``."""
    seed = int(seed) & masking.M32
    c = _agg_ref.split_counter(offs)[None, :]
    return tuple(
        _agg_ref.mix32_tail(
            _agg_ref.split_pair_keys(seed ^ tag, P, offs.device)[:, None] ^ c)
        for tag in (masking.DP_TAG_A, masking.DP_TAG_B))


def clip_noise_kernel_order(updates: torch.Tensor, seed: int, clip, sigma,
                            mask=None, row_norms=None) -> torch.Tensor:
    """`clip_noise_kernel`'s arithmetic: the words from `split_dp_words`,
    each row's factor min(1, C / max(||u_p||, 1e-12)) once, Box-Muller and
    factor u + (sigma C) z in the plain version's order, rounded after each
    operation; dead rows pass through.  One (P, N) block, no chunks."""
    P, N = updates.shape
    dev = updates.device
    if row_norms is None:
        row_norms = _row_norms(updates)
    factor = clip_factor(row_norms, clip)
    scale = torch.as_tensor(sigma, dtype=torch.float32, device=dev) * \
        torch.as_tensor(clip, dtype=torch.float32, device=dev)
    b1, b2 = split_dp_words(seed, P, torch.arange(N, device=dev))
    u1 = ((b1 >> 8) + 1).to(torch.float32) * masking._U24    # (0, 1]
    u2 = (b2 >> 8).to(torch.float32) * masking._U24          # [0, 1)
    z = masking.box_muller(u1, u2)
    u = updates.to(torch.float32)
    out = torch.where(_alive(mask, P, dev) > 0.0, factor * u + scale * z, u)
    return out.to(updates.dtype)
