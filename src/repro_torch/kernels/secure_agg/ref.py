"""Plain-PyTorch versions of the secure-aggregation kernels.

They are what the CPU runs, what the tests hold against the JAX package,
and what ``chip_smoke.py`` holds the CUDA kernels against on the card.

Output dtype contract, in both domains (the int-domain decode runs in f32
and casts back once at the end):

  rolling_update_*         -> params.dtype   (blends ONE params row)
  masked_rolling_update_*  -> updates.dtype  (blends ALL P update rows)

Field shares travel as ``torch.uint32`` tensors (the legacy two-stage
path's published shares) or as int64 words in [0, 2^32) inside the plain
arithmetic; share-sums as int32 bit patterns.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.secure_agg import field, masking
from repro_torch.kernels.secure_agg.masking import M32


def _alive(mask, P: int, device) -> torch.Tensor:
    """(P, 1) f32 participation column (None = everyone)."""
    if mask is None:
        return torch.ones((P, 1), dtype=torch.float32, device=device)
    return torch.as_tensor(mask, device=device).to(torch.float32).reshape(P, 1)


def _pair_alive(sign: torch.Tensor, alive: torch.Tensor) -> torch.Tensor:
    """(1, npairs) bool: pairs whose two members both survive.  Only those
    exchange masks (the Bonawitz dropout semantics)."""
    return (alive * sign.abs()).sum(dim=0, keepdim=True) == 2.0


def _pair_gates(sign: torch.Tensor, alive: torch.Tensor):
    """(pos, neg) int64 0/1 matrices (P, npairs): the field-domain pad
    application, survivor-pair gated."""
    pa = _pair_alive(sign, alive)
    return (((sign > 0) & pa).to(torch.int64),
            ((sign < 0) & pa).to(torch.int64))


def _apply_pads(q: torch.Tensor, pos: torch.Tensor, neg: torch.Tensor,
                words: torch.Tensor) -> torch.Tensor:
    """q + pos @ words - neg @ words mod 2^32, one pair at a time (CUDA has
    no integer matmul; every partial value stays below 2^40)."""
    for k in range(words.shape[0]):
        w = words[k]
        q = q + pos[:, k:k + 1] * w - neg[:, k:k + 1] * w
    return q & M32


def rolling_update_reference(shares: torch.Tensor, params: torch.Tensor,
                             alpha) -> torch.Tensor:
    """The legacy float round: mean over the P pre-masked shares (P, N),
    blended into one params row (N,) as ``p + alpha * (mean - p)`` ->
    (N,) in params.dtype.  The mean is the f32 sum divided by P, as the
    kernel computes it."""
    agg = shares.to(torch.float32).sum(dim=0) / float(shares.shape[0])
    p = params.to(torch.float32)
    a = torch.as_tensor(alpha, dtype=torch.float32,
                        device=p.device).reshape(())
    return (p + a * (agg - p)).to(params.dtype)


def field_wsum_reference(shares: torch.Tensor, *,
                         chunk: int = 1 << 24) -> torch.Tensor:
    """The legacy int round's share-sum: (P, N) uint32 field shares ->
    (N,) int32 bit patterns of their exact column sum mod 2^32.  `chunk`
    bounds the (P, chunk) int64 transient; the sum does not depend on
    it."""
    if shares.dtype != torch.uint32:
        raise ValueError(f"field shares are uint32, got {shares.dtype}")
    words = shares.view(torch.int32)
    N = shares.shape[1]
    out = torch.empty((N,), dtype=torch.int32, device=shares.device)
    for start in range(0, N, chunk):
        stop = min(start + chunk, N)
        out[start:stop] = field.to_int32(
            words[:, start:stop].to(torch.int64).sum(dim=0))
    return out


def int_blend_params(params: torch.Tensor, wsum: torch.Tensor, count, alpha,
                     *, frac_bits: int = field.FRAC_BITS) -> torch.Tensor:
    """Decode + blend of the legacy int round: exact share-sum (int32 bit
    patterns) -> mean over `count` shares -> rolling update of ONE params
    row -> (N,) in params.dtype."""
    p = params.to(torch.float32)
    agg = field.decode_mean(wsum, torch.tensor(float(count),
                                               device=p.device), frac_bits)
    a = torch.as_tensor(alpha, dtype=torch.float32,
                        device=p.device).reshape(())
    return (p + a * (agg - p)).to(params.dtype)


def rolling_update_int_reference(shares: torch.Tensor, params: torch.Tensor,
                                 alpha, *,
                                 frac_bits: int = field.FRAC_BITS):
    """The legacy int round: (P, N) uint32 field shares
    (`core.secure_agg.make_shares_int`), summed exactly and decoded +
    blended by `int_blend_params` -> (N,) in params.dtype."""
    return int_blend_params(params, field_wsum_reference(shares),
                            shares.shape[0], alpha, frac_bits=frac_bits)


def int_blend_rows(updates: torch.Tensor, wsum: torch.Tensor, alpha,
                   mask=None, *, frac_bits: int = field.FRAC_BITS):
    """Decode + blend of the int domain: exact survivor share-sum (int32
    bit patterns) -> survivor mean -> rolling update of all P rows (dead rows pass
    through bit-identically) -> (P, N) in updates.dtype."""
    P = updates.shape[0]
    u = updates.to(torch.float32)
    a = torch.as_tensor(alpha, dtype=torch.float32, device=u.device)
    if mask is None:
        agg = field.decode_mean(wsum, torch.tensor(float(P), device=u.device),
                                frac_bits)
        return (u + a * (agg[None, :] - u)).to(updates.dtype)
    alive = _alive(mask, P, u.device)
    count = torch.clamp(alive.sum(), min=1.0)
    agg = field.decode_mean(wsum, count, frac_bits)
    blended = u + a * (agg[None, :] - u)
    return torch.where(alive > 0.0, blended, u).to(updates.dtype)


def field_shares_reference(updates: torch.Tensor, seed: int, mask=None, *,
                           frac_bits: int = field.FRAC_BITS,
                           start: int = 0) -> torch.Tensor:
    """The (P, N) uint32 field shares (int64 words) each institution would
    publish: encode(update) +/- the survivor-gated pairwise `mask_bits`
    words.  `start` is the PRG counter of column 0, so a caller can build
    the shares of a long row one column chunk at a time."""
    P, N = updates.shape
    dev = updates.device
    sign = torch.as_tensor(masking.pair_sign_matrix(P), device=dev)
    pos, neg = _pair_gates(sign, _alive(mask, P, dev))
    pair = torch.arange(sign.shape[1], device=dev)[:, None]
    offs = torch.arange(start, start + N, device=dev)[None, :]
    words = masking.mask_bits(seed, pair, offs, dev)
    q = field.encode_rows(updates.to(torch.float32), frac_bits)
    return _apply_pads(q, pos, neg, words)


def masked_rolling_update_reference(updates: torch.Tensor, seed: int, alpha,
                                    mask=None, *, chunk: int = 1 << 20):
    """The fused float MPC round: masks from ``mask_block(seed, pair,
    column)`` exchanged by survivor pairs, masked survivor mean, then
    ``u + alpha * (agg - u)`` on surviving rows; dead rows pass through.
    `chunk` bounds the transient (npairs, chunk) mask block; the mask
    derivation does not depend on it."""
    P, N = updates.shape
    dev = updates.device
    sign = torch.as_tensor(masking.pair_sign_matrix(P), device=dev)
    alive = _alive(mask, P, dev)
    sign_alive = sign * _pair_alive(sign, alive).to(torch.float32)
    count = torch.clamp(alive.sum(), min=1.0)
    a = torch.as_tensor(alpha, dtype=torch.float32, device=dev)
    u = updates.to(torch.float32)
    pair = torch.arange(sign.shape[1], device=dev)[:, None]
    outs = []
    for start in range(0, N, chunk):
        stop = min(start + chunk, N)
        offs = torch.arange(start, stop, device=dev)[None, :]
        m = masking.mask_block(seed, pair, offs, device=dev)
        # in float64 the net pad is exact before its one rounding to f32,
        # and no TF32 setting can reach it
        net = (sign_alive.double() @ m.double()).to(torch.float32)
        uc = u[:, start:stop]
        # where(), not *: a dead row holding inf/NaN must not poison the
        # survivors' aggregate
        agg = torch.where(alive > 0.0, uc + net, 0.0).sum(dim=0) / count
        blended = uc + a * (agg[None, :] - uc)
        outs.append(torch.where(alive > 0.0, blended, uc))
    out = outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)
    return out.to(updates.dtype)


def masked_field_wsum_reference(updates: torch.Tensor, seed: int, mask=None,
                                *, chunk: int = 1 << 20,
                                frac_bits: int = field.FRAC_BITS):
    """(N,) int32 bit patterns of the exact uint32 survivor share-sum of
    the Z_2^32 MPC round: encode, survivor-gated one-time-pad words
    added/subtracted mod 2^32, wrapping sum over surviving rows.
    Identical for any chunk."""
    P, N = updates.shape
    dev = updates.device
    sign = torch.as_tensor(masking.pair_sign_matrix(P), device=dev)
    alive = _alive(mask, P, dev)
    pos, neg = _pair_gates(sign, alive)
    u = updates.to(torch.float32)
    pair = torch.arange(sign.shape[1], device=dev)[:, None]
    outs = []
    for start in range(0, N, chunk):
        stop = min(start + chunk, N)
        offs = torch.arange(start, stop, device=dev)[None, :]
        words = masking.mask_bits(seed, pair, offs, dev)
        shares = _apply_pads(field.encode_rows(u[:, start:stop], frac_bits),
                             pos, neg, words)
        # where(), not *: a dead row's saturated encode stays out
        outs.append(field.to_int32(
            torch.where(alive > 0.0, shares, 0).sum(dim=0)))
    return outs[0] if len(outs) == 1 else torch.cat(outs)

