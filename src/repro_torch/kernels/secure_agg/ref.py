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



# ----------------------------------------------------------------------
# The fused kernels' own arithmetic (csrc/secure_agg.cu), in PyTorch.
# Nothing on the main path calls these: they are what the CPU tests hold
# against the JAX package and what the card tests hold the kernels
# against bit for bit.

_U23 = 2.0 ** -23
REGISTER_ROWS = 16   # the kernels that hold a column's rows in registers


def split_pair_keys(seed, npairs: int, device=None) -> torch.Tensor:
    """(npairs,) int64: key ^ (key >> 16) of each pair's stream key
    mix32(mix32(seed ^ golden) ^ k * pair_mul).  mix32's first xor-shift
    distributes over xor, so mask_bits(seed, k, col) ==
    mix32_tail(key'_k ^ c'_col) with c' from `split_counter`."""
    seed = masking._as_u32(int(seed) & M32, device)
    pair = torch.arange(npairs, dtype=torch.int64, device=device)
    h = masking._mix32(seed ^ masking.GOLDEN)
    key = masking._mix32(h ^ masking._mul32(pair, masking.PAIR_MUL))
    return key ^ (key >> 16)


def split_counter(offs: torch.Tensor) -> torch.Tensor:
    """c ^ (c >> 16), c = col * golden mod 2^32: the counter's half of
    mix32's first xor-shift, once per column."""
    c = masking._mul32(offs.to(torch.int64) & M32, masking.GOLDEN)
    return c ^ (c >> 16)


def mix32_tail(x: torch.Tensor) -> torch.Tensor:
    """mix32 after its first xor-shift: 5 logic/shift ops, 2 multiplies."""
    x = masking._mul32(x, masking.MUL_A)
    x = x ^ (x >> 15)
    x = masking._mul32(x, masking.MUL_B)
    return x ^ (x >> 16)


def split_mask_bits(seed, npairs: int, offs: torch.Tensor) -> torch.Tensor:
    """(npairs, N) uint32 words (as int64) of pairs 0..npairs-1 at column
    counters `offs` (N,) through the split hash; equal to
    ``masking.mask_bits``."""
    keys = split_pair_keys(seed, npairs, offs.device)
    return mix32_tail(keys[:, None] ^ split_counter(offs)[None, :])


def _alive_rows(mask, P: int) -> list:
    return [bool(a) for a in (_alive(mask, P, "cpu")[:, 0] > 0.0).tolist()]


def int_net_pads(seed, P: int, offs: torch.Tensor, mask=None):
    """(P, N) int64: row p's net float pad in units of 2^-23, as the float
    kernel sums it in int32.  A mask value is exactly ((bits >> 8) - 2^23)
    2^-23, so the net is sum_k sign (bits_k >> 8) over the row's alive
    pairs, started at -2^23 d_p (d_p: their sign sum).  Exact, so the
    order of the pairs does not matter; |net| < 2^28."""
    alive = _alive_rows(mask, P)
    pairs = masking.pair_list(P)
    words = split_mask_bits(seed, len(pairs), offs)
    net = torch.zeros((P, offs.shape[0]), dtype=torch.int64,
                      device=offs.device)
    for p in range(P):
        if alive[p]:
            above = sum(alive[p + 1:])
            below = sum(alive[:p])
            net[p] = (below - above) << 23
    for k, (i, j) in enumerate(pairs):
        if alive[i] and alive[j]:
            b = words[k] >> 8
            net[i] += b
            net[j] -= b
    return net


def float_net_pads(seed, P: int, offs: torch.Tensor, mask=None):
    """(P, N) f32 net pads: the exact integer net converted once (round to
    nearest even) and scaled by 2^-23, which is exact."""
    return int_net_pads(seed, P, offs, mask).to(torch.float32) * _U23


def masked_rolling_update_kernel_order(updates: torch.Tensor, seed: int,
                                       alpha, mask=None) -> torch.Tensor:
    """The fused float round in `masked_rolling_update_kernel`'s order:
    net pads from `float_net_pads` (past REGISTER_ROWS rows the tile
    walk's integers, `wide_int_net_pads`: the same ones), the survivors'
    shares summed in row order 0..P-1 from 0, IEEE division by max(count,
    1) (a full tensor, so no backend divides by a reciprocal), and the
    blend u + alpha (agg - u) rounded after each operation; dead rows pass
    through."""
    P, N = updates.shape
    dev = updates.device
    alive = _alive_rows(mask, P)
    u = updates.to(torch.float32)
    nets = int_net_pads if P <= REGISTER_ROWS else wide_int_net_pads
    net = nets(seed, P, torch.arange(N, device=dev), mask).to(
        torch.float32) * _U23
    total = torch.zeros((N,), dtype=torch.float32, device=dev)
    for p in range(P):
        if alive[p]:
            total = total + (u[p] + net[p])
    agg = total / torch.full_like(total, float(max(sum(alive), 1)))
    a = torch.tensor(float(alpha), dtype=torch.float32, device=dev)
    out = u.clone()
    for p in range(P):
        if alive[p]:
            out[p] = u[p] + a * (agg - u[p])
    return out.to(updates.dtype)


def encode_rows_clamp_first(x: torch.Tensor,
                            frac_bits: int = field.FRAC_BITS):
    """`field.encode_rows` in the int kernel's order: clamp x * 2^frac_bits
    to [-2^31, 2^31 - 128], then round half to even once.  Equal to
    round-then-clamp: no f32 lies strictly between 2^31 - 128 and 2^31.
    A NaN clamps to -2^31 (fmaxf returns the other operand)."""
    s = x.to(torch.float32) * float(2.0 ** frac_bits)
    s = torch.where(torch.isnan(s), field.I32_MIN_F, s)
    s = torch.clamp(s, field.I32_MIN_F, field.I32_MAX_F)
    return torch.round(s).to(torch.int64) & M32


def masked_field_wsum_kernel_order(updates: torch.Tensor, seed: int,
                                   mask=None, *,
                                   frac_bits: int = field.FRAC_BITS):
    """The Z_2^32 share-sum in `masked_field_wsum_kernel`'s order: the pad
    words of the alive pairs through the split hash, accumulated per row
    from 0 (+w on row i, -w on row j; past REGISTER_ROWS rows in the tile
    walk, `wide_field_pads`), then each survivor's encode added and the
    shares summed with wrapping adds -> (N,) int32 bit patterns."""
    P, N = updates.shape
    dev = updates.device
    alive = _alive_rows(mask, P)
    offs = torch.arange(N, device=dev)
    if P > REGISTER_ROWS:
        pad = wide_field_pads(seed, P, offs, mask)
    else:
        pairs = masking.pair_list(P)
        words = split_mask_bits(seed, len(pairs), offs)
        pad = torch.zeros((P, N), dtype=torch.int64, device=dev)
        for k, (i, j) in enumerate(pairs):
            if alive[i] and alive[j]:
                pad[i] = (pad[i] + words[k]) & M32
                pad[j] = (pad[j] - words[k]) & M32
    enc = encode_rows_clamp_first(updates, frac_bits)
    total = torch.zeros((N,), dtype=torch.int64, device=dev)
    for p in range(P):
        if alive[p]:
            total = (total + enc[p] + pad[p]) & M32
    return field.to_int32(total)


# ----------------------------------------------------------------------
# The P > 16 pair kernels' walk (csrc/secure_agg.cu, "The fused kernels at
# P > 16"): rows in tiles of WIDE_TILE, each pair's word hashed once, tile
# I's nets in registers and the later rows' in per-column accumulators,
# summed in wrapping unsigned arithmetic.  The kernel-order models take
# their nets and pads from here past REGISTER_ROWS rows.

WIDE_TILE = 16
NET32_ROWS = 256     # |net| < P 2^23: int32 holds the float net up to here


def wide_pair_tiles(P: int) -> list:
    """The walk: [(I, J, pairs)] for the tile pairs (I, J), I <= J, of
    WIDE_TILE-row tiles in the kernel's order (I outer), `pairs` the (i,
    j), i < j < P, with row i in tile I and j in tile J, in the order the
    kernel hashes them (j's offset in its tile outer, i's inner)."""
    T = -(-P // WIDE_TILE)
    walk = []
    for I in range(T):
        for J in range(I, T):
            walk.append((I, J, [
                (WIDE_TILE * I + a, WIDE_TILE * J + b)
                for b in range(WIDE_TILE)
                for a in range(WIDE_TILE if J > I else b)
                if WIDE_TILE * J + b < P]))
    return walk


def _wide_walk_sums(seed, P: int, offs: torch.Tensor, mask, shift: int,
                    bits: int) -> torch.Tensor:
    """(P, N) int64: each row's sum of its alive pairs' words >> `shift`
    (+ as the pair's i, - as its j), modulo 2^bits (bits = 64: int64's own
    wrapping).  The kernel adds the same words in the walk's order, tile
    I's nets in its registers and a later row's in its accumulator; a sum
    modulo 2^bits is the same in any order, so each tile row I of the walk
    goes in one op (|a row's sum| < P 2^32 before the wrap)."""
    alive = torch.tensor(_alive_rows(mask, P), device=offs.device)
    keys = split_pair_keys(seed, P * (P - 1) // 2, offs.device)
    c = split_counter(offs)
    wrap = (1 << bits) - 1 if bits < 64 else -1
    sums = torch.zeros((P, offs.shape[0]), dtype=torch.int64,
                       device=offs.device)
    rows = {}
    for I, _, pairs in wide_pair_tiles(P):
        rows.setdefault(I, []).extend(pairs)
    for pairs in rows.values():
        if not pairs:
            continue
        i, j = (torch.tensor(v, device=offs.device) for v in zip(*pairs))
        k = i * (2 * P - i - 1) // 2 + (j - i - 1)
        w = (mix32_tail(keys[k][:, None] ^ c[None, :]) >> shift) * (
            alive[i] & alive[j])[:, None]
        sums.index_add_(0, i, w)
        sums.index_add_(0, j, -w)
    return sums & wrap


def wide_int_net_pads(seed, P: int, offs: torch.Tensor, mask=None):
    """(P, N) int64: `int_net_pads` as the P > 16 float kernel sums them:
    the words' top 24 bits walked modulo 2^32 (2^64 past NET32_ROWS rows),
    the offset -2^23 d_p added when the row's tile is done, the result
    read as a signed integer.  Exact, since |net| < P 2^23."""
    bits = 32 if P <= NET32_ROWS else 64
    net = _wide_walk_sums(seed, P, offs, mask, 8, bits)
    alive = _alive_rows(mask, P)
    count, below = sum(alive), 0
    for p in range(P):
        if alive[p]:
            net[p] += (2 * below + 1 - count) << 23
            below += 1
    if bits == 32:
        net &= M32
        net = torch.where(net >= 2 ** 31, net - 2 ** 32, net)
    return net


def wide_field_pads(seed, P: int, offs: torch.Tensor, mask=None):
    """(P, N) int64 in [0, 2^32): each row's pad words (+w as a pair's i,
    -w as its j) as the P > 16 int kernel walks them, modulo 2^32."""
    return _wide_walk_sums(seed, P, offs, mask, 0, 32)

