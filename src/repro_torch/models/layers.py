"""Building blocks of the dense transformer family, in PyTorch.

Params are plain pytrees (nested dicts of tensors).  A model module
defines a ``param_specs(cfg)`` tree of :class:`Spec` entries, from which
``init_params`` draws real tensors and ``param_count`` counts them.
Per-layer weights carry a leading ``layers`` dim, and the model runs a
Python loop over it where the JAX package runs ``lax.scan``.

Weights are kept in ``PARAM_DTYPE`` (fp32) and cast to the activations'
``COMPUTE_DTYPE`` (bf16) at each matmul, as in the reference.  Attention
goes to the hand-written Hopper flash kernel on CUDA tensors
(``impl="auto"``, ``"pallas"`` or ``"fused"``); one-token decode
attention is plain tensor code, as in the reference.  The MoE FFN's
routing (top-k, a stable sort, the capacity scatter and the combine) is
plain tensor code too, batched over the token groups; the reference runs
it outside any Pallas kernel as well.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.pytree import tree_flatten, tree_unflatten

COMPUTE_DTYPE = torch.bfloat16
PARAM_DTYPE = torch.float32


# ======================================================================
# Param spec machinery
# ======================================================================
@dataclasses.dataclass(frozen=True)
class Spec:
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]       # logical axis name per dim
    init: str = "normal"                  # normal | zeros | ones
    scale: float = 1.0                    # stddev multiplier for "normal"

    def __post_init__(self):
        assert len(self.shape) == len(self.axes), (self.shape, self.axes)


def init_params(specs, generator: torch.Generator):
    """Real tensors for a spec tree, drawn leaf by leaf (JAX leaf order)
    from `generator`, on the generator's device.  The draws differ from
    ``jax.random``'s: parity tests carry the JAX package's params across
    with `repro_torch.convert.params_from_jax`."""
    leaves, spec = tree_flatten(specs)
    dev = generator.device
    out = []
    for s in leaves:
        if s.init == "zeros":
            arr = torch.zeros(s.shape, dtype=PARAM_DTYPE, device=dev)
        elif s.init == "ones":
            arr = torch.ones(s.shape, dtype=PARAM_DTYPE, device=dev)
        else:
            fan_in = s.shape[-2] if len(s.shape) >= 2 else s.shape[-1]
            std = s.scale / np.sqrt(max(fan_in, 1))
            arr = torch.randn(s.shape, generator=generator,
                              dtype=PARAM_DTYPE, device=dev) * std
        out.append(arr)
    return tree_unflatten(spec, out)


def param_count(specs) -> int:
    return sum(int(np.prod(s.shape)) for s in tree_flatten(specs)[0])


def unstack_layers(block):
    """Every layer's weights out of a tree stacked on a leading layers
    dim, by one ``unbind`` a leaf: under autograd its backward stacks the
    layers' gradients once, where indexing one layer at a time would make
    each layer's gradient a zero-filled copy of the whole stack."""
    names = list(block)
    return [dict(zip(names, ws))
            for ws in zip(*(block[n].unbind(0) for n in names))]


def zero_aux(device) -> dict:
    """The auxiliary losses of a model without MoE layers: all 0."""
    zero = torch.zeros((), dtype=torch.float32, device=device)
    return {"load_balance": zero, "router_z": zero, "dropped_frac": zero}


# ======================================================================
# Activation recomputation (the reference's jax.checkpoint)
# ======================================================================
class _Recompute(torch.autograd.Function):
    """``fn(*inputs)`` that saves only its inputs and recomputes ``fn``
    under ``torch.func.vjp`` on the backward pass.  It composes with
    autograd, ``torch.func.grad`` and ``vmap(grad)`` (``setup_context``
    and a generated vmap rule); ``torch.utils.checkpoint`` composes with
    none of the transforms.  Integer inputs get no gradient."""
    generate_vmap_rule = True

    @staticmethod
    def forward(fn, *inputs):
        return fn(*inputs)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.fn = inputs[0]
        ctx.save_for_backward(*inputs[1:])

    @staticmethod
    def backward(ctx, *cotangents):
        inputs = ctx.saved_tensors
        diff = [i for i, t in enumerate(inputs) if t.is_floating_point()]

        def primal(*wrt):
            full = list(inputs)
            for i, t in zip(diff, wrt):
                full[i] = t
            return ctx.fn(*full)

        # the gradients leave detached: attached, they would keep the
        # recomputed graph (every layer's activations) alive, recorded for
        # a double backward that nothing takes, until the whole backward
        # pass ends
        with torch.enable_grad():
            _, vjp = torch.func.vjp(primal, *(inputs[i] for i in diff))
            grads = [None] * len(inputs)
            for i, g in zip(diff, vjp(cotangents)):
                grads[i] = g.detach()
        return (None, *grads)


def recompute(fn, *args):
    """``fn(*args)`` with its activations recomputed on the backward pass
    instead of kept: only the tensor leaves of `args` (the layer's input
    and params, passed explicitly so that their gradients flow) are
    saved.  `args` and the result are pytrees of tensors."""
    leaves, spec = tree_flatten(args)
    out_spec = []

    def flat_fn(*flat):
        out_leaves, o_spec = tree_flatten(fn(*tree_unflatten(spec, flat)))
        out_spec[:] = [o_spec]
        return tuple(out_leaves)

    out = _Recompute.apply(flat_fn, *leaves)
    return tree_unflatten(out_spec[0], list(out))


# ======================================================================
# Norms / activations
# ======================================================================
def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    dtype = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * weight.float()).to(dtype)


def head_rms_norm(x: torch.Tensor, weight: torch.Tensor,
                  eps: float = 1e-5) -> torch.Tensor:
    """qk-norm: RMSNorm over the head_dim of (..., H, hd), shared scale."""
    return rms_norm(x, weight, eps)


def swiglu(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    return F.silu(gate) * up


# ======================================================================
# Rotary position embeddings
# ======================================================================
def rope_frequencies(head_dim: int, theta: float, rope_style: str,
                     device=None) -> torch.Tensor:
    rot_dim = head_dim // 2 if rope_style == "half" else head_dim
    assert rot_dim % 2 == 0
    exponent = torch.arange(0, rot_dim, 2, dtype=torch.float32,
                            device=device) / rot_dim
    return 1.0 / (theta ** exponent)          # (rot_dim/2,)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
               rope_style: str = "full") -> torch.Tensor:
    """x: (B, S, H, hd); positions: (B, S) int.

    "full": rotate all head dims (llama convention, half-split pairing).
    "half": rotate only the first half of head dims (ChatGLM 2d-RoPE), the
            second half passes through unrotated.
    """
    hd = x.shape[-1]
    inv_freq = rope_frequencies(hd, theta, rope_style, x.device)
    angles = positions[..., None].float() * inv_freq        # (B,S,r/2)
    cos = torch.cos(angles)[:, :, None, :]                  # (B,S,1,r/2)
    sin = torch.sin(angles)[:, :, None, :]
    rot_dim = hd // 2 if rope_style == "half" else hd
    x_rot, x_pass = x[..., :rot_dim], x[..., rot_dim:]
    x1, x2 = x_rot.float().chunk(2, dim=-1)
    rotated = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return torch.cat([rotated.to(x.dtype), x_pass], dim=-1)


# ======================================================================
# Attention: the plain versions here, the Hopper flash kernel in
# repro_torch.kernels.flash_attention, selected by `attention`.
# ======================================================================
NEG_INF = -1e30
_ATTENTION_IMPLS = ("auto", "plain", "pallas", "fused", "chunked", "ref")


def _gqa_expand(k: torch.Tensor, n_q_heads: int) -> torch.Tensor:
    """(B, S, Hkv, hd) -> (B, S, Hq, hd) by repetition."""
    rep = n_q_heads // k.shape[2]
    if rep == 1:
        return k
    return k.repeat_interleave(rep, dim=2)


def attention_mask(q_pos: torch.Tensor, kv_pos: torch.Tensor, causal: bool,
                   window: int) -> torch.Tensor:
    """Boolean mask (..., Sq, Skv); True = attend."""
    diff = q_pos[..., :, None] - kv_pos[..., None, :]
    m = torch.ones(diff.shape, dtype=torch.bool, device=diff.device)
    if causal:
        m &= diff >= 0
    if window > 0:
        m &= diff < window
    return m


def mha_reference(q, k, v, *, causal: bool = True, window: int = 0,
                  q_positions=None, kv_positions=None,
                  kv_mask=None) -> torch.Tensor:
    """Naive softmax attention. q: (B,Sq,Hq,hd); k,v: (B,Skv,Hkv,hd)."""
    B, Sq, Hq, hd = q.shape
    Skv = k.shape[1]
    k = _gqa_expand(k, Hq)
    v = _gqa_expand(v, Hq)
    if q_positions is None:
        q_positions = torch.arange(Sq, device=q.device).expand(B, Sq)
    if kv_positions is None:
        kv_positions = torch.arange(Skv, device=q.device).expand(B, Skv)
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(),
                          k.float()) / math.sqrt(hd)
    mask = attention_mask(q_positions, kv_positions, causal, window)[:, None]
    if kv_mask is not None:
        mask = mask & kv_mask[:, None, None, :]
    scores = torch.where(mask, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    # fully-masked rows (can happen with rolling caches) -> zeros, not NaN
    probs = torch.where(mask.any(-1, keepdim=True), probs, 0.0)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v.float()).to(q.dtype)


def _fit_chunk(size: int, target: int) -> int:
    """Largest divisor of `size` that is <= target (>=1)."""
    c = min(target, size)
    while size % c:
        c -= 1
    return c


def mha_chunked(q, k, v, *, causal: bool = True, window: int = 0,
                q_chunk: int = 512, kv_chunk: int = 1024) -> torch.Tensor:
    """Online-softmax (flash-style) attention in plain tensor code.

    Bounds the transient score tensor to (B,H,q_chunk,kv_chunk); with a
    sliding window each q chunk visits only its kv band.  The same
    algorithm as the flash kernel."""
    B, Sq, Hq, hd = q.shape
    Skv = k.shape[1]
    k = _gqa_expand(k, Hq).float()
    v = _gqa_expand(v, Hq).float()
    q_chunk = _fit_chunk(Sq, q_chunk)
    kv_chunk = _fit_chunk(Skv, kv_chunk)
    nq, nk = Sq // q_chunk, Skv // kv_chunk
    scale = 1.0 / np.sqrt(hd)
    if window > 0:
        band = window + q_chunk
        band = min(((band + kv_chunk - 1) // kv_chunk) * kv_chunk, Skv)
        nk_eff = band // kv_chunk
    else:
        band, nk_eff = Skv, nk

    outs = []
    for qi in range(nq):
        qb = q[:, qi * q_chunk:(qi + 1) * q_chunk].float()
        q_pos = qi * q_chunk + torch.arange(q_chunk, device=q.device)
        start = (min(max(qi * q_chunk + q_chunk - band, 0), Skv - band)
                 if window > 0 else 0)
        m = torch.full((B, Hq, q_chunk), NEG_INF, device=q.device)
        l = torch.zeros((B, Hq, q_chunk), device=q.device)
        acc = torch.zeros((B, Hq, q_chunk, hd), device=q.device)
        for ki in range(nk_eff):
            lo = start + ki * kv_chunk
            kb, vb = k[:, lo:lo + kv_chunk], v[:, lo:lo + kv_chunk]
            kv_pos = lo + torch.arange(kv_chunk, device=q.device)
            s = torch.einsum("bqhd,bkhd->bhqk", qb, kb) * scale
            diff = q_pos[:, None] - kv_pos[None, :]
            mask = torch.ones(diff.shape, dtype=torch.bool, device=q.device)
            if causal:
                mask &= diff >= 0
            if window > 0:
                mask &= diff < window
            s = torch.where(mask[None, None], s, NEG_INF)
            m_new = torch.maximum(m, s.amax(-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(-1)
            acc = acc * corr[..., None] + torch.einsum("bhqk,bkhd->bhqd",
                                                       p, vb)
            m = m_new
        out = acc / torch.clamp(l, min=1e-30)[..., None]
        outs.append(out.permute(0, 2, 1, 3))                # (B,qc,H,hd)
    return torch.cat(outs, dim=1).to(q.dtype)


def attention(q, k, v, *, causal=True, window=0, impl="auto",
              **kw) -> torch.Tensor:
    """Dispatch: "pallas" or "fused" is the hand-written flash kernel (its
    plain version for CPU tensors); "chunked" and "ref" the plain paths;
    "plain" what the reference picks off the TPU, on any device (chunked
    above S = 1024, else ref); "auto" the kernel for CUDA tensors,
    otherwise "plain"."""
    if impl not in _ATTENTION_IMPLS:
        raise ValueError(f"unknown attention impl {impl!r}; valid impls: "
                         f"{_ATTENTION_IMPLS}")
    if impl == "auto":
        impl = "pallas" if q.device.type == "cuda" else "plain"
    if impl == "plain":
        impl = "chunked" if q.shape[1] > 1024 else "ref"
    if impl in ("pallas", "fused"):
        from repro_torch.kernels.flash_attention import ops as fa_ops
        return fa_ops.flash_attention(q, k, v, causal=causal, window=window)
    if impl == "chunked":
        return mha_chunked(q, k, v, causal=causal, window=window)
    return mha_reference(q, k, v, causal=causal, window=window, **kw)


# ======================================================================
# Decode-time attention against a (rolling) KV cache
# ======================================================================
def decode_attention(q, k_cache, v_cache, cache_positions, *,
                     window: int = 0):
    """One-token attention. q: (B,1,Hq,hd); caches: (B,W,Hkv,hd);
    cache_positions: (B,W) absolute positions, -1 = empty slot."""
    return _decode_attention_impl(q, k_cache, v_cache, cache_positions)


def _decode_attention_impl(q, k_cache, v_cache, cache_positions):
    """Grouped-query decode: q heads are folded into (Hkv, group) and
    contracted against the cache without expanding it.  Products of the
    cache's storage dtype accumulate in fp32, as the reference's
    ``preferred_element_type=float32``."""
    kv_mask = cache_positions >= 0                         # (B, W)
    B, _, Hq, hd = q.shape
    Hkv = k_cache.shape[2]
    G = Hq // Hkv
    qg = q[:, 0].reshape(B, Hkv, G, hd)
    s = torch.einsum("bkgd,bwkd->bkgw", qg.to(k_cache.dtype).float(),
                     k_cache.float()) / math.sqrt(hd)
    s = torch.where(kv_mask[:, None, None, :], s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    denom = p.sum(dim=-1, keepdim=True)
    p = p / torch.clamp(denom, min=1e-30)
    out = torch.einsum("bkgw,bwkd->bkgd", p.to(k_cache.dtype).float(),
                       v_cache.float())
    return out.reshape(B, 1, Hq, hd).to(q.dtype)


def cache_update(k_cache, v_cache, cache_positions, k_new, v_new, pos):
    """Insert one token into a rolling-buffer cache (new tensors; the
    inputs are not written).

    caches: (B,W,Hkv,hd); pos: (B,) absolute position of the new token.
    slot = pos % W implements Mistral-style rolling SWA buffers; for full
    caches W == max_seq and the modulo is a no-op."""
    W = k_cache.shape[1]
    slot = pos % W                                        # (B,)
    mask = slot[:, None] == torch.arange(W, device=pos.device)[None, :]
    k_cache = torch.where(mask[..., None, None],
                          k_new[:, 0][:, None].to(k_cache.dtype), k_cache)
    v_cache = torch.where(mask[..., None, None],
                          v_new[:, 0][:, None].to(v_cache.dtype), v_cache)
    cache_positions = torch.where(mask, pos[:, None].to(
        cache_positions.dtype), cache_positions)
    return k_cache, v_cache, cache_positions


# ======================================================================
# Dense FFN
# ======================================================================
def ffn_swiglu(x, wi_gate, wi_up, wo):
    h = swiglu(x @ wi_gate.to(x.dtype), x @ wi_up.to(x.dtype))
    return h @ wo.to(x.dtype)


# ======================================================================
# MoE FFN: routing + capacity dispatch, expert products, combine
# ======================================================================
def _moe_dispatch(x, router_w, *, top_k: int, capacity: int):
    """Routing and capacity scatter of every token group at once (the
    reference's per-group `_moe_dispatch_one`, batched over G).
    x: (G, T, d).  Returns (buf (G, E, C, d), idx, dest, order, keep,
    gate, aux): idx (G, T, k) each token's experts; order (G, T*k) the
    stable sort of the flat expert ids; dest (G, T*k) each sorted
    assignment's buffer row, E*C where it is over its expert's capacity
    (keep False: dropped); gate (G, T, k) the renormalised top-k
    probabilities; aux's entries are (G,).

    Out-of-place ops that `torch.func.vmap` batches (gather, scatter,
    cumsum), so the federation's ``vmap(grad)`` runs through it.  The
    dropped assignments all write row E*C, which is sliced off, so its
    value and its gradient (0) never reach an output."""
    G, T, d = x.shape
    E, C = router_w.shape[-1], capacity
    Tk = T * top_k

    logits = x.float() @ router_w.float()                 # (G, T, E)
    probs = torch.softmax(logits, dim=-1)
    # lax.top_k puts the lower index first on a tie; torch.topk promises
    # no order there (fp32 ties between router probabilities: not seen)
    gate, idx = torch.topk(probs, top_k, dim=-1)          # (G, T, k)
    gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)

    fidx = idx.reshape(G, Tk)
    order = torch.argsort(fidx, dim=-1, stable=True)
    sorted_e = torch.gather(fidx, 1, order)
    counts = (fidx[..., None] == torch.arange(
        E, device=x.device)).sum(1)                       # (G, E)
    seg_start = torch.cumsum(counts, -1) - counts         # = searchsorted
    pos_in_e = (torch.arange(Tk, device=x.device)
                - torch.gather(seg_start, 1, sorted_e))
    keep = pos_in_e < C
    dest = torch.where(keep, sorted_e * C + pos_in_e, E * C)

    tok_of = (order // top_k)[..., None].expand(G, Tk, d)
    rows = torch.gather(x, 1, tok_of)
    buf = torch.zeros((G, E * C + 1, d), dtype=x.dtype,
                      device=x.device).scatter(
        1, dest[..., None].expand(G, Tk, d), rows)
    buf = buf[:, :-1].reshape(G, E, C, d)

    me = probs.mean(dim=1)                                # (G, E)
    ce = counts.float() / Tk
    aux = {"load_balance": E * (me * ce).sum(-1),
           "router_z": torch.logsumexp(logits, dim=-1).square().mean(-1),
           "dropped_frac": 1.0 - keep.float().mean(-1)}
    return buf, idx, dest, order, keep, gate, aux


def _moe_combine(eo, dest, order, gate, *, top_k: int):
    """Expert outputs back to token order, gate-weighted over the k
    choices (the reference's `_moe_combine_one`, batched over G).
    eo: (G, E, C, d) -> (G, T, d); a dropped assignment reads a zero row."""
    G, E, C, d = eo.shape
    Tk = order.shape[1]
    eo_flat = torch.cat([eo.reshape(G, E * C, d),
                         eo.new_zeros((G, 1, d))], 1)
    out_sorted = torch.gather(eo_flat, 1, dest[..., None].expand(G, Tk, d))
    out_perm = torch.zeros_like(out_sorted).scatter(
        1, order[..., None].expand(G, Tk, d), out_sorted)
    return (out_perm.reshape(G, Tk // top_k, top_k, d)
            * gate[..., None].to(eo.dtype)).sum(2)


def moe_capacity(tokens_per_group: int, n_experts: int, top_k: int,
                 capacity_factor: float) -> int:
    """Rows an expert takes a group: ``max(ceil(Tg k cf / E), k)``."""
    return max(int(np.ceil(tokens_per_group * top_k * capacity_factor
                            / n_experts)), top_k)


def moe_ffn(x, router_w, w_gate, w_up, w_down, *, top_k: int,
            capacity_factor: float = 1.25):
    """Group-local MoE: x (G, Tg, d); groups are dispatch-independent.
    Returns (out (G, Tg, d), aux), aux's entries averaged over the groups.
    The expert products run on the stacked (G, E, C, *) buffers, the
    expert weights cast to the activations' dtype at each layer, as in
    the reference."""
    E = router_w.shape[-1]
    C = moe_capacity(x.shape[1], E, top_k, capacity_factor)
    buf, _, dest, order, _, gate, aux = _moe_dispatch(
        x, router_w, top_k=top_k, capacity=C)
    h = torch.einsum("gecd,edf->gecf", buf, w_gate.to(x.dtype))
    u = torch.einsum("gecd,edf->gecf", buf, w_up.to(x.dtype))
    eo = torch.einsum("gecf,efd->gecd", swiglu(h, u), w_down.to(x.dtype))
    out = _moe_combine(eo, dest, order, gate, top_k=top_k)
    return out, {k: v.mean() for k, v in aux.items()}
