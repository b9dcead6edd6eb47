"""Hymba: a hybrid-head architecture, parallel attention and SSM (mamba)
heads in every layer, fused by per-branch normalisation and averaging,
with learnable meta tokens prepended to the sequence [arXiv:2411.13676],
in PyTorch.

As in the reference: the depthwise conv1d of the original mamba head is
folded into the token-shift-free projection, and the attention heads use
sliding-window attention in every layer, so the decode state is a
rolling window-W k/v cache plus a (d_inner, N) SSM state per layer.
Layers are stacked on a leading ``layers`` dim and run as a Python loop
where the reference runs ``lax.scan``.

The mamba branch's recurrence runs through ``repro_torch.kernels.
ssm_scan`` and prefill attention through the flash kernel: on CUDA
tensors (``impl="auto"``) both are the hand-written Hopper kernels, on
the CPU their plain versions.  The decode step asks the scan for
``impl="auto"``: the kernel at T = 1 on the card, the plain version on
the CPU.  The reference's decode step passes ``impl="ref"`` only because
a one-token Pallas grid is wasteful on a TPU; both compute the same
function, and the card's serving path runs no plain recurrence.  Decode
attention is plain tensor code, as in the reference.  Training takes
the plain paths (``impl="ref"``, or the trainer's ``"auto"``, which
resolves to ``"plain"``), as the reference does: neither kernel has a
backward pass, and a gradient through one raises.

The meta tokens exist only on the prefill path: prefill and token-wise
ingestion of the same prompt differ by design.
"""
from __future__ import annotations

from typing import Any, Dict

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import transformer as TF

Params = Dict[str, Any]
N_META_TOKENS = 128


def param_specs(cfg: ModelConfig) -> Params:
    d, f, nl = cfg.d_model, cfg.d_ff, cfg.n_layers
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    di, N = cfg.ssm_expand * d, cfg.ssm_state
    V = cfg.vocab_size

    def stacked(shape, axes, **kw):
        return L.Spec((nl,) + tuple(shape), ("layers",) + tuple(axes), **kw)

    block = {
        "in_norm": stacked((d,), (None,), init="ones"),
        # attention branch
        "wq": stacked((d, hq * hd), ("fsdp", "heads")),
        "wk": stacked((d, hkv * hd), ("fsdp", "kv_heads")),
        "wv": stacked((d, hkv * hd), ("fsdp", "kv_heads")),
        # mamba branch
        "in_proj": stacked((d, 2 * di), ("fsdp", "mlp")),
        "w_dt": stacked((di,), (None,), init="zeros"),
        "dt_bias": stacked((di,), (None,), init="zeros"),
        "a_log": stacked((di,), (None,), init="zeros"),
        "w_B": stacked((d, N), ("fsdp", None)),
        "w_C": stacked((d, N), ("fsdp", None)),
        "d_skip": stacked((di,), (None,), init="ones"),
        # fusion + output
        "attn_out_norm": stacked((hq * hd,), (None,), init="ones"),
        "ssm_out_norm": stacked((di,), (None,), init="ones"),
        "wo_attn": stacked((hq * hd, d), ("heads", "fsdp")),
        "wo_ssm": stacked((di, d), ("mlp", "fsdp")),
        # FFN
        "ffn_norm": stacked((d,), (None,), init="ones"),
        "wi_gate": stacked((d, f), ("fsdp", "mlp")),
        "wi_up": stacked((d, f), ("fsdp", "mlp")),
        "wo_ffn": stacked((f, d), ("mlp", "fsdp")),
    }
    return {
        "embed": L.Spec((V, d), ("vocab", "fsdp")),
        "meta_tokens": L.Spec((N_META_TOKENS, d), (None, None), scale=0.5),
        "block": block,
        "final_norm": L.Spec((d,), (None,), init="ones"),
        "lm_head": L.Spec((d, V), ("fsdp", "vocab")),
    }


# ----------------------------------------------------------------------
def _mamba_branch(cfg, p, h, ssm_h0, impl: str = "auto"):
    """Returns (y (B,T,di), h_last (B,di,N)).  The recurrence runs through
    repro_torch.kernels.ssm_scan.  ``F.softplus`` returns its input above
    its threshold of 20, where JAX's softplus returns log1p(exp(x)): the
    two agree in fp32 there."""
    d = h.shape[-1]
    di = cfg.ssm_expand * d
    zx = h @ p["in_proj"].to(h.dtype)
    z, xin = zx[..., :di], zx[..., di:]                 # (B,T,di) each
    dt = F.softplus(xin.float() * p["w_dt"] + p["dt_bias"])
    A = -torch.exp(p["a_log"].float())                  # (di,) negative
    a = torch.exp(dt * A)                               # (B,T,di)
    Bp = h.float() @ p["w_B"].float()                   # (B,T,N)
    Cp = h.float() @ p["w_C"].float()                   # (B,T,N)
    bx = dt * xin.float()                               # (B,T,di)

    from repro_torch.kernels.ssm_scan import ops as ssm_ops
    y, h_last = ssm_ops.ssm_scan(a, bx, Bp, Cp, ssm_h0, impl=impl)
    y = y.float() + p["d_skip"] * xin.float()
    y = y.to(h.dtype) * F.silu(z)
    return y, h_last


def _fuse(cfg, p, x, attn, ssm):
    """Per-branch norm, average, project, then the FFN."""
    fused = 0.5 * (L.rms_norm(attn, p["attn_out_norm"], cfg.norm_eps)
                   @ p["wo_attn"].to(x.dtype)
                   + L.rms_norm(ssm, p["ssm_out_norm"], cfg.norm_eps)
                   @ p["wo_ssm"].to(x.dtype))
    x = x + fused
    h = L.rms_norm(x, p["ffn_norm"], cfg.norm_eps)
    return x + L.ffn_swiglu(h, p["wi_gate"], p["wi_up"], p["wo_ffn"])


def _qkv(cfg, p, h, positions):
    B, T, _ = h.shape
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = (h @ p["wq"].to(h.dtype)).reshape(B, T, hq, hd)
    k = (h @ p["wk"].to(h.dtype)).reshape(B, T, hkv, hd)
    v = (h @ p["wv"].to(h.dtype)).reshape(B, T, hkv, hd)
    q = L.apply_rope(q, positions, cfg.rope_theta, cfg.rope_style)
    k = L.apply_rope(k, positions, cfg.rope_theta, cfg.rope_style)
    return q, k, v


def _hybrid_block(cfg, p, x, positions, ssm_h0, impl, collect_kv=False):
    B, T, _ = x.shape
    h = L.rms_norm(x, p["in_norm"], cfg.norm_eps)
    # attention branch
    q, k, v = _qkv(cfg, p, h, positions)
    attn = L.attention(q, k, v, causal=True, window=cfg.attn_window,
                       impl=impl).reshape(B, T, -1)
    # mamba branch (parallel, same input: hymba's "hybrid heads")
    ssm, h_last = _mamba_branch(cfg, p, h, ssm_h0, impl)
    x = _fuse(cfg, p, x, attn, ssm)
    if collect_kv:
        return x, h_last, (k.to(L.COMPUTE_DTYPE), v.to(L.COMPUTE_DTYPE))
    return x, h_last


def _embed_with_meta(cfg: ModelConfig, params: Params, tokens):
    """(x (B, 128 + T, d) with the meta tokens first, positions, h0)."""
    B = tokens.shape[0]
    di, N = cfg.ssm_expand * cfg.d_model, cfg.ssm_state
    x = F.embedding(tokens, params["embed"]).to(L.COMPUTE_DTYPE)
    meta = params["meta_tokens"].to(x.dtype)[None].expand(
        B, N_META_TOKENS, cfg.d_model)
    x = torch.cat([meta, x], dim=1)
    S = x.shape[1]
    positions = torch.arange(S, dtype=torch.int32,
                             device=x.device).expand(B, S)
    h0 = torch.zeros((B, di, N), dtype=torch.float32, device=x.device)
    return x, positions, h0


# ======================================================================
def forward_features(cfg: ModelConfig, params: Params, batch, *,
                     impl: str = "auto", remat: bool = False):
    """Backbone output before the LM head, meta positions dropped:
    (features (B,T,d), aux, head (d,V)).  ``remat`` recomputes each layer
    on the backward pass (`layers.recompute`), as the reference's
    ``jax.checkpoint``."""
    x, positions, h0 = _embed_with_meta(cfg, params, batch["tokens"])

    def body(x, p, positions, h0):
        return _hybrid_block(cfg, p, x, positions, h0, impl)[0]

    for p in L.unstack_layers(params["block"]):
        x = (L.recompute(body, x, p, positions, h0) if remat
             else body(x, p, positions, h0))
    x = x[:, N_META_TOKENS:]                      # drop meta positions
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return x, L.zero_aux(x.device), params["lm_head"]


def forward(cfg: ModelConfig, params: Params, batch, *, impl: str = "auto",
            remat: bool = False):
    x, aux, head = forward_features(cfg, params, batch, impl=impl,
                                    remat=remat)
    return x @ head.to(x.dtype), aux


def prefill(cfg: ModelConfig, params: Params, batch, cache_seq_len: int,
            *, impl: str = "auto"):
    """Forward over the prompt that also returns the hybrid decode state:
    the last min(W, S) positions (meta tokens included) of each layer's
    k/v at their rolling slots ``pos % W``, and the final SSM states."""
    x, positions, h0 = _embed_with_meta(cfg, params, batch["tokens"])
    B, S = positions.shape
    state = init_decode_state(cfg, B, cache_seq_len, device=x.device)
    W = state["k"].shape[2]
    take = min(W, S)
    pos_tail = torch.arange(S - take, S, dtype=torch.int32, device=x.device)
    slots = (pos_tail % W).long()
    for i, p in enumerate(L.unstack_layers(params["block"])):
        x, h_last, (k, v) = _hybrid_block(cfg, p, x, positions, h0, impl,
                                          collect_kv=True)
        state["k"][i][:, slots] = k[:, S - take:]
        state["v"][i][:, slots] = v[:, S - take:]
        state["ssm"][i] = h_last
    state["pos"][:, :, slots] = pos_tail
    x = x[:, N_META_TOKENS:]
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = x @ params["lm_head"].to(x.dtype)
    return logits, state, L.zero_aux(x.device)


# ======================================================================
# Decode
# ======================================================================
def init_decode_state(cfg: ModelConfig, batch_size: int, seq_len: int,
                      device=None) -> Params:
    W = TF.cache_window(cfg, seq_len)
    nl, hkv, hd = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim
    di, N = cfg.ssm_expand * cfg.d_model, cfg.ssm_state
    return {
        "k": torch.zeros((nl, batch_size, W, hkv, hd), dtype=L.COMPUTE_DTYPE,
                         device=device),
        "v": torch.zeros((nl, batch_size, W, hkv, hd), dtype=L.COMPUTE_DTYPE,
                         device=device),
        "pos": torch.full((nl, batch_size, W), -1, dtype=torch.int32,
                          device=device),
        "ssm": torch.zeros((nl, batch_size, di, N), dtype=torch.float32,
                           device=device),
    }


def decode_step(cfg: ModelConfig, params: Params, state: Params,
                tokens: torch.Tensor, pos: torch.Tensor):
    """tokens: (B,) int; pos: (B,) position of the new token among the
    prompt's (the meta tokens shift it by 128 in the cache).  Returns
    (logits (B,V), new state); `state` is not written."""
    B = tokens.shape[0]
    x = F.embedding(tokens, params["embed"])[:, None].to(L.COMPUTE_DTYPE)
    abs_pos = pos + N_META_TOKENS
    positions = abs_pos[:, None]
    ks, vs, ps, ssms = [], [], [], []
    for i, p in enumerate(L.unstack_layers(params["block"])):
        h = L.rms_norm(x, p["in_norm"], cfg.norm_eps)
        q, k, v = _qkv(cfg, p, h, positions)
        kc, vc, pc = L.cache_update(state["k"][i], state["v"][i],
                                    state["pos"][i], k, v, abs_pos)
        attn = L.decode_attention(q, kc, vc, pc, window=cfg.attn_window)
        ssm, h_new = _mamba_branch(cfg, p, h, state["ssm"][i], "auto")
        x = _fuse(cfg, p, x, attn.reshape(B, 1, -1), ssm)
        ks.append(kc)
        vs.append(vc)
        ps.append(pc)
        ssms.append(h_new)
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = (x @ params["lm_head"].to(x.dtype))[:, 0]
    return logits, {"k": torch.stack(ks), "v": torch.stack(vs),
                    "pos": torch.stack(ps), "ssm": torch.stack(ssms)}
