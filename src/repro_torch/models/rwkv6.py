"""RWKV-6 "Finch": attention-free, with a data-dependent decay
[arXiv:2404.05892], in PyTorch.

The Finch block, as in the reference:
  * ddlerp token shift (data-dependent interpolation, 5-way LoRA),
  * a data-dependent per-channel decay  w_t = exp(-exp(w0 + tanh(x_w A) B)),
  * a per-head matrix-valued WKV state  S <- diag(w_t) S + k_tᵀ v_t, read
    out as  y_t = r_t (S + diag(u) k_tᵀ v_t),
  * group-norm + silu(g) gating, squared-relu channel mix.

The WKV recurrence runs through ``repro_torch.kernels.rwkv6_scan``: the
hand-written Hopper kernel on CUDA tensors (``impl="auto"``), the plain
version on the CPU.  Decode carries (S, shift) state, O(1) per token.
Layers are stacked on a leading ``layers`` dim, as in the reference, and
run as a Python loop where the reference runs ``lax.scan``.

The decode step asks the WKV op for ``impl="auto"``: the kernel at T = 1
on the card, the plain version on the CPU.  The reference's decode step
passes ``impl="ref"`` only because a one-token Pallas grid is wasteful on
a TPU; both compute the same function, and the card's serving path runs
no plain recurrence.  Training (`serving.harness.LMFederation`,
`training.train`) takes the plain path (``impl="ref"``, or the trainer's
``"auto"``, which resolves to ``"plain"``), as the reference does: the
kernel has no backward pass, and a gradient through it raises.
"""
from __future__ import annotations

from typing import Any, Dict

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.sharding.api import (
    logical_shard, merge_last, mesh_rules_for, split_last,
)

Params = Dict[str, Any]
LORA_MIX = 32
LORA_DECAY = 64


def param_specs(cfg: ModelConfig) -> Params:
    d, f, nl = cfg.d_model, cfg.d_ff, cfg.n_layers
    H, hd = cfg.n_wkv_heads, cfg.wkv_head_dim
    V = cfg.vocab_size

    def stacked(shape, axes, **kw):
        return L.Spec((nl,) + tuple(shape), ("layers",) + tuple(axes), **kw)

    block = {
        "ln1": stacked((d,), (None,), init="ones"),
        "ln2": stacked((d,), (None,), init="ones"),
        # ddlerp token shift
        "mu_x": stacked((d,), (None,), init="zeros"),
        "mu_rkvwg": stacked((5, d), (None, None), init="zeros"),
        "mix_A": stacked((d, 5 * LORA_MIX), ("fsdp", None), scale=0.1),
        "mix_B": stacked((5, LORA_MIX, d), (None, None, None), scale=0.1),
        # data-dependent decay
        "w0": stacked((d,), (None,), init="zeros"),
        "decay_A": stacked((d, LORA_DECAY), ("fsdp", None), scale=0.1),
        "decay_B": stacked((LORA_DECAY, d), (None, "fsdp"), scale=0.1),
        "u": stacked((H, hd), (None, None), init="zeros"),   # "bonus"
        # projections
        "wr": stacked((d, d), ("fsdp", "heads")),
        "wk": stacked((d, d), ("fsdp", "heads")),
        "wv": stacked((d, d), ("fsdp", "heads")),
        "wg": stacked((d, d), ("fsdp", "heads")),
        "wo": stacked((d, d), ("heads", "fsdp")),
        "ln_x": stacked((d,), (None,), init="ones"),
        # channel mix
        "mu_ck": stacked((d,), (None,), init="zeros"),
        "mu_cr": stacked((d,), (None,), init="zeros"),
        "w_ck": stacked((d, f), ("fsdp", "mlp")),
        "w_cv": stacked((f, d), ("mlp", "fsdp")),
        "w_cr": stacked((d, d), ("fsdp", None)),
    }
    return {
        "embed": L.Spec((V, d), ("vocab", "fsdp")),
        "block": block,
        "final_norm": L.Spec((d,), (None,), init="ones"),
        "lm_head": L.Spec((d, V), ("fsdp", "vocab")),
    }


# ----------------------------------------------------------------------
def _ddlerp(x, shifted, p):
    """Data-dependent token-shift interpolation -> (x_r,x_k,x_v,x_w,x_g)."""
    delta = shifted - x
    xx = x + delta * p["mu_x"].to(x.dtype)
    lo = torch.tanh(xx @ p["mix_A"].to(x.dtype))
    lo = split_last(lo, 5, "batch", "seq", None, None)
    offs = torch.einsum("...ke,ked->...kd", lo, p["mix_B"].to(x.dtype))
    mus = p["mu_rkvwg"].to(x.dtype) + offs                  # (..., 5, d)
    return tuple(x + delta * mus[..., i, :] for i in range(5))


def _decay(x_w, p):
    """w_t in (0,1): exp(-exp(w0 + tanh(x_w A) B)) (Finch eq. 4), fp32."""
    lo = (torch.tanh(x_w @ p["decay_A"].to(x_w.dtype))
          @ p["decay_B"].to(x_w.dtype))
    return torch.exp(-torch.exp((p["w0"].float() + lo.float()).clamp(
        -20.0, 10.0)))


def _group_norm(x, scale, H, eps=1e-5):
    """GroupNorm over heads: x (..., d) viewed as (..., H, hd), with the
    population variance, as ``jnp.var``."""
    xh = split_last(x, H, "batch", "seq", "heads", None).float()
    mean = xh.mean(-1, keepdim=True)
    var = xh.var(-1, keepdim=True, correction=0)
    xh = (xh - mean) * torch.rsqrt(var + eps)
    xh = merge_last(xh, "batch", "seq", "heads", None)
    return (xh * scale.float()).to(x.dtype)


def _time_mix(cfg: ModelConfig, p, x, shifted, wkv_state, impl: str):
    H = cfg.n_wkv_heads
    x_r, x_k, x_v, x_w, x_g = _ddlerp(x, shifted, p)
    r = split_last(x_r @ p["wr"].to(x.dtype), H, "batch", "seq", "heads",
                   None)
    k = split_last(x_k @ p["wk"].to(x.dtype), H, "batch", "seq", "heads",
                   None)
    v = split_last(x_v @ p["wv"].to(x.dtype), H, "batch", "seq", "heads",
                   None)
    g = F.silu(x_g @ p["wg"].to(x.dtype))
    w = split_last(_decay(x_w, p), H, "batch", "seq", "heads", None)
    r = logical_shard(r, "batch", "seq", "heads", None)
    k = logical_shard(k, "batch", "seq", "heads", None)

    from repro_torch.kernels.rwkv6_scan import ops as wkv_ops
    y, new_state = wkv_ops.wkv6(r, k, v, w, p["u"].float(), wkv_state,
                                impl=impl)
    y = _group_norm(merge_last(y, "batch", "seq", "heads", None),
                    p["ln_x"], H)
    return (y * g) @ p["wo"].to(x.dtype), new_state


def _channel_mix(p, x, shifted):
    delta = shifted - x
    xk = x + delta * p["mu_ck"].to(x.dtype)
    xr = x + delta * p["mu_cr"].to(x.dtype)
    k = torch.square(F.relu(xk @ p["w_ck"].to(x.dtype)))
    k = logical_shard(k, "batch", "seq", "mlp")
    return torch.sigmoid(xr @ p["w_cr"].to(x.dtype)) * (
        k @ p["w_cv"].to(x.dtype))


def _shift_seq(x):
    """x_{t-1} along time (zeros at t=0).  On a mesh, as a concatenation:
    some torch releases' DTensor cannot plan the redistribution that a
    pad of a batch-sharded tensor asks for."""
    if mesh_rules_for(x) is not None:
        return torch.cat([torch.zeros_like(x[:, :1]), x[:, :-1]], dim=1)
    return F.pad(x, (0, 0, 1, 0))[:, :-1]


def _embed(cfg: ModelConfig, params: Params, tokens):
    x = L.embed(tokens, params["embed"]).to(L.COMPUTE_DTYPE)
    x = logical_shard(x, "batch", "seq", "embed")
    B = tokens.shape[0]
    s0 = torch.zeros((B, cfg.n_wkv_heads, cfg.wkv_head_dim,
                      cfg.wkv_head_dim), dtype=torch.float32,
                     device=x.device)
    return x, s0


def _block(cfg: ModelConfig, p: Params, x, s0, impl: str):
    """One Finch block over a whole sequence from WKV state s0: (x, final
    WKV state, the time mix's and the channel mix's normed inputs)."""
    h1 = L.rms_norm(x, p["ln1"], cfg.norm_eps)
    tm, S_new = _time_mix(cfg, p, h1, _shift_seq(h1), s0, impl)
    x = x + tm
    h2 = L.rms_norm(x, p["ln2"], cfg.norm_eps)
    x = x + _channel_mix(p, h2, _shift_seq(h2))
    return logical_shard(x, "batch", "seq", "embed"), S_new, h1, h2


# ======================================================================
def forward_features(cfg: ModelConfig, params: Params, batch, *,
                     impl: str = "auto", remat: bool = False):
    """Backbone output before the LM head: (features (B,S,d), aux, head
    (d,V)).  ``remat`` recomputes each layer on the backward pass
    (`layers.recompute`), as the reference's ``jax.checkpoint``."""
    x, s0 = _embed(cfg, params, batch["tokens"])

    def body(x, p, s0):
        return _block(cfg, p, x, s0, impl)[0]

    for p in L.unstack_layers(params["block"]):
        x = L.recompute(body, x, p, s0) if remat else body(x, p, s0)
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return x, L.zero_aux(x.device), params["lm_head"]


def forward(cfg: ModelConfig, params: Params, batch, *, impl: str = "auto",
            remat: bool = False):
    x, aux, head = forward_features(cfg, params, batch, impl=impl,
                                    remat=remat)
    return logical_shard(x @ head.to(x.dtype), "batch", "seq", "vocab"), aux


def prefill(cfg: ModelConfig, params: Params, batch, cache_seq_len: int,
            *, impl: str = "auto"):
    """Forward over the prompt that also returns the recurrent decode state
    (final per-layer WKV matrices + last-token shift states)."""
    x, s0 = _embed(cfg, params, batch["tokens"])
    wkv, st, sc = [], [], []
    for p in L.unstack_layers(params["block"]):
        x, S_new, h1, h2 = _block(cfg, p, x, s0, impl)
        wkv.append(S_new)
        st.append(h1[:, -1].to(L.COMPUTE_DTYPE))
        sc.append(h2[:, -1].to(L.COMPUTE_DTYPE))
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = logical_shard(x @ params["lm_head"].to(x.dtype), "batch", "seq",
                           "vocab")
    return logits, {"wkv": torch.stack(wkv), "shift_t": torch.stack(st),
                    "shift_c": torch.stack(sc)}, L.zero_aux(x.device)


# ======================================================================
# Decode: state = (wkv S, time-mix shift, channel-mix shift) per layer
# ======================================================================
def init_decode_state(cfg: ModelConfig, batch_size: int, seq_len: int,
                      device=None) -> Params:
    nl, d = cfg.n_layers, cfg.d_model
    H, hd = cfg.n_wkv_heads, cfg.wkv_head_dim
    return {
        "wkv": torch.zeros((nl, batch_size, H, hd, hd), dtype=torch.float32,
                           device=device),
        "shift_t": torch.zeros((nl, batch_size, d), dtype=L.COMPUTE_DTYPE,
                               device=device),
        "shift_c": torch.zeros((nl, batch_size, d), dtype=L.COMPUTE_DTYPE,
                               device=device),
    }


def decode_state_specs(cfg: ModelConfig, batch_size: int, seq_len: int):
    """(``meta`` tensors of the decode state, logical axes)."""
    axes = {"wkv": ("layers", "batch", "heads", None, None),
            "shift_t": ("layers", "batch", None),
            "shift_c": ("layers", "batch", None)}
    return init_decode_state(cfg, batch_size, seq_len, device="meta"), axes


def decode_step(cfg: ModelConfig, params: Params, state: Params,
                tokens: torch.Tensor, pos: torch.Tensor):
    """tokens: (B,) int; pos: (B,) (unused: the state carries the
    position).  Returns (logits (B,V), new state); `state` is not
    written."""
    x = L.embed(tokens, params["embed"])[:, None].to(L.COMPUTE_DTYPE)
    wkv, st, sc = [], [], []
    for i, p in enumerate(L.unstack_layers(params["block"])):
        h = L.rms_norm(x, p["ln1"], cfg.norm_eps)
        tm, S_new = _time_mix(cfg, p, h, state["shift_t"][i][:, None],
                              state["wkv"][i], "auto")
        st.append(h[:, 0])
        x = x + tm
        h = L.rms_norm(x, p["ln2"], cfg.norm_eps)
        x = x + _channel_mix(p, h, state["shift_c"][i][:, None])
        sc.append(h[:, 0])
        wkv.append(S_new)
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = (x @ params["lm_head"].to(x.dtype))[:, 0]
    return logits, {"wkv": torch.stack(wkv), "shift_t": torch.stack(st),
                    "shift_c": torch.stack(sc)}
