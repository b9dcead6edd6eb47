"""Dense / MoE / encoder-only / VLM transformer backbone in PyTorch.

One implementation covers chatglm3, smollm, qwen3, deepseek (dense GQA,
optional qk-norm, full or half rope, optional sliding window), olmoe,
dbrx (MoE FFN: top-k routing with a capacity per expert), hubert
(encoder-only audio: no rope, non-causal attention, precomputed frame
embeddings in place of the conv front end) and llava (VLM: precomputed
patch embeddings ahead of the text in place of the vision tower), as
the reference does.

Layers are stacked on a leading ``layers`` dim, as in the reference, and
run as a Python loop where the reference runs ``lax.scan``.

Entry points:
  forward(cfg, params, batch)                -> logits, aux      (train/prefill)
  prefill(cfg, params, batch, cache_seq_len) -> logits, state, aux
  init_decode_state(cfg, batch, seq_len)     -> KV cache pytree
  decode_step(cfg, params, state, token,pos) -> logits, state    (serve)
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.sharding.api import logical_shard, merge_last, split_last

Params = Dict[str, Any]


# ======================================================================
# Param specs (the reference's tree: same keys, shapes and leaf order)
# ======================================================================
def param_specs(cfg: ModelConfig) -> Params:
    d, f, nl = cfg.d_model, cfg.d_ff, cfg.n_layers
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    V = cfg.vocab_size

    def stacked(shape, axes, **kw):
        return L.Spec((nl,) + tuple(shape), ("layers",) + tuple(axes), **kw)

    block: Params = {
        "attn_norm": stacked((d,), (None,), init="ones"),
        "wq": stacked((d, hq * hd), ("fsdp", "heads")),
        "wk": stacked((d, hkv * hd), ("fsdp", "kv_heads")),
        "wv": stacked((d, hkv * hd), ("fsdp", "kv_heads")),
        "wo": stacked((hq * hd, d), ("heads", "fsdp")),
        "ffn_norm": stacked((d,), (None,), init="ones"),
    }
    if cfg.qk_norm:
        block["q_norm"] = stacked((hd,), (None,), init="ones")
        block["k_norm"] = stacked((hd,), (None,), init="ones")
    if cfg.is_moe:
        E = cfg.n_experts
        block["router"] = stacked((d, E), ("fsdp", None), scale=0.1)
        block["w_gate"] = stacked((E, d, f), ("experts", "fsdp", "mlp"))
        block["w_up"] = stacked((E, d, f), ("experts", "fsdp", "mlp"))
        block["w_down"] = stacked((E, f, d), ("experts", "mlp", "fsdp"))
    else:
        block["wi_gate"] = stacked((d, f), ("fsdp", "mlp"))
        block["wi_up"] = stacked((d, f), ("fsdp", "mlp"))
        block["wo_ffn"] = stacked((f, d), ("mlp", "fsdp"))

    specs: Params = {
        "embed": L.Spec((V, d), ("vocab", "fsdp"), scale=1.0),
        "block": block,
        "final_norm": L.Spec((d,), (None,), init="ones"),
    }
    if not cfg.tie_embeddings:
        specs["lm_head"] = L.Spec((d, V), ("fsdp", "vocab"))
    return specs


# ======================================================================
# One transformer block (the reference's scan body)
# ======================================================================
def _attention_block(cfg: ModelConfig, p: Params, x: torch.Tensor,
                     positions: torch.Tensor, impl: str,
                     return_kv: bool = False):
    hq, hkv = cfg.n_heads, cfg.n_kv_heads
    h = L.rms_norm(x, p["attn_norm"], cfg.norm_eps)
    q = split_last(h @ p["wq"].to(h.dtype), hq, "batch", "seq", "heads",
                   None)
    k = split_last(h @ p["wk"].to(h.dtype), hkv, "batch", "seq",
                   "kv_heads", None)
    v = split_last(h @ p["wv"].to(h.dtype), hkv, "batch", "seq",
                   "kv_heads", None)
    if cfg.qk_norm:
        q = L.head_rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = L.head_rms_norm(k, p["k_norm"], cfg.norm_eps)
    if not cfg.encoder_only:          # the encoder (hubert) has no rope
        q = L.apply_rope(q, positions, cfg.rope_theta, cfg.rope_style)
        k = L.apply_rope(k, positions, cfg.rope_theta, cfg.rope_style)
    q = logical_shard(q, "batch", "seq", "heads", None)
    k = logical_shard(k, "batch", "seq", "kv_heads", None)
    out = L.attention(q, k, v, causal=cfg.causal, window=cfg.attn_window,
                      impl=impl)
    out = merge_last(out, "batch", "seq", "heads", None)
    x = x + out @ p["wo"].to(x.dtype)
    if return_kv:
        return x, (k.to(L.COMPUTE_DTYPE), v.to(L.COMPUTE_DTYPE))
    return x


def _ffn_block(cfg: ModelConfig, p: Params, x: torch.Tensor):
    B, S, d = x.shape
    h = L.rms_norm(x, p["ffn_norm"], cfg.norm_eps)
    if cfg.is_moe:
        # groups: one per sequence while training / prefilling; the whole
        # batch (empty engine slots too) is one group for 1-token decode
        grouped = h if S > 1 else h.reshape(1, B, d)
        out, aux = L.moe_ffn(grouped, p["router"], p["w_gate"],
                             p["w_up"], p["w_down"], top_k=cfg.top_k,
                             capacity_factor=cfg.capacity_factor)
        return x + out.reshape(B, S, d), aux
    out = L.ffn_swiglu(h, p["wi_gate"], p["wi_up"], p["wo_ffn"])
    return x + out, L.zero_aux(x.device)


def _block(cfg: ModelConfig, p: Params, x: torch.Tensor,
           positions: torch.Tensor, impl: str, collect_kv: bool = False):
    if collect_kv:
        x, kv = _attention_block(cfg, p, x, positions, impl, return_kv=True)
    else:
        x = _attention_block(cfg, p, x, positions, impl)
        kv = None
    x, aux = _ffn_block(cfg, p, x)
    x = logical_shard(x, "batch", "seq", "embed")
    return (x, aux, kv) if collect_kv else (x, aux)


def _mean_aux(auxs):
    return {k: torch.stack([a[k] for a in auxs]).mean(0) for k in auxs[0]}


# ======================================================================
# Embedding (text / audio stub / vlm stub)
# ======================================================================
def embed_inputs(cfg: ModelConfig, params: Params,
                 batch: Dict[str, torch.Tensor]):
    """Returns (x (B,S,d) in COMPUTE_DTYPE, positions (B,S) int32).

    text : batch["tokens"] (B,S) int
    audio: batch["frame_embeddings"] (B,S,d), the conv front end's output
           (a stub: the caller supplies it)
    vlm  : batch["tokens"] (B,S_text) + batch["patch_embeddings"] (B,P,d)
           concatenated [patches; text], positions over the whole of it
    """
    if cfg.modality == "audio":
        x = batch["frame_embeddings"].to(L.COMPUTE_DTYPE)
    elif cfg.modality == "vlm":
        tok = L.embed(batch["tokens"], params["embed"])
        x = torch.cat([batch["patch_embeddings"].to(L.COMPUTE_DTYPE),
                       tok.to(L.COMPUTE_DTYPE)], dim=1)
    else:
        x = L.embed(batch["tokens"], params["embed"]).to(L.COMPUTE_DTYPE)
    B, S = x.shape[:2]
    positions = torch.arange(S, dtype=torch.int32,
                             device=x.device).expand(B, S)
    return logical_shard(x, "batch", "seq", "embed"), positions


def _head(cfg: ModelConfig, params: Params) -> torch.Tensor:
    return params["embed"].T if cfg.tie_embeddings else params["lm_head"]


def unembed(cfg: ModelConfig, params: Params, x: torch.Tensor) -> torch.Tensor:
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return logical_shard(x @ _head(cfg, params).to(x.dtype), "batch", "seq",
                         "vocab")


# ======================================================================
# Forward (train / prefill)
# ======================================================================
def forward_features(cfg: ModelConfig, params: Params,
                     batch: Dict[str, torch.Tensor], *, impl: str = "auto",
                     remat: bool = False):
    """Backbone output before the LM head: (features (B,S,d), aux, head
    (d,V)).  ``remat`` keeps only each layer's input and recomputes the
    layer on the backward pass (`layers.recompute`), as the reference's
    ``jax.checkpoint`` of its scan body."""
    x, positions = embed_inputs(cfg, params, batch)

    def body(x, p, positions):
        return _block(cfg, p, x, positions, impl)

    auxs = []
    for p in L.unstack_layers(params["block"]):
        x, aux = (L.recompute(body, x, p, positions) if remat
                  else body(x, p, positions))
        auxs.append(aux)
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return x, _mean_aux(auxs), _head(cfg, params)


def forward(cfg: ModelConfig, params: Params, batch: Dict[str, torch.Tensor],
            *, impl: str = "auto", remat: bool = False
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    x, aux, head = forward_features(cfg, params, batch, impl=impl,
                                    remat=remat)
    return logical_shard(x @ head.to(x.dtype), "batch", "seq", "vocab"), aux


# ======================================================================
# Decode (1 new token against a rolling KV cache)
# ======================================================================
def cache_window(cfg: ModelConfig, seq_len: int) -> int:
    return min(cfg.attn_window, seq_len) if cfg.attn_window > 0 else seq_len


def init_decode_state(cfg: ModelConfig, batch_size: int, seq_len: int,
                      device=None) -> Params:
    W = cache_window(cfg, seq_len)
    nl, hkv, hd = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim
    shape = (nl, batch_size, W, hkv, hd)
    return {
        "k": torch.zeros(shape, dtype=L.COMPUTE_DTYPE, device=device),
        "v": torch.zeros(shape, dtype=L.COMPUTE_DTYPE, device=device),
        "pos": torch.full((nl, batch_size, W), -1, dtype=torch.int32,
                          device=device),
    }


def decode_state_specs(cfg: ModelConfig, batch_size: int, seq_len: int):
    """(``meta`` tensors of the cache, logical axes): the cache's sequence
    dim is the one the reference shards ("kv_seq")."""
    axes = {"k": ("layers", "batch", "kv_seq", None, None),
            "v": ("layers", "batch", "kv_seq", None, None),
            "pos": ("layers", "batch", "kv_seq")}
    return init_decode_state(cfg, batch_size, seq_len, device="meta"), axes


def prefill(cfg: ModelConfig, params: Params, batch: Dict[str, torch.Tensor],
            cache_seq_len: int, *, impl: str = "auto"):
    """Batched prefill: one forward pass over the prompt that also fills
    the rolling KV cache.  Returns (logits (B,S,V), decode_state, aux)
    with the last min(W, S) positions of each layer's k/v written into the
    window-W cache at their rolling slots."""
    x, positions = embed_inputs(cfg, params, batch)
    B, S = positions.shape
    W = cache_window(cfg, cache_seq_len)
    take = min(W, S)
    auxs, k_tail, v_tail = [], [], []
    for p in L.unstack_layers(params["block"]):
        x, aux, (k, v) = _block(cfg, p, x, positions, impl, collect_kv=True)
        auxs.append(aux)
        k_tail.append(k[:, S - take:])
        v_tail.append(v[:, S - take:])
    logits = unembed(cfg, params, x)

    state = init_decode_state(cfg, B, cache_seq_len, device=x.device)
    pos_tail = torch.arange(S - take, S, dtype=torch.int32, device=x.device)
    slots = (pos_tail % W).long()
    state["k"][:, :, slots] = torch.stack(k_tail)
    state["v"][:, :, slots] = torch.stack(v_tail)
    state["pos"][:, :, slots] = pos_tail
    return logits, state, _mean_aux(auxs)


def decode_step(cfg: ModelConfig, params: Params, state: Params,
                tokens: torch.Tensor, pos: torch.Tensor):
    """tokens: (B,) int; pos: (B,) absolute position of the new token.
    Returns (logits (B,V), new state); `state` is not written."""
    x = L.embed(tokens, params["embed"])[:, None].to(L.COMPUTE_DTYPE)
    x = logical_shard(x, "batch", "seq", "embed")
    positions = pos[:, None]
    hq, hkv = cfg.n_heads, cfg.n_kv_heads
    ks, vs, ps = [], [], []
    for i, p in enumerate(L.unstack_layers(params["block"])):
        h = L.rms_norm(x, p["attn_norm"], cfg.norm_eps)
        q = split_last(h @ p["wq"].to(h.dtype), hq, "batch", "seq", "heads",
                       None)
        k = split_last(h @ p["wk"].to(h.dtype), hkv, "batch", "seq",
                       "kv_heads", None)
        v = split_last(h @ p["wv"].to(h.dtype), hkv, "batch", "seq",
                       "kv_heads", None)
        if cfg.qk_norm:
            q = L.head_rms_norm(q, p["q_norm"], cfg.norm_eps)
            k = L.head_rms_norm(k, p["k_norm"], cfg.norm_eps)
        q = L.apply_rope(q, positions, cfg.rope_theta, cfg.rope_style)
        k = L.apply_rope(k, positions, cfg.rope_theta, cfg.rope_style)
        kc, vc, pc = L.cache_update(state["k"][i], state["v"][i],
                                    state["pos"][i], k, v, pos)
        out = L.decode_attention(q, kc, vc, pc, window=cfg.attn_window)
        out = merge_last(out, "batch", "seq", "heads", None)
        x = x + out @ p["wo"].to(x.dtype)
        x, _ = _ffn_block(cfg, p, x)
        ks.append(kc)
        vs.append(vc)
        ps.append(pc)
    logits = unembed(cfg, params, x)[:, 0]
    return logits, {"k": torch.stack(ks), "v": torch.stack(vs),
                    "pos": torch.stack(ps)}
