"""Model/run configuration system, copied from the JAX package (pure data).

Every assigned architecture is a `ModelConfig` instance in its own module
(``configs/<arch_id>.py``) citing the source paper / model card.
``reduced()`` derives the CPU-smoke variant (2 layers, d_model<=512,
<=4 experts).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass


@dataclass(frozen=True)
class ModelConfig:
    """Architecture hyper-parameters (backbone only; frontends are stubs)."""

    name: str
    family: str                 # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int                # 0 for attention-free families
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0           # 0 -> d_model // n_heads

    # --- attention flavour ---
    rope_theta: float = 10_000.0
    rope_style: str = "full"    # "full" | "half" (chatglm 2d rope on half dims)
    qk_norm: bool = False       # qwen3-style per-head RMSNorm on q/k
    causal: bool = True         # False => encoder-only (hubert)
    attn_window: int = 0        # 0 = full attention, >0 = sliding window size

    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01

    # --- SSM / hybrid ---
    ssm_state: int = 0          # per-head SSM state size (hymba)
    wkv_head_dim: int = 64      # rwkv6 head size
    ssm_expand: int = 2         # inner expansion of the mamba branch

    # --- modality ---
    modality: str = "text"      # text | audio | vlm
    n_image_patches: int = 0    # vlm: patch-embedding stub length (anyres tiles)

    # --- misc ---
    tie_embeddings: bool = False
    norm_eps: float = 1e-5
    citation: str = ""

    def __post_init__(self):
        if self.head_dim == 0 and self.n_heads > 0:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)

    # ------------------------------------------------------------------
    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def encoder_only(self) -> bool:
        return not self.causal

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def n_wkv_heads(self) -> int:
        return self.d_model // self.wkv_head_dim

    def param_count(self) -> int:
        """Approximate parameter count N (used for MODEL_FLOPS = 6 N D)."""
        d, f, L, V = self.d_model, self.d_ff, self.n_layers, self.vocab_size
        hd = self.head_dim
        emb = V * d * (1 if self.tie_embeddings else 2)
        per_layer = 0
        if self.family == "ssm":                       # rwkv6 time-mix+channel-mix
            per_layer = 5 * d * d + 2 * d * f + d * f  # r,k,v,g,o + channel mix
        else:
            attn = d * (self.n_heads * hd) * 2 + d * (self.n_kv_heads * hd) * 2
            if self.is_moe:
                ffn = self.n_experts * 3 * d * f
            else:
                ffn = 3 * d * f
            per_layer = attn + ffn
            if self.family == "hybrid":                # + mamba branch
                di = self.ssm_expand * d
                per_layer += 2 * d * di + di * d + di * (2 * self.ssm_state + 2)
        return emb + L * per_layer

    def active_param_count(self) -> int:
        """Active params per token (MoE: only top_k experts count)."""
        if not self.is_moe:
            return self.param_count()
        d, f, L = self.d_model, self.d_ff, self.n_layers
        dense_moe = L * self.n_experts * 3 * d * f
        active_moe = L * self.top_k * 3 * d * f
        return self.param_count() - dense_moe + active_moe


def reduced(cfg: ModelConfig) -> ModelConfig:
    """CPU smoke-test variant: 2 layers, d_model<=512, <=4 experts."""
    n_heads = cfg.n_heads
    n_kv = cfg.n_kv_heads
    d_model = min(cfg.d_model, 512)
    if n_heads > 0:
        n_heads = min(n_heads, 8)
        n_kv = min(n_kv, n_heads)
        while n_heads % n_kv:
            n_kv -= 1
        d_model = max(64 * n_heads // 8, 64)
        d_model = 256 if d_model <= 512 else 512
        head_dim = max(d_model // n_heads, 16)
    else:
        d_model = 256
        head_dim = 0
    return dataclasses.replace(
        cfg,
        name=cfg.name + "-reduced",
        n_layers=2,
        d_model=d_model,
        n_heads=n_heads,
        n_kv_heads=n_kv if n_heads else cfg.n_kv_heads,
        head_dim=head_dim if n_heads else 0,
        d_ff=min(cfg.d_ff, 512),
        vocab_size=min(cfg.vocab_size, 512),
        n_experts=min(cfg.n_experts, 4) if cfg.n_experts else 0,
        top_k=min(cfg.top_k, 2) if cfg.top_k else 0,
        wkv_head_dim=32,
        ssm_state=min(cfg.ssm_state, 8) if cfg.ssm_state else 0,
        n_image_patches=min(cfg.n_image_patches, 16) if cfg.n_image_patches else 0,
        attn_window=min(cfg.attn_window, 64) if cfg.attn_window else 0,
    )


# ----------------------------------------------------------------------
# Input shapes assigned to this paper (public pool).
@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str                   # "train" | "prefill" | "decode"


INPUT_SHAPES = {
    "train_4k":    InputShape("train_4k",    4_096,   256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768,   32, "prefill"),
    "decode_32k":  InputShape("decode_32k",  32_768,  128, "decode"),
    "long_500k":   InputShape("long_500k",  524_288,    1, "decode"),
}
