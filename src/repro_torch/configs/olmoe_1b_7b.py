"""OLMoE-1B-7B [moe] — 64 experts, top-8, dropless-style fine-grained FFN [arXiv:2409.02060]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="olmoe-1b-7b", family="moe",
    n_layers=16, d_model=2048, n_heads=16, n_kv_heads=16,
    d_ff=1024, vocab_size=50304, head_dim=128,
    n_experts=64, top_k=8, qk_norm=True,
    citation="arXiv:2409.02060 (OLMoE)",
)
