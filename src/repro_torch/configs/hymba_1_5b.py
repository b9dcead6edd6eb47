"""Hymba-1.5B [hybrid] — parallel attention + mamba heads in each layer [arXiv:2411.13676]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="hymba-1.5b", family="hybrid",
    n_layers=32, d_model=1600, n_heads=25, n_kv_heads=5,
    d_ff=5504, vocab_size=32001, head_dim=64,
    ssm_state=16, ssm_expand=2,
    attn_window=1024,           # hymba uses SWA in most layers (global attn stub: window)
    citation="arXiv:2411.13676 (Hymba: A Hybrid-head Architecture)",
)
