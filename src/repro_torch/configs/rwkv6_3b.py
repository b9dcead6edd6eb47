"""RWKV6-World-3B "Finch" [ssm] — attention-free, data-dependent decay [arXiv:2404.05892]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-3b", family="ssm",
    n_layers=32, d_model=2560, n_heads=0, n_kv_heads=0,
    d_ff=8960, vocab_size=65536,
    wkv_head_dim=64,            # 40 wkv heads
    citation="arXiv:2404.05892 (Eagle and Finch / RWKV-5,6)",
)
