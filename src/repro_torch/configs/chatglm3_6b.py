"""ChatGLM3-6B [dense] — RoPE-2d (rotary on half dims), GQA kv=2 [arXiv:2406.12793]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="chatglm3-6b", family="dense",
    n_layers=28, d_model=4096, n_heads=32, n_kv_heads=2,
    d_ff=13696, vocab_size=65024, head_dim=128,
    rope_style="half",          # chatglm applies rotary to half the head dims (2d rope)
    citation="arXiv:2406.12793 (ChatGLM family report)",
)
