"""HuBERT-XLarge [audio] — encoder-only; conv feature frontend is a STUB:
input_specs() provides precomputed frame embeddings (B, S, d_model) [arXiv:2106.07447]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="hubert-xlarge", family="audio",
    n_layers=48, d_model=1280, n_heads=16, n_kv_heads=16,
    d_ff=5120, vocab_size=504,   # masked-unit classification over 504 clusters
    head_dim=80, causal=False, modality="audio",
    citation="arXiv:2106.07447 (HuBERT)",
)
