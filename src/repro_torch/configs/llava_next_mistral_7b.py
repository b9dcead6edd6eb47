"""LLaVA-NeXT (Mistral-7B backbone) [vlm] — anyres tiling; the SigLIP/CLIP vision
tower + projector are a STUB: input_specs() provides precomputed patch embeddings
(B, n_image_patches, d_model) [hf:llava-hf/llava-v1.6-mistral-7b-hf]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llava-next-mistral-7b", family="vlm",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=14336, vocab_size=32000, head_dim=128,
    modality="vlm", n_image_patches=2304,   # anyres: up to 4 tiles + base, 576 each (trimmed)
    attn_window=4096,                       # mistral-style rolling-buffer SWA
    citation="hf:llava-hf/llava-v1.6-mistral-7b-hf",
)
