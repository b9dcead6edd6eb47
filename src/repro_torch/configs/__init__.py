"""Architecture registry: ``get_config(arch_id)`` / ``ARCHS``."""
from __future__ import annotations

from repro_torch.configs.base import (
    INPUT_SHAPES, InputShape, ModelConfig, reduced,
)
from repro_torch.configs.chatglm3_6b import CONFIG as chatglm3_6b
from repro_torch.configs.hymba_1_5b import CONFIG as hymba_1_5b
from repro_torch.configs.smollm_360m import CONFIG as smollm_360m
from repro_torch.configs.hubert_xlarge import CONFIG as hubert_xlarge
from repro_torch.configs.qwen3_0_6b import CONFIG as qwen3_0_6b
from repro_torch.configs.olmoe_1b_7b import CONFIG as olmoe_1b_7b
from repro_torch.configs.dbrx_132b import CONFIG as dbrx_132b
from repro_torch.configs.llava_next_mistral_7b import (
    CONFIG as llava_next_mistral_7b,
)
from repro_torch.configs.rwkv6_3b import CONFIG as rwkv6_3b
from repro_torch.configs.deepseek_coder_33b import CONFIG as deepseek_coder_33b
from repro_torch.configs.stigma_cnn import CNNConfig, STIGMA_CNN

ARCHS = {
    "chatglm3-6b": chatglm3_6b,
    "hymba-1.5b": hymba_1_5b,
    "smollm-360m": smollm_360m,
    "hubert-xlarge": hubert_xlarge,
    "qwen3-0.6b": qwen3_0_6b,
    "olmoe-1b-7b": olmoe_1b_7b,
    "dbrx-132b": dbrx_132b,
    "llava-next-mistral-7b": llava_next_mistral_7b,
    "rwkv6-3b": rwkv6_3b,
    "deepseek-coder-33b": deepseek_coder_33b,
}


def get_config(arch_id: str) -> ModelConfig:
    if arch_id not in ARCHS:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(ARCHS)}")
    return ARCHS[arch_id]


__all__ = [
    "ARCHS", "get_config", "reduced", "ModelConfig", "InputShape",
    "INPUT_SHAPES", "CNNConfig", "STIGMA_CNN",
]
