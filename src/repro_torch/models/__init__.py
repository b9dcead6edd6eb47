"""Model zoo dispatch: family -> implementation module.

The transformer families (`transformer.py`: dense, MoE, encoder-only
audio and VLM), rwkv6 (``ssm``, `rwkv6.py`) and hymba (``hybrid``,
`hymba.py`) are ported.  `stigma_cnn.py`
is the paper's CNN, driven by `chaos.harness.CNNFederation`.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L


def _module(cfg: ModelConfig):
    if cfg.family == "ssm":
        from repro_torch.models import rwkv6
        return rwkv6
    if cfg.family == "hybrid":
        from repro_torch.models import hymba
        return hymba
    from repro_torch.models import transformer
    return transformer


def param_specs(cfg: ModelConfig):
    return _module(cfg).param_specs(cfg)


def init_params(cfg: ModelConfig, generator: torch.Generator):
    return L.init_params(param_specs(cfg), generator)


def param_count(cfg: ModelConfig) -> int:
    return L.param_count(param_specs(cfg))


def forward(cfg: ModelConfig, params, batch, *, impl: str = "auto",
            remat: bool = False):
    return _module(cfg).forward(cfg, params, batch, impl=impl, remat=remat)


def forward_features(cfg: ModelConfig, params, batch, *, impl: str = "auto",
                     remat: bool = False):
    """(features (B,S,d), aux, head (d,V))."""
    return _module(cfg).forward_features(cfg, params, batch, impl=impl,
                                         remat=remat)


def init_decode_state(cfg: ModelConfig, batch_size: int, seq_len: int,
                      device=None):
    if cfg.encoder_only:
        raise ValueError(f"{cfg.name} is encoder-only: no decode step")
    return _module(cfg).init_decode_state(cfg, batch_size, seq_len,
                                          device=device)


def decode_step(cfg: ModelConfig, params, state, tokens, pos):
    return _module(cfg).decode_step(cfg, params, state, tokens, pos)


def prefill(cfg: ModelConfig, params, batch, cache_seq_len: int, *,
            impl: str = "auto"):
    """(logits (B,S,V), populated decode state, aux): batched prompt
    ingestion for serving (one forward pass instead of S decode steps)."""
    if cfg.encoder_only:
        raise ValueError(f"{cfg.name} is encoder-only: no decode/prefill")
    return _module(cfg).prefill(cfg, params, batch, cache_seq_len, impl=impl)
