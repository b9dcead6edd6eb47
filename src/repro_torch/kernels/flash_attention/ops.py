"""Public flash attention op in the model layout (B, S, H, hd).

On CUDA tensors it launches the hand-written kernel, reading q, k and v
and writing the output through strided (B, H, S, hd) views, so nothing
is transposed or padded; on CPU tensors it takes the plain version."""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention import kernel as _k


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    block_q: int = 256, block_k: int = 512) -> torch.Tensor:
    """q: (B,S,Hq,hd); k,v: (B,S,Hkv,hd) -> (B,S,Hq,hd) in q.dtype.
    `block_q`/`block_k` are accepted for signature parity only."""
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    _k.flash_attention_bhsd(q.transpose(1, 2), k.transpose(1, 2),
                            v.transpose(1, 2), causal=causal, window=window,
                            block_q=block_q, block_k=block_k,
                            out=out.transpose(1, 2))
    return out
