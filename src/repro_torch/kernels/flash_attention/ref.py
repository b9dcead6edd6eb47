"""Plain PyTorch version of the flash attention kernel (kernel layout
B, H, S, hd): naive softmax attention in fp32."""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def attention_reference(q, k, v, *, causal: bool = True, window: int = 0):
    """q: (B,Hq,Sq,hd); k,v: (B,Hkv,Skv,hd) -> (B,Hq,Sq,hd) in q.dtype.
    A q row that no key may attend to returns 0."""
    B, Hq, Sq, hd = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    rep = Hq // Hkv
    if rep > 1:
        k = k.repeat_interleave(rep, dim=1)
        v = v.repeat_interleave(rep, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) / math.sqrt(hd)
    diff = (torch.arange(Sq, device=q.device)[:, None]
            - torch.arange(Skv, device=q.device)[None, :])
    mask = torch.ones((Sq, Skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= diff >= 0
    if window > 0:
        mask &= diff < window
    s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    p = torch.where(mask.any(-1)[None, None, :, None], p, 0.0)
    return torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype)
