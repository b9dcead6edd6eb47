"""Plain PyTorch version of the WKV6 recurrence: a Python loop over time
on fp32 copies, the reference's ``lax.scan`` oracle step for step."""
from __future__ import annotations

import torch


def wkv6_reference(r, k, v, w, u, s0):
    """r, k, v, w: (B, T, H, hd); u: (H, hd); s0: (B, H, hd, hd) fp32.

    Per (b, h) and token t, with kv = k_tᵀ v_t:
        y_t = Σ_i r_t[i] · (S[i, :] + u[i] · kv[i, :])
        S  <- w_t[:, None] · S + kv
    Returns y (B, T, H, hd) in r.dtype and the final state (B, H, hd, hd)
    in fp32."""
    rf, kf, vf, wf = (x.float() for x in (r, k, v, w))
    uf = u.float()[..., :, None]                       # (H, hd, 1)
    S = s0.float()
    ys = []
    for t in range(r.shape[1]):
        kv = kf[:, t, :, :, None] * vf[:, t, :, None, :]   # (B, H, hd, hd)
        ys.append(((S + uf * kv) * rf[:, t, :, :, None]).sum(dim=-2))
        S = wf[:, t, :, :, None] * S + kv
    return torch.stack(ys, dim=1).to(r.dtype), S
