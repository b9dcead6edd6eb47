"""RWKV-6 "Finch" [arXiv:2404.05892] in plain PyTorch, float32, one
sequence at a time, and the weights the benchmark serves.

The block as the paper describes it: data-dependent token shift (the
5-way LoRA "ddlerp"), decay w_t = exp(-exp(w0 + tanh(x A) B)) (the
exponent clamped to [-20, 10], as the served model clamps it), the
per-head matrix state S <- diag(w_t) S + k_t^T v_t read out as
y_t = r_t (S + diag(u) k_t^T v_t), group norm over heads and silu(g)
gating, then the squared-ReLU channel mix.  The norms are the served
model's, not the published checkpoint's: RMSNorm with a weight and no
bias before each half and before the head, no norm after the
embedding, and a scale without a bias on the heads' group norm, where
the published model has LayerNorms with weights and biases, `ln0` after
the embedding and a biased group norm.  No bf16, no kernels, no cache:
the WKV recurrence runs in chunks of `CHUNK` tokens, the state inside a
chunk stepped token by token, the chunks then joined in order; every
product of decays is formed directly, never through a difference of
logarithms.

`lower=True` is the control: every matrix product takes float8 (e4m3)
inputs, the weights scaled per output column and the activations per
row, accumulated in float32.
"""
from __future__ import annotations

import math
from typing import Dict, List, Sequence

import torch
import torch.nn.functional as F

from bench import roofline

LORA_MIX = 32
LORA_DECAY = 64
CHUNK = 64
FP8_MAX = 448.0


def shapes(m: Dict) -> Dict[str, tuple]:
    """The served tree's leaves: 'embed', 'final_norm', 'lm_head', and
    'block/<name>' stacked over layers."""
    d, f, L, V = m["d_model"], m["d_ff"], m["n_layers"], m["vocab_size"]
    hd = m["wkv_head_dim"]
    H = d // hd
    block = {
        "ln1": (d,), "ln2": (d,), "mu_x": (d,), "mu_rkvwg": (5, d),
        "mix_A": (d, 5 * LORA_MIX), "mix_B": (5, LORA_MIX, d), "w0": (d,),
        "decay_A": (d, LORA_DECAY), "decay_B": (LORA_DECAY, d),
        "u": (H, hd), "wr": (d, d), "wk": (d, d), "wv": (d, d),
        "wg": (d, d), "wo": (d, d), "ln_x": (d,), "mu_ck": (d,),
        "mu_cr": (d,), "w_ck": (d, f), "w_cv": (f, d), "w_cr": (d, d)}
    out = {"embed": (V, d), "final_norm": (d,), "lm_head": (d, V)}
    out.update({f"block/{k}": (L,) + s for k, s in block.items()})
    return out


def _draw(name: str, shape: tuple):
    """(base, scale) of a leaf: value = base + scale * N(0, 1)."""
    leaf = name.split("/")[-1]
    if leaf in ("ln1", "ln2", "ln_x", "final_norm"):
        return 1.0, 0.1
    if leaf.startswith("mu_"):
        return 0.5, 0.2
    if leaf == "w0":
        return -3.5, 1.0
    if leaf == "u":
        return 0.0, 0.5
    if leaf == "embed":
        return 0.0, 1.0
    fan_in = shape[-2]
    lora = leaf in ("mix_A", "mix_B", "decay_A", "decay_B")
    return 0.0, (0.1 if lora else 1.0) / math.sqrt(fan_in)


def make_params(m: Dict, seed: int, device) -> Dict:
    """The served weights from `seed`: one float32 normal draw of every
    element on `device`, each leaf a view of it, shifted and scaled in
    place.  Returns the nested tree the model takes."""
    sh = shapes(m)
    names = sorted(sh)
    total = sum(math.prod(sh[n]) for n in names)
    g = torch.Generator(device=device).manual_seed(int(seed))
    flat = torch.randn(total, generator=g, dtype=torch.float32,
                       device=device)
    tree: Dict = {"block": {}}
    off = 0
    for n in names:
        size = math.prod(sh[n])
        leaf = flat[off:off + size].view(sh[n])
        base, scale = _draw(n, sh[n])
        leaf.mul_(scale).add_(base)
        off += size
        if n.startswith("block/"):
            tree["block"][n[6:]] = leaf
        else:
            tree[n] = leaf
    return tree


def param_count(m: Dict) -> int:
    return sum(math.prod(s) for s in shapes(m).values())


def token_flops(m: Dict) -> float:
    """FLOPs of one token through the served model."""
    return roofline.rwkv6_token_flops(m, param_count(m))


# ----------------------------------------------------------------------
def _fp8(x: torch.Tensor, dim: int) -> torch.Tensor:
    """x rounded to e4m3 with one scale per slice along `dim`."""
    scale = x.abs().amax(dim=dim, keepdim=True).clamp(min=1e-30) / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


def _lin(x, w, lower: bool):
    if lower:
        return _fp8(x, -1) @ _fp8(w, 0)
    return x @ w


def _rms(x, w, eps):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * w


def _shift(x):
    return torch.cat([torch.zeros_like(x[:1]), x[:-1]], dim=0)


def wkv(r, k, v, w, u):
    """r, k, v, w: (T, H, hd) float32; u (H, hd) -> y (T, H, hd) from a
    zero state."""
    T, H, hd = r.shape
    C = CHUNK
    n = -(-T // C)
    pad = n * C - T

    def chunks(x, fill):
        x = F.pad(x, (0, 0, 0, 0, 0, pad), value=fill) if pad else x
        return x.reshape(n, C, H, hd)

    r, k, v, w = chunks(r, 0.0), chunks(k, 0.0), chunks(v, 0.0), \
        chunks(w, 1.0)
    S_loc = r.new_zeros((n, H, hd, hd))
    decay = r.new_ones((n, H, hd))
    y = torch.empty_like(r)
    lead = torch.empty_like(r)        # decay from the chunk start to t-1
    for t in range(C):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]
        y[:, t] = torch.einsum("nhi,nhij->nhj", r[:, t],
                               S_loc + u[None, :, :, None] * kv)
        lead[:, t] = decay
        S_loc = w[:, t, :, :, None] * S_loc + kv
        decay = decay * w[:, t]
    S = r.new_zeros((H, hd, hd))
    for c in range(n):
        y[c] += torch.einsum("thi,hij->thj", r[c] * lead[c], S)
        S = decay[c][:, :, None] * S + S_loc[c]
    return y.reshape(n * C, H, hd)[:T]


def _layer(m, p, x, lower):
    eps = m["norm_eps"]
    d = x.shape[-1]
    hd = m["wkv_head_dim"]
    H = d // hd
    T = x.shape[0]
    h = _rms(x, p["ln1"], eps)
    delta = _shift(h) - h
    xx = h + delta * p["mu_x"]
    lo = torch.tanh(_lin(xx, p["mix_A"], lower)).reshape(T, 5, LORA_MIX)
    mus = p["mu_rkvwg"] + torch.stack(
        [_lin(lo[:, i], p["mix_B"][i], lower) for i in range(5)], dim=1)
    xr, xk, xv, xw, xg = (h + delta * mus[:, i] for i in range(5))
    r = _lin(xr, p["wr"], lower).reshape(T, H, hd)
    k = _lin(xk, p["wk"], lower).reshape(T, H, hd)
    v = _lin(xv, p["wv"], lower).reshape(T, H, hd)
    g = F.silu(_lin(xg, p["wg"], lower))
    lw = p["w0"] + _lin(torch.tanh(_lin(xw, p["decay_A"], lower)),
                        p["decay_B"], lower)
    w = torch.exp(-torch.exp(lw.clamp(-20.0, 10.0))).reshape(T, H, hd)
    y = wkv(r, k, v, w, p["u"])
    mean = y.mean(-1, keepdim=True)
    var = y.var(-1, keepdim=True, correction=0)
    y = ((y - mean) * torch.rsqrt(var + 1e-5)).reshape(T, d) * p["ln_x"]
    x = x + _lin(y * g, p["wo"], lower)
    h = _rms(x, p["ln2"], eps)
    delta = _shift(h) - h
    xk = h + delta * p["mu_ck"]
    xr = h + delta * p["mu_cr"]
    kk = torch.square(F.relu(_lin(xk, p["w_ck"], lower)))
    return x + torch.sigmoid(_lin(xr, p["w_cr"], lower)) * \
        _lin(kk, p["w_cv"], lower)


@torch.no_grad()
def logits_at(m: Dict, params: Dict, tokens: Sequence[int],
              positions: Sequence[int], lower: bool = False
              ) -> torch.Tensor:
    """(len(positions), V) float32 logits of the full forward pass over
    `tokens` at `positions`, layer by layer."""
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    saved = cudnn.allow_tf32, matmul.allow_tf32
    cudnn.allow_tf32 = matmul.allow_tf32 = False
    try:
        dev = params["embed"].device
        tok = torch.as_tensor(list(tokens), dtype=torch.long, device=dev)
        x = params["embed"][tok]
        blk = params["block"]
        for i in range(m["n_layers"]):
            x = _layer(m, {k: v[i] for k, v in blk.items()}, x, lower)
        pos = torch.as_tensor(list(positions), dtype=torch.long, device=dev)
        h = _rms(x[pos], params["final_norm"], m["norm_eps"])
        return _lin(h, params["lm_head"], lower)
    finally:
        cudnn.allow_tf32, matmul.allow_tf32 = saved


def served_gaps(m: Dict, params: Dict, prompt: List[int],
                served: List[int], lower: bool = False) -> List[float]:
    """For each served token, how far its reference logit lies below the
    reference's best at that position.  With `lower`, the control's
    first choice at each position is judged instead of the served
    token."""
    seq = list(prompt) + list(served[:-1])
    pos = list(range(len(prompt) - 1, len(seq)))
    ref = logits_at(m, params, seq, pos)
    if lower:
        pick = logits_at(m, params, seq, pos, lower=True).argmax(-1)
    else:
        pick = torch.as_tensor(served, dtype=torch.long, device=ref.device)
    best = ref.max(-1).values
    return (best - ref.gather(-1, pick[:, None])[:, 0]).tolist()
