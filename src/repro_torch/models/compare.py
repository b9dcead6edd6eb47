"""Two runs of one of the port's models held against each other: the
card against the CPU, the flash kernel against the plain path, the port
against the JAX package.  The models never call this module.

* `family_batch`: a seeded (B, S) input batch for a config's modality.
* `RouterTap`: records each MoE layer's router input while it is active.
* `routes` / `routing_flips`: each MoE call's routing in both runs, and
  the tokens that chose other experts in one run than in the other.

The rule `routing_flips` holds.  Top-k over router logits flips a token
to another expert when its k-th and (k+1)-th logits are nearly equal and
the two runs' router inputs differ by rounding (bf16 activations that
two libraries, or a kernel and the plain path, round in other places).
Any flip has margin <= 2 delta (margin: the k-th logit less the (k+1)-th;
delta: the largest difference of the token's logits between the runs),
so that alone shows nothing.  What is held instead: until the first MoE
call in which a token flips, the runs route alike, so their router
inputs must agree within ROUTER_INPUT_ULPS bf16 ulps of the call's
largest |input|, and each flip of that first call must have delta within
FLIP_DELTA_ULPS bf16 ulps of the call's largest |router logit|.  After
it the runs differ by design (the flipped token's FFN output changes,
capacity drops move, attention carries both to later tokens): later
flips are counted, not held.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Tuple

import numpy as np
import torch

from repro_torch.models import layers

ROUTER_INPUT_ULPS = 8
FLIP_DELTA_ULPS = 8


def bf16_ulps(want, ulps: float) -> float:
    """`ulps` bf16 ulps of the largest magnitude in `want`."""
    top = float(want.abs().max())
    return ulps * 2.0 ** (math.floor(math.log2(top)) - 7) if top else 0.0


def family_batch(cfg, B: int, S: int, seed: int, device="cpu"):
    """A (B, S) batch for `cfg`'s modality, from a seeded numpy RNG:
    tokens in [1, vocab); audio: frame embeddings (B, S, d) instead; vlm:
    the tokens after cfg.n_image_patches patch embeddings (B, P, d)."""
    rng = np.random.default_rng(seed)
    toks = torch.from_numpy(rng.integers(
        1, cfg.vocab_size, (B, S)).astype(np.int32)).to(device)

    def emb(n):
        return torch.from_numpy(rng.standard_normal(
            (B, n, cfg.d_model)).astype(np.float32)).to(device)
    if cfg.modality == "audio":
        return {"frame_embeddings": emb(S)}
    if cfg.modality == "vlm":
        return {"tokens": toks, "patch_embeddings": emb(cfg.n_image_patches)}
    return {"tokens": toks}


class RouterTap:
    """While active, records each `layers.moe_ffn` call's (router input,
    router weights, top_k, capacity) in `calls`, in call order."""

    def __enter__(self):
        self.real, self.calls = layers.moe_ffn, []

        def tap(x, router_w, *w, top_k, capacity_factor):
            C = layers.moe_capacity(x.shape[1], router_w.shape[-1], top_k,
                                    capacity_factor)
            self.calls.append((x.detach().clone(), router_w.detach(), top_k,
                               C))
            return self.real(x, router_w, *w, top_k=top_k,
                             capacity_factor=capacity_factor)
        layers.moe_ffn = tap
        return self

    def __exit__(self, *exc):
        layers.moe_ffn = self.real


# one MoE call's routing, on the CPU: router input x (G, T, d), each
# token's experts idx (G, T, k), each sorted assignment's buffer row dest
# and whether it is kept (G, T k), the fp32 router logits (G, T, E)
Route = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor,
              torch.Tensor]


def routes(calls) -> List[Route]:
    """`RouterTap.calls` routed by the port's `_moe_dispatch`."""
    out = []
    for x, w, k, C in calls:
        _, idx, dest, _, keep, _, _ = layers._moe_dispatch(
            x, w, top_k=k, capacity=C)
        out.append(tuple(t.cpu() for t in (
            x, idx, dest, keep, x.float() @ w.float())))
    return out


@dataclasses.dataclass
class RoutingReport:
    n_calls: int
    # (call, group, token, margin, delta), margin and delta as above
    flips: List[Tuple[int, int, int, float, float]]
    first: Optional[int]      # the first call with a flip
    input_ulps: float         # router inputs' largest difference, held calls
    delta_share: float        # largest delta / its limit, the first call's

    def note(self) -> str:
        held = self.n_calls if self.first is None else self.first + 1
        line = (f"router inputs of {held} MoE calls within "
                f"{self.input_ulps:.2f} bf16 ulps (bound "
                f"{ROUTER_INPUT_ULPS})")
        if self.first is None:
            return f"MoE routing equal in all {self.n_calls} calls; {line}"
        n_first = sum(f[0] == self.first for f in self.flips)
        return (f"{len(self.flips)} routing flips in {self.n_calls} MoE "
                f"calls, the first in call {self.first}: its {n_first} "
                f"within rounding (logit delta at most "
                f"{self.delta_share:.2f} of the limit, {FLIP_DELTA_ULPS} "
                f"bf16 ulps of the largest logit); {line}")


def routing_flips(got: List[Route], want: List[Route]) -> RoutingReport:
    """The tokens whose experts differ between two runs' `routes`, call
    by call, held to the module's rule; a call in which every token chose
    the same experts must give the same buffer rows and drops."""
    assert len(got) == len(want) > 0, (len(got), len(want))
    flips, first, input_ulps, share = [], None, 0.0, 0.0
    for n, (a, b) in enumerate(zip(got, want)):
        (xa, ia, da, ka, la), (xb, ib, db, kb, lb) = a, b
        assert xa.shape == xb.shape and ia.shape == ib.shape, n
        same = (ia.sort(-1).values == ib.sort(-1).values).all(-1)
        if bool(same.all()):
            assert torch.equal(da, db) and torch.equal(ka, kb), n
        if first is not None:
            flips += _flipped(n, same, la, lb, ia.shape[-1])
            continue
        unit = bf16_ulps(xb.float(), 1)
        err = float((xa.float() - xb.float()).abs().max()) / unit
        assert err <= ROUTER_INPUT_ULPS, (n, err, ROUTER_INPUT_ULPS)
        input_ulps = max(input_ulps, err)
        if bool(same.all()):
            continue
        first, new = n, _flipped(n, same, la, lb, ia.shape[-1])
        limit = bf16_ulps(lb, FLIP_DELTA_ULPS)
        for f in new:
            assert f[4] <= limit, (f, limit)
            share = max(share, f[4] / limit)
        flips += new
    return RoutingReport(len(want), flips, first, input_ulps, share)


def _flipped(n, same, la, lb, k):
    out = []
    for g, t in (~same).nonzero().tolist():
        top = lb[g, t].sort(descending=True).values
        out.append((n, g, t, float(top[k - 1] - top[k]),
                    float((la[g, t] - lb[g, t]).abs().max())))
    return out
