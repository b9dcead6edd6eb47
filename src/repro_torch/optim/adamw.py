"""AdamW with decoupled weight decay: functional, over param pytrees.

The state mirrors the param tree: fp32 moments ``m`` and ``v`` and an
int32 step ``count``.  The update is computed in fp32 and cast back to
each param's dtype.  The sharding helpers of the reference
(``optimizer_abstract_state``, ``optimizer_state_axes``) go with the
meshes (ROADMAP queue A item 27) and are not ported.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Tuple

import torch

from repro_torch.pytree import tree_flatten, tree_map, tree_unflatten

Pytree = Any


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    learning_rate: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip_norm: float = 1.0


def adamw_init(params: Pytree) -> Pytree:
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    first = tree_flatten(params)[0][0]
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "count": torch.zeros((), dtype=torch.int32,
                                 device=first.device)}


def global_norm(tree: Pytree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in tree_flatten(tree)[0]))


def adamw_update(cfg: AdamWConfig, params: Pytree, grads: Pytree,
                 state: Pytree, lr_scale=1.0) -> Tuple[Pytree, Pytree, dict]:
    """One step: the gradient is clipped to ``grad_clip_norm`` by its
    global norm (``min(1, C / (|g| + 1e-9))``), the moments' bias
    corrections come from the int32 count, and ``v`` is clamped at 0:
    moments merged from outside can carry negative residue."""
    gnorm = global_norm(grads)
    clip = torch.clamp(cfg.grad_clip_norm / (gnorm + 1e-9), max=1.0)
    count = state["count"] + 1
    b1c = 1 - cfg.b1 ** count.float()
    b2c = 1 - cfg.b2 ** count.float()
    lr = cfg.learning_rate * torch.as_tensor(lr_scale, dtype=torch.float32)

    def upd(p, g, m, v):
        g = g.float() * clip
        m = cfg.b1 * m + (1 - cfg.b1) * g
        v = torch.clamp(cfg.b2 * v + (1 - cfg.b2) * torch.square(g), min=0.0)
        step = (m / b1c) / (torch.sqrt(v / b2c) + cfg.eps)
        step = step + cfg.weight_decay * p.float()
        return (p.float() - lr * step).to(p.dtype), m, v

    flat_p, spec = tree_flatten(params)
    flat_g = tree_flatten(grads)[0]
    flat_m = tree_flatten(state["m"])[0]
    flat_v = tree_flatten(state["v"])[0]
    out = [upd(p, g, m, v) for p, g, m, v in zip(flat_p, flat_g, flat_m,
                                                  flat_v)]
    new_p = tree_unflatten(spec, [o[0] for o in out])
    new_m = tree_unflatten(spec, [o[1] for o in out])
    new_v = tree_unflatten(spec, [o[2] for o in out])
    return new_p, {"m": new_m, "v": new_v, "count": count}, {
        "grad_norm": gnorm, "lr": lr}
