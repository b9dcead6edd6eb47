"""Deterministic Byzantine attack models for the federation, the JAX
package's ``chaos/attacks.py`` on torch tensors.

A `ByzantineSchedule` marks a subset of institutions as compromised and
describes what they publish instead of their honest update.  Like the
fault schedules, every attack decision is a pure function of ``(seed,
round, institution)`` via the counter-based RNG in `chaos.rng`, so an
attack run is bit-reproducible and independent of evaluation order.

Attack kinds (cf. Yin et al. 2018; Fang et al. 2020):

  sign_flip    the attacker publishes ``-scale * update``: at scale > 1
               this is the classic scaled sign-flip that makes the plain
               mean's round map expansive when
               |(P - f - scale*f) / P| > 1;
  scaled_grad  the attacker publishes ``scale * update`` (a boosted /
               model-replacement style update);
  label_flip   data poisoning: the attacker's training labels are flipped
               at source (`SyntheticGlendaDataset(label_flip_institutions)`)
               so its honestly computed update steers the federation
               toward the wrong decision boundary.  The model-space
               transform is the identity; the harness wires the poisoned
               dataset.

`apply_attack` is applied by the overlay to the stacked published rows in
both round engines; the attacker masks travel as (P,) arrays exactly like
participation masks, so eager and batched runs replay identical attacks.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional, Tuple

import numpy as np
import torch

from repro_torch.chaos import rng
from repro_torch.pytree import tree_map

Pytree = Any

ATTACK_KINDS = ("sign_flip", "scaled_grad", "label_flip")

# Stream tag decorrelating attacker draws from every fault-schedule stream.
_STREAM_BYZ = 0xB42D


def draw_attackers(n: int, fraction: float, seed: int = 0) -> Tuple[int, ...]:
    """Exactly ``floor(fraction * n)`` compromised institutions, chosen
    deterministically (the institutions with the smallest counter hashes —
    a seeded random subset that is a pure function of (seed, n))."""
    f = int(np.floor(fraction * n))
    if f <= 0:
        return ()
    order = np.argsort(rng.hash_u32(seed, _STREAM_BYZ, np.arange(n)),
                       kind="stable")
    return tuple(sorted(int(i) for i in order[:f]))


@dataclass(frozen=True)
class ByzantineSchedule:
    """WHO is compromised, WHEN, and WHAT they publish.

    kind        one of `ATTACK_KINDS`
    attackers   fixed compromised set; empty = draw `fraction` of the
                federation deterministically from `seed` (exact count,
                stable across rounds — a compromised hospital stays
                compromised)
    fraction    used only when `attackers` is empty
    scale       attack magnitude (see the kind table above)
    start/stop  active round window [start, stop); stop=None = forever
    seed        counter-RNG seed for the attacker draw
    """
    kind: str
    attackers: Tuple[int, ...] = ()
    fraction: float = 0.0
    scale: float = 1.0
    start: int = 0
    stop: Optional[int] = None
    seed: int = 0

    def __post_init__(self):
        if self.kind not in ATTACK_KINDS:
            raise ValueError(
                f"unknown attack kind {self.kind!r}; one of {ATTACK_KINDS}")

    def attacker_set(self, n: int) -> Tuple[int, ...]:
        """The stable compromised set for a P=n federation."""
        if self.attackers:
            bad = [i for i in self.attackers if not 0 <= i < n]
            if bad:
                raise ValueError(f"attacker indices {bad} out of range "
                                 f"for P={n}")
            return tuple(sorted(set(self.attackers)))
        return draw_attackers(n, self.fraction, self.seed)

    def active(self, round_index: int) -> bool:
        return (round_index >= self.start
                and (self.stop is None or round_index < self.stop))

    def attacker_mask(self, round_index: int, n: int) -> np.ndarray:
        """(P,) bool — institutions publishing poison THIS round."""
        mask = np.zeros(n, bool)
        if self.active(round_index):
            mask[list(self.attacker_set(n))] = True
        return mask


def apply_attack(kind: str, stacked: Pytree, att_mask, scale) -> Pytree:
    """Model-space transform: attacker rows of the stacked (P, ...) pytree
    are replaced by what they publish, in f32 and cast back; honest rows
    pass through bit-identical.  `att_mask` is a (P,) bool/float array or
    tensor, `scale` a scalar."""
    if kind == "label_flip":
        return stacked          # data-space; the dataset carries the poison
    if kind not in ("sign_flip", "scaled_grad"):
        raise ValueError(f"unknown attack kind {kind!r}")
    s = float(np.float32(scale))
    factor = -s if kind == "sign_flip" else s

    def poison(x):
        att = torch.as_tensor(att_mask, device=x.device).to(torch.bool)
        ab = att.reshape(att.shape + (1,) * (x.dim() - 1))
        return torch.where(ab, (factor * x.to(torch.float32)).to(x.dtype), x)
    return tree_map(poison, stacked)


def attack_scenarios(seed: int = 0):
    """The named adversarial matrix shared by the benchmark and the
    determinism tests (None = attack-free baseline).  Fractions stay below
    the f < P/2 breakdown point of the robust merges."""
    return {
        "honest": None,
        "sign_flip_30": ByzantineSchedule("sign_flip", fraction=0.30,
                                          scale=8.0, seed=seed),
        "scaled_grad_20": ByzantineSchedule("scaled_grad", fraction=0.20,
                                            scale=10.0, seed=seed + 1),
        "label_flip_30": ByzantineSchedule("label_flip", fraction=0.30,
                                           seed=seed + 2),
        "late_onset": ByzantineSchedule("sign_flip", fraction=0.30,
                                        scale=8.0, start=3, seed=seed + 3),
    }
