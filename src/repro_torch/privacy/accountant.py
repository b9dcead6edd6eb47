"""RDP (moments) accountant for the DP-published federation, a pure-math
copy of the JAX package's ``privacy/accountant.py``.

Every committed overlay round each institution publishes a row that went
through the fused clip+noise kernel (`kernels/dp`): L2-clipped to C, then
perturbed with Gaussian noise of std `noise_multiplier * C`.  That is one
invocation of the Gaussian mechanism with sensitivity C and noise multiplier
sigma, whose Renyi-DP at order alpha is the classic

    eps_RDP(alpha) = alpha / (2 * sigma^2)

per round (Mironov 2017, Prop. 7).  RDP composes by ADDITION across rounds,
and converts to (eps, delta)-DP with the Canonne–Kamath–Steinke conversion
(the one TF-Privacy/Opacus use):

    eps(delta) = min_alpha  rdp(alpha) + log((alpha-1)/alpha)
                            - (log(delta) + log(alpha)) / (alpha - 1)

Everything here is deterministic host-side float math — the accountant
state advances once per COMMITTED round (an aborted consensus instance
publishes nothing and spends no budget) and its running eps(delta) is
committed into the round's DLT metadata by the overlay, so the ledger
carries the full privacy trace next to the model provenance.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Sequence, Tuple

# Default Renyi orders: the TF-Privacy grid (dense low orders where the
# minimum usually sits, sparse high orders for tiny-noise regimes).
DEFAULT_ORDERS: Tuple[float, ...] = (
    1.25, 1.5, 1.75, 2.0, 2.25, 2.5, 3.0, 3.5, 4.0, 4.5,
    5.0, 6.0, 7.0, 8.0, 10.0, 12.0, 16.0, 20.0, 24.0, 32.0,
    48.0, 64.0, 128.0, 256.0, 512.0,
)


@dataclasses.dataclass(frozen=True)
class DPConfig:
    """Knobs of the per-institution Gaussian mechanism.

    clip_norm         C — every published row is L2-clipped to this norm
    noise_multiplier  sigma — noise std is sigma * C per element
    delta             the delta at which the DLT-committed eps is reported
    seed              uint32 base seed of the counter-based noise PRG; the
                      per-round seed is derived from the round's merge key,
                      this offsets the whole stream (two federations with
                      identical keys but different dp seeds draw
                      decorrelated noise)
    """
    clip_norm: float
    noise_multiplier: float
    delta: float = 1e-5
    seed: int = 0

    def __post_init__(self):
        if not self.clip_norm > 0.0:
            raise ValueError(f"clip_norm must be > 0, got {self.clip_norm}")
        if self.noise_multiplier < 0.0:
            raise ValueError(
                f"noise_multiplier must be >= 0, got {self.noise_multiplier}")
        if not 0.0 < self.delta < 1.0:
            raise ValueError(f"delta must be in (0, 1), got {self.delta}")
        if not 0 <= self.seed < 2 ** 32:
            # the seed is XOR-ed into the uint32 round seed
            raise ValueError(f"seed must be a uint32, got {self.seed}")


class RDPAccountant:
    """Tracks cumulative RDP of `steps` Gaussian-mechanism rounds at
    `noise_multiplier`, convertible to (eps, delta) at any delta."""

    def __init__(self, noise_multiplier: float,
                 orders: Sequence[float] = DEFAULT_ORDERS):
        if noise_multiplier < 0.0:
            raise ValueError("noise_multiplier must be >= 0")
        if any(a <= 1.0 for a in orders):
            raise ValueError("Renyi orders must be > 1")
        self.noise_multiplier = float(noise_multiplier)
        self.orders = tuple(float(a) for a in orders)
        self.steps = 0

    def step(self, n: int = 1) -> None:
        """Account `n` more rounds of the mechanism (RDP adds up)."""
        if n < 0:
            raise ValueError("cannot un-spend privacy budget")
        self.steps += n

    def rdp(self) -> Tuple[float, ...]:
        """Cumulative eps_RDP(alpha) per order."""
        sigma = self.noise_multiplier
        if sigma == 0.0:
            return tuple(math.inf for _ in self.orders)
        return tuple(self.steps * a / (2.0 * sigma * sigma)
                     for a in self.orders)

    def epsilon(self, delta: float) -> float:
        """Tightest (eps, delta) guarantee over the order grid."""
        if not 0.0 < delta < 1.0:
            raise ValueError(f"delta must be in (0, 1), got {delta}")
        if self.steps == 0:
            return 0.0
        if self.noise_multiplier == 0.0:
            return math.inf
        best = math.inf
        for a, r in zip(self.orders, self.rdp()):
            eps = (r + math.log((a - 1.0) / a)
                   - (math.log(delta) + math.log(a)) / (a - 1.0))
            if eps < best:
                best = eps
        return max(best, 0.0)

    def best_order(self, delta: float) -> float:
        """The order attaining `epsilon(delta)` (diagnostic)."""
        eps = self.epsilon(delta)
        for a, r in zip(self.orders, self.rdp()):
            cand = (r + math.log((a - 1.0) / a)
                    - (math.log(delta) + math.log(a)) / (a - 1.0))
            if math.isclose(max(cand, 0.0), eps, rel_tol=1e-12,
                            abs_tol=1e-12):
                return a
        return self.orders[-1]
