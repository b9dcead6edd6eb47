"""Cost-model-driven federation placement, copied from the JAX package's
``continuum/placement.py`` over the port's `chaos.schedule`.

The JAX package's `core.scheduler.ContinuumScheduler` (not in the port
yet) places ONE training job on the best continuum resource (paper Fig
3a).  This module closes the remaining loop
between the paper's analytic cost model and the LIVE federation: it assigns
all P institutions of an overlay to cloud/fog/edge resources, derives each
institution's per-round wall time from the Fig 3/4 cost model (local
training + model publish/fetch over the institution's own uplink), and
turns the spread of those times into the overlay's fault-schedule language:

  * `straggler_weights` — (P,) floats in (0, 1], fastest placement = 1.0;
    threshold them into a `MergeContext.mask` participation vector
    (``mask = weights >= cutoff``: the slow tail drops from the round) or
    scale per-institution contributions with them in a custom merge
    strategy.  NOTE: the built-in masked reductions count a row as
    either in or out — a fractional weight passed raw as `ctx.mask`
    participates fully in the numerator but contributes its fraction to
    the survivor count, which is not a weighted mean; binarize first;
  * `PlacementSchedule` — a `chaos.FaultSchedule` whose per-round
    delays are each institution's round-time excess over the fastest tier.
    Attached via ``OverlayConfig.fault_schedule``, consensus waits for the
    modeled stragglers (`straggler_wait_s` shows up in the overlay stats)
    and, past `deadline_s`, the slowest tiers drop out of the round — the
    merge context's participation mask then comes from the COST MODEL, not
    from synthetic chaos.

Assignment is greedy marginal-cost load balancing: institutions are placed
one at a time onto the resource minimizing their post-assignment round
time, where co-locating k institutions on one resource divides its
training throughput k ways (the exchange time is per-institution — each
hospital owns its uplink).  Deterministic: ties break on the sorted
resource name.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.chaos.schedule import FaultSchedule, RoundFaults
from repro_torch.continuum.costmodel import (
    DEVICE_PROFILES, MB_BITS, TRAIN_FLOP_FACTOR, device_fanin_time_s,
)
from repro_torch.continuum.resources import C3_TESTBED, Resource


@dataclass(frozen=True)
class FederationWorkload:
    """One overlay ROUND of one institution, in cost-model units."""
    flops_per_sample: float
    samples_per_round: int          # batch * local_steps
    model_size_mb: float


@dataclass(frozen=True)
class DeviceFleet:
    """The device sub-federation an institution fronts: each
    round, `n_devices` personal devices upload an `update_size_mb` masked
    update over a `DEVICE_PROFILES[profile]` last-hop link before the
    institution can publish its own round update.  Attach via the `fleet`
    parameter of `round_time_s` / `assign_institutions`; `fleet=None`
    keeps every modeled time (and the placement goldens) bit-identical to
    the single-tier model."""
    n_devices: int
    profile: str = "phone"
    update_size_mb: float = 0.01

    def fanin_time_s(self, edge: Resource) -> float:
        return device_fanin_time_s(self.n_devices,
                                   DEVICE_PROFILES[self.profile], edge,
                                   self.update_size_mb)


@dataclass(frozen=True)
class InstitutionPlacement:
    institution: int
    resource: str
    tier: str                       # cci | fog | edge
    round_time_s: float


def exchange_time_s(resource: Resource, model_size_mb: float) -> float:
    """Publish the local model + fetch the merged one through the C3
    backbone; the institution's own uplink is the bottleneck."""
    return 2.0 * (resource.latency_s
                  + model_size_mb * MB_BITS / (resource.bandwidth_mbps * 1e6))


def round_time_s(resource: Resource, workload: FederationWorkload,
                 load: int = 1,
                 fleet: Optional[DeviceFleet] = None) -> float:
    """Modeled wall time of one overlay round for an institution on
    `resource` shared by `load` co-located institutions.  With a `fleet`,
    the institution first absorbs its device sub-federation's fan-in
    (`DeviceFleet.fanin_time_s`) before training and exchanging;
    fleet=None is bit-identical to the pre-device-tier model."""
    compute = (TRAIN_FLOP_FACTOR * workload.flops_per_sample
               * workload.samples_per_round * load
               / (resource.gflops * 1e9))
    fanin = 0.0 if fleet is None else fleet.fanin_time_s(resource)
    return fanin + compute + exchange_time_s(resource, workload.model_size_mb)


def assign_institutions(
        n_institutions: int, workload: FederationWorkload,
        resources: Optional[Dict[str, Resource]] = None,
        fleet: Optional[DeviceFleet] = None,
) -> List[InstitutionPlacement]:
    """Greedy marginal-cost placement of P institutions onto the continuum.

    Institution i goes to the resource minimizing its round time GIVEN the
    load already placed there; after all are placed, every institution's
    final round time is recomputed with the final loads (co-tenants of one
    resource share one figure).  Deterministic for a given testbed dict.
    With a `fleet`, every institution fronts that device sub-federation
    and its fan-in joins the round time the greedy compares (fleet=None
    reproduces the single-tier placement goldens bit-identically).
    """
    pool = dict(resources or C3_TESTBED)
    if not pool:
        raise ValueError("empty resource pool")
    loads = {name: 0 for name in pool}
    chosen: List[str] = []
    for _ in range(n_institutions):
        best = min(sorted(pool),
                   key=lambda n: round_time_s(pool[n], workload,
                                              loads[n] + 1, fleet))
        loads[best] += 1
        chosen.append(best)
    return [InstitutionPlacement(
        institution=i, resource=name, tier=pool[name].tier,
        round_time_s=round_time_s(pool[name], workload, loads[name], fleet))
        for i, name in enumerate(chosen)]


def tier_latency_summary(
        placements: Sequence[InstitutionPlacement],
        workload: FederationWorkload,
        resources: Optional[Dict[str, Resource]] = None,
) -> Dict[str, Dict[str, float]]:
    """Per-tier (cci/fog/edge) latency/throughput roll-up of a placement,
    split into the two components `round_time_s` folds together:

      ``compute_s``      worst-case per-placement compute time on the tier
                         (co-tenant load included) — for a serving
                         placement (`serving.federated.serving_workload`)
                         this is the modeled TICK latency: the workload
                         already divided `TRAIN_FLOP_FACTOR` out, so the
                         factor cancels and the figure prices exactly one
                         forward-only batch;
      ``exchange_s``     worst-case model publish+fetch on the tier — for
                         serving, the modeled hot-swap model fetch;
      ``samples_per_s``  tier-aggregate throughput: sum over the tier's
                         placements of samples_per_round / compute time
                         (decode tokens/s for a serving workload).

    Deterministic for a given testbed dict; tiers sort lexicographically.
    """
    pool = dict(resources or C3_TESTBED)
    loads: Dict[str, int] = {}
    for p in placements:
        loads[p.resource] = loads.get(p.resource, 0) + 1
    acc: Dict[str, Dict[str, list]] = {}
    for p in placements:
        res = pool[p.resource]
        compute = (TRAIN_FLOP_FACTOR * workload.flops_per_sample
                   * workload.samples_per_round * loads[p.resource]
                   / (res.gflops * 1e9))
        a = acc.setdefault(p.tier, {"compute_s": [], "exchange_s": []})
        a["compute_s"].append(compute)
        a["exchange_s"].append(exchange_time_s(res, workload.model_size_mb))
    return {
        tier: {
            "replicas": len(a["compute_s"]),
            "compute_s": max(a["compute_s"]),
            "exchange_s": max(a["exchange_s"]),
            "samples_per_s": sum(workload.samples_per_round / c
                                 for c in a["compute_s"]),
        }
        for tier, a in sorted(acc.items())
    }


def straggler_weights(
        placements: Sequence[InstitutionPlacement]) -> np.ndarray:
    """(P,) float weights in (0, 1]: fastest placement = 1.0, a tier twice
    as slow = 0.5.  Binarize for the built-in merges
    (`participation_mask`) or weight contributions in a custom merge."""
    t = np.asarray([p.round_time_s for p in placements], np.float64)
    if len(t) == 0:
        return t
    return (t.min() / t).astype(np.float64)


def participation_mask(weights: np.ndarray, cutoff: float) -> np.ndarray:
    """(P,) bool `MergeContext.mask`: institutions whose straggler weight
    clears `cutoff` participate; the slow tail passes through untouched.
    The boolean form the built-in masked reductions expect.

    Boundary is INCLUSIVE: ``weight == cutoff`` participates (``>=``), so
    ``cutoff=1.0`` always keeps the fastest tier — `straggler_weights`
    pins the fastest placement at exactly 1.0.  Mirrors the other two
    deadline comparisons in this stack (`PlacementSchedule`: delay ==
    deadline_s participates; `chaos.DeviceSchedule`: a device exactly on
    its deadline is on time).  Do not flip to ``>`` without updating all
    three together."""
    return np.asarray(weights, np.float64) >= cutoff


class PlacementSchedule(FaultSchedule):
    """The cost model as a fault schedule: every round, institution i is
    delayed by its placement's round-time excess over the fastest tier;
    with a `deadline_s`, tiers slower than the deadline drop from the
    round entirely (their rows pass through the merge untouched and the
    DLT records only the survivors).  Boundary is INCLUSIVE: an
    institution whose delay EQUALS `deadline_s` still makes the round
    (``delays <= deadline_s``), consistent with `participation_mask`'s
    ``>=`` cutoff."""

    def __init__(self, placements: Sequence[InstitutionPlacement],
                 deadline_s: Optional[float] = None):
        t = np.asarray([p.round_time_s for p in placements], np.float64)
        self.placements = tuple(placements)
        self.delays = t - (t.min() if len(t) else 0.0)
        self.deadline_s = deadline_s

    def faults(self, round_index: int, n: int) -> RoundFaults:
        if n != len(self.delays):
            raise ValueError(
                f"schedule placed {len(self.delays)} institutions, overlay "
                f"has {n}")
        if self.deadline_s is None:
            part = np.ones(n, bool)
            delay = self.delays.copy()
        else:
            part = self.delays <= self.deadline_s
            delay = np.where(part, self.delays, 0.0)  # dropped: nobody waits
        return RoundFaults(part, delay, False)
