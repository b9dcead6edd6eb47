"""Deterministic failure and attack injection for the federation, and the
federation harness.

  rng.py        counter-based host RNG: fault decisions are pure
                functions of (seed, round, institution)
  schedule.py   composable FaultSchedules (Dropout, Straggler, Partition,
                Flapping, CoordinatorCrash) and the RoundFaults record
                that consensus and the overlay's merges consume
  scenarios.py  the named chaos matrix (standard_scenarios)
  attacks.py    Byzantine attack models: ByzantineSchedule, apply_attack
                and the named attack matrix
  harness.py    CNNFederation, which runs the paper's federation
"""
from repro_torch.chaos.attacks import (
    ATTACK_KINDS, ByzantineSchedule, apply_attack, attack_scenarios,
    draw_attackers,
)
from repro_torch.chaos.schedule import (
    ComposedSchedule, CoordinatorCrash, Dropout, FaultSchedule, Flapping,
    Partition, RoundFaults, Straggler, compose,
)
from repro_torch.chaos.scenarios import standard_scenarios

__all__ = [
    "ATTACK_KINDS", "ByzantineSchedule", "ComposedSchedule",
    "CoordinatorCrash", "Dropout", "FaultSchedule", "Flapping", "Partition",
    "RoundFaults", "Straggler", "apply_attack", "attack_scenarios",
    "compose", "draw_attackers", "standard_scenarios",
]
