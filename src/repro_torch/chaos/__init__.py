"""Deterministic failure and attack injection for the federation, and the
federation harness.

  rng.py        counter-based host RNG: fault decisions are pure
                functions of (seed, round, institution)
  schedule.py   composable FaultSchedules (Dropout, Straggler, Partition,
                Flapping, CoordinatorCrash), the RoundFaults record
                that consensus and the overlay's merges consume, and
                DeviceSchedule, the device tier's per-device draws
  scenarios.py  the named chaos matrix (standard_scenarios)
  attacks.py    Byzantine attack models: ByzantineSchedule, apply_attack
                and the named attack matrix
  harness.py    CNNFederation, which runs the paper's federation
  recovery.py   kill/recover: fatal crash rounds, snapshot corruption,
                simulate_crash_run against golden_run
"""
from repro_torch.chaos.attacks import (
    ATTACK_KINDS, ByzantineSchedule, apply_attack, attack_scenarios,
    draw_attackers,
)
from repro_torch.chaos.schedule import (
    ComposedSchedule, CoordinatorCrash, DeviceSchedule, Dropout,
    FaultSchedule, Flapping, Partition, RoundFaults, Straggler, compose,
)
from repro_torch.chaos.recovery import (
    CORRUPTION_MODES, RecoveryReport, corrupt_snapshot, fatal_crash_rounds,
    golden_run, simulate_crash_run,
)
from repro_torch.chaos.scenarios import standard_scenarios

__all__ = [
    "ATTACK_KINDS", "CORRUPTION_MODES", "ByzantineSchedule",
    "ComposedSchedule", "CoordinatorCrash", "DeviceSchedule", "Dropout", "FaultSchedule",
    "Flapping", "Partition", "RecoveryReport", "RoundFaults", "Straggler",
    "apply_attack", "attack_scenarios", "compose", "corrupt_snapshot",
    "draw_attackers", "fatal_crash_rounds", "golden_run",
    "simulate_crash_run", "standard_scenarios",
]
