"""Composable fault schedules for the federation chaos harness, copied
from the JAX package's ``chaos/schedule.py`` (its ``DeviceSchedule`` waits
for the device tier).

Every fault decision is a pure function of ``(seed, round, institution)``
via the counter-based RNG in `chaos.rng`, so a fault trace is
bit-reproducible and independent of evaluation order.

A schedule maps a round index to a `RoundFaults` record consumed by both
sides of the stack:

  * `core.consensus.PaxosSimulator.run_consensus(faults=...)`: crashed
    acceptors cost detection timeouts, a crashed coordinator triggers
    leader re-election, and losing quorum aborts the instance;
  * `core.overlay.DecentralizedOverlay.merge_phase`: the participation
    mask becomes a (P,) bool tensor gating the merges (masked mean over
    survivors, secure aggregation with survivor-pair masks).

Schedules compose with ``a | b`` (or `compose`): participation is the AND,
straggler delays take the elementwise max (the coordinator waits for the
slowest), coordinator crashes OR together.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import numpy as np

from repro_torch.chaos import rng

# Stream tags decorrelate the per-schedule hash streams even when two
# schedules share a seed (e.g. Dropout(seed=0) | Straggler(seed=0)).
_STREAM_DROPOUT = 0x0D0D
_STREAM_STRAGGLE = 0x57A6
_STREAM_CRASH = 0xC0DE
_STREAM_FLAP = 0xF1AB


@dataclass(frozen=True)
class RoundFaults:
    """Faults injected into ONE overlay round (P institutions).

    participation   (P,) bool — institution takes part in this round's
                    consensus + merge (False = crashed / unreachable /
                    straggled past the deadline)
    delay_s         (P,) float — straggler delay; participants' delays
                    stall the phase (coordinator waits for slowest vote)
    coordinator_crash  the current leader dies mid-instance: detection
                    timeout + re-election among survivors
    """
    participation: np.ndarray
    delay_s: np.ndarray
    coordinator_crash: bool = False

    @staticmethod
    def none(n: int) -> "RoundFaults":
        return RoundFaults(np.ones(n, bool), np.zeros(n), False)

    @property
    def trivial(self) -> bool:
        return (bool(self.participation.all())
                and float(self.delay_s.max(initial=0.0)) == 0.0
                and not self.coordinator_crash)

    def survivors(self) -> Tuple[int, ...]:
        return tuple(int(i) for i in np.flatnonzero(self.participation))

    def merge(self, other: "RoundFaults") -> "RoundFaults":
        return RoundFaults(
            self.participation & other.participation,
            np.maximum(self.delay_s, other.delay_s),
            self.coordinator_crash or other.coordinator_crash)


class FaultSchedule:
    """Base: the all-healthy schedule.  Subclasses override `faults`."""

    def faults(self, round_index: int, n: int) -> RoundFaults:
        return RoundFaults.none(n)

    def __or__(self, other: "FaultSchedule") -> "FaultSchedule":
        return ComposedSchedule((self, other))


class ComposedSchedule(FaultSchedule):
    def __init__(self, parts: Sequence[FaultSchedule]):
        flat = []
        for p in parts:
            flat.extend(p.parts if isinstance(p, ComposedSchedule) else [p])
        self.parts = tuple(flat)

    def faults(self, round_index: int, n: int) -> RoundFaults:
        out = RoundFaults.none(n)
        for p in self.parts:
            out = out.merge(p.faults(round_index, n))
        return out


def compose(*schedules: FaultSchedule) -> FaultSchedule:
    return ComposedSchedule(schedules)


@dataclass(frozen=True)
class Dropout(FaultSchedule):
    """Each institution independently misses a round with prob `rate`
    (device churn, Ye et al. 2112.09341)."""
    rate: float
    seed: int = 0

    def faults(self, round_index: int, n: int) -> RoundFaults:
        u = rng.uniform(self.seed, _STREAM_DROPOUT, round_index, np.arange(n))
        return RoundFaults(u >= self.rate, np.zeros(n), False)


@dataclass(frozen=True)
class Straggler(FaultSchedule):
    """Each institution independently straggles with prob `rate`, delayed by
    uniform(0, max_delay_s).  Delays past `deadline_s` drop the institution
    from the round (the coordinator's vote timeout); delays under it stall
    the phase for everyone."""
    rate: float
    max_delay_s: float = 2.0
    deadline_s: Optional[float] = None
    seed: int = 0

    def faults(self, round_index: int, n: int) -> RoundFaults:
        idx = np.arange(n)
        hit = rng.uniform(self.seed, _STREAM_STRAGGLE, round_index, idx)
        mag = rng.uniform(self.seed, _STREAM_STRAGGLE + 1, round_index, idx)
        delay = np.where(hit < self.rate, mag * self.max_delay_s, 0.0)
        if self.deadline_s is None:
            part = np.ones(n, bool)
        else:
            part = delay <= self.deadline_s
            delay = np.where(part, delay, 0.0)   # dropped: nobody waits
        return RoundFaults(part, delay, False)


@dataclass(frozen=True)
class Partition(FaultSchedule):
    """Network partition for rounds [start, stop): institutions whose index
    is in `minority` fall off the coordinator's side of the overlay.  If the
    minority is actually the larger side, the coordinator's side loses
    quorum and the consensus instance aborts — both behaviors emerge from
    the quorum rule in `core.consensus`."""
    start: int
    stop: int
    minority: Tuple[int, ...]

    def faults(self, round_index: int, n: int) -> RoundFaults:
        part = np.ones(n, bool)
        if self.start <= round_index < self.stop:
            part[list(self.minority)] = False
        return RoundFaults(part, np.zeros(n), False)


@dataclass(frozen=True)
class Flapping(FaultSchedule):
    """Institutions that periodically die and rejoin: down for `down_for`
    rounds out of every `period`, with a per-institution phase offset so the
    whole federation never flaps in lockstep."""
    period: int
    down_for: int
    institutions: Tuple[int, ...] = ()
    seed: int = 0

    def faults(self, round_index: int, n: int) -> RoundFaults:
        part = np.ones(n, bool)
        insts = self.institutions or tuple(range(n))
        for i in insts:
            phase = int(rng.hash_u32(self.seed, _STREAM_FLAP, i)
                        % np.uint32(self.period))
            part[i] = ((round_index + phase) % self.period) >= self.down_for
        return RoundFaults(part, np.zeros(n), False)


@dataclass(frozen=True)
class CoordinatorCrash(FaultSchedule):
    """The consensus leader crashes mid-instance with prob `rate` per round
    (or deterministically on `rounds`), forcing failure detection + leader
    re-election among the survivors — the paper's single-coordinator
    bottleneck made into a fault, not just a slow path.

    ``fatal=True`` marks the crash as killing the whole coordinating
    process, not just the in-flight Paxos instance.  Its consensus effect
    is identical; the JAX package's crash recovery (``chaos.recovery``,
    not ported yet) treats the first fatal crash round as the point where
    the coordinating process dies."""
    rate: float = 0.0
    rounds: Tuple[int, ...] = ()
    seed: int = 0
    fatal: bool = False

    def faults(self, round_index: int, n: int) -> RoundFaults:
        crash = round_index in self.rounds
        if self.rate > 0.0 and not crash:
            crash = bool(rng.uniform(self.seed, _STREAM_CRASH, round_index)
                         < self.rate)
        return RoundFaults(np.ones(n, bool), np.zeros(n), crash)
