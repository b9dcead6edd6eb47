"""Composable fault schedules for the federation chaos harness, copied
from the JAX package's ``chaos/schedule.py``, and `DeviceSchedule`, the
per-device draws of the device tier, on tensors.

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
_STREAM_DEV_DROPOUT = 0xDE0D     # device-tier streams, distinct from the
_STREAM_DEV_STRAGGLE = 0xDE57    # institution streams above


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
class DeviceSchedule:
    """Per-DEVICE fault draws below one institution (the device tier):
    `Dropout` and `Straggler` one level down, drawn on the device inside
    the sweep's chunk loop (`rng.uniform_traced`):

      * a device misses the sweep with prob `dropout_rate` (u >= rate
        participates, as in `Dropout`);
      * a participant straggles with prob `straggler_rate`, delayed by
        uniform(0, max_delay_s); a delay PAST `deadline_s` makes it LATE
        (``delay <= deadline_s`` is still on time, the inclusive boundary
        of `Straggler` and `placement.participation_mask`).  Late devices
        are not dropped: the device tier folds their update into the
        NEXT round's carry (`core.device_tier`).

    Decisions are pure functions of (seed, sweep, institution, device), so
    `draw` (tensors, on the counters' device) and `draw_host` (numpy)
    agree bit for bit: the uniforms are exact in float32 and every
    threshold is a float32 on both paths.  Lateness compares the delay's
    MAGNITUDE with deadline_s / max_delay_s (algebraically ``mag *
    max_delay_s > deadline_s``), so no float32-vs-float64 multiply can
    flip a boundary decision between the two paths.
    """
    dropout_rate: float = 0.0
    straggler_rate: float = 0.0
    max_delay_s: float = 2.0
    deadline_s: Optional[float] = None
    seed: int = 0

    def _thresholds(self):
        drop = np.float32(self.dropout_rate)
        strag = np.float32(self.straggler_rate)
        if self.deadline_s is None or self.max_delay_s <= 0.0:
            late = np.float32(np.inf)        # nobody is ever late
        else:
            late = np.float32(self.deadline_s / self.max_delay_s)
        return drop, strag, late

    def draw(self, sweep_index, inst_id, device_ids):
        """(on_time, late) bool tensors over `device_ids`, on their
        device; no host sync, so it runs under `torch.func.vmap`."""
        drop_t, strag_t, late_t = (float(t) for t in self._thresholds())
        u = rng.uniform_traced(self.seed, _STREAM_DEV_DROPOUT, sweep_index,
                               inst_id, device_ids)
        alive = u >= drop_t
        hit = rng.uniform_traced(self.seed, _STREAM_DEV_STRAGGLE,
                                 sweep_index, inst_id, device_ids)
        mag = rng.uniform_traced(self.seed, _STREAM_DEV_STRAGGLE + 1,
                                 sweep_index, inst_id, device_ids)
        is_late = (hit < strag_t) & (mag > late_t)
        return alive & ~is_late, alive & is_late

    def draw_host(self, sweep_index, inst_id, device_ids):
        """Numpy twin of `draw`, the oracle of loop references and
        checks."""
        drop_t, strag_t, late_t = self._thresholds()
        ids = np.asarray(device_ids)
        u = rng.uniform(self.seed, _STREAM_DEV_DROPOUT, sweep_index,
                        inst_id, ids)
        alive = u >= drop_t
        hit = rng.uniform(self.seed, _STREAM_DEV_STRAGGLE, sweep_index,
                          inst_id, ids)
        mag = rng.uniform(self.seed, _STREAM_DEV_STRAGGLE + 1, sweep_index,
                          inst_id, ids)
        is_late = (hit < strag_t) & (mag > late_t)
        return alive & ~is_late, alive & is_late


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
    is identical; crash recovery (``chaos.recovery.fatal_crash_rounds``)
    reads the fatal crash rounds as the points where the coordinating
    process dies."""
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
