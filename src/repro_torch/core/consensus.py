"""Paxos 3-phase-commit consensus over the STIGMA EHR overlay (paper §5),
a numpy copy of the JAX package's ``core/consensus.py``: the same seeded
discrete-event simulation draws the same RNG sequence, so transcripts,
commit bits and survivor sets are identical per seed.

  * one coordinator relays every message (the paper's noted bottleneck),
  * three phases per instance: PREPARE/PROMISE, ACCEPT/ACCEPTED, COMMIT,
  * per-acceptor conflict probability per round forces a re-vote,
  * per-message latency drawn from the institution's continuum tier with
    lognormal jitter.

`run_consensus(faults=...)` takes a record with ``participation`` (P,)
bool, ``delay_s`` (P,) float and ``coordinator_crash`` bool, and models
acceptor crashes, coordinator failover, quorum and stragglers.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.continuum.resources import C3_TESTBED

PHASES = ("prepare", "accept", "commit")


@dataclass(frozen=True)
class ProtocolParams:
    """§5.2 experimental design constants."""
    leader_interval_s: float = 0.030
    vote_delay_s: float = 0.100
    join_interval_s: float = 10.0
    conflict_rate: float = 0.20      # per-acceptor per-round re-vote probability
    conflict_growth: float = 0.004   # extra conflict prob per extra institution
    election_conflict_rate: float = 0.17
    jitter_sigma: float = 0.25       # lognormal message-latency jitter
    mean_link_latency_s: float = 0.005
    queue_factor: float = 0.05       # coordinator relay congestion ~ (n-2)^2
    failure_detect_timeout_s: float = 0.5   # per dead peer, paid once

    @classmethod
    def for_fleet(cls, n_institutions: int) -> "ProtocolParams":
        """Constants for federations of P >= ~16.  Under the defaults each
        acceptor re-votes with probability 0.20, so an instance commits
        with probability (1 - rate)^(P-1), which vanishes at large P.  A
        fleet batches votes through the leader, which keeps the expected
        conflicts a round constant in P: the per-acceptor rate scales as
        0.8 / P (capped at 0.20), so (1 - c/P)^(P-1) -> e^-c, and
        `conflict_growth` is 0.  This is another protocol model, not the
        paper's testbed (for_fleet(5) draws at 0.16, not 0.20); the
        latency terms, the (n-2)^2 coordinator queueing above all, are
        unchanged."""
        n = max(n_institutions, 2)
        return cls(conflict_rate=min(0.20, 0.8 / n), conflict_growth=0.0)


def _institution_latencies(n: int, rng: np.random.Generator,
                           params: ProtocolParams) -> np.ndarray:
    """Per-institution link latency: hospitals sit on heterogeneous tiers."""
    tiers = list(C3_TESTBED.values())
    picks = rng.choice(len(tiers), size=n)
    lat = np.array([tiers[i].latency_s for i in picks])
    # normalize to the calibrated mean so tier mix changes spread, not scale
    return lat * (params.mean_link_latency_s / max(lat.mean(), 1e-9))


@dataclass
class Transcript:
    """What happened during one consensus instance (for the DLT log)."""
    n_institutions: int
    phases: List[Dict] = field(default_factory=list)
    elapsed_s: float = 0.0
    committed: bool = False
    rounds_total: int = 0
    # fault-injection telemetry (defaults keep the happy path unchanged)
    leader: int = 0                  # coordinator that drove the instance
    survivors: tuple = ()            # institutions that participated
    leader_elections: int = 0        # mid-instance re-elections
    aborted_no_quorum: bool = False  # leader's side lost the majority
    straggler_wait_s: float = 0.0    # time spent waiting on slow voters


class PaxosSimulator:
    def __init__(self, n_institutions: int, seed: int = 0,
                 params: Optional[ProtocolParams] = None):
        if n_institutions < 2:
            raise ValueError("consensus needs >= 2 institutions")
        self.n = n_institutions
        self.params = params or ProtocolParams()
        self.rng = np.random.default_rng(seed)
        self.latencies = _institution_latencies(self.n, self.rng, self.params)

    # ------------------------------------------------------------------
    def _message_time(self, acceptor: int) -> float:
        base = self.params.leader_interval_s + self.latencies[acceptor]
        return base * self.rng.lognormal(0.0, self.params.jitter_sigma)

    def _voting_round(self, conflict_rate: float) -> tuple[float, bool]:
        """Coordinator relays to each acceptor sequentially, then collects
        votes; returns (elapsed, success).  The single-coordinator relay is
        the paper's noted bottleneck: its queueing delay grows ~(n-2)^2.
        The fault-free round IS the faulty round with every acceptor live
        and no straggler wait — one implementation, identical RNG draws."""
        return self._faulty_voting_round(range(1, self.n), conflict_rate, 0.0)

    def _phase(self, conflict_rate: float, max_rounds: int = 64):
        return self._faulty_phase(range(1, self.n), conflict_rate, 0.0,
                                  max_rounds)

    # ------------------------------------------------------------------
    def run_consensus(self, max_rounds: int = 64,
                      faults=None) -> Transcript:
        """One 3-phase commit on a fully-initialized network.
        If any phase exhausts its voting rounds the instance ABORTS —
        the overlay then skips that merge (paper step 7: updates happen
        "only after a consensus ... is reached").

        `faults` (optional): a participation/delay/crash record; see
        the module docstring for the failure semantics.  ``faults=None`` is
        the exact seed code path (bit-identical RNG draw order)."""
        if faults is not None:
            return self._run_consensus_faulty(faults, max_rounds)
        tr = Transcript(n_institutions=self.n)
        tr.survivors = tuple(range(self.n))
        t = 0.0
        committed = True
        for phase in PHASES:
            dt, rounds = self._phase(self.params.conflict_rate, max_rounds)
            t += dt
            tr.rounds_total += rounds
            tr.phases.append({"phase": phase, "elapsed_s": dt, "rounds": rounds})
            if rounds >= max_rounds:
                committed = False
                break
        tr.elapsed_s = t
        tr.committed = committed
        return tr

    # ------------------------------------------------------------------
    # fault-injected instance

    def _faulty_voting_round(self, acceptors: Sequence[int],
                             conflict_rate: float,
                             extra_wait_s: float) -> tuple[float, bool]:
        """One voting round over an explicit acceptor set: the leader
        relays only to live acceptors, queueing grows with the live member
        count m = len(acceptors) + 1, and every round additionally waits
        `extra_wait_s` for the slowest participating straggler.  The
        fault-free `_voting_round` delegates here with all n-1 acceptors
        and zero wait."""
        m = len(acceptors) + 1
        t = 0.0
        for acceptor in acceptors:
            t += self._message_time(acceptor)          # relay out
            t += self._message_time(acceptor)          # vote back via leader
        t += (self.params.queue_factor * (m - 2) ** 2
              * self.params.leader_interval_s)
        rate = conflict_rate + self.params.conflict_growth * max(m - 3, 0)
        conflicted = self.rng.random(len(acceptors)) < rate
        t += self.params.vote_delay_s + extra_wait_s
        return t, not conflicted.any()

    def _faulty_phase(self, acceptors: Sequence[int], conflict_rate: float,
                      extra_wait_s: float, max_rounds: int = 64):
        t, rounds = 0.0, 0
        while rounds < max_rounds:
            dt, ok = self._faulty_voting_round(acceptors, conflict_rate,
                                               extra_wait_s)
            t += dt
            rounds += 1
            if ok:
                return t, rounds
            t += self.params.vote_delay_s              # back-off before re-vote
        return t, rounds                                # give up (still counted)

    def _run_consensus_faulty(self, faults, max_rounds: int) -> Transcript:
        p = self.params
        tr = Transcript(n_institutions=self.n)
        active = np.array(faults.participation, dtype=bool, copy=True)
        if active.shape != (self.n,):
            raise ValueError(f"participation mask shape {active.shape} "
                             f"!= ({self.n},)")
        delays = np.asarray(faults.delay_s, dtype=float)
        t = 0.0
        # The leader pings each dead institution once and times out.
        t += int((~active).sum()) * p.failure_detect_timeout_s
        leader = int(np.flatnonzero(active)[0]) if active.any() else -1
        if getattr(faults, "coordinator_crash", False) and active.any():
            # Leader dies mid-instance: detect, then elect a successor
            # among the remaining survivors (paper's single-coordinator
            # bottleneck turned into a recoverable fault).
            t += p.failure_detect_timeout_s
            active[leader] = False
            if active.any():
                leader = int(np.flatnonzero(active)[0])
                electorate = [int(i) for i in np.flatnonzero(active)
                              if i != leader]
                dt, rounds = self._faulty_phase(
                    electorate, p.election_conflict_rate, 0.0, max_rounds)
                t += dt
                tr.rounds_total += rounds
                tr.leader_elections += 1
                tr.phases.append({"phase": f"election@leader{leader}",
                                  "elapsed_s": dt, "rounds": rounds})
                if rounds >= max_rounds:
                    # no coordinator was ever elected — the instance cannot
                    # proceed to PREPARE, let alone commit
                    tr.leader = leader
                    tr.survivors = tuple(int(i)
                                         for i in np.flatnonzero(active))
                    tr.elapsed_s = t
                    tr.committed = False
                    return tr
        tr.leader = leader
        tr.survivors = tuple(int(i) for i in np.flatnonzero(active))
        quorum = self.n // 2 + 1
        if int(active.sum()) < quorum:
            # Paxos safety: a minority side may never commit.  The leader
            # learns this after one voting delay and gives up.
            tr.elapsed_s = t + p.vote_delay_s
            tr.committed = False
            tr.aborted_no_quorum = True
            return tr
        extra_wait = float(delays[active].max(initial=0.0))
        acceptors = [int(i) for i in np.flatnonzero(active) if i != leader]
        committed = True
        for phase in PHASES:
            dt, rounds = self._faulty_phase(acceptors, p.conflict_rate,
                                            extra_wait, max_rounds)
            t += dt
            tr.rounds_total += rounds
            tr.straggler_wait_s += extra_wait * rounds
            tr.phases.append({"phase": phase, "elapsed_s": dt,
                              "rounds": rounds})
            if rounds >= max_rounds:
                committed = False
                break
        tr.elapsed_s = t
        tr.committed = committed
        return tr

    def run_initialization(self,
                           include_join_wait: bool = False) -> Transcript:
        """Network bootstrap: institutions join one by one, and every join
        triggers a leader election among the current members.  The time is
        the elections' overhead; the fixed join spacing is added only when
        asked for."""
        tr = Transcript(n_institutions=self.n)
        t = 0.0
        full_lat = self.latencies
        for m in range(2, self.n + 1):
            self.latencies = full_lat[:m]
            saved_n, self.n = self.n, m
            dt, rounds = self._phase(self.params.election_conflict_rate)
            self.n = saved_n
            t += dt
            tr.rounds_total += rounds
            tr.phases.append({"phase": f"election@{m}", "elapsed_s": dt,
                              "rounds": rounds})
            if include_join_wait:
                t += self.params.join_interval_s
        self.latencies = full_lat
        tr.elapsed_s = t
        tr.committed = True
        return tr


def measure(kind: str, n_institutions: int, n_runs: int = 10, seed: int = 0,
            params: Optional[ProtocolParams] = None):
    """The mean and standard deviation of `n_runs` instances' elapsed
    seconds, `kind` "consensus" or "initialization" (paper §5.2)."""
    times = []
    for r in range(n_runs):
        sim = PaxosSimulator(n_institutions, seed=seed * 1000 + r,
                             params=params)
        tr = (sim.run_consensus() if kind == "consensus"
              else sim.run_initialization())
        times.append(tr.elapsed_s)
    arr = np.asarray(times)
    return float(arr.mean()), float(arr.std())


class ConsensusGate:
    """Bridges the protocol simulation to the round loop: each round runs
    one consensus instance, and its commit bit (and modeled latency) gate
    the merge."""

    def __init__(self, n_institutions: int, seed: int = 0,
                 params: Optional[ProtocolParams] = None):
        self.n = n_institutions
        self.seed = seed
        self.params = params
        self.history: List[Transcript] = []

    def next_round(self, faults=None) -> Transcript:
        sim = PaxosSimulator(self.n, seed=self.seed + len(self.history),
                             params=self.params)
        tr = sim.run_consensus(faults=faults)
        self.history.append(tr)
        return tr

    def fast_forward(self, n_instances: int,
                     faults_for=None) -> List[Transcript]:
        """Replay `n_instances` instances without acting on them: each is a
        pure function of seed x instance index x faults, so a restored
        overlay re-derives the gate state it had, and its next instance
        equals the uninterrupted run's.  `faults_for` maps an instance
        index to its faults (None: fault-free)."""
        if n_instances < 0:
            raise ValueError("cannot fast-forward backwards")
        out = []
        for _ in range(n_instances):
            faults = (faults_for(len(self.history))
                      if faults_for is not None else None)
            out.append(self.next_round(faults=faults))
        return out

    @property
    def total_consensus_time_s(self) -> float:
        return sum(t.elapsed_s for t in self.history)

