"""Named chaos scenarios, the JAX package's ``chaos/scenarios.py``: the
same matrix, so both packages exercise the same fault traces for a seed.

Every scenario is deterministic in (seed, round, institution) — see
`chaos.rng` — so two runs with the same seed produce identical
participation masks, consensus transcripts, and merged weights.
"""
from __future__ import annotations

from typing import Dict, Optional

from repro_torch.chaos.schedule import (
    CoordinatorCrash, Dropout, FaultSchedule, Flapping, Partition, Straggler,
    compose,
)


def standard_scenarios(seed: int = 0) -> Dict[str, Optional[FaultSchedule]]:
    """The chaos-test matrix (None = fault-free baseline).

    dropout30       every institution independently misses ~30% of rounds
                    (the acceptance point of the fault-tolerance work)
    stragglers      40% of institutions per round are late by up to 2 s;
                    past the 1 s vote deadline they are dropped instead
    partition       rounds 2-3 split the overlay; the coordinator keeps a
                    quorum-holding majority and commits among survivors
    quorum_loss     rounds 2-3 strand the coordinator in a minority —
                    consensus MUST abort (Paxos safety), models untouched
    flapping        two institutions flap down-2-up-2; they rejoin with
                    stale weights and get pulled back by survivor merges
    coordinator_crash  the leader dies mid-instance on fixed rounds,
                    forcing detection + re-election under a new leader
    churn           everything at once: dropout + stragglers + occasional
                    coordinator crashes (the e-health edge in the wild)
    """
    return {
        "baseline": None,
        "dropout30": Dropout(rate=0.30, seed=seed),
        "stragglers": Straggler(rate=0.40, max_delay_s=2.0, deadline_s=1.0,
                                seed=seed),
        "partition": Partition(start=2, stop=4, minority=(3, 4)),
        "quorum_loss": Partition(start=2, stop=4, minority=(0, 1, 2)),
        "flapping": Flapping(period=4, down_for=2, institutions=(1, 3),
                             seed=seed),
        "coordinator_crash": CoordinatorCrash(rounds=(1, 3, 5)),
        "churn": compose(Dropout(rate=0.20, seed=seed + 1),
                         Straggler(rate=0.30, max_delay_s=1.5,
                                   deadline_s=0.75, seed=seed + 2),
                         CoordinatorCrash(rate=0.25, seed=seed + 3)),
    }
