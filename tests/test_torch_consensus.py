"""The port's consensus remainder held against the JAX package, exactly:
`ProtocolParams.for_fleet`, `PaxosSimulator.run_initialization`
transcripts, `measure`, `ConsensusGate.fast_forward` followed by
`next_round` (equal to a gate that never stopped), and a fleet
federation's gate through `OverlayConfig.consensus_params`.  The
simulation is numpy on both sides, so every field of every transcript is
equal, floats included.
"""
import dataclasses

import numpy as np
import pytest

from repro.chaos import standard_scenarios as jax_standard_scenarios
from repro.core.consensus import ConsensusGate as JaxGate
from repro.core.consensus import PaxosSimulator as JaxSimulator
from repro.core.consensus import ProtocolParams as JaxParams
from repro.core.consensus import measure as jax_measure
from repro_torch.chaos import standard_scenarios
from repro_torch.core import (
    ConsensusGate, DecentralizedOverlay, OverlayConfig, PaxosSimulator,
    ProtocolParams, measure,
)


def _same(a, b):
    assert dataclasses.asdict(a) == dataclasses.asdict(b)


@pytest.mark.parametrize("P", [1, 2, 5, 16, 32, 64, 128])
def test_for_fleet_params_equal(P):
    assert dataclasses.asdict(ProtocolParams.for_fleet(P)) == \
        dataclasses.asdict(JaxParams.for_fleet(P))


@pytest.mark.parametrize("join_wait", [False, True])
@pytest.mark.parametrize("P", [3, 10, 16])
def test_run_initialization_transcripts_equal(P, join_wait):
    for seed in (0, 7):
        for fleet in (False, True):
            ours = PaxosSimulator(P, seed, ProtocolParams.for_fleet(P)
                                  if fleet else None)
            theirs = JaxSimulator(P, seed, JaxParams.for_fleet(P)
                                  if fleet else None)
            _same(ours.run_initialization(join_wait),
                  theirs.run_initialization(join_wait))
            # the simulator's state after bootstrap: the next instance too
            _same(ours.run_consensus(), theirs.run_consensus())


@pytest.mark.parametrize("kind", ["consensus", "initialization"])
def test_measure_equal(kind):
    for P in (3, 10, 16):
        for seed in (0, 2):
            assert measure(kind, P, 4, seed) == jax_measure(kind, P, 4, seed)
    assert measure(kind, 32, 3, 1, ProtocolParams.for_fleet(32)) == \
        jax_measure(kind, 32, 3, 1, JaxParams.for_fleet(32))


@pytest.mark.parametrize("scenario", [None, "churn", "coordinator_crash"])
def test_fast_forward_then_next_round_equals_uninterrupted(scenario):
    P, skip, total = 6, 4, 7
    ours_s = None if scenario is None else standard_scenarios(1)[scenario]
    theirs_s = (None if scenario is None
                else jax_standard_scenarios(1)[scenario])

    def faults(sched):
        return None if sched is None else (lambda r: sched.faults(r, P))

    whole = ConsensusGate(P, seed=3)
    for r in range(total):
        whole.next_round(faults=faults(ours_s)(r) if ours_s else None)
    ours, theirs = ConsensusGate(P, seed=3), JaxGate(P, seed=3)
    replayed = ours.fast_forward(skip, faults(ours_s))
    for a, b in zip(replayed, theirs.fast_forward(skip, faults(theirs_s))):
        _same(a, b)
    for r in range(skip, total):
        f = faults(ours_s)(r) if ours_s else None
        g = faults(theirs_s)(r) if theirs_s else None
        a, b = ours.next_round(faults=f), theirs.next_round(faults=g)
        _same(a, b)
        _same(a, whole.history[r])
    assert ours.total_consensus_time_s == whole.total_consensus_time_s
    with pytest.raises(ValueError, match="backwards"):
        ours.fast_forward(-1)


def test_fleet_overlay_gate_commits_like_jax():
    """At P = 32 the defaults almost never commit; `for_fleet` through
    OverlayConfig.consensus_params does, and its transcripts equal the
    JAX gate's with the same params."""
    P = 32
    ov = DecentralizedOverlay(OverlayConfig(
        n_institutions=P, merge="mean", consensus_seed=4,
        consensus_params=ProtocolParams.for_fleet(P)))
    assert ov.gate.params == ProtocolParams.for_fleet(P)
    theirs = JaxGate(P, seed=4, params=JaxParams.for_fleet(P))
    trs = [ov.gate.next_round() for _ in range(8)]
    for a in trs:
        _same(a, theirs.next_round())
    assert any(t.committed for t in trs)
    default = ConsensusGate(P, seed=4)
    assert sum(default.next_round().committed for _ in range(8)) < \
        sum(t.committed for t in trs)
    assert np.isfinite([t.elapsed_s for t in trs]).all()
