"""Mesh-parallel federations in the port (`run_rounds(mesh=...)` over
``torch.distributed``), held against the port's single-process run and
the JAX package's single-device run.

  * A 1-rank ("inst",) mesh over a 1-rank gloo group is bit-identical to
    mesh=None (params, metrics, chain digest, stats) for every registered
    merge under healthy and dropout30 schedules: the gather of one rank
    is the identity.
  * A mesh without an "inst" axis raises ValueError before the consensus
    gate moves.
  * One spawned run of W = 4 gloo ranks on the CPU
    (tests/_torch_mesh_child.py, paid once): float merges at P in {5, 8,
    16} within RTOL 2e-5, ATOL 1e-6 of the port's single-process run and
    of the JAX package's single-device `run_rounds` (P = 5 does not
    divide 4 and runs replicated); int secure_mean, the personal head,
    the device tier's uint32 totals, the recovered chain digest and the
    gather of f32, uint32 and bool rows bit for bit; the toolkit's
    ``group=`` reductions against the single-block helpers.
"""
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.distributed.device_mesh import DeviceMesh

from repro.chaos import Dropout as JaxDropout
from repro.core import DecentralizedOverlay as JaxOverlay
from repro.core import OverlayConfig as JaxOverlayConfig
from repro.core.consensus import ProtocolParams as JaxProtocolParams
from repro_torch import random as prng
from repro_torch.core import DecentralizedOverlay, OverlayConfig
from repro_torch.core.merges import available_merges
from repro_torch.launch.mesh import process_group
from repro_torch.sharding import make_institution_mesh
from _torch_mesh_child import (
    ATOL, KEY, RTOL, W, batch_arrays, run, schedules, start_arrays, tensors,
)
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, os.pardir, "src")
MERGES = sorted(available_merges())


@pytest.fixture(scope="module")
def one_rank_mesh():
    with process_group("gloo"):
        yield make_institution_mesh(1, device="cpu")


@pytest.mark.parametrize("merge", MERGES)
@pytest.mark.parametrize("schedule", sorted(schedules()))
def test_one_rank_mesh_bit_identical_to_no_mesh(one_rank_mesh, merge,
                                                schedule):
    ov_r, a, trs_r = run(4, merge, schedules()[schedule], None)
    ov_m, b, trs_m = run(4, merge, schedules()[schedule], one_rank_mesh)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    assert [t.hash() for t in ov_r.registry.chain] == \
        [t.hash() for t in ov_m.registry.chain]
    assert ov_r.stats == ov_m.stats and ov_m.registry.verify_chain()
    assert any(s["committed"] for s in ov_m.stats)


def test_run_rounds_rejects_mesh_without_inst_axis(one_rank_mesh):
    mesh = DeviceMesh("cpu", [0], mesh_dim_names=("model",))
    ov = DecentralizedOverlay(OverlayConfig(
        n_institutions=4, local_steps=1, merge="mean", merge_subtree=None))
    x, y = batch_arrays(4)
    with pytest.raises(ValueError, match="inst"):
        ov.run_rounds(tensors(start_arrays(4)),
                      (torch.from_numpy(x), torch.from_numpy(y)), None,
                      prng.PRNGKey(0), 2, mesh=mesh)
    assert ov.round_index == 0 and len(ov.gate.history) == 0


# ----------------------------------------------------------------------
# W = 4 ranks: one spawned run

@pytest.fixture(scope="module")
def child_report():
    env = dict(os.environ, PYTHONPATH=os.path.abspath(SRC))
    proc = subprocess.run(
        [sys.executable, os.path.join(HERE, "_torch_mesh_child.py")],
        capture_output=True, text=True, env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    report = json.loads(proc.stdout.strip().splitlines()[-1])
    assert report["world"] == W and len(report["ranks"]) == W
    return report["ranks"]


def _cases(ranks, domain):
    return [[c for c in rank["cases"] if c["domain"] == domain]
            for rank in ranks]


def test_four_rank_mesh_allclose_to_single_process(child_report):
    per_rank = _cases(child_report, "float")
    cases = per_rank[0]
    assert {(c["P"], c["schedule"]) for c in cases if c["merge"] == "mean"} \
        == {(p, s) for p in (5, 8, 16) for s in schedules()}
    assert {c["merge"] for c in cases if c["P"] == 8} == set(MERGES)
    for rank in per_rank:
        bad = [c for c in rank if not (c["allclose"] and c["stats_equal"]
                                       and c["transcripts_equal"])]
        assert not bad, bad
        # the merge ran on both layouts, and they agree on the commits
        assert all(0 < c["committed"] == c["committed_mesh"] for c in rank)
    # every rank returns the same full state
    for rank in per_rank[1:]:
        assert [c["fingerprint"] for c in rank] == \
            [c["fingerprint"] for c in cases]


def _jax_local_step(p, batch, k):
    x, y = batch
    g = jax.grad(lambda p: jnp.mean((x @ p["w"] - y) ** 2))(p)
    return jax.tree.map(lambda a, b: a - 0.1 * b, p, g), {
        "loss": jnp.mean((x @ p["w"] - y) ** 2)}


def _jax_run(P, merge, schedule):
    sched = None if schedule == "healthy" else JaxDropout(rate=0.30, seed=0)
    ov = JaxOverlay(JaxOverlayConfig(
        n_institutions=P, local_steps=1, merge=merge, alpha=0.7,
        group_size=2, consensus_seed=0, fault_schedule=sched,
        consensus_params=JaxProtocolParams.for_fleet(P),
        merge_subtree=None))
    x, y = batch_arrays(P)
    stacked, metrics, _ = ov.run_rounds(
        jax.tree.map(jnp.asarray, start_arrays(P)),
        (jnp.asarray(x), jnp.asarray(y)), _jax_local_step,
        jax.random.PRNGKey(KEY), 2)
    return [np.asarray(a) for a in jax.tree.leaves((stacked, metrics))]


JAX_CASES = [(P, "mean", s) for P in (5, 8, 16) for s in sorted(schedules())]
JAX_CASES += [(8, m, s) for m in MERGES if m != "mean"
              for s in sorted(schedules())]


@pytest.mark.parametrize("P,merge,schedule", JAX_CASES)
def test_four_rank_mesh_allclose_to_jax(child_report, P, merge, schedule):
    case, = [c for c in child_report[0]["cases"] if c["domain"] == "float"
             and (c["P"], c["merge"], c["schedule"]) == (P, merge, schedule)]
    want = _jax_run(P, merge, schedule)
    assert len(case["leaves"]) == len(want)
    for got, w in zip(case["leaves"], want):
        np.testing.assert_allclose(np.asarray(got, np.float32), w,
                                   rtol=RTOL, atol=ATOL)


def test_four_rank_int_domain_bit_identical(child_report):
    for rank in _cases(child_report, "int"):
        assert {(c["P"], c["schedule"]) for c in rank} == \
            {(p, s) for p in (5, 8, 16) for s in schedules()}
        assert all(c["merge"] == "secure_mean" for c in rank)
        bad = [c for c in rank if not c["bit_equal"]]
        assert not bad, bad
        assert all(0 < c["committed"] == c["committed_mesh"] for c in rank)


def test_four_rank_partial_head_bit_identical(child_report):
    for rank in child_report:
        assert {c["schedule"] for c in rank["partial"]} == set(schedules())
        for c in rank["partial"]:
            assert c["allclose"] and c["head_bit_equal"], c
            assert c["head_untouched"] and c["backbone_moved"], c
            assert 0 < c["committed"] == c["committed_mesh"], c


def test_four_rank_gather_keeps_bits(child_report):
    for rank in child_report:
        assert rank["gather"] is True


def test_toolkit_group_reductions_match_single_block(child_report):
    for rank in child_report:
        assert rank["toolkit"] == {"count_equal": True,
                                   "mean_allclose": True,
                                   "absmax_equal": True}


def test_four_rank_recovery_bit_identical(child_report):
    """Snapshot every 2 rounds, a kill in round 5, failover from the
    round-4 snapshot, on to round 6: every rank's params equal the
    uninterrupted mesh run's and the single-process run's, and rank 0's
    chain digest (it alone keeps the ledger) equals both runs'."""
    for rank in child_report:
        rec = rank["recovery"]
        assert rec["restored_round"] == 4 and rec["snapshots_skipped"] == 0
        assert rec["params_equal"] and rec["params_equal_single"], rec
    rec0 = child_report[0]["recovery"]
    assert rec0["digest_equal"] and rec0["digest_equal_single"], rec0
    assert rec0["chain_verified"]


def test_four_rank_two_tier_federation_parity(child_report):
    for rank in child_report:
        dev = rank["device"]
        assert dev["uint32_leaves"] == ["device_w", "stale_hi", "stale_lo",
                                        "stale_w"], dev
        assert dev["device_aggregates_bit_equal"] and dev["params_allclose"]
        assert 0 < dev["committed"] == dev["committed_mesh"], dev
