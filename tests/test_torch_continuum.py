"""The port's continuum cost model and placement held against the JAX
package: host arithmetic copied from the reference, so every modeled time,
weight and placement is an equal float or an equal string (no tolerance).
Mirrors tests/test_costmodel.py case for case, adds the serving placement,
and drives a P = 5 CNN federation under a cost-model `PlacementSchedule`
with a deadline against the JAX package's (survivors, transcripts and
ledger equal; params within the federation tests' atol = 1e-4).
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax

from repro.chaos.harness import CNNFederation as JaxFederation
from repro.configs.stigma_cnn import STIGMA_CNN as JAX_STIGMA_CNN
from repro.continuum import costmodel as jcost
from repro.continuum import placement as jplace
from repro.models.stigma_cnn import flops_per_image as jax_flops_per_image
from repro.serving import ServeConfig as JaxServeConfig
from repro.serving import plan_serving as jax_plan_serving
from repro.serving import serving_workload as jax_serving_workload
from repro.serving.harness import TINY_SERVE as JAX_TINY_SERVE
from repro_torch import continuum
from repro_torch.chaos.harness import CNNFederation
from repro_torch.configs.stigma_cnn import STIGMA_CNN
from repro_torch.continuum import (
    C3_TESTBED, DEVICE_PROFILES, H100_SXM, DeviceFleet, FederationWorkload,
    PlacementSchedule, assign_institutions, device_fanin_time_s,
    device_upload_time_s, participation_mask, round_time_s,
    straggler_weights, training_time, transfer_matrix_1mb, transfer_time_mb,
)
from repro_torch.continuum.costmodel import MB_BITS, TRAIN_FLOP_FACTOR
from repro_torch.continuum.placement import (
    exchange_time_s, tier_latency_summary,
)
from repro_torch.convert import params_from_jax
from repro_torch.models.stigma_cnn import flops_per_image
from repro_torch.pytree import tree_flatten
from repro_torch.serving import ServeConfig, plan_serving, serving_workload
from repro_torch.serving.harness import TINY_SERVE
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

# the reference's heavy placement workload: spreads P = 7 over edge and fog
_WL = FederationWorkload(flops_per_sample=1.3e8, samples_per_round=500,
                         model_size_mb=5.0)
_JWL = jplace.FederationWorkload(flops_per_sample=1.3e8,
                                 samples_per_round=500, model_size_mb=5.0)
FLEET = dict(n_devices=4096, profile="wearable", update_size_mb=0.01)


def _placements_equal(ours, theirs):
    assert [dataclasses.asdict(p) for p in ours] == \
        [dataclasses.asdict(p) for p in theirs]


# ----------------------------------------------------------------------
# transfer model and resource tables (paper Fig 4, Table 1)

def test_fig4_edge_beats_cloud_for_1mb():
    m = transfer_matrix_1mb()
    assert m == jcost.transfer_matrix_1mb()
    assert m["rpi4"]["egs"] < m["es.large"]["es.medium"] < \
        m["m5a.xlarge"]["c5.large"]


def test_transfer_time_symmetric_and_equal():
    for a in C3_TESTBED:
        for b in C3_TESTBED:
            t = transfer_time_mb(1.0, C3_TESTBED[a], C3_TESTBED[b])
            assert t == transfer_time_mb(1.0, C3_TESTBED[b], C3_TESTBED[a])
            assert t == jcost.transfer_time_mb(1.0, jcost.C3_TESTBED[a],
                                               jcost.C3_TESTBED[b])


def test_transfer_scales_linearly_in_size():
    a, b = C3_TESTBED["egs"], C3_TESTBED["njn"]
    lat = a.latency_s + b.latency_s
    t1, t10 = transfer_time_mb(1.0, a, b), transfer_time_mb(10.0, a, b)
    assert t10 - lat == pytest.approx(10 * (t1 - lat), rel=1e-6)
    assert t10 == jcost.transfer_time_mb(10.0, jcost.C3_TESTBED["egs"],
                                         jcost.C3_TESTBED["njn"])


def test_table1_resources_equal_the_reference():
    assert {k: dataclasses.asdict(r) for k, r in C3_TESTBED.items()} == \
        {k: dataclasses.asdict(r) for k, r in jcost.C3_TESTBED.items()}
    bw = {k: r.bandwidth_mbps for k, r in C3_TESTBED.items()}
    assert bw["m5a.xlarge"] == 27 and bw["c5.large"] == 26
    assert bw["es.large"] == 65 and bw["egs"] == 813 and bw["rpi4"] == 800


def test_h100_roofline_constants():
    """NVIDIA's data-sheet figures, which chip_smoke.py's kernel bounds
    read from `H100_SXM`; the TPU's stay in the JAX package."""
    assert H100_SXM.peak_flops_bf16 == 989e12
    assert H100_SXM.hbm_bandwidth == 3.35e12
    assert H100_SXM.hbm_gb == 80.0 and H100_SXM.ici_bandwidth == 450e9
    assert not hasattr(continuum, "TPU_V5E")
    assert MB_BITS == jcost.MB_BITS
    assert TRAIN_FLOP_FACTOR == jcost.TRAIN_FLOP_FACTOR


def test_training_time_equals_the_reference():
    for src, dst in (("egs", None), ("rpi4", "egs"), ("c5.large", "njn")):
        kw = dict(flops_per_sample=1.3e8, n_samples=500, epochs=3,
                  model_size_mb=5.0)
        ours = training_time(C3_TESTBED[src], inference_resource=None if
                             dst is None else C3_TESTBED[dst], **kw)
        theirs = jcost.training_time(
            jcost.C3_TESTBED[src], inference_resource=None if dst is None
            else jcost.C3_TESTBED[dst], **kw)
        assert ours == theirs


# ----------------------------------------------------------------------
# federation placement: the reference's golden pins, equal floats

def test_round_time_matches_hand_computation():
    egs = C3_TESTBED["egs"]
    compute = TRAIN_FLOP_FACTOR * 1.3e8 * 500 / (egs.gflops * 1e9)
    exchange = 2 * (egs.latency_s + 5.0 * MB_BITS
                    / (egs.bandwidth_mbps * 1e6))
    assert round_time_s(egs, _WL, 1) == pytest.approx(compute + exchange)
    assert exchange_time_s(egs, 5.0) == pytest.approx(exchange)
    assert round_time_s(egs, _WL, 3) == pytest.approx(3 * compute + exchange)
    for load in (1, 2, 5):
        assert round_time_s(egs, _WL, load) == jplace.round_time_s(
            jcost.C3_TESTBED["egs"], _JWL, load)


@pytest.mark.parametrize("fleet", [None, FLEET])
@pytest.mark.parametrize("P", [5, 7, 16, 64])
def test_placements_equal_the_reference(P, fleet):
    ours = assign_institutions(
        P, _WL, fleet=None if fleet is None else DeviceFleet(**fleet))
    theirs = jplace.assign_institutions(
        P, _JWL, fleet=None if fleet is None else jplace.DeviceFleet(**fleet))
    _placements_equal(ours, theirs)
    np.testing.assert_array_equal(straggler_weights(ours),
                                  jplace.straggler_weights(theirs))
    assert tier_latency_summary(ours, _WL) == \
        jplace.tier_latency_summary(theirs, _JWL)


def test_assign_institutions_golden_c3_p5_and_p7():
    pl = assign_institutions(5, _WL)
    assert [p.resource for p in pl] == ["egs", "njn", "egs", "njn", "egs"]
    assert all(p.tier == "edge" for p in pl)
    assert pl[0].round_time_s == round_time_s(C3_TESTBED["egs"], _WL, 3)
    pl7 = assign_institutions(7, _WL)
    assert [p.resource for p in pl7] == \
        ["egs", "njn", "egs", "njn", "egs", "es.large", "njn"]


def test_straggler_weights_fastest_is_one():
    pl = assign_institutions(7, _WL)
    w = straggler_weights(pl)
    t = np.asarray([p.round_time_s for p in pl])
    assert w.shape == (7,) and (w <= 1.0).all() and (w > 0.0).all()
    assert w[t.argmin()] == 1.0
    assert straggler_weights([]).shape == (0,)


def test_placement_schedule_delays_and_deadline():
    pl = assign_institutions(7, _WL)
    jpl = jplace.assign_institutions(7, _JWL)
    t = np.asarray([p.round_time_s for p in pl])
    for deadline in (None, float(np.sort(t - t.min())[3])):
        ours = PlacementSchedule(pl, deadline_s=deadline)
        theirs = jplace.PlacementSchedule(jpl, deadline_s=deadline)
        for rnd in (0, 5):
            a, b = ours.faults(rnd, 7), theirs.faults(rnd, 7)
            np.testing.assert_array_equal(a.participation, b.participation)
            np.testing.assert_array_equal(a.delay_s, b.delay_s)
            assert a.coordinator_crash is b.coordinator_crash is False
        if deadline is not None:
            f = ours.faults(0, 7)
            assert f.participation.sum() == 4
            assert (f.delay_s[~f.participation] == 0.0).all()
    with pytest.raises(ValueError, match="placed 7 institutions, overlay "
                                         "has 9"):
        PlacementSchedule(pl).faults(0, 9)


def test_participation_mask_boundary_inclusive():
    w = np.array([1.0, 0.5, 0.25], np.float64)
    for cutoff in (0.5, 1.0, 0.25):
        np.testing.assert_array_equal(participation_mask(w, cutoff),
                                      jplace.participation_mask(w, cutoff))
    np.testing.assert_array_equal(participation_mask(w, 0.5),
                                  [True, True, False])
    np.testing.assert_array_equal(participation_mask(w, 1.0),
                                  [True, False, False])


def test_placement_schedule_deadline_boundary_inclusive():
    pl = assign_institutions(7, _WL)
    t = np.asarray([p.round_time_s for p in pl])
    delays = t - t.min()
    edge_delay = float(np.sort(np.unique(delays))[1])
    f = PlacementSchedule(pl, deadline_s=edge_delay).faults(0, 7)
    assert f.participation[np.isclose(delays, edge_delay)].all()
    assert f.participation.sum() == int((delays <= edge_delay).sum())


# ----------------------------------------------------------------------
# the device tier's fan-in in cost-model units

def test_device_fanin_hand_computation():
    egs, phone = C3_TESTBED["egs"], DEVICE_PROFILES["phone"]
    assert {k: dataclasses.asdict(v) for k, v in DEVICE_PROFILES.items()} \
        == {k: dataclasses.asdict(v)
            for k, v in jcost.DEVICE_PROFILES.items()}
    up = phone.latency_s + 0.01 * MB_BITS / (phone.bandwidth_mbps * 1e6)
    assert device_upload_time_s(phone, 0.01) == pytest.approx(up)
    ingest = 1024 * 0.01 * MB_BITS / (egs.bandwidth_mbps * 1e6)
    assert device_fanin_time_s(1024, phone, egs, 0.01) == pytest.approx(
        up + ingest)
    assert device_fanin_time_s(1024, phone, egs, 0.01) == \
        jcost.device_fanin_time_s(1024, jcost.DEVICE_PROFILES["phone"],
                                  jcost.C3_TESTBED["egs"], 0.01)
    assert device_fanin_time_s(0, phone, egs, 0.01) == 0.0


def test_device_fleet_preserves_single_tier_goldens():
    egs = C3_TESTBED["egs"]
    assert round_time_s(egs, _WL, 1, fleet=None) == round_time_s(egs, _WL, 1)
    fleet = DeviceFleet(**FLEET)
    assert round_time_s(egs, _WL, 1, fleet=fleet) > round_time_s(egs, _WL, 1)
    assert fleet.fanin_time_s(egs) == jplace.DeviceFleet(
        **FLEET).fanin_time_s(jcost.C3_TESTBED["egs"])
    for p in assign_institutions(5, _WL, fleet=fleet):
        assert p.round_time_s >= fleet.fanin_time_s(C3_TESTBED[p.resource])


# ----------------------------------------------------------------------
# serving placement

def test_plan_serving_places_replicas_on_tiers():
    scfg, jscfg = ServeConfig(max_seq_len=48, batch_size=2), \
        JaxServeConfig(max_seq_len=48, batch_size=2)
    wl = serving_workload(TINY_SERVE, scfg)
    assert dataclasses.asdict(wl) == dataclasses.asdict(
        jax_serving_workload(JAX_TINY_SERVE, jscfg))
    placements = plan_serving(8, TINY_SERVE, scfg)
    _placements_equal(placements, jax_plan_serving(8, JAX_TINY_SERVE, jscfg))
    assert placements == plan_serving(8, TINY_SERVE, scfg)
    assert all(p.tier in ("cci", "fog", "edge") and p.round_time_s > 0
               for p in placements)
    summary = tier_latency_summary(placements, wl)
    assert sum(t["replicas"] for t in summary.values()) == 8
    assert all(t["compute_s"] > 0 and t["samples_per_s"] > 0
               and t["exchange_s"] > 0 for t in summary.values())


# ----------------------------------------------------------------------
# the CNN federation placed by the cost model

P_FED, ROUNDS = 5, 2


def test_cnn_federation_under_placement_schedule_matches_jax():
    """A P = 5 federation under the cost model's delays with a deadline
    that drops the slowest tier (the fog seat) and keeps a quorum."""
    assert flops_per_image(STIGMA_CNN, 1.0) == \
        jax_flops_per_image(JAX_STIGMA_CNN, 1.0)
    wl = FederationWorkload(flops_per_image(STIGMA_CNN, 1.0), 2000, 5.0)
    jwl = jplace.FederationWorkload(jax_flops_per_image(JAX_STIGMA_CNN, 1.0),
                                    2000, 5.0)
    pl, jpl = assign_institutions(P_FED, wl), \
        jplace.assign_institutions(P_FED, jwl)
    _placements_equal(pl, jpl)
    t = np.asarray([p.round_time_s for p in pl])
    deadline = float(np.sort(np.unique(t - t.min()))[-2])
    sched = PlacementSchedule(pl, deadline_s=deadline)
    want = sched.faults(0, P_FED).participation
    assert 3 <= want.sum() < P_FED
    jf = JaxFederation(jplace.PlacementSchedule(jpl, deadline_s=deadline), 0,
                       n_institutions=P_FED)
    tf = CNNFederation(sched, 0, n_institutions=P_FED, device="cpu",
                       stacked=params_from_jax(jax.device_get(jf.stacked)))
    jm, jtrs = jf.run_rounds(ROUNDS)
    tm, ttrs = tf.run_rounds(ROUNDS)
    for a, b in zip(ttrs, jtrs):
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
        assert a.committed
        assert list(a.survivors) == [int(i) for i in np.flatnonzero(want)]
        assert a.straggler_wait_s > 0
    ledger = [tx.metadata.split('"ledger_root"')[0]
              for tx in tf.overlay.registry.chain
              if tx.kind == "rolling_update"]
    assert ledger == [tx.metadata.split('"ledger_root"')[0]
                      for tx in jf.overlay.registry.chain
                      if tx.kind == "rolling_update"]
    np.testing.assert_allclose(tm["loss"].numpy(), np.asarray(jm["loss"]),
                               rtol=1e-4)
    after = tree_flatten(tf.stacked)[0]
    for a, b in zip(after, jax.tree.leaves(jf.stacked)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4,
                                   rtol=0)
    # the dropped fog seat trained locally but never merged: its rows
    # differ from the survivors' merged model
    dead = int(np.flatnonzero(~want)[0])
    alive = int(np.flatnonzero(want)[0])
    assert not torch.equal(after[0][dead], after[0][alive])
