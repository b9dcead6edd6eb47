"""The port's crash recovery (verified checkpoints, federation snapshots,
kill / failover / replay) held against the JAX package on the CPU.

Exact throughout: checkpoints and snapshots cross between the packages in
both directions with equal manifests; on the int-domain merge-only chain
(whose merged bytes are the reference's, bit for bit) the ledger's
serialization, lineage and model query, the federation.json bytes and the
snapshot fingerprints equal the reference's; a recovered run's chain
digest and params fingerprint equal its uninterrupted run's bit for bit;
the recovery reports' structure (the round restored, the rounds replayed,
the snapshots refused) equals the reference's for the same schedule.
"""
import dataclasses
import json
import os
import tempfile

import numpy as np
import pytest
import torch

import jax

from repro import checkpoint as jax_ckpt
from repro import models as jax_models
from repro.chaos import ByzantineSchedule as JaxByzantine
from repro.chaos import CoordinatorCrash as JaxCrash
from repro.chaos import Dropout as JaxDropout
from repro.chaos import compose as jax_compose
from repro.chaos import corrupt_snapshot as jax_corrupt
from repro.chaos import simulate_crash_run as jax_simulate
from repro.chaos.harness import CNNFederation as JaxFederation
from repro.configs import ARCHS as JAX_ARCHS
from repro.configs import reduced as jax_reduced
from repro.core.overlay import DecentralizedOverlay as JaxOverlay
from repro.core.overlay import OverlayConfig as JaxOverlayConfig
from repro.core.registry import ModelRegistry as JaxRegistry
from repro.privacy.accountant import DPConfig as JaxDP
from repro_torch import random as prng
from repro_torch.chaos import (
    ByzantineSchedule, CORRUPTION_MODES, CoordinatorCrash, Dropout, compose,
    corrupt_snapshot, fatal_crash_rounds, golden_run, simulate_crash_run,
)
from repro_torch.chaos.harness import CNNFederation
from repro_torch.checkpoint import (
    CheckpointError, SnapshotError, latest_verified_snapshot,
    list_snapshots, load_checkpoint, load_snapshot, overlay_cfg_summary,
    save_checkpoint, save_snapshot, snapshot_path,
)
from repro_torch.convert import params_from_jax
from repro_torch.core.merkle import MerkleLog, verify_inclusion
from repro_torch.core.overlay import DecentralizedOverlay, OverlayConfig
from repro_torch.core.registry import ModelRegistry, fingerprint_pytree
from repro_torch.privacy.accountant import DPConfig
from repro_torch.pytree import tree_flatten
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

MODES = ["float", "int", "dp"]
SCHED = compose(Dropout(rate=0.3, seed=5),
                CoordinatorCrash(rounds=(3,), fatal=True))
JAX_SCHED = jax_compose(JaxDropout(rate=0.3, seed=5),
                        JaxCrash(rounds=(3,), fatal=True))
# the reference's recovery tests' federation (tests/test_snapshot_recovery)
MK = dict(seed=3, n_institutions=4, local_steps=2, batch=4, image_size=8,
          width_scale=0.25)


def _mk(schedule=SCHED, mode="float", **kw):
    if mode == "dp":
        kw["dp"] = DPConfig(clip_norm=0.5, noise_multiplier=1.0)
    return CNNFederation(schedule, **{**MK, **kw}, device="cpu",
                         secure_domain="int" if mode == "int" else "float")


def _state(fed):
    return fed.chain_digest(), fed.params_fingerprint()


def _leaves(tree):
    return [np.asarray(x) for x in tree_flatten(tree)[0]]


def _manifest(path):
    with open(os.path.join(path, "manifest.json")) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def jax_cnn():
    """The reference federation's stacked (P = 4, 8x8, width 0.25) CNN
    params, on the host."""
    return jax.device_get(JaxFederation(JAX_SCHED, **MK).stacked)


# ----------------------------------------------------------------------
# (a) checkpoints cross between the packages

def _trees(jax_cnn):
    cfg = jax_reduced(JAX_ARCHS["qwen3-0.6b"])
    qwen = jax.device_get(jax_models.init_params(cfg,
                                                 jax.random.PRNGKey(0)))
    ints = {"w": np.arange(6, dtype=np.float32).reshape(2, 3),
            "opt": {"step": np.array(7, np.int32),
                    "count": np.arange(4, dtype=np.uint32) * 977}}
    return {"cnn": jax_cnn, "qwen3": qwen, "ints": ints}


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_checkpoints_cross_between_packages(jax_cnn, writer, tmp_path):
    """The same bytes saved by each package: equal manifests, field for
    field and in order; the other package restores them verified."""
    for name, tree in _trees(jax_cnn).items():
        ours, theirs = str(tmp_path / name / "port"), \
            str(tmp_path / name / "jax")
        fp = save_checkpoint(ours, params_from_jax(tree), step=3,
                             metadata={"arch": name})
        assert fp == jax_ckpt.save_checkpoint(theirs, tree, step=3,
                                              metadata={"arch": name})
        mine, ref = _manifest(ours), _manifest(theirs)
        assert list(mine) == list(ref)
        for field in ref:
            assert mine[field] == ref[field], (name, field)
        assert list(mine["leaves"]) == list(ref["leaves"])
        if writer == "port":
            restored, manifest = jax_ckpt.load_checkpoint(ours, tree)
            got = jax.tree.leaves(restored)
        else:
            restored, manifest = load_checkpoint(theirs,
                                                 params_from_jax(tree))
            got = _leaves(restored)
            assert all(isinstance(x, torch.Tensor)
                       for x in tree_flatten(restored)[0])
        assert manifest["fingerprint"] == fp
        for a, b in zip(got, jax.tree.leaves(tree)):
            assert np.asarray(a).dtype == np.asarray(b).dtype
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


# ----------------------------------------------------------------------
# (b) the reference's refusals, each naming the leaf

def _refusal_case(kind, d):
    """(restore target, expected error, match) after damaging `d`."""
    if kind == "shape":
        save_checkpoint(d, {"w": torch.zeros((4, 4))})
        return {"w": torch.zeros((2, 8))}, CheckpointError, \
            "shape mismatch at w"
    if kind == "payload":
        params = {"w": torch.arange(16.0).reshape(4, 4)}
        save_checkpoint(d, params)
        arr = params["w"].numpy().copy()
        arr[0, 0] += 1.0
        np.savez(os.path.join(d, "arrays.npz"), w=arr)
        return params, CheckpointError, "fingerprint mismatch"
    if kind == "torn":
        params = {"w": torch.zeros((64, 64))}
        save_checkpoint(d, params)
        npz = os.path.join(d, "arrays.npz")
        with open(npz, "rb") as f:
            blob = f.read()
        with open(npz, "wb") as f:
            f.write(blob[:len(blob) // 2])
        return params, Exception, None
    if kind == "target_dtype":
        save_checkpoint(d, {"layer": {"w": torch.zeros((3, 3))}})
        return {"layer": {"w": torch.zeros((3, 3), dtype=torch.float64)}}, \
            CheckpointError, r"dtype mismatch at layer/w"
    if kind == "manifest_dtype":
        params = {"w": torch.zeros((4,))}
        save_checkpoint(d, params)
        np.savez(os.path.join(d, "arrays.npz"),
                 w=np.zeros((4,), np.float16))
        return params, CheckpointError, "payload float16"
    assert kind == "missing"
    save_checkpoint(d, {"enc": {"w": torch.zeros((2, 2))}})
    return {"enc": {"w": torch.zeros((2, 2)), "b": torch.zeros((2,))}}, \
        CheckpointError, r"enc/b"


@pytest.mark.parametrize("kind", ["shape", "payload", "torn", "target_dtype",
                                  "manifest_dtype", "missing"])
def test_checkpoint_refusals(kind, tmp_path):
    target, err, match = _refusal_case(kind, str(tmp_path))
    with pytest.raises(err, match=match):
        load_checkpoint(str(tmp_path), target)


def test_checkpoint_stacked_roundtrip_on_the_like_device():
    """A stacked (P, ...) tree with int leaves round-trips bit-exactly, as
    tensors on the devices of the restore target's leaves."""
    P = 4
    g = torch.Generator().manual_seed(0)
    stacked = {"params": {"w": torch.randn((P, 2, 3), generator=g)},
               "opt": {"mu": torch.zeros((P, 2, 3)),
                       "step": torch.zeros((P,), dtype=torch.int32)}}
    with tempfile.TemporaryDirectory() as d:
        fp = save_checkpoint(d, stacked, step=7)
        assert fp == fingerprint_pytree(stacked)
        restored, manifest = load_checkpoint(d, stacked)
        assert manifest["fingerprint"] == fp and manifest["step"] == 7
    for a, b in zip(tree_flatten(restored)[0], tree_flatten(stacked)[0]):
        assert a.device == b.device and a.dtype == b.dtype
        assert torch.equal(a, b)


# ----------------------------------------------------------------------
# (c), (e) the ledger and snapshots on the int merge-only P = 4 chain

@pytest.fixture(scope="module")
def int_chain(jax_cnn):
    """Two int-domain merge-only rounds in both packages from the same
    bytes (test_torch_federation.py::test_int_merge_only_chain_digest_
    identical): the merged bytes and the chains are equal."""
    cfg = dict(n_institutions=4, merge="secure_mean", secure_domain="int",
               arch_family="cnn", consensus_seed=5, merge_subtree=None)
    theirs = JaxOverlay(JaxOverlayConfig(**cfg),
                        registry=JaxRegistry(logical_clock=True))
    ours = DecentralizedOverlay(OverlayConfig(**cfg),
                                registry=ModelRegistry(logical_clock=True))
    j_state, t_state = jax_cnn, params_from_jax(jax_cnn)
    for rnd in range(2):
        j_state, _ = theirs.merge_phase(j_state, jax.random.PRNGKey(100 + rnd))
        t_state, _ = ours.merge_phase(t_state, prng.PRNGKey(100 + rnd))
    j_state = jax.device_get(j_state)
    assert ours.registry.chain[-1].hash() == theirs.registry.chain[-1].hash()
    return dict(jax=theirs, port=ours, jax_state=j_state, port_state=t_state)


def test_registry_serialization_and_queries_equal_jax(int_chain):
    ours, theirs = int_chain["port"].registry, int_chain["jax"].registry
    assert ours.to_dict() == theirs.to_dict()
    assert json.dumps(ours.to_dict(), sort_keys=True) == \
        json.dumps(theirs.to_dict(), sort_keys=True)
    back = ModelRegistry.from_dict(json.loads(json.dumps(ours.to_dict())))
    assert [t.hash() for t in back.chain] == [t.hash() for t in ours.chain]
    assert back.merkle_root() == ours.merkle_root() and back.verify_log()
    head = ours.chain[-1].model_fingerprint
    assert ours.lineage(head) == theirs.lineage(head)
    assert len(ours.lineage(head)) > 1
    for family, exclude in (("cnn", None), ("cnn", "overlay"),
                            ("cnn", "hospital-1"), ("lm", None)):
        assert [dataclasses.asdict(t) for t in
                ours.suitable_models(family, exclude)] == \
            [dataclasses.asdict(t) for t in
             theirs.suitable_models(family, exclude)]
    # a tampered image rebuilds a ledger that fails its audit, in both
    tampered = json.loads(json.dumps(ours.to_dict()))
    row = tampered["chain"][len(tampered["chain"]) // 2]
    row["metadata"] = row["metadata"].replace("0", "1", 1)
    assert not ModelRegistry.from_dict(tampered).verify_log()
    assert not JaxRegistry.from_dict(tampered).verify_log()


def test_snapshots_byte_equal_and_cross_load(int_chain, tmp_path):
    ours, theirs = int_chain["port"], int_chain["jax"]
    mine = str(tmp_path / "port" / "round_000002")
    ref = str(tmp_path / "jax" / "round_000002")
    fp = save_snapshot(mine, int_chain["port_state"], ours,
                       metadata={"note": "x"})
    assert fp == jax_ckpt.save_snapshot(ref, int_chain["jax_state"], theirs,
                                        metadata={"note": "x"})
    for name in ("federation.json", "COMMIT"):
        with open(os.path.join(mine, name), "rb") as a, \
                open(os.path.join(ref, name), "rb") as b:
            assert a.read() == b.read(), name
    assert _manifest(mine) == _manifest(ref)
    # each package restores the other's snapshot, verified
    stacked, state = load_snapshot(ref, int_chain["port_state"],
                                   cfg=ours.cfg)
    assert state.round_index == 2
    assert state.ledger_root == ours.registry.merkle_root()
    for a, b in zip(_leaves(stacked), _leaves(int_chain["port_state"])):
        np.testing.assert_array_equal(a, b)
    j_stacked, j_state = jax_ckpt.load_snapshot(
        mine, int_chain["jax_state"], cfg=theirs.cfg)
    assert j_state.ledger_root == state.ledger_root
    assert j_state.stats == state.stats
    for a, b in zip(jax.tree.leaves(j_stacked),
                    jax.tree.leaves(int_chain["jax_state"])):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


# ----------------------------------------------------------------------
# (d) the config summary

def _summary_cases():
    crash = dict(schedule=(SCHED, JAX_SCHED))
    attack = dict(attack=(ByzantineSchedule(kind="sign_flip",
                                            attackers=(1,), seed=4),
                          JaxByzantine(kind="sign_flip", attackers=(1,),
                                       seed=4)))
    dp = dict(dp=(DPConfig(clip_norm=1.0, noise_multiplier=0.8,
                           delta=1e-5, seed=11),
                  JaxDP(clip_norm=1.0, noise_multiplier=0.8, delta=1e-5,
                        seed=11)))
    return {"crash": crash, "attack": attack, "dp": dp,
            "all": {**crash, **attack, **dp}}


@pytest.mark.parametrize("case", ["crash", "attack", "dp", "all"])
def test_cfg_summary_equals_jax(case):
    knobs = _summary_cases()[case]

    def cfg(cls, side):
        pick = {k: v[side] for k, v in knobs.items()}
        return cls(n_institutions=6, local_steps=3, merge="trimmed_mean",
                   consensus_seed=9, fault_schedule=pick.get("schedule"),
                   attack_schedule=pick.get("attack"), dp=pick.get("dp"),
                   merge_subtree=None)
    ours = overlay_cfg_summary(cfg(OverlayConfig, 0))
    theirs = jax_ckpt.overlay_cfg_summary(cfg(JaxOverlayConfig, 1))
    assert ours == theirs
    assert json.dumps(ours, sort_keys=True) == \
        json.dumps(theirs, sort_keys=True)


def test_cfg_summary_leaves_out_what_the_reference_leaves_out():
    """Copied as the reference has it: the secure domain is not in the
    summary, so an int-domain snapshot restores into a float overlay."""
    a = OverlayConfig(n_institutions=4, secure_domain="int")
    b = OverlayConfig(n_institutions=4, secure_domain="float")
    assert overlay_cfg_summary(a) == overlay_cfg_summary(b)
    assert "secure_domain" not in overlay_cfg_summary(a)


# ----------------------------------------------------------------------
# (f) the reference's recovery cases, in the port

def test_snapshot_roundtrip_restores_everything():
    fed = _mk()
    fed.run_rounds(3)
    with tempfile.TemporaryDirectory() as d:
        path = fed.snapshot(d)
        assert path == snapshot_path(d, 3)
        assert os.path.exists(os.path.join(path, "COMMIT"))
        stacked, state = load_snapshot(path, fed.stacked,
                                       cfg=fed.overlay.cfg)
    assert state.round_index == 3
    assert state.ledger_root == fed.overlay.registry.merkle_root()
    assert state.params_fingerprint == fingerprint_pytree(fed.stacked)
    assert [t.hash() for t in state.registry.chain] == \
        [t.hash() for t in fed.overlay.registry.chain]
    assert state.stats == fed.overlay.stats
    for a, b in zip(tree_flatten(stacked)[0], tree_flatten(fed.stacked)[0]):
        assert torch.equal(a, b)


def test_restore_requires_fresh_overlay():
    fed = _mk()
    fed.run_rounds(2)
    with tempfile.TemporaryDirectory() as d:
        fed.snapshot(d)
        with pytest.raises(ValueError, match="fresh overlay"):
            fed.resume_from(d)


def test_snapshot_every_requires_dir_and_advances_nothing():
    fed = _mk()
    for kw, match in ((dict(snapshot_every=1), "snapshot_dir"),
                      (dict(snapshot_every=0, snapshot_dir="x"),
                       "positive")):
        with pytest.raises(ValueError, match=match):
            fed.run_rounds(2, **kw)
    assert fed.overlay.round_index == 0 and not fed.overlay.gate.history


def test_cfg_mismatch_refused():
    fed = _mk()
    fed.run_rounds(2)
    with tempfile.TemporaryDirectory() as d:
        path = fed.snapshot(d)
        other = _mk(schedule=None)
        with pytest.raises(SnapshotError, match="different federation"):
            load_snapshot(path, other.stacked, cfg=other.overlay.cfg)


def test_chunked_snapshotting_is_bit_identical_to_single_run():
    plain = _mk()
    plain.run_rounds(6)
    with tempfile.TemporaryDirectory() as d:
        chunked = _mk()
        metrics, trs = chunked.run_rounds(6, snapshot_every=2,
                                          snapshot_dir=d)
        assert [r for r, _ in list_snapshots(d)] == [2, 4, 6]
    assert _state(chunked) == _state(plain)
    assert len(trs) == 6 and metrics["loss"].shape[0] == 6


@pytest.fixture(scope="module")
def goldens():
    return {mode: golden_run(lambda m=mode: _mk(mode=m), 6)
            for mode in MODES}


@pytest.mark.parametrize("crash_round", [1, 3, 5])
@pytest.mark.parametrize("mode", MODES)
def test_resume_bit_identical(goldens, mode, crash_round):
    with tempfile.TemporaryDirectory() as d:
        rep = simulate_crash_run(lambda: _mk(mode=mode), 6, crash_round, d,
                                 snapshot_every=2)
    assert (rep.chain_digest, rep.params_fingerprint) == goldens[mode]
    assert rep.restored_round == (crash_round // 2) * 2
    assert rep.rounds_replayed == crash_round - rep.restored_round


def test_eager_resume_bit_identical():
    golden = _mk()
    for r in range(5):
        golden.run_round(r)
    with tempfile.TemporaryDirectory() as d:
        doomed = _mk()
        for r in range(3):
            doomed.run_round(r)
            if (r + 1) % 2 == 0:
                doomed.snapshot(d)
        del doomed
        fed = _mk()
        restored, skipped = fed.resume_from(d)
    assert restored == 2 and not skipped
    for r in range(restored, 5):
        fed.run_round(r)
    assert _state(fed) == _state(golden)


def test_resumed_dp_attack_schedules_stay_in_lockstep():
    def mk():
        return _mk(schedule=Dropout(rate=0.25, seed=9), merge="trimmed_mean",
                   dp=DPConfig(clip_norm=1.0, noise_multiplier=0.8,
                               delta=1e-5, seed=11),
                   attack_schedule=ByzantineSchedule(
                       kind="sign_flip", attackers=(1,), seed=4))
    golden = golden_run(mk, 5)
    with tempfile.TemporaryDirectory() as d:
        rep = simulate_crash_run(mk, 5, 3, d, snapshot_every=2)
    assert (rep.chain_digest, rep.params_fingerprint) == golden
    a = mk()
    a.run_rounds(5)
    with tempfile.TemporaryDirectory() as d:
        mk().run_rounds(3, snapshot_every=3, snapshot_dir=d)
        c = mk()
        c.resume_from(d)
    assert c.overlay.accountant.steps == 3
    c.run_rounds(2)

    def rows(fed):
        return [json.loads(t.metadata) for t in fed.overlay.registry.chain
                if t.kind == "rolling_update"]
    assert [m["dp"] for m in rows(a)] == [m["dp"] for m in rows(c)]
    assert [m.get("attackers") for m in rows(a)] == \
        [m.get("attackers") for m in rows(c)]


@pytest.mark.parametrize("mode", CORRUPTION_MODES)
def test_each_corruption_mode_detected(mode):
    fed = _mk()
    fed.run_rounds(2)
    with tempfile.TemporaryDirectory() as d:
        path = fed.snapshot(d)
        corrupt_snapshot(path, mode)
        fresh = _mk()
        with pytest.raises(SnapshotError):
            load_snapshot(path, fresh.stacked, cfg=fresh.overlay.cfg)
    with pytest.raises(ValueError, match="unknown corruption mode"):
        corrupt_snapshot(path, "nope")


@pytest.mark.parametrize("mode", CORRUPTION_MODES)
def test_fallback_skips_corrupt_newest(goldens, mode):
    with tempfile.TemporaryDirectory() as d:
        def sabotage(sd):
            corrupt_snapshot(list_snapshots(sd)[-1][1], mode)
        rep = simulate_crash_run(_mk, 6, 5, d, snapshot_every=2,
                                 corrupt=sabotage)
    assert rep.restored_round == 2
    assert [os.path.basename(p) for p in rep.snapshots_skipped] == \
        ["round_000004"]
    assert (rep.chain_digest, rep.params_fingerprint) == goldens["float"]


def test_all_corrupt_restarts_from_zero(goldens):
    with tempfile.TemporaryDirectory() as d:
        def nuke(sd):
            modes = ["torn_arrays", "flip_state", "drop_commit"]
            for i, (_, p) in enumerate(list_snapshots(sd)):
                corrupt_snapshot(p, modes[i % len(modes)])
        rep = simulate_crash_run(_mk, 6, 5, d, snapshot_every=2,
                                 corrupt=nuke)
    assert rep.restored_round == 0 and len(rep.snapshots_skipped) == 2
    assert (rep.chain_digest, rep.params_fingerprint) == goldens["float"]


def test_latest_verified_raises_when_none_verify():
    fed = _mk()
    fed.run_rounds(2)
    with tempfile.TemporaryDirectory() as d:
        corrupt_snapshot(fed.snapshot(d), "drop_commit")
        fresh = _mk()
        with pytest.raises(SnapshotError, match="no verified snapshot"):
            latest_verified_snapshot(d, fresh.stacked,
                                     cfg=fresh.overlay.cfg)


def test_recovered_ledger_roots_accept_proofs():
    with tempfile.TemporaryDirectory() as d:
        fed = _mk()
        fed.run_rounds(4, snapshot_every=2, snapshot_dir=d)
        del fed
        fed = _mk()
        fed.resume_from(d)
    fed.run_rounds(2)
    reg = fed.overlay.registry
    assert fed.overlay.round_index == 6 and reg.verify_log()
    for tx in reg.chain:
        if tx.kind != "rolling_update":
            continue
        root = json.loads(tx.metadata)["ledger_root"]
        prefix = MerkleLog()
        for prev in reg.chain[:tx.index]:
            prefix.append(prev.hash())
        assert prefix.root() == root
        assert verify_inclusion(reg.chain[tx.index - 1].hash(),
                                prefix.proof(tx.index - 1), root)


def test_fatal_crash_rounds_reads_composed_schedule():
    sched = compose(Dropout(rate=0.1, seed=0),
                    CoordinatorCrash(rounds=(2, 5), fatal=True),
                    CoordinatorCrash(rounds=(4,)))      # not fatal
    assert fatal_crash_rounds(sched, 8) == [2, 5]
    assert fatal_crash_rounds(Dropout(rate=0.5), 8) == []
    assert fatal_crash_rounds(None, 8) == []
    assert fatal_crash_rounds(SCHED, 6) == [3]


# ----------------------------------------------------------------------
# (g) the recovery report's structure equals the reference's

def test_recovery_report_structure_equals_jax():
    """Crash at round 5 with snapshots every 2 rounds and the newest
    (round 4) corrupted: both packages restore round 2, replay 3 rounds
    and refuse the same snapshot."""
    def sabotage(corrupt):
        return lambda sd: corrupt(
            os.path.join(sd, sorted(os.listdir(sd))[-1]), "flip_arrays")
    with tempfile.TemporaryDirectory() as d:
        theirs = jax_simulate(lambda: JaxFederation(JAX_SCHED, **MK), 6, 5,
                              d, snapshot_every=2,
                              corrupt=sabotage(jax_corrupt))
    with tempfile.TemporaryDirectory() as d:
        ours = simulate_crash_run(_mk, 6, 5, d, snapshot_every=2,
                                  corrupt=sabotage(corrupt_snapshot))

    def shape(rep):
        return (rep.total_rounds, rep.snapshot_every, rep.crash_round,
                rep.restored_round, rep.rounds_replayed,
                [os.path.basename(p) for p in rep.snapshots_skipped])
    assert shape(ours) == shape(theirs) == \
        (6, 2, 5, 2, 3, ["round_000004"])
