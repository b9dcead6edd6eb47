"""The port's fault and attack schedules held against the JAX package, and
the CNN federation under them.

Bit-exact: chaos hash words and uniforms, every `RoundFaults` of the
standard scenarios, attacker sets, label-flipped batches, consensus
transcripts, commit bits, survivor lists, the ledger's survivor and
attacker metadata, and the MPC seeds.  `apply_attack` is one f32 multiply
per poisoned value in both packages, so it is held to array_equal as well.

Federation params and losses are held to the tolerances of the fault-free
three-round test (tests/test_torch_federation.py): loss rtol = 1e-4 and
params atol = 1e-4.  The convolutions sum in another order than XLA's, the
float MPC pads cancel to fp32 rounding, and the int domain quantizes at
2^-16.  Inside the port, eager and batched runs are bit-identical.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.chaos import apply_attack as jax_apply_attack
from repro.chaos import attack_scenarios as jax_attack_scenarios
from repro.chaos import compose as jax_compose
from repro.chaos import draw_attackers as jax_draw_attackers
from repro.chaos import rng as jax_rng
from repro.chaos import schedule as jax_schedule
from repro.chaos import standard_scenarios as jax_standard_scenarios
from repro.chaos.harness import CNNFederation as JaxFederation
from repro.core.secure_agg import seed_from_key as jax_seed_from_key
from repro.data import SyntheticGlendaDataset as JaxDataset
from repro_torch import random as prng
from repro_torch.chaos import (
    ByzantineSchedule, Dropout, Partition, Straggler, apply_attack,
    attack_scenarios, compose, draw_attackers, rng, standard_scenarios,
)
from repro_torch.chaos.harness import CNNFederation
from repro_torch.convert import params_from_jax
from repro_torch.core.overlay import DecentralizedOverlay, OverlayConfig
from repro_torch.core.secure_agg import seed_from_key
from repro_torch.data.pipeline import SyntheticGlendaDataset
from repro_torch.pytree import tree_flatten
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

P_FED, ROUNDS = 5, 6


def _faults_equal(a, b):
    np.testing.assert_array_equal(a.participation, b.participation)
    assert a.participation.dtype == b.participation.dtype
    np.testing.assert_array_equal(a.delay_s, b.delay_s)
    assert a.coordinator_crash == b.coordinator_crash


# ----------------------------------------------------------------------
# the counter RNG, the schedules and the attacker draws: bit-exact

@pytest.mark.parametrize("seed", [0, 1, 0xDEADBEEF, 2 ** 32 - 1])
def test_chaos_hash_words_bitexact(seed):
    r = np.arange(40)
    for counters in [(), (7,), (3, r), (0x0D0D, 5, r), (1, 2, 3, r % 7)]:
        np.testing.assert_array_equal(rng.hash_u32(seed, *counters),
                                      jax_rng.hash_u32(seed, *counters))
        np.testing.assert_array_equal(rng.uniform(seed, *counters),
                                      jax_rng.uniform(seed, *counters))


@pytest.mark.parametrize("P", [5, 10])
@pytest.mark.parametrize("scenario", sorted(standard_scenarios(0)))
def test_round_faults_of_standard_scenarios_equal(scenario, P):
    for seed in (0, 3):
        ours = standard_scenarios(seed)[scenario]
        theirs = jax_standard_scenarios(seed)[scenario]
        assert (ours is None) == (theirs is None)
        if ours is None:
            continue
        for rnd in range(8):
            _faults_equal(ours.faults(rnd, P), theirs.faults(rnd, P))


def test_composed_schedules_and_survivors_equal():
    ours = compose(Dropout(0.4, seed=2), Straggler(0.5, deadline_s=0.5,
                                                   seed=2)) | \
        Partition(1, 3, (0,))
    theirs = jax_compose(jax_schedule.Dropout(0.4, seed=2),
                         jax_schedule.Straggler(0.5, deadline_s=0.5,
                                                seed=2)) | \
        jax_schedule.Partition(1, 3, (0,))
    assert len(ours.parts) == len(theirs.parts) == 3
    for rnd in range(8):
        a, b = ours.faults(rnd, 7), theirs.faults(rnd, 7)
        _faults_equal(a, b)
        assert a.survivors() == b.survivors() and a.trivial == b.trivial


def test_attacker_sets_equal():
    for n, frac, seed in ((10, 0.3, 3), (7, 0.5, 0), (5, 0.0, 1),
                          (64, 0.25, 9), (5, 0.3, 2)):
        assert draw_attackers(n, frac, seed) == \
            jax_draw_attackers(n, frac, seed)
    for name, sched in attack_scenarios(4).items():
        theirs = jax_attack_scenarios(4)[name]
        if sched is None:
            assert theirs is None
            continue
        for P in (5, 10):
            assert sched.attacker_set(P) == theirs.attacker_set(P)
            for rnd in range(8):
                np.testing.assert_array_equal(sched.attacker_mask(rnd, P),
                                              theirs.attacker_mask(rnd, P))


def test_byzantine_schedule_validation():
    with pytest.raises(ValueError, match="unknown attack kind"):
        ByzantineSchedule("gradient_surgery")
    with pytest.raises(ValueError, match="out of range"):
        ByzantineSchedule("sign_flip", attackers=(9,)).attacker_set(8)
    with pytest.raises(ValueError, match="start/stop"):
        CNNFederation(None, 0, n_institutions=2, image_size=8, device="cpu",
                      attack_schedule=ByzantineSchedule(
                          "label_flip", attackers=(1,), start=2))

    class Bogus:
        kind = "melt_the_gpus"
    with pytest.raises(ValueError, match="attack kind"):
        DecentralizedOverlay(OverlayConfig(n_institutions=2,
                                           attack_schedule=Bogus()))


@pytest.mark.parametrize("kind", ["sign_flip", "scaled_grad", "label_flip"])
def test_apply_attack_matches_jax(kind):
    rng_ = np.random.default_rng(1)
    tree = {"w": rng_.standard_normal((5, 3, 4)).astype(np.float32),
            "b": [rng_.standard_normal((5, 2)).astype(np.float16)]}
    att = np.array([False, True, False, True, True])
    want = jax_apply_attack(kind, jax.tree.map(jnp.asarray, tree),
                            jnp.asarray(att), 7.3)
    got = apply_attack(kind, params_from_jax(tree), torch.from_numpy(att),
                       np.float32(7.3))
    for a, b in zip(tree_flatten(got)[0], jax.tree.leaves(want)):
        assert a.dtype == params_from_jax(np.asarray(b)).dtype
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    with pytest.raises(ValueError, match="unknown attack"):
        apply_attack("nope", params_from_jax(tree), torch.from_numpy(att),
                     1.0)


def test_label_flipped_batches_byte_identical():
    kw = dict(image_size=16, n_samples=60, n_institutions=5, seed=2,
              label_flip_institutions=(1, 3))
    ours, theirs = SyntheticGlendaDataset(**kw), JaxDataset(**kw)
    assert ours.labels.tobytes() == theirs.labels.tobytes()
    assert ours.images.tobytes() == theirs.images.tobytes()
    for step in range(3):
        for inst in range(5):
            a, b = ours.batch(step, 8, inst), theirs.batch(step, 8, inst)
            assert a[0].tobytes() == b[0].tobytes()
            assert a[1].tobytes() == b[1].tobytes()
    clean = SyntheticGlendaDataset(**{**kw, "label_flip_institutions": ()})
    bad = np.isin(clean.institution, [1, 3])
    np.testing.assert_array_equal(ours.labels[bad], 1 - clean.labels[bad])
    np.testing.assert_array_equal(ours.labels[~bad], clean.labels[~bad])
    with pytest.raises(ValueError, match="out of range"):
        SyntheticGlendaDataset(**{**kw, "label_flip_institutions": (7,)})


# ----------------------------------------------------------------------
# the CNN federation under faults and attacks

FAULT_RUNS = [(name, domain) for name in ("dropout30", "quorum_loss",
                                          "coordinator_crash", "churn")
              for domain in ("float", "int")]
ATTACK_RUNS = [("sign_flip_30", "float"), ("label_flip_30", "float")]


def _schedules(name, attack_module_scenarios, fault_module_scenarios):
    if name in fault_module_scenarios:
        return fault_module_scenarios[name], None
    return None, attack_module_scenarios[name]


def _federations(name, domain):
    jsched, jatt = _schedules(name, jax_attack_scenarios(0),
                              jax_standard_scenarios(0))
    jf = JaxFederation(jsched, 0, n_institutions=P_FED, attack_schedule=jatt)
    if domain == "int":
        jf.overlay.cfg.secure_domain = "int"
    sched, att = _schedules(name, attack_scenarios(0), standard_scenarios(0))
    tf = CNNFederation(sched, 0, n_institutions=P_FED, attack_schedule=att,
                       secure_domain=domain, device="cpu",
                       stacked=params_from_jax(jax.device_get(jf.stacked)))
    return jf, tf


def _ledger_metadata(fed):
    return [tx.metadata.split('"ledger_root"')[0]
            for tx in fed.overlay.registry.chain
            if tx.kind == "rolling_update"]


@pytest.mark.parametrize("name,domain", FAULT_RUNS + ATTACK_RUNS)
def test_federation_under_faults_and_attacks_matches_jax(name, domain):
    jf, tf = _federations(name, domain)
    jm, jtrs = jf.run_rounds(ROUNDS)
    tm, ttrs = tf.run_rounds(ROUNDS)
    for a, b in zip(ttrs, jtrs):
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
    assert [s["n_survivors"] for s in tf.overlay.stats] == \
        [s["n_survivors"] for s in jf.overlay.stats]
    # survivors, leader, commit bits, attackers: the ledger's metadata
    assert _ledger_metadata(tf) == _ledger_metadata(jf)
    regs = [tx.institution for tx in tf.overlay.registry.chain
            if tx.kind == "register"]
    assert regs == [tx.institution for tx in jf.overlay.registry.chain
                    if tx.kind == "register"]
    for rnd in range(ROUNDS):
        np.testing.assert_array_equal(
            seed_from_key(prng.split(tf.round_key(rnd))[1]),
            np.asarray(jax_seed_from_key(jax.random.split(
                jf.round_key(rnd))[1])))
    np.testing.assert_allclose(tm["loss"].numpy(), np.asarray(jm["loss"]),
                               rtol=1e-4)
    for a, b in zip(tree_flatten(tf.stacked)[0], jax.tree.leaves(jf.stacked)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4,
                                   rtol=0)
    assert tf.overlay.registry.verify_log()
    if name == "quorum_loss":
        assert [t.aborted_no_quorum for t in ttrs] == \
            [False, False, True, True, False, False]


class _MergeRecorder:
    """Wraps an overlay's `_merge` and records, for every round, the rows it
    was given, the rows it returned and the commit bit."""

    def __init__(self, overlay):
        self.inner, self.calls = overlay._merge, []
        overlay._merge = self

    def __call__(self, stacked, key, committed, *args):
        out = self.inner(stacked, key, committed, *args)
        self.calls.append((stacked, out[0], committed))
        return out


@pytest.mark.parametrize("name,domain,dp", [
    ("churn", "float", False), ("quorum_loss", "int", False),
    ("dropout30", "float", True), ("sign_flip_30", "float", False),
    ("label_flip_30", "int", False)])
def test_eager_equals_run_rounds_under_faults_and_attacks(name, domain, dp):
    from repro_torch.privacy.accountant import DPConfig
    sched, att = _schedules(name, attack_scenarios(0), standard_scenarios(0))
    kw = dict(n_institutions=P_FED, attack_schedule=att, secure_domain=domain,
              device="cpu", dp=DPConfig(0.5, 1.0) if dp else None)
    eager, batched = CNNFederation(sched, 0, **kw), CNNFederation(sched, 0,
                                                                  **kw)
    recorder = _MergeRecorder(eager.overlay)
    losses = [eager.run_round(r)[0]["loss"] for r in range(ROUNDS)]
    metrics, _ = batched.run_rounds(ROUNDS)
    assert torch.equal(torch.stack(losses), metrics["loss"])
    for a, b in zip(tree_flatten(eager.stacked)[0],
                    tree_flatten(batched.stacked)[0]):
        assert torch.equal(a, b)
    assert eager.chain_digest() == batched.chain_digest()
    assert eager.overlay.stats == batched.overlay.stats
    # a round that did not commit leaves every institution bit-untouched
    aborted = [c for c in recorder.calls if not c[2]]
    assert bool(aborted) == (name in ("churn", "quorum_loss"))
    for before, after, _ in aborted:
        for a, b in zip(tree_flatten(before)[0], tree_flatten(after)[0]):
            assert torch.equal(a, b)
    if dp:
        assert eager.overlay.accountant.steps == \
            batched.overlay.accountant.steps == ROUNDS


def test_dead_rows_pass_through_and_dead_attackers_publish_nothing():
    """A crashed institution's row is neither merged nor poisoned, with DP
    on (its (x - ref) + ref round trip is undone bit for bit)."""
    from repro_torch.chaos import RoundFaults
    from repro_torch.privacy.accountant import DPConfig

    class OneDead:
        def faults(self, round_index, n):
            part = np.ones(n, bool)
            part[2] = False
            return RoundFaults(part, np.zeros(n), False)

    g = torch.Generator().manual_seed(0)
    stacked = {"w": torch.randn((6, 7), generator=g),
               "b": {"c": torch.randn((6, 3, 2), generator=g)}}
    ref = {"w": torch.randn((6, 7), generator=g) * 0.1 + stacked["w"],
           "b": {"c": stacked["b"]["c"] + 0.1}}
    ov = DecentralizedOverlay(OverlayConfig(
        n_institutions=6, merge="mean", fault_schedule=OneDead(),
        dp=DPConfig(clip_norm=1.0, noise_multiplier=0.5),
        attack_schedule=ByzantineSchedule("scaled_grad", attackers=(2, 4),
                                          scale=1e6)))
    merged, tr = ov.merge_phase(stacked, prng.PRNGKey(0), ref=ref)
    assert tr.committed and 2 not in tr.survivors
    for a, b in zip(tree_flatten(merged)[0], tree_flatten(stacked)[0]):
        assert torch.equal(a[2], b[2])
    # attacker 4 survived: the merge moved toward its 1e6-scaled row
    assert float(merged["w"][0].abs().max()) > 1e3
    meta = ov.registry.chain[-1].metadata
    assert '"attackers": [4]' in meta and '"survivors": [0, 1, 3, 4, 5]' in meta
