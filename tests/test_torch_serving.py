"""The port's serve path (engine, verified pull, federated server, LM
federation) held against the JAX package on the CPU.

Tolerances, stated per comparison:
  * exact: token batches, round keys, consensus commits, Merkle roots and
    inclusion proofs of identical chains, the error taxonomy, and the
    port's own determinism and hot-swap identity;
  * bf16 logits: 4 ulps of the largest magnitude (see test_torch_lm.py);
    greedy tokens must equal the JAX engine's wherever the JAX logits'
    top-two margin exceeds twice that bound;
  * 3 federated rounds from the JAX package's params: per-round loss
    within rtol 1e-2 (the loss is a bf16 value, 2^-8 relative spacing) and
    params within atol 2e-3 (gradients are rounded to bf16 in different
    places, times lr = 0.1, over 6 SGD steps).
"""
import dataclasses
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import models as jax_models
from repro.core.merkle import verify_inclusion as jax_verify_inclusion
from repro.core.registry import ModelRegistry as JaxRegistry
from repro.serving import Request as JaxRequest
from repro.serving import ServeConfig as JaxServeConfig
from repro.serving import ServingEngine as JaxEngine
from repro.serving import engine as jax_engine
from repro.serving import federated as jax_federated
from repro.serving.harness import LMFederation as JaxLMFederation
from repro.serving.harness import TINY_SERVE as JAX_TINY_SERVE
from repro_torch import models
from repro_torch.chaos.recovery import CORRUPTION_MODES, corrupt_snapshot
from repro_torch.checkpoint import SnapshotError, list_snapshots
from repro_torch.convert import params_from_jax
from repro_torch.core.merkle import verify_inclusion
from repro_torch.core.registry import ModelRegistry, fingerprint_pytree
from repro_torch.pytree import tree_flatten, tree_map
from repro_torch.serving import (
    FederatedServer, FingerprintMismatchError, LedgerRootMismatchError,
    ModelStore, ModelUnavailableError, NoCommittedModelError, Request,
    ServeConfig, ServingEngine, TamperedLedgerError, pull_from_snapshot,
    pull_latest_model,
)
from repro_torch.serving import federated
from repro_torch.serving.harness import LMFederation, TINY_SERVE
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

SCFG = ServeConfig(max_seq_len=48, batch_size=2)
JAX_SCFG = JaxServeConfig(max_seq_len=48, batch_size=2)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _bf16_atol(want, ulps=4):
    return ulps * 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)


def _jax_params(seed):
    return jax.device_get(jax_models.init_params(JAX_TINY_SERVE,
                                                 jax.random.PRNGKey(seed)))


def _prompts(n):
    return [[3 + (i % 7), 5, 9 + (i % 3)] for i in range(n)]


def _submit(eng, uids, tokens_each=4, req=Request):
    for i in uids:
        eng.submit(req(uid=i, prompt=_prompts(i + 1)[i],
                       max_new_tokens=tokens_each))


def _gen_by_uid(done):
    return {r.uid: r.generated for r in done}


@pytest.fixture(scope="module")
def feds():
    """The same 3-round federation in both packages, the port's started
    from the JAX package's stacked params."""
    jf = JaxLMFederation(JAX_TINY_SERVE, seed=0)
    start = jax.device_get(jf.stacked)
    jm, jtrs = jf.run_rounds(3)
    tf = LMFederation(TINY_SERVE, seed=0, stacked=params_from_jax(start),
                      device="cpu")
    tm, ttrs = tf.run_rounds(3)
    return dict(jax=jf, port=tf, jax_metrics=jm, port_metrics=tm,
                jax_trs=jtrs, port_trs=ttrs)


@pytest.fixture(scope="module")
def store(feds):
    s = ModelStore()
    feds["port"].publish(s)
    return s


# ----------------------------------------------------------------------
# the LM federation against the reference

def test_round_batches_and_keys_byte_identical(feds):
    jf, tf = feds["jax"], feds["port"]
    for rnd in range(4):
        assert (tf._round_batches(rnd).numpy().tobytes()
                == np.asarray(jf._round_batches(rnd)).tobytes())
        np.testing.assert_array_equal(tf.round_key(rnd),
                                      np.asarray(jf.round_key(rnd)))


def test_three_rounds_from_jax_params_match(feds):
    assert [t.committed for t in feds["port_trs"]] == [
        t.committed for t in feds["jax_trs"]]
    np.testing.assert_allclose(_np(feds["port_metrics"]["loss"]),
                               _np(feds["jax_metrics"]["loss"]), rtol=1e-2)
    jleaves = jax.tree.leaves(jax.device_get(feds["jax"].stacked))
    tleaves = tree_flatten(feds["port"].stacked)[0]
    assert len(jleaves) == len(tleaves)
    for a, b in zip(tleaves, jleaves):
        np.testing.assert_allclose(_np(a), _np(b), atol=2e-3)
    tx, jtx = (f.overlay.registry.chain for f in (feds["port"], feds["jax"]))
    assert [(t.kind, t.institution, t.parents == ()) for t in tx] == [
        (t.kind, t.institution, t.parents == ()) for t in jtx]


def test_same_seed_federations_have_identical_chains():
    """The logical clock makes two same-seed runs byte-identical."""
    a, b = (LMFederation(TINY_SERVE, seed=2, device="cpu") for _ in range(2))
    for f in (a, b):
        f.run_rounds(1)
    assert a.chain_digest() == b.chain_digest()
    assert a.params_fingerprint() == b.params_fingerprint()


def test_prefix_roots_and_proofs_equal_jax():
    """Identical chains (the same param bytes registered in the same
    order) give identical roots, prefix roots and inclusion proofs."""
    regs = (ModelRegistry(logical_clock=True),
            JaxRegistry(logical_clock=True))
    rng = np.random.default_rng(0)
    for rnd in range(3):
        trees = [{"w": rng.standard_normal((3, 4)).astype(np.float32),
                  "b": rng.standard_normal(4).astype(np.float32)}
                 for _ in range(3)]
        for reg in regs:
            parents = [reg.register(kind="register", institution=f"h{i}",
                                    params=t, arch_family="tiny",
                                    metadata={"round": rnd}).model_fingerprint
                       for i, t in enumerate(trees)]
            reg.register(kind="rolling_update", institution="overlay",
                         params=trees[0], arch_family="tiny",
                         parents=parents,
                         metadata={"round": rnd,
                                   "ledger_root": reg.merkle_root()})
    ours, theirs = regs
    assert [t.hash() for t in ours.chain] == [t.hash() for t in theirs.chain]
    assert ours.merkle_root() == theirs.merkle_root()
    n = len(ours.chain)
    for m in range(n + 1):
        assert ours.root_at(m) == theirs.root_at(m)
    for i in range(n):
        assert (dataclasses.asdict(ours.inclusion_proof(i))
                == dataclasses.asdict(theirs.inclusion_proof(i)))
        for m in (i + 1, n):
            a = ours.inclusion_proof_at(i, m)
            b = theirs.inclusion_proof_at(i, m)
            assert dataclasses.asdict(a) == dataclasses.asdict(b)
            assert verify_inclusion(ours.chain[i].hash(), a, ours.root_at(m))
            assert jax_verify_inclusion(theirs.chain[i].hash(), b,
                                        theirs.root_at(m))
    with pytest.raises(IndexError):
        ours.inclusion_proof_at(n - 1, n - 1)
    assert ours.clone().merkle_root() == ours.merkle_root()


def test_error_taxonomy_equals_jax():
    names = ["ServingVerificationError", "TamperedLedgerError",
             "LedgerRootMismatchError", "NoCommittedModelError",
             "ModelUnavailableError", "FingerprintMismatchError"]
    for name in names:
        ours, theirs = getattr(federated, name), getattr(jax_federated, name)
        assert [c.__name__ for c in ours.__mro__] == [
            c.__name__ for c in theirs.__mro__]


# ----------------------------------------------------------------------
# verified pull and the tamper battery (the reference's, on the port)

def test_pull_verifies_latest_committed_round(feds, store):
    reg = feds["port"].overlay.registry
    model = pull_latest_model(reg, store, arch_family=TINY_SERVE.name)
    tx = model.tx
    assert tx.kind == "rolling_update" and tx is reg.chain[-1]
    assert model.fingerprint == tx.model_fingerprint \
        == fingerprint_pytree(model.params)
    assert model.parents_verified == len(tx.parents) > 0
    again = pull_latest_model(reg, store, trusted_root=model.ledger_root)
    assert again.fingerprint == model.fingerprint


def test_pull_serves_through_engine(feds, store):
    srv = FederatedServer(TINY_SERVE, feds["port"].overlay.registry, store,
                          SCFG, device="cpu")
    assert srv.engine.params_version == srv.model.version
    _submit(srv.engine, range(3))
    done = srv.engine.run()
    assert len(done) == 3 == srv.engine.submitted
    assert all(r.params_version == srv.model.version for r in done)


def test_tamper_flipped_params_rejected(feds, store):
    reg = feds["port"].overlay.registry
    model = pull_latest_model(reg, store)
    tampered = tree_map(lambda x: x.clone(), model.params)
    tree_flatten(tampered)[0][0].view(-1)[0] += 1e-3
    bad = ModelStore()
    bad._by_fp[model.fingerprint] = tampered
    with pytest.raises(FingerprintMismatchError):
        pull_latest_model(reg, bad)


def test_tamper_truncated_chain_rejected(feds, store):
    reg = feds["port"].overlay.registry
    trusted = reg.merkle_root()
    rolled_back = reg.clone()
    n_parents = len(rolled_back.chain[-1].parents)
    del rolled_back.chain[-(n_parents + 1):]
    rolled_back._rebuild_merkle()
    assert rolled_back.verify_log()           # self-consistent
    with pytest.raises(LedgerRootMismatchError):
        pull_latest_model(rolled_back, store, trusted_root=trusted)


def test_tamper_forged_ledger_root_rejected(feds, store):
    forged = feds["port"].overlay.registry.clone()
    tx = forged.chain[-1]
    meta = json.loads(tx.metadata)
    meta["ledger_root"] = "f" * 64
    forged.chain[-1] = dataclasses.replace(
        tx, metadata=json.dumps(meta, sort_keys=True))
    forged._rebuild_merkle()
    with pytest.raises(TamperedLedgerError):
        pull_latest_model(forged, store)


def test_tamper_mutated_transaction_rejected(feds, store):
    mutated = feds["port"].overlay.registry.clone()
    mid = len(mutated.chain) // 2
    mutated.chain[mid] = dataclasses.replace(mutated.chain[mid],
                                             model_fingerprint="0" * 64)
    mutated._rebuild_merkle()
    with pytest.raises(TamperedLedgerError):
        pull_latest_model(mutated, store)


def test_pull_missing_weights_and_empty_ledger_rejected(feds, store):
    reg = feds["port"].overlay.registry
    with pytest.raises(ModelUnavailableError):
        pull_latest_model(reg, ModelStore())
    with pytest.raises(NoCommittedModelError):
        pull_latest_model(ModelRegistry(logical_clock=True), store)
    with pytest.raises(NoCommittedModelError):
        pull_latest_model(reg, store, arch_family="no-such-arch")


@pytest.mark.parametrize("mode", CORRUPTION_MODES)
def test_tamper_corrupted_snapshot_rejected(feds, tmp_path, mode):
    """A rebooted serving tier refuses each of the four corruptions of its
    snapshot, as the reference's (test_serving_federated.py) does."""
    fed = feds["port"]
    snap_dir = str(tmp_path / mode)
    fed.snapshot(snap_dir)
    (_, path), = list_snapshots(snap_dir)
    corrupt_snapshot(path, mode)
    with pytest.raises(SnapshotError):
        pull_from_snapshot(snap_dir, fed.stacked, cfg=fed.overlay.cfg)


def test_pull_from_verified_snapshot_serves(feds, store, tmp_path):
    """A verified snapshot gives the live pull's model, and a server fed
    from it generates the live server's tokens."""
    fed = feds["port"]
    snap_dir = str(tmp_path / "clean")
    fed.snapshot(snap_dir)
    model = pull_from_snapshot(snap_dir, fed.stacked, cfg=fed.overlay.cfg,
                               arch_family=TINY_SERVE.name)
    want = pull_latest_model(fed.overlay.registry, store)
    assert model.fingerprint == want.fingerprint
    assert model.version == want.version
    assert model.ledger_root == want.ledger_root
    rebooted = ModelStore()
    rebooted.put(model.params)
    tokens = []
    for s in (rebooted, store):
        srv = FederatedServer(TINY_SERVE, fed.overlay.registry, s, SCFG,
                              trusted_root=model.ledger_root, device="cpu")
        _submit(srv.engine, range(4))
        tokens.append(_gen_by_uid(srv.engine.run()))
    assert tokens[0] == tokens[1] and len(tokens[0]) == 4


def test_federated_refresh_hot_swaps_only_on_new_round():
    fed = LMFederation(TINY_SERVE, seed=1, device="cpu")
    fed.run_rounds(1)
    store = ModelStore()
    fed.publish(store)
    srv = FederatedServer(TINY_SERVE, fed.overlay.registry, store, SCFG,
                          device="cpu")
    assert srv.refresh() is None              # nothing newer committed
    v0 = srv.engine.params_version
    fed.run_rounds(1)
    fed.publish(store)
    model = srv.refresh()
    assert model is not None and model.version > v0
    _submit(srv.engine, range(2))
    done = srv.engine.run()
    assert len(done) == 2
    assert all(r.params_version == model.version for r in done)
    assert srv.engine.swap_log[-1]["pause_ticks"] == 0


# ----------------------------------------------------------------------
# the engine against the JAX engine

def test_engine_tokens_match_jax_engine_teacher_forced():
    """The JAX engine's greedy streams, fed to the port's prefill and
    decode step: the port's logits stay within the bf16 bound of the JAX
    package's on the same stream, and the port picks the same token
    wherever the JAX top-two margin is wider than twice that bound.  Then
    the port's own engine reproduces every stream up to its first near
    tie."""
    jp = _jax_params(0)
    tp = params_from_jax(jp)
    jeng = JaxEngine(JAX_TINY_SERVE, jp, JAX_SCFG)
    _submit(jeng, range(4), tokens_each=6, req=JaxRequest)
    jgens = _gen_by_uid(jeng.run())
    teng = ServingEngine(TINY_SERVE, tp, SCFG, device="cpu")
    _submit(teng, range(4), tokens_each=6)
    tgens = _gen_by_uid(teng.run())
    W = SCFG.max_seq_len
    jax_prefill = jax_engine._cached_prefill_fn(JAX_TINY_SERVE, W)
    jax_step = jax_engine._cached_step_fn(JAX_TINY_SERVE)
    compared = 0
    for uid, gen in jgens.items():
        prompt = _prompts(uid + 1)[uid]
        jl, js = jax_prefill(jp, jnp.asarray([prompt], jnp.int32))
        tl, ts, _ = models.prefill(TINY_SERVE, tp,
                                   {"tokens": torch.tensor([prompt])}, W)
        jlog, tlog = [_np(jl[0, -1])], [_np(tl[0, -1])]
        for t, tok in enumerate(gen[:-1]):
            pos = len(prompt) + t
            jd, js = jax_step(jp, js, jnp.asarray([tok], jnp.int32),
                              jnp.asarray([pos], jnp.int32))
            td, ts = models.decode_step(
                TINY_SERVE, tp, ts, torch.tensor([tok], dtype=torch.int32),
                torch.tensor([pos], dtype=torch.int32))
            jlog.append(_np(jd[0]))
            tlog.append(_np(td[0]))
        clear = []
        for tok, a, b in zip(gen, jlog, tlog):
            atol = _bf16_atol(a)
            np.testing.assert_allclose(b, a, atol=atol, rtol=0)
            assert int(a.argmax()) == tok
            top2 = np.sort(a)[-2:]
            clear.append(top2[1] - top2[0] > 2 * atol)
            if clear[-1]:
                assert int(b.argmax()) == tok
        compared += sum(clear)
        n_clear = clear.index(False) if False in clear else len(clear)
        assert tgens[uid][:n_clear] == gen[:n_clear]
    assert compared >= 12


# ----------------------------------------------------------------------
# the port's own engine: batching, determinism, hot-swap identity

def _port_params(seed):
    return params_from_jax(_jax_params(seed))


def test_engine_continuous_batching_is_deterministic():
    p = _port_params(0)
    runs = []
    for _ in range(2):
        eng = ServingEngine(TINY_SERVE, p, SCFG, device="cpu")
        _submit(eng, range(5), tokens_each=4)    # 5 requests, 2 slots
        done = eng.run()
        assert len(done) == 5 == eng.submitted
        assert eng.queue == [] and all(s is None for s in eng.slots)
        assert all(len(r.generated) == 4 for r in done)
        runs.append(_gen_by_uid(done))
    assert runs[0] == runs[1]


def test_engine_temperature_sampling_is_seeded():
    p = _port_params(0)
    scfg = dataclasses.replace(SCFG, temperature=1.0)
    gens = []
    for seed in (0, 0, 1):
        eng = ServingEngine(TINY_SERVE, p, scfg, seed=seed, device="cpu")
        _submit(eng, range(3), tokens_each=8)
        gens.append(_gen_by_uid(eng.run()))
    assert gens[0] == gens[1] != gens[2]


def test_hot_swap_no_drops_and_bit_identity():
    old, new = _port_params(0), _port_params(1)
    eng = ServingEngine(TINY_SERVE, old, SCFG, device="cpu")
    _submit(eng, range(4), tokens_each=6)
    while eng.tick < 3:                       # mid-traffic: slots busy
        eng.step()
    assert any(s is not None for s in eng.slots)
    eng.swap_params(new, version=1)
    _submit(eng, range(4, 7), tokens_each=6)  # admitted post-swap
    done = eng.run()
    assert len(done) == eng.submitted == 7
    (entry,) = eng.swap_log
    assert entry["pause_ticks"] == entry["applied_tick"] - entry["staged_tick"]
    gens = _gen_by_uid(done)
    versions = {r.uid: r.params_version for r in done}
    assert all(versions[i] == 0 for i in range(2))
    assert all(versions[i] == 1 for i in range(2, 7))
    ref_old = ServingEngine(TINY_SERVE, old, SCFG, device="cpu")
    _submit(ref_old, range(2), tokens_each=6)
    old_gens = _gen_by_uid(ref_old.run())
    assert all(gens[i] == old_gens[i] for i in range(2))
    ref_new = ServingEngine(TINY_SERVE, new, SCFG, device="cpu")
    _submit(ref_new, range(2, 7), tokens_each=6)
    new_gens = _gen_by_uid(ref_new.run())
    assert all(gens[i] == new_gens[i] for i in range(2, 7))


def _path_logits(params, prompt, gen, use_prefill):
    """Logits before each token of `gen`, teacher-forced through prefill
    admission or token-wise admission (decode steps from an empty cache)."""
    W = SCFG.max_seq_len
    if use_prefill:
        lg, st, _ = models.prefill(TINY_SERVE, params,
                                   {"tokens": torch.tensor([prompt])}, W)
        out, start, seq = [_np(lg[0, -1])], len(prompt), gen[:-1]
    else:
        st = models.init_decode_state(TINY_SERVE, 1, W)
        out, start, seq = [], 0, prompt + gen[:-1]
    for t, tok in enumerate(seq):
        lg, st = models.decode_step(TINY_SERVE, params, st,
                                    torch.tensor([tok], dtype=torch.int32),
                                    torch.tensor([start + t],
                                                 dtype=torch.int32))
        if start + t >= len(prompt) - 1:
            out.append(_np(lg[0]))
    return out


def test_prefill_and_tokenwise_admission_agree_and_slots_are_hermetic():
    """The two admission paths round bf16 at different places, as in the
    reference: on the prefill engine's streams their logits agree within
    the bf16 bound, and the token-wise engine's streams equal the prefill
    engine's up to the first near tie (top-two margin within twice the
    bound, where either token is a right answer)."""
    p = _port_params(0)
    gens = {}
    for use_prefill in (True, False):
        eng = ServingEngine(TINY_SERVE, p, SCFG, use_prefill=use_prefill,
                            device="cpu")
        _submit(eng, range(5), tokens_each=4)
        done = eng.run()
        assert len(done) == 5
        gens[use_prefill] = _gen_by_uid(done)
    for uid, gen in gens[True].items():
        prompt = _prompts(uid + 1)[uid]
        a = _path_logits(p, prompt, gen, True)
        b = _path_logits(p, prompt, gen, False)
        clear = []
        for x, y in zip(a, b):
            atol = _bf16_atol(x)
            np.testing.assert_allclose(y, x, atol=atol, rtol=0)
            top2 = np.sort(x)[-2:]
            clear.append(top2[1] - top2[0] > 2 * atol)
        n = clear.index(False) if False in clear else len(clear)
        assert gens[False][uid][:n] == gen[:n]
    scfg = ServeConfig(max_seq_len=48, batch_size=1)
    eng = ServingEngine(TINY_SERVE, p, scfg, use_prefill=False, device="cpu")
    _submit(eng, [0], tokens_each=6)          # occupies + dirties slot 0
    eng.submit(Request(uid=1, prompt=[9, 8, 7], max_new_tokens=6))
    reused = _gen_by_uid(eng.run())[1]
    fresh = ServingEngine(TINY_SERVE, p, scfg, use_prefill=False,
                          device="cpu")
    fresh.submit(Request(uid=1, prompt=[9, 8, 7], max_new_tokens=6))
    assert reused == _gen_by_uid(fresh.run())[1]


def test_subtree_merge_matches_jax():
    """LMFederation merges bare param trees (merge_subtree=None); under the
    default "params" subtree mode a state dict merges its params alone,
    as the JAX package's overlay does: equal merged params, the "opt"
    leaf untouched, the same fingerprints registered."""
    from repro.core.overlay import DecentralizedOverlay as JaxOverlay
    from repro.core.overlay import OverlayConfig as JaxOverlayConfig
    from repro_torch.core.overlay import DecentralizedOverlay, OverlayConfig
    g = np.random.default_rng(4)
    state = {"params": {"w": g.standard_normal((2, 3)).astype(np.float32)},
             "opt": g.standard_normal(2).astype(np.float32)}
    ov = DecentralizedOverlay(OverlayConfig(n_institutions=2, local_steps=1,
                                            merge="mean"))
    jov = JaxOverlay(JaxOverlayConfig(n_institutions=2, local_steps=1,
                                      merge="mean"))
    merged, tr = ov.merge_phase(params_from_jax(state),
                                np.zeros(2, np.uint32))
    jmerged, jtr = jov.merge_phase(jax.tree.map(jnp.asarray, state),
                                   jax.random.PRNGKey(0))
    assert tr.committed and jtr.committed
    np.testing.assert_array_equal(merged["params"]["w"].numpy(),
                                  np.asarray(jmerged["params"]["w"]))
    np.testing.assert_array_equal(merged["opt"].numpy(), state["opt"])
    np.testing.assert_array_equal(np.asarray(jmerged["opt"]), state["opt"])
    assert [tx.model_fingerprint for tx in ov.registry.chain] == \
        [tx.model_fingerprint for tx in jov.registry.chain]


def test_entry_points_raise_without_a_card(monkeypatch, feds, store):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LMFederation(TINY_SERVE, seed=0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServingEngine(TINY_SERVE, _port_params(0), SCFG)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        FederatedServer(TINY_SERVE, feds["port"].overlay.registry, store,
                        SCFG)
