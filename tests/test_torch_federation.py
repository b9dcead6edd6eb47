"""The port's federation slice held against the JAX package: data,
consensus, ledger fingerprints and digests exactly; a 3-round same-seed
CNN federation in each secure mode within tolerance.

Tolerances: per-round loss rtol = 1e-4 and params atol = 1e-4.  The
convolutions sum in another order than XLA's, the float MPC pads cancel
to fp32 rounding, and the int domain quantizes at 2^-16, so an update that
lands near a quantization boundary may round one step apart.
"""
import dataclasses
import glob
import hashlib
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax

from repro.chaos.harness import CNNFederation as JaxFederation
from repro.core.consensus import ConsensusGate as JaxGate
from repro.core.overlay import DecentralizedOverlay as JaxOverlay
from repro.core.overlay import OverlayConfig as JaxOverlayConfig
from repro.core.registry import ModelRegistry as JaxRegistry
from repro.core.registry import fingerprint_pytree as jax_fingerprint
from repro.core.secure_agg import seed_from_key as jax_seed_from_key
from repro.data import DirichletPartitioner as JaxPartitioner
from repro.data import SyntheticGlendaDataset as JaxDataset
from repro.privacy.accountant import DPConfig as JaxDP
from repro_torch import random as prng
from repro_torch.chaos.harness import CNNFederation
from repro_torch.convert import params_from_jax
from repro_torch.core.consensus import ConsensusGate
from repro_torch.core.overlay import DecentralizedOverlay, OverlayConfig
from repro_torch.core.registry import ModelRegistry, fingerprint_pytree
from repro_torch.core.secure_agg import seed_from_key
from repro_torch.pytree import tree_flatten
from repro_torch.data.pipeline import DirichletPartitioner, SyntheticGlendaDataset
from repro_torch.privacy.accountant import DPConfig
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

SRC = os.path.join(os.path.dirname(__file__), os.pardir, "src")
MODES = ["float", "int", "dp"]
# every JAX federation here has the same P: the reference compiles its
# param init anew for each P, and one compile is enough
P_FED = 5


def _mode_kwargs(mode, dp_cls):
    return dict(dp=dp_cls(clip_norm=0.5, noise_multiplier=1.0)
                if mode == "dp" else None)


def _jax_federation(mode, **kw):
    fed = JaxFederation(None, 0, **_mode_kwargs(mode, JaxDP), **kw)
    if mode == "int":
        fed.overlay.cfg.secure_domain = "int"
    return fed


def _port_federation(mode, stacked, **kw):
    return CNNFederation(None, 0, **_mode_kwargs(mode, DPConfig),
                         secure_domain="int" if mode == "int" else "float",
                         stacked=params_from_jax(stacked), device="cpu", **kw)


def _leaves(tree):
    return [np.asarray(x) for x in tree_flatten(tree)[0]]


# ----------------------------------------------------------------------
# data, consensus and the ledger: exact

@pytest.mark.parametrize("dirichlet", [None, 0.3])
def test_dataset_batches_byte_identical(dirichlet):
    kw = dict(image_size=16, n_samples=60, n_institutions=3, seed=4)
    ours = SyntheticGlendaDataset(
        **kw, partitioner=None if dirichlet is None else
        DirichletPartitioner(3, alpha=dirichlet, seed=4))
    theirs = JaxDataset(
        **kw, partitioner=None if dirichlet is None else
        JaxPartitioner(3, alpha=dirichlet, seed=4))
    assert ours.images.tobytes() == theirs.images.tobytes()
    assert ours.labels.tobytes() == theirs.labels.tobytes()
    np.testing.assert_array_equal(ours.institution, theirs.institution)
    for step in range(3):
        for inst in range(3):
            a, b = ours.batch(step, 8, inst), theirs.batch(step, 8, inst)
            assert a[0].tobytes() == b[0].tobytes()
            assert a[1].tobytes() == b[1].tobytes()


@pytest.mark.parametrize("dirichlet", [None, 0.3])
def test_federation_round_batches_byte_identical(dirichlet):
    jf = _jax_federation("float", n_institutions=P_FED,
                         dirichlet_alpha=dirichlet)
    tf = _port_federation("float", jax.device_get(jf.stacked),
                          n_institutions=P_FED, dirichlet_alpha=dirichlet)
    for rnd in range(2):
        (ji, jl), (ti, tl) = jf._round_batches(rnd), tf._round_batches(rnd)
        assert ti.numpy().tobytes() == np.asarray(ji).tobytes()
        assert tl.numpy().tobytes() == np.asarray(jl).tobytes()
        np.testing.assert_array_equal(tf.round_key(rnd),
                                      np.asarray(jf.round_key(rnd)))


@dataclasses.dataclass
class _Faults:
    participation: np.ndarray
    delay_s: np.ndarray
    coordinator_crash: bool = False


@pytest.mark.parametrize("P", [2, 5, 10])
def test_consensus_transcripts_identical(P):
    ours, theirs = ConsensusGate(P, seed=3), JaxGate(P, seed=3)
    rng = np.random.default_rng(P)
    for r in range(12):
        faults = None
        if r % 3:
            part = rng.random(P) > 0.3
            part[r % P] = True
            faults = _Faults(part, rng.random(P) * 0.1, bool(r % 4 == 1))
        a, b = ours.next_round(faults), theirs.next_round(faults)
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
    assert ours.total_consensus_time_s == theirs.total_consensus_time_s


def test_fingerprints_of_identical_bytes_equal():
    jf = _jax_federation("float", n_institutions=P_FED)
    stacked = jax.device_get(jf.stacked)
    ours = params_from_jax(stacked)
    assert fingerprint_pytree(ours) == jax_fingerprint(stacked)
    row = jax.tree.map(lambda x: x[1], stacked)
    assert fingerprint_pytree(params_from_jax(row)) == jax_fingerprint(row)


@pytest.mark.parametrize("n", [1, 2, 7, 16, 33])
def test_merkle_roots_and_proofs_identical(n):
    from repro.core.merkle import MerkleLog as JaxLog
    from repro_torch.core.merkle import MerkleLog, verify_inclusion
    ours, theirs = MerkleLog(), JaxLog()
    for i in range(n):
        leaf = hashlib.sha256(str(i).encode()).hexdigest()
        assert ours.append(leaf) == theirs.append(leaf)
    for i in range(n):
        proof, want = ours.proof(i), theirs.proof(i)
        assert (proof.leaf_index, proof.n_leaves, proof.path) == \
            (want.leaf_index, want.n_leaves, want.path)
        leaf = hashlib.sha256(str(i).encode()).hexdigest()
        assert verify_inclusion(leaf, proof, ours.root())


@pytest.mark.parametrize("masked", [False, True])
def test_mean_merge_matches_jax(masked):
    from repro.core.merges import mean_merge as jax_mean_merge
    from repro_torch.core.merges import mean_merge
    rng = np.random.default_rng(7)
    tree = {"w": rng.standard_normal((4, 3, 5)).astype(np.float32),
            "b": [rng.standard_normal((4, 2)).astype(np.float32)]}
    mask = np.array([True, False, True, True]) if masked else None
    want = jax_mean_merge(jax.tree.map(jax.numpy.asarray, tree), True,
                          alpha=0.6, mask=mask)
    got = mean_merge(params_from_jax(tree), True, alpha=0.6,
                     mask=None if mask is None else torch.from_numpy(mask))
    for a, b in zip(_leaves(got), jax.tree.leaves(want)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-6, atol=1e-6)
    rejected = mean_merge(params_from_jax(tree), False, alpha=0.6)
    for a, b in zip(_leaves(rejected), jax.tree.leaves(tree)):
        np.testing.assert_array_equal(a, b)


def test_int_merge_only_chain_digest_identical():
    """Two int-domain merge-only rounds fed the reference's bytes: the same
    merged bytes, fingerprints, Merkle roots and chain digests."""
    P = 4   # the survivor mean divides by 4 exactly in both packages
    jf = _jax_federation("float", n_institutions=P_FED)
    stacked = jax.tree.map(lambda x: x[:P], jax.device_get(jf.stacked))
    cfg = dict(n_institutions=P, merge="secure_mean", secure_domain="int",
               arch_family="cnn", consensus_seed=5)
    theirs = JaxOverlay(JaxOverlayConfig(**cfg, merge_subtree=None),
                        registry=JaxRegistry(logical_clock=True))
    ours = DecentralizedOverlay(OverlayConfig(**cfg),
                                registry=ModelRegistry(logical_clock=True))
    j_state, t_state = stacked, params_from_jax(stacked)
    for rnd in range(2):
        key = jax.random.PRNGKey(100 + rnd)
        j_state, jtr = theirs.merge_phase(j_state, key)
        t_state, ttr = ours.merge_phase(t_state, prng.PRNGKey(100 + rnd))
        assert jtr.committed == ttr.committed
        for a, b in zip(_leaves(t_state), jax.tree.leaves(j_state)):
            np.testing.assert_array_equal(a, np.asarray(b))
    assert [tx.model_fingerprint for tx in ours.registry.chain] == \
        [tx.model_fingerprint for tx in theirs.registry.chain]
    assert ours.registry.merkle_root() == theirs.registry.merkle_root()
    assert ours.registry.chain[-1].hash() == theirs.registry.chain[-1].hash()
    assert ours.registry.verify_log()


# ----------------------------------------------------------------------
# the round engines

@pytest.mark.parametrize("mode", MODES)
def test_eager_equals_run_rounds_bitidentical(mode):
    stacked = jax.device_get(_jax_federation(
        "float", n_institutions=P_FED).stacked)
    eager = _port_federation(mode, stacked, n_institutions=P_FED)
    batched = _port_federation(mode, stacked, n_institutions=P_FED)
    losses = [eager.run_round(r)[0]["loss"] for r in range(3)]
    metrics, _ = batched.run_rounds(3)
    assert torch.equal(torch.stack(losses), metrics["loss"])
    for a, b in zip(_leaves(eager.stacked), _leaves(batched.stacked)):
        np.testing.assert_array_equal(a, b)
    assert eager.chain_digest() == batched.chain_digest()
    assert eager.overlay.stats == batched.overlay.stats


@pytest.mark.parametrize("mode", MODES)
def test_three_round_federation_matches_jax(mode):
    jf = _jax_federation(mode, n_institutions=P_FED)
    tf = _port_federation(mode, jax.device_get(jf.stacked),
                          n_institutions=P_FED)
    jm, jtrs = jf.run_rounds(3)
    tm, ttrs = tf.run_rounds(3)
    for rnd in range(3):
        k2 = prng.split(tf.round_key(rnd))[1]
        jk2 = jax.random.split(jf.round_key(rnd))[1]
        np.testing.assert_array_equal(seed_from_key(k2),
                                      np.asarray(jax_seed_from_key(jk2)))
    assert [t.committed for t in ttrs] == [t.committed for t in jtrs]
    assert tm["loss"].shape == (3, P_FED)
    np.testing.assert_allclose(tm["loss"].numpy(), np.asarray(jm["loss"]),
                               rtol=1e-4)
    for a, b in zip(_leaves(tf.stacked), jax.tree.leaves(jf.stacked)):
        np.testing.assert_allclose(a, np.asarray(b), atol=1e-4, rtol=0)
    assert tf.overlay.registry.verify_log()
    ours = [tx.metadata for tx in tf.overlay.registry.chain
            if tx.kind == "rolling_update"]
    theirs = [tx.metadata for tx in jf.overlay.registry.chain
              if tx.kind == "rolling_update"]
    strip = [(m.split('"ledger_root"')[0]) for m in ours]
    assert strip == [m.split('"ledger_root"')[0] for m in theirs]


# ----------------------------------------------------------------------
# package boundaries and the device contract

def test_port_imports_neither_jax_nor_the_jax_package():
    """Every module of the port, chip_smoke.py and the torch examples
    import without jax."""
    root = os.path.abspath(os.path.join(SRC, os.pardir))
    scripts = [os.path.join(root, "chip_smoke.py")] + sorted(
        glob.glob(os.path.join(root, "examples", "torch_*.py")))
    assert len(scripts) == 7, scripts
    code = (
        "import importlib, importlib.util, pkgutil, sys\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        f"for i, path in enumerate({scripts!r}):\n"
        "    spec = importlib.util.spec_from_file_location(f'script{i}', path)\n"
        "    spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "bad = sorted(k for k in sys.modules\n"
        "             if k.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n"
        "new = {'repro_torch.checkpoint.store', 'repro_torch.checkpoint"
        ".snapshot', 'repro_torch.chaos.recovery', 'repro_torch.core"
        ".device_tier', 'repro_torch.continuum.placement', 'repro_torch"
        ".continuum.costmodel', 'repro_torch.optim.adamw', 'repro_torch"
        ".optim.schedules', 'repro_torch.training.train', 'repro_torch"
        ".core.scheduler', 'repro_torch.launch.train', 'repro_torch.launch"
        ".ehr_train', 'repro_torch.core.gossip', 'repro_torch.launch"
        ".analysis', 'repro_torch.launch.op_cost', 'repro_torch.launch"
        ".dryrun'}\n"
        "assert new <= set(sys.modules), new - set(sys.modules)\n"
        "print(len([k for k in sys.modules if k.startswith('repro_torch')]))\n")
    env = dict(os.environ, PYTHONPATH=os.path.abspath(SRC))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 20


def test_default_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        CNNFederation(None, 0, n_institutions=2, image_size=8)


def test_unported_knobs_raise():
    """Meshes are not ported (fault and attack schedules are:
    tests/test_torch_chaos.py)."""
    with pytest.raises(NotImplementedError):
        CNNFederation(None, 0, n_institutions=2, device="cpu",
                      mesh=object())
    ov = DecentralizedOverlay(OverlayConfig(n_institutions=2))
    stacked = {"w": torch.zeros((2, 3))}
    with pytest.raises(NotImplementedError):
        ov.run_rounds(stacked, (torch.zeros((1, 10, 2, 1)),), None,
                      prng.PRNGKey(0), 1, mesh=object())
