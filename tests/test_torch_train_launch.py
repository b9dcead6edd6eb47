"""The port's training launchers held against the JAX package on the CPU:
an overlay training round (reduced smollm-360m, P = 4, secure_mean in the
float and the int domain) and `launch.train.main`'s centralized and
overlay runs against the reference launcher's; then the EHR driver.

Both sides start from the JAX package's initial params (seed 0), carried
across with `params_from_jax` in place of the port launcher's own draw
(`launch.train.initial_params`).  Tolerances, stated per comparison:
  * exact: commit flags, survivor sets, the ledger's length, step counts;
  * the overlay round with both packages' ``COMPUTE_DTYPE`` set to
    float32, after 2 rounds of 2 local steps: params within atol 3e-5
    (the int domain rounds each update to its fixed-point grid, and a
    value on a grid boundary can round either way), AdamW's m within
    atol 1e-6 and v within 2% of each leaf's largest v; the merged params
    of the 4 institutions within 1e-6 of each other, their moments not
    merged (each institution's own);
  * the launchers' losses (bf16 compute): rtol 1e-3.
"""
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import repro.models.layers as jax_layers
from repro import models as jax_models
from repro.configs import ARCHS as JAX_ARCHS
from repro.configs import reduced as jax_reduced
from repro.core import DecentralizedOverlay as JaxOverlay
from repro.core import OverlayConfig as JaxOverlayConfig
from repro.core import replicate_params as jax_replicate
from repro.data import DataConfig as JaxDataConfig
from repro.data import SyntheticTokenDataset as JaxDataset
from repro.data import institution_batches as jax_institution_batches
from repro.launch import train as jax_launch
from repro.optim import AdamWConfig as JaxAdamWConfig
from repro.optim import adamw_init as jax_adamw_init
from repro.training import TrainConfig as JaxTrainConfig
from repro.training import make_local_step as jax_make_local_step
from repro_torch.checkpoint import load_checkpoint
from repro_torch.configs import ARCHS, reduced
from repro_torch.convert import params_from_jax
from repro_torch.data import DataConfig
from repro_torch.launch import ehr_train
from repro_torch.launch import train as launch
from repro_torch.models import layers as L
from repro_torch.optim import AdamWConfig
from repro_torch.pytree import tree_flatten, tree_map
from repro_torch.training import TrainConfig
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

ARCH = "smollm-360m"
P, LOCAL_STEPS, ROUNDS = 4, 2, 2


@pytest.fixture(scope="module")
def jax_params():
    return jax_models.init_params(jax_reduced(JAX_ARCHS[ARCH]),
                                  jax.random.PRNGKey(0))


@pytest.fixture
def from_jax(monkeypatch, jax_params):
    """The port's launchers start from the JAX package's initial params."""
    monkeypatch.setattr(launch, "initial_params",
                        lambda cfg, dev: params_from_jax(jax_params, dev))


def _jax_overlay_run(jax_params, domain):
    """The reference launcher's `run_overlay`, with the MPC domain set."""
    jcfg = jax_reduced(JAX_ARCHS[ARCH])
    state = {"params": jax_replicate(jax_params, P,
                                     key=jax.random.PRNGKey(1), jitter=0.0),
             "opt": jax_replicate(jax_adamw_init(jax_params), P),
             "step": jnp.zeros((P,), jnp.int32)}
    ov = JaxOverlay(JaxOverlayConfig(
        n_institutions=P, local_steps=LOCAL_STEPS, merge="secure_mean",
        alpha=1.0, arch_family=jcfg.family, secure_domain=domain))
    local_step = jax_make_local_step(jcfg, JaxTrainConfig(
        optimizer=JaxAdamWConfig(learning_rate=3e-4), total_steps=10,
        warmup_steps=5, remat=False, impl="ref"))
    ds = JaxDataset(jcfg, JaxDataConfig(seq_len=32, global_batch=8))
    history = []
    for r in range(ROUNDS):
        toks = jax_institution_batches(ds, P, LOCAL_STEPS, r)
        state, metrics, _ = ov.round(state, {"tokens": jnp.asarray(toks)},
                                     local_step, jax.random.PRNGKey(100 + r))
        history.append(float(metrics["loss"].mean()))
    return state, history, ov


def _survivors(registry):
    return [json.loads(tx.metadata)["survivors"] for tx in registry.chain
            if tx.kind == "rolling_update"]


@pytest.mark.parametrize("domain", ["float", "int"])
def test_overlay_training_round_matches_jax(monkeypatch, jax_params,
                                            from_jax, domain):
    monkeypatch.setattr(jax_layers, "COMPUTE_DTYPE", jnp.float32)
    monkeypatch.setattr(L, "COMPUTE_DTYPE", torch.float32)
    jstate, jhist, jov = _jax_overlay_run(jax_params, domain)
    state, hist, ov = launch.run_overlay(
        reduced(ARCHS[ARCH]),
        TrainConfig(optimizer=AdamWConfig(learning_rate=3e-4),
                    total_steps=10, warmup_steps=5, remat=False,
                    impl="ref"),
        DataConfig(seq_len=32, global_batch=8), n_inst=P,
        local_steps=LOCAL_STEPS, rounds=ROUNDS, merge="secure_mean",
        alpha=1.0, device="cpu", secure_domain=domain)
    np.testing.assert_allclose(hist, jhist, rtol=1e-5)
    assert [s["committed"] for s in ov.stats] == \
        [s["committed"] for s in jov.stats] == [True] * ROUNDS
    assert _survivors(ov.registry) == _survivors(jov.registry) == \
        [list(range(P))] * ROUNDS
    assert len(ov.registry.chain) == len(jov.registry.chain)
    assert ov.registry.verify_chain()
    for got, want in zip(tree_flatten(state["params"])[0],
                         jax.tree.leaves(jstate["params"])):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=3e-5)
        # merged: every institution holds the same model
        assert float((got - got[:1]).abs().max()) <= 1e-6
    for got, want in zip(tree_flatten(state["opt"]["m"])[0],
                         jax.tree.leaves(jstate["opt"]["m"])):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-6)
    for got, want in zip(tree_flatten(state["opt"]["v"])[0],
                         jax.tree.leaves(jstate["opt"]["v"])):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=0.02 * float(np.abs(want).max()))
    # the moments stay per hospital: not merged, so the rows differ
    m = state["opt"]["m"]["block"]["wq"]
    assert float((m - m[:1]).abs().max()) > 1e-6
    assert state["opt"]["count"].tolist() == [ROUNDS * LOCAL_STEPS] * P
    assert state["step"].tolist() == [ROUNDS * LOCAL_STEPS] * P


def _jax_main_history(monkeypatch, argv, overlay):
    """The reference launcher's `main(argv)`, its run's loss history
    taken from the function it calls."""
    name = "run_overlay" if overlay else "run_centralized"
    real = getattr(jax_launch, name)
    got = []

    def spy(*args, **kwargs):
        out = real(*args, **kwargs)
        got.append(out[1])
        return out
    monkeypatch.setattr(jax_launch, name, spy)
    jax_launch.main(argv)
    return got[0]


@pytest.mark.parametrize("argv", [
    ["--reduced", "--steps", "3", "--seq-len", "32", "--batch", "4"],
    ["--reduced", "--overlay", "--rounds", "2", "--local-steps", "2",
     "--seq-len", "32", "--batch", "8"],
], ids=["centralized", "overlay"])
def test_launcher_main_matches_jax(monkeypatch, from_jax, argv):
    want = _jax_main_history(monkeypatch, argv, "--overlay" in argv)
    got = launch.main(argv + ["--device", "cpu"])
    assert len(got) == len(want) == (2 if "--overlay" in argv else 3)
    np.testing.assert_allclose(got, want, rtol=1e-3)


def test_launchers_default_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch.main(["--reduced", "--steps", "1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ehr_train.main(["--rounds", "1"])


def test_ehr_driver_checkpoints_the_merged_model(tmp_path, capsys):
    ckpt = tmp_path / "ehr"
    ov, state, fp = ehr_train.main(["--rounds", "2", "--local-steps", "2",
                                    "--seq-len", "16", "--batch", "4",
                                    "--device", "cpu", "--ckpt-dir",
                                    str(ckpt)])
    out = capsys.readouterr().out
    assert "scheduler placed training on 'egs'" in out
    assert ov.registry.verify_chain()
    assert [s["committed"] for s in ov.stats] == [True, True]
    # the checkpoint holds row 0, the model the ledger registered
    assert fp == ov.registry.chain[-1].model_fingerprint
    row0 = tree_map(lambda x: x[0], state["params"])
    params, manifest = load_checkpoint(str(ckpt), row0)
    assert manifest["step"] == 4 and manifest["metadata"]["overlay"]
    for a, b in zip(tree_flatten(params)[0], tree_flatten(row0)[0]):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    m = state["opt"]["m"]["embed"]
    assert float((m - m[:1]).abs().max()) > 0
