"""The port's examples (`examples/torch_*.py`) on the CPU.

`torch_quickstart` is held against the reference quickstart's own
computation (`examples/quickstart.py`: three hospitals, rounds of local
SGD steps, secure_mean merges), with the JAX package's params carried
across by `repro_torch.convert.params_from_jax`:

  * the whole quickstart (5 rounds of 6 steps): the same consensus
    transcripts, an equal chain length and a verified chain on both sides;
  * 2 rounds of 2 steps: per-round losses within rtol = 1e-4 and params
    within atol = 1e-4, the CNN federation's tolerances in
    `test_torch_federation.py`.  Over the whole quickstart the two part
    further (losses up to 6.4e-3 apart by round 4): in round 0's second
    step two of institution 0's activations are equal to within fp32
    rounding, a 2x2 max-pool picks the other one, and the step's conv
    weight gradients differ by up to 5.5e-4 while every loss still agrees
    to 1e-7.  Each side's single steps agree to 2e-6.

The other six run at their smallest flags on ``--device cpu``
(`torch_scale_institutions` over two spawned gloo ranks); without it each
raises where there is no card.
"""
import dataclasses
import importlib.util
import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs.stigma_cnn import STIGMA_CNN as JAX_CNN
from repro.core import DecentralizedOverlay as JaxOverlay
from repro.core import OverlayConfig as JaxOverlayConfig
from repro.core import replicate_params as jax_replicate
from repro.data import SyntheticGlendaDataset as JaxDataset
from repro.models import stigma_cnn as jax_cnn
from repro_torch.convert import params_from_jax
from repro_torch.pytree import tree_flatten
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

EXAMPLES = os.path.join(os.path.dirname(__file__), os.pardir, "examples")


def _example(name):
    path = os.path.join(EXAMPLES, f"torch_{name}.py")
    spec = importlib.util.spec_from_file_location(f"torch_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod    # spawned ranks unpickle by this name
    spec.loader.exec_module(mod)
    return mod


def _jax_quickstart(ex):
    """The reference quickstart's computation at `ex`'s ROUNDS and STEPS,
    returning what it prints from: (start params, end params, metrics,
    transcripts, chain length, verified)."""
    cfg = dataclasses.replace(JAX_CNN, image_size=32)

    def local_step(params, batch, key):
        imgs, labels = batch
        (loss, acc), g = jax.value_and_grad(
            lambda p: jax_cnn.loss_fn(cfg, p, imgs, labels),
            has_aux=True)(params)
        return jax.tree.map(lambda a, b: a - 0.05 * b, params, g), {
            "loss": loss, "acc": acc}

    params = jax_cnn.init_params(cfg, jax.random.PRNGKey(0))
    stacked = jax_replicate(params, ex.P, key=jax.random.PRNGKey(1),
                            jitter=0.01)
    start = jax.device_get(stacked)
    overlay = JaxOverlay(JaxOverlayConfig(
        n_institutions=ex.P, local_steps=ex.STEPS, merge="secure_mean",
        arch_family="cnn"))
    ds = JaxDataset(image_size=32, n_samples=240,
                                n_institutions=ex.P, seed=0)
    imgs, labels = ex.round_batches(ds)
    keys = jnp.stack([jax.random.PRNGKey(r) for r in range(ex.ROUNDS)])
    stacked, metrics, transcripts = overlay.run_rounds(
        stacked, (jnp.asarray(imgs), jnp.asarray(labels)), local_step, keys,
        ex.ROUNDS)
    return (start, jax.device_get(stacked), jax.device_get(metrics),
            transcripts, len(overlay.registry.chain),
            overlay.registry.verify_chain())


def test_whole_quickstart_commits_like_the_reference():
    ex = _example("quickstart")
    start, _, _, jtr, jlen, jok = _jax_quickstart(ex)
    overlay, _, metrics, transcripts = ex.run(
        torch.device("cpu"), stacked=params_from_jax(start))
    assert metrics["loss"].shape == (ex.ROUNDS, ex.P)
    assert [(t.committed, t.elapsed_s) for t in transcripts] == \
        [(t.committed, t.elapsed_s) for t in jtr]
    assert len(overlay.registry.chain) == jlen
    assert overlay.registry.verify_chain() and jok


def test_quickstart_numbers_match_the_reference_within_tolerance():
    ex = _example("quickstart")      # a fresh module: its cut is its own
    ex.ROUNDS = ex.STEPS = 2
    start, want, jmetrics, _, jlen, _ = _jax_quickstart(ex)
    overlay, stacked, metrics, _ = ex.run(
        torch.device("cpu"), stacked=params_from_jax(start))
    np.testing.assert_allclose(metrics["loss"].numpy(),
                               np.asarray(jmetrics["loss"]), rtol=1e-4)
    for a, b in zip(tree_flatten(stacked)[0], jax.tree.leaves(want)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4,
                                   rtol=0)
    assert len(overlay.registry.chain) == jlen


def test_quickstart_main_prints_its_rounds():
    text = _example("quickstart").main(["--device", "cpu"])
    assert text.count("\nround ") + text.startswith("round ") == 5
    assert "chain verified=True" in text


_SMALLEST = {
    "chaos_federation": ["--scenario", "churn", "--rounds", "1"],
    "adversarial_federation": ["--attack", "sign_flip_30", "--rounds", "1"],
    "personalized_federation": ["--rounds", "1"],
    "continuum_serve": ["--requests", "2", "--max-new", "1"],
    "device_tier_federation": ["--institutions", "2", "--devices", "8",
                               "--chunk", "4", "--rounds", "1"],
    # two gloo ranks, each training 2 of the 4 hospitals
    "scale_institutions": ["--world-size", "2", "--backend", "gloo",
                           "--institutions", "4", "--rounds", "2",
                           "--image-size", "8", "--batch", "2",
                           "--local-steps", "1"],
}
_EXPECT = {
    "chaos_federation": ("DLT verified=True",),
    "adversarial_federation": ("eps trace",),
    "personalized_federation": ("personalization gain",),
    "continuum_serve": ("inference report registered on DLT",),
    "device_tier_federation": ("placement with device fan-in",),
    "scale_institutions": ("ranks: 2 (gloo, cpu)", "round 1:",
                           "committed=True", "chain verified=True"),
}


@pytest.mark.parametrize("name", sorted(_SMALLEST))
def test_example_runs_on_the_cpu(name):
    text = _example(name).main(_SMALLEST[name] + ["--device", "cpu"])
    for want in _EXPECT[name]:
        assert want in text, (want, text)
    assert "committed=False" not in text or name != "scale_institutions"


def test_list_flags_print_the_scenarios():
    assert "churn" in _example("chaos_federation").main(["--list"])
    assert "sign_flip_30" in _example("adversarial_federation").main(
        ["--list"])


@pytest.mark.parametrize("name", ["quickstart"] + sorted(_SMALLEST))
def test_default_device_raises_without_cuda(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _example(name).main(_SMALLEST.get(name, []))
