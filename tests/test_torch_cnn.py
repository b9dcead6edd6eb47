"""The port's STIGMA CNN held against the JAX package on carried weights.

Forward, loss and gradients agree within rtol = 1e-4, atol = 1e-5: the
convolutions sum in another order (oneDNN vs XLA) in float32.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs.stigma_cnn import STIGMA_CNN
from repro.models import stigma_cnn as jcnn
from repro_torch.configs.stigma_cnn import STIGMA_CNN as T_STIGMA_CNN
from repro_torch.convert import params_from_jax
from repro_torch.pytree import tree_flatten
from repro_torch.models import stigma_cnn as tcnn
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

TOL = dict(rtol=1e-4, atol=1e-5)


def _jax_tree(cfg, width_scale, seed):
    """The reference's param tree and shapes (`jax.eval_shape`, which
    compiles nothing), filled from a numpy seed: weights ~ N(0, 1/fan_in),
    biases ~ N(0, 0.01)."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda: jcnn.init_params(
        cfg, jax.random.PRNGKey(seed), width_scale))
    return jax.tree.map(lambda s: (rng.standard_normal(s.shape) / (
        np.sqrt(np.prod(s.shape[:-1])) if len(s.shape) > 1 else 10.0)
    ).astype(np.float32), shapes)


def _setup(width_scale, image_size, seed=0, batch=6):
    cfg = dataclasses.replace(STIGMA_CNN, image_size=image_size)
    params = _jax_tree(cfg, width_scale, seed)
    rng = np.random.default_rng([seed, 1])
    imgs = rng.standard_normal((batch, image_size, image_size, 3)
                               ).astype(np.float32)
    labels = rng.integers(0, 2, batch).astype(np.int32)
    tcfg = dataclasses.replace(T_STIGMA_CNN, image_size=image_size)
    return cfg, tcfg, params, imgs, labels


@pytest.mark.parametrize("width_scale,image_size", [(0.25, 16), (0.5, 8)])
def test_forward_loss_and_grads_match(width_scale, image_size):
    cfg, tcfg, params, imgs, labels = _setup(width_scale, image_size)
    # jitted: one XLA compile instead of one per op
    want_logits = np.asarray(jax.jit(
        lambda p: jcnn.forward(cfg, p, jnp.asarray(imgs)))(params))
    (want_loss, want_acc), want_g = jax.jit(jax.value_and_grad(
        lambda p: jcnn.loss_fn(cfg, p, jnp.asarray(imgs),
                               jnp.asarray(labels)), has_aux=True))(params)

    tparams = params_from_jax(params)
    np.testing.assert_allclose(
        tcnn.forward(tcfg, tparams, torch.from_numpy(imgs)).detach().numpy(),
        want_logits, **TOL)
    g, (loss, acc) = torch.func.grad_and_value(
        lambda p: tcnn.loss_fn(tcfg, p, torch.from_numpy(imgs),
                               torch.from_numpy(labels)),
        has_aux=True)(tparams)
    np.testing.assert_allclose(float(loss), float(want_loss), **TOL)
    assert float(acc) == float(want_acc)
    got_leaves, spec = tree_flatten(g)
    want_leaves = jax.tree.leaves(want_g)
    assert len(got_leaves) == len(want_leaves)
    for a, b in zip(got_leaves, want_leaves):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


def test_param_tree_layout_and_counts_match():
    for width_scale, image_size in [(1.0, 64), (0.25, 16)]:
        cfg, tcfg, params, _, _ = _setup(width_scale, image_size)
        ours = tcnn.init_params(tcfg, torch.Generator().manual_seed(0),
                                width_scale)
        got, want = tree_flatten(ours)[0], jax.tree.leaves(params)
        assert [tuple(x.shape) for x in got] == [x.shape for x in want]
        assert all(x.dtype == torch.float32 for x in got)
        assert tcnn.scaled_channels(tcfg, width_scale) == \
            jcnn.scaled_channels(cfg, width_scale)
        assert tcnn.flops_per_image(tcfg, width_scale) == \
            jcnn.flops_per_image(cfg, width_scale)
    # the paper's CNN at full width: N = 109,634 parameters per hospital
    full = tcnn.init_params(T_STIGMA_CNN, torch.Generator().manual_seed(0))
    assert sum(x.numel() for x in tree_flatten(full)[0]) == 109_634


def test_full_fp32_turns_tf32_off_and_restores(monkeypatch):
    """The federation's local step trains with TF32 off and cuDNN held to
    its deterministic algorithms, and the process's own settings come back
    afterwards, also after an exception."""
    from repro_torch.chaos.harness import CNNFederation

    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    monkeypatch.setattr(cudnn, "allow_tf32", True)
    monkeypatch.setattr(matmul, "allow_tf32", True)
    monkeypatch.setattr(cudnn, "deterministic", False)
    seen = []
    loss_fn = tcnn.loss_fn

    def spy(*args):
        seen.append((cudnn.allow_tf32, matmul.allow_tf32,
                     cudnn.deterministic))
        return loss_fn(*args)

    monkeypatch.setattr(tcnn, "loss_fn", spy)
    CNNFederation(None, 0, n_institutions=2, local_steps=1, image_size=8,
                  device="cpu").run_round(0)
    assert seen and all(s == (False, False, True) for s in seen)
    assert (cudnn.allow_tf32, matmul.allow_tf32, cudnn.deterministic) == \
        (True, True, False)
    with pytest.raises(RuntimeError):
        with tcnn.full_fp32():
            raise RuntimeError("inside")
    assert (cudnn.allow_tf32, matmul.allow_tf32, cudnn.deterministic) == \
        (True, True, False)


def test_init_params_seeded_and_scaled():
    tcfg = dataclasses.replace(T_STIGMA_CNN, image_size=16)
    a = tcnn.init_params(tcfg, torch.Generator().manual_seed(3), 0.25)
    b = tcnn.init_params(tcfg, torch.Generator().manual_seed(3), 0.25)
    for x, y in zip(tree_flatten(a)[0], tree_flatten(b)[0]):
        assert torch.equal(x, y)
    w = a["conv"][0]["w"]
    assert abs(float(w.std()) - 1 / np.sqrt(27)) < 0.05
