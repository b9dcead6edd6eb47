"""The port's training stack held against the JAX package on the CPU: LR
schedules, AdamW, the LM token data, the train step (microbatches, remat,
the fused cross-entropy), the continuum scheduler, and the LM kernels'
refusal of gradients they cannot give.

Inputs are the same on both sides: numpy-seeded tokens and arrays, and
the JAX package's own initialised params carried across with
`params_from_jax`.  Tolerances, stated per comparison:
  * exact: tokens, batch specs, the scheduler's placements and workloads
    (host float64, rtol 1e-12), the fused cross-entropy's threshold, the
    int32 step count, remat against no remat under ``vmap(grad)`` (the
    same ops in the same order: bit-equal; under ``.backward()`` the
    recompute's ``torch.func.vjp`` sums a bf16 activation's gradient
    contributions in another order than autograd does, so that side is
    held in fp32 compute within 1e-5 of each leaf's largest gradient),
    the plain impl against the paths it names;
  * rtol 1e-6 (fp32 elementwise, one ulp's worth): schedules and
    `adamw_update`;
  * the train step after 2 steps with both packages' ``COMPUTE_DTYPE``
    set to float32: params within atol 2e-6 (dense), 5e-5 (hymba: its
    fp32 scan state integrates every token's products, and AdamW's first
    steps move a param by about lr whatever its gradient's size, so a
    gradient near 0 that rounds differently moves the param by up to
    lr), m within atol 1e-7 (hymba 1e-6) and v within 2% of each leaf's
    largest v (v
    holds squared gradients, whose small entries carry the relative
    error of both packages' reductions); the loss within rtol 1e-5;
  * the same in bf16 (the models' compute dtype): the loss within rtol
    1e-3, AdamW's m and v within 4% of each leaf's largest (read: m 1.4%,
    v 1.7%; the port's bf16 m against its own fp32 m 1.9%).  The
    moments, not the params: the first step's lr is 0 (warm-up), so both
    steps' gradients are taken at the starting params and m holds them,
    while AdamW moves a param by about lr a step whatever its gradient;
  * microbatches 2 against 1 in fp32 compute: params within atol 1e-6
    (the gradient is summed in another order);
  * the fused cross-entropy against the plain loss: loss and grads
    within rtol 1e-5 in fp32, and against the JAX package's `_fused_nll`
    within atol 1e-5.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import repro.models.layers as jax_layers
from repro import models as jax_models
from repro.configs import ARCHS as JAX_ARCHS
from repro.configs import reduced as jax_reduced
from repro.core.scheduler import ContinuumScheduler as JaxScheduler
from repro.core.scheduler import cnn_workload as jax_cnn_workload
from repro.core import scheduler as jax_sched
from repro.data import DataConfig as JaxDataConfig
from repro.data import SyntheticTokenDataset as JaxDataset
from repro.data import institution_batches as jax_institution_batches
from repro.data import make_batch_specs as jax_make_batch_specs
from repro.optim import AdamWConfig as JaxAdamWConfig
from repro.optim import adamw_init as jax_adamw_init
from repro.optim import adamw_update as jax_adamw_update
from repro.optim import cosine_schedule as jax_cosine
from repro.optim import linear_warmup_cosine as jax_warmup_cosine
from repro.training import TrainConfig as JaxTrainConfig
from repro.training import make_train_step as jax_make_train_step
from repro.training import train as jax_train
from repro_torch import models
from repro_torch.configs import ARCHS, reduced
from repro_torch.convert import params_from_jax
from repro_torch.core import scheduler as sched
from repro_torch.core.scheduler import ContinuumScheduler, cnn_workload
from repro_torch.data import (
    DataConfig, SyntheticTokenDataset, institution_batches, make_batch_specs,
)
from repro_torch.kernels import _cuda
from repro_torch.kernels.rwkv6_scan import ops as wkv_ops
from repro_torch.kernels.ssm_scan import ops as ssm_ops
from repro_torch.models import layers as L
from repro_torch.optim import (
    AdamWConfig, adamw_init, adamw_update, cosine_schedule, global_norm,
    linear_warmup_cosine,
)
from repro_torch.pytree import tree_flatten, tree_map
from repro_torch.training import (
    TrainConfig, TrainState, make_loss_fn, make_train_step, resolve_impl,
)
from repro_torch.training import train as train_mod
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

LR = 3e-4
STEPS = 2
BF16_MOMENT_REL = 0.04       # bf16 moments: a share of each leaf's largest


def to_np(x):
    return np.asarray(x.detach().float().cpu().numpy()
                      if isinstance(x, torch.Tensor) else x)


def leaves_np(tree):
    return [to_np(x) for x in tree_flatten(tree)[0]]


# ----------------------------------------------------------------------
# LR schedules and AdamW

STEP_VALUES = [0, 1, 4, 5, 6, 50, 99, 100, 101, 1000, 5000]


@pytest.mark.parametrize("warmup,total", [(5, 100), (0, 10), (100, 1000),
                                          (10, 10)])
def test_schedules_match_jax(warmup, total):
    steps = np.asarray(STEP_VALUES, np.int32)
    got = linear_warmup_cosine(torch.from_numpy(steps), warmup, total)
    want = jax_warmup_cosine(jnp.asarray(steps), warmup, total)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(to_np(got), np.asarray(want), rtol=1e-6)
    got = cosine_schedule(torch.from_numpy(steps), total, 0.2)
    np.testing.assert_allclose(to_np(got),
                               np.asarray(jax_cosine(jnp.asarray(steps),
                                                     total, 0.2)),
                               rtol=1e-6)
    # a scalar step, as the train step passes it
    for s in (0, warmup, total + 3):
        np.testing.assert_allclose(
            float(linear_warmup_cosine(torch.tensor(s, dtype=torch.int32),
                                       warmup, total)),
            float(jax_warmup_cosine(jnp.int32(s), warmup, total)),
            rtol=1e-6)


def _adamw_case(seed, grad_scale, count, negative_v):
    rng = np.random.default_rng(seed)
    params = {"a": rng.standard_normal((4, 5)).astype(np.float32),
              "b": {"w": rng.standard_normal((7,)).astype(np.float32)}}
    grads = tree_map(lambda p: (rng.standard_normal(p.shape) * grad_scale)
                     .astype(np.float32), params)
    m = tree_map(lambda p: (rng.standard_normal(p.shape) * 0.01)
                 .astype(np.float32), params)
    v = tree_map(lambda p: (rng.random(p.shape) * 1e-4).astype(np.float32),
                 params)
    if negative_v:      # merged moments: ulp-scale negative residue
        v["a"][0, :3] = -1e-12
        v["b"]["w"][2] = -3e-9
    state = {"m": m, "v": v, "count": np.int32(count)}
    return params, grads, state


@pytest.mark.parametrize("grad_scale", [1e-3, 10.0])   # clip off / on
@pytest.mark.parametrize("count", [0, 2])              # to count 1 / 3
@pytest.mark.parametrize("negative_v", [False, True])
def test_adamw_update_matches_jax(grad_scale, count, negative_v):
    params, grads, state = _adamw_case(7, grad_scale, count, negative_v)
    cfg = AdamWConfig(learning_rate=1e-2)
    jcfg = JaxAdamWConfig(learning_rate=1e-2)
    t = lambda tree: tree_map(torch.from_numpy, tree)     # noqa: E731
    j = lambda tree: tree_map(jnp.asarray, tree)          # noqa: E731
    tstate = {"m": t(state["m"]), "v": t(state["v"]),
              "count": torch.tensor(count, dtype=torch.int32)}
    jstate = {"m": j(state["m"]), "v": j(state["v"]),
              "count": jnp.int32(count)}
    for scale in (1.0, 0.37):
        p2, s2, met = adamw_update(cfg, t(params), t(grads), tstate,
                                   torch.tensor(scale))
        jp2, js2, jmet = jax_adamw_update(jcfg, j(params), j(grads), jstate,
                                          jnp.float32(scale))
        clipped = float(met["grad_norm"]) > cfg.grad_clip_norm
        assert clipped == (grad_scale > 1)
        np.testing.assert_allclose(float(met["grad_norm"]),
                                   float(jmet["grad_norm"]), rtol=1e-6)
        np.testing.assert_allclose(float(met["lr"]), float(jmet["lr"]),
                                   rtol=1e-6)
        assert s2["count"].dtype == torch.int32
        assert int(s2["count"]) == int(js2["count"]) == count + 1
        for got, want in zip(leaves_np((p2, s2["m"], s2["v"])),
                             jax.tree.leaves((jp2, js2["m"], js2["v"]))):
            np.testing.assert_allclose(got, np.asarray(want), rtol=1e-6,
                                       atol=1e-12)
        assert all((x >= 0).all() for x in leaves_np(s2["v"]))


def test_adamw_keeps_param_dtype_and_fp32_moments():
    p = {"w": torch.randn(3, 4).to(torch.bfloat16)}
    st = adamw_init(p)
    assert st["m"]["w"].dtype == torch.float32
    assert st["count"].dtype == torch.int32 and int(st["count"]) == 0
    p2, st2, _ = adamw_update(AdamWConfig(), p, {"w": torch.ones(3, 4)}, st)
    assert p2["w"].dtype == torch.bfloat16
    assert st2["v"]["w"].dtype == torch.float32
    np.testing.assert_allclose(float(global_norm({"a": torch.ones(4),
                                                  "b": torch.ones(5)})), 3.0)


# ----------------------------------------------------------------------
# LM token data

@pytest.mark.parametrize("arch", ["smollm-360m", "hubert-xlarge",
                                  "llava-next-mistral-7b"])
def test_token_data_and_specs_match_jax(arch):
    cfg, jcfg = reduced(ARCHS[arch]), jax_reduced(JAX_ARCHS[arch])
    dc = DataConfig(seq_len=40, global_batch=8, seed=3)
    ds = SyntheticTokenDataset(cfg, dc)
    jds = JaxDataset(jcfg, JaxDataConfig(seq_len=40, global_batch=8, seed=3))
    np.testing.assert_array_equal(ds.perm, jds.perm)
    for step in (0, 5):
        got, want = ds.batch(step), jds.batch(step)
        assert sorted(got) == sorted(want)
        for k in got:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k])
    for kind in ("train", "prefill", "decode"):
        specs, axes = make_batch_specs(cfg, 64, 4, kind)
        jspecs, jaxes = jax_make_batch_specs(jcfg, 64, 4, kind)
        assert sorted(specs) == sorted(jspecs)
        assert axes == {k: tuple(v) for k, v in jaxes.items()}
        for k, (shape, dtype) in specs.items():
            assert shape == jspecs[k].shape, k
            assert str(dtype).split(".")[1] == str(jspecs[k].dtype), k


def test_institution_batches_match_jax():
    cfg = reduced(ARCHS["smollm-360m"])
    jcfg = jax_reduced(JAX_ARCHS["smollm-360m"])
    ds = SyntheticTokenDataset(cfg, DataConfig(seq_len=16, global_batch=8))
    jds = JaxDataset(jcfg, JaxDataConfig(seq_len=16, global_batch=8))
    for rnd in (0, 3):
        got = institution_batches(ds, 4, 3, rnd)
        want = jax_institution_batches(jds, 4, 3, rnd)
        assert got.shape == (3, 4, 2, 16) and got.dtype == np.int32
        np.testing.assert_array_equal(got, want)
    with pytest.raises(AssertionError):
        institution_batches(ds, 3, 1, 0)


# ----------------------------------------------------------------------
# the train step against the JAX package

def _fp32(monkeypatch):
    monkeypatch.setattr(jax_layers, "COMPUTE_DTYPE", jnp.float32)
    monkeypatch.setattr(L, "COMPUTE_DTYPE", torch.float32)


def _run_both(arch, tkw, steps=STEPS, port_kw=None):
    """`steps` train steps of reduced `arch` on both packages from the
    JAX package's initial params; returns ((params, opt, loss) port,
    (params, opt, loss) JAX)."""
    jcfg = jax_reduced(JAX_ARCHS[arch])
    cfg = reduced(ARCHS[arch])
    jp = jax_models.init_params(jcfg, jax.random.PRNGKey(0))
    jds = JaxDataset(jcfg, JaxDataConfig(seq_len=32, global_batch=4))
    jstep = jax.jit(jax_make_train_step(jcfg, JaxTrainConfig(
        optimizer=JaxAdamWConfig(learning_rate=LR), total_steps=10,
        warmup_steps=1, **tkw)))
    tstep = make_train_step(cfg, TrainConfig(
        optimizer=AdamWConfig(learning_rate=LR), total_steps=10,
        warmup_steps=1, **dict(tkw, **(port_kw or {}))))
    po, oo = jp, jax_adamw_init(jp)
    pt = params_from_jax(jp)
    ot = adamw_init(pt)
    for s in range(steps):
        toks = jds.batch(s)["tokens"]
        po, oo, jm = jstep(po, oo, jnp.int32(s), {"tokens": jnp.asarray(toks)})
        pt, ot, tm = tstep(pt, ot, torch.tensor(s, dtype=torch.int32),
                           {"tokens": torch.from_numpy(toks)})
    assert set(tm) == set(jm)
    return (pt, ot, float(tm["loss"])), (po, oo, float(jm["loss"]))


def _assert_moments(ot, oo, m_atol):
    for got, want in zip(leaves_np(ot["m"]), jax.tree.leaves(oo["m"])):
        np.testing.assert_allclose(got, np.asarray(want), rtol=0,
                                   atol=m_atol)
    for got, want in zip(leaves_np(ot["v"]), jax.tree.leaves(oo["v"])):
        want = np.asarray(want)
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=0.02 * float(np.abs(want).max()))
    assert int(ot["count"]) == int(oo["count"]) == STEPS


# (arch, train-config knobs, port-only knobs, params atol)
FP32_CASES = [
    ("smollm-360m", {"remat": False}, {"remat": True}, 2e-6),
    ("qwen3-0.6b", {"remat": False, "fused_xent_min_vocab": 256,
                    "fused_xent_chunk": 8}, {}, 2e-6),
    ("smollm-360m", {"remat": False, "microbatches": 2}, {}, 2e-6),
    ("hymba-1.5b", {"remat": False}, {}, 5e-5),
]


@pytest.mark.parametrize("arch,tkw,port_kw,atol", FP32_CASES,
                         ids=["smollm-remat", "qwen3-fused", "smollm-mb2",
                              "hymba"])
def test_train_step_matches_jax_fp32(monkeypatch, arch, tkw, port_kw, atol):
    _fp32(monkeypatch)
    (pt, ot, loss), (po, oo, jloss) = _run_both(arch, tkw, port_kw=port_kw)
    np.testing.assert_allclose(loss, jloss, rtol=1e-5)
    for got, want in zip(leaves_np(pt), jax.tree.leaves(po)):
        np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=atol)
    _assert_moments(ot, oo, 1e-7 if atol < 1e-5 else 1e-6)


def test_train_step_matches_jax_bf16():
    (_, ot, loss), (_, oo, jloss) = _run_both("smollm-360m",
                                              {"remat": False})
    np.testing.assert_allclose(loss, jloss, rtol=1e-3)
    for key in ("m", "v"):
        for got, want in zip(leaves_np(ot[key]), jax.tree.leaves(oo[key])):
            want = np.asarray(want)
            np.testing.assert_allclose(
                got, want, rtol=0,
                atol=BF16_MOMENT_REL * float(np.abs(want).max()))


def _step_once(arch, monkeypatch, **tkw):
    _fp32(monkeypatch)
    cfg = reduced(ARCHS[arch])
    st = TrainState.create(cfg, torch.Generator().manual_seed(0))
    assert st.step.dtype == torch.int32
    ds = SyntheticTokenDataset(cfg, DataConfig(seq_len=32, global_batch=4))
    batch = {"tokens": torch.from_numpy(ds.batch(0)["tokens"])}
    step = make_train_step(cfg, TrainConfig(**tkw))
    return step(st.params, st.opt_state, st.step, batch)


def test_microbatches_match_one_batch(monkeypatch):
    p1, _, m1 = _step_once("smollm-360m", monkeypatch, microbatches=1)
    p2, _, m2 = _step_once("smollm-360m", monkeypatch, microbatches=2)
    np.testing.assert_allclose(float(m1["loss"]), float(m2["loss"]),
                               rtol=1e-6)
    for a, b in zip(leaves_np(p1), leaves_np(p2)):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)


# ----------------------------------------------------------------------
# remat under vmap, as the overlay calls the local step

@pytest.mark.parametrize("arch", ["smollm-360m", "rwkv6-3b", "hymba-1.5b"])
def test_remat_matches_no_remat_under_vmap(monkeypatch, arch):
    cfg = reduced(ARCHS[arch])
    gen = torch.Generator().manual_seed(1)
    params = models.init_params(cfg, gen)
    stacked = tree_map(lambda x: torch.stack([x, x * 0.9]), params)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        1, cfg.vocab_size, (2, 2, 24)).astype(np.int32))
    grads = {}
    for remat in (False, True):
        loss_fn = make_loss_fn(cfg, TrainConfig(remat=remat))
        grads[remat] = torch.func.vmap(torch.func.grad_and_value(
            loss_fn, has_aux=True))(stacked, {"tokens": toks})
    (g0, (l0, _)), (g1, (l1, _)) = grads[False], grads[True]
    assert torch.equal(l0, l1)
    for a, b in zip(tree_flatten(g0)[0], tree_flatten(g1)[0]):
        assert torch.equal(a, b)
    # and under plain autograd: .backward() through the recompute helper,
    # whose backward differentiates with torch.func.vjp: its bf16
    # gradients sum their contributions in another order than autograd's,
    # so this side is held in fp32 compute
    _fp32(monkeypatch)
    got = {}
    for remat in (False, True):
        p = tree_map(lambda x: x.clone().requires_grad_(), params)
        loss, _ = make_loss_fn(cfg, TrainConfig(remat=remat))(
            p, {"tokens": toks[0]})
        loss.backward()
        got[remat] = [x.grad for x in tree_flatten(p)[0]]
    for a, b in zip(got[False], got[True]):
        np.testing.assert_allclose(to_np(b), to_np(a), rtol=0,
                                   atol=1e-5 * float(a.abs().max()))


def test_recompute_saves_inputs_and_skips_int_inputs():
    w = torch.randn(4, 4, requires_grad=True)
    x = torch.randn(3, 4, requires_grad=True)
    pos = torch.arange(3)

    def body(x, p, pos):
        return {"y": torch.tanh(x @ p["w"]) + pos[:, None].float(),
                "s": (x * x).sum()}
    out = L.recompute(body, x, {"w": w}, pos)
    (out["y"].sum() + out["s"]).backward()
    gx, gw = x.grad.clone(), w.grad.clone()
    x.grad = w.grad = None
    out = body(x, {"w": w}, pos)
    (out["y"].sum() + out["s"]).backward()
    assert torch.equal(gx, x.grad) and torch.equal(gw, w.grad)


# ----------------------------------------------------------------------
# the fused cross-entropy

def test_fused_nll_matches_jax_and_plain_loss(monkeypatch):
    _fp32(monkeypatch)
    rng = np.random.default_rng(4)
    feats = rng.standard_normal((2, 12, 16)).astype(np.float32)
    head = (rng.standard_normal((16, 40)) * 0.3).astype(np.float32)
    labels = rng.integers(0, 40, (2, 12)).astype(np.int32)
    mask = np.ones((2, 12), bool)
    mask[1, -3:] = False
    got = train_mod._fused_nll(torch.from_numpy(feats),
                               torch.from_numpy(head),
                               torch.from_numpy(labels),
                               torch.from_numpy(mask), 5)
    want = jax_train._fused_nll(jnp.asarray(feats), jnp.asarray(head),
                                jnp.asarray(labels), jnp.asarray(mask), 5)
    np.testing.assert_allclose(to_np(got), np.asarray(want), atol=1e-5)

    cfg = reduced(ARCHS["smollm-360m"])       # vocab 512
    params = models.init_params(cfg, torch.Generator().manual_seed(2))
    toks = {"tokens": torch.from_numpy(rng.integers(
        1, cfg.vocab_size, (2, 20)).astype(np.int32))}
    calls = []
    real = train_mod._fused_nll
    monkeypatch.setattr(train_mod, "_fused_nll",
                        lambda *a: calls.append(a[-1]) or real(*a))
    out = {}
    for min_vocab, chunk in ((512, 4), (513, 4), (16_384, 2048), (0, 0)):
        fn = make_loss_fn(cfg, TrainConfig(fused_xent_min_vocab=min_vocab,
                                           fused_xent_chunk=chunk,
                                           remat=False))
        out[min_vocab] = torch.func.grad(fn, has_aux=True)(params, toks)
    # the reference's threshold: vocab >= min_vocab and a chunk > 0
    assert calls == [4]
    (g_f, m_f), (g_p, m_p) = out[512], out[513]
    np.testing.assert_allclose(float(m_f["loss"]), float(m_p["loss"]),
                               rtol=1e-5)
    for a, b in zip(leaves_np(g_f), leaves_np(g_p)):
        np.testing.assert_allclose(a, b, rtol=1e-5,
                                   atol=1e-5 * float(np.abs(b).max()))


# ----------------------------------------------------------------------
# which paths training takes, and the kernels' refusal

def test_training_impl_resolves_to_the_plain_paths():
    assert resolve_impl("auto") == "plain"
    assert resolve_impl("ref") == "ref" and resolve_impl("pallas") == "pallas"
    g = torch.Generator().manual_seed(0)
    q = torch.randn((1, 1030, 2, 32), generator=g)
    k = torch.randn((1, 1030, 1, 32), generator=g)
    assert torch.equal(L.attention(q, k, k, impl="plain"),
                       L.mha_chunked(q, k, k))
    q, k = q[:, :40], k[:, :40]
    assert torch.equal(L.attention(q, k, k, impl="plain"),
                       L.mha_reference(q, k, k))
    r = torch.randn((1, 9, 2, 16), generator=g)
    w = -torch.rand(r.shape, generator=g)
    u = torch.randn((2, 16), generator=g)
    s0 = torch.zeros((1, 2, 16, 16))
    for x, y in zip(wkv_ops.wkv6(r, r, r, w, u, s0, impl="plain"),
                    wkv_ops.wkv6(r, r, r, w, u, s0, impl="ref")):
        assert torch.equal(x, y)
    a = torch.rand((1, 9, 6), generator=g)
    B = torch.randn((1, 9, 4), generator=g)
    h0 = torch.zeros((1, 6, 4))
    for x, y in zip(ssm_ops.ssm_scan(a, a, B, B, h0, impl="plain"),
                    ssm_ops.ssm_scan(a, a, B, B, h0, impl="chunked")):
        assert torch.equal(x, y)


def test_grad_tracking_is_seen_through_every_transform():
    """`_cuda.refuse_transforms`, which the flash, WKV6 and scan wrappers
    call before a CUDA launch, sees a gradient under autograd, under
    torch.func.grad and under either nesting with vmap, and lets a plain
    or no-grad call through (the card tests hold the wrappers to it)."""
    seen = []

    def probe(x):
        seen.append(_cuda._grad_tracked(x))
        try:
            _cuda.refuse_transforms("k", x)
        except RuntimeError as e:
            seen.append(str(e))
        return (x * 2).sum()

    x = torch.randn(2, 3)
    probe(x)
    with torch.no_grad():
        probe(x.clone().requires_grad_())
    assert seen == [False, False]
    probe(x.clone().requires_grad_())
    torch.func.grad(probe)(x[0])
    torch.func.vmap(torch.func.grad(probe))(x)
    torch.func.grad(lambda y: torch.func.vmap(probe)(y).sum())(x)
    tracked = seen[2:]
    assert tracked[0::2] == [True] * 4
    assert all("no backward kernel" in m and 'impl="ref"' in m
               for m in tracked[1::2])
    seen.clear()
    torch.func.vmap(probe)(x)
    assert seen[0] is False and "batching rule" in seen[1]


# ----------------------------------------------------------------------
# the continuum scheduler

@pytest.mark.parametrize("acc", [0.5, 0.7, 0.8, 0.85, 0.9, 0.97, 0.99])
def test_scheduler_matches_jax(acc):
    np.testing.assert_allclose(sched.accuracy_to_width(acc),
                               jax_sched.accuracy_to_width(acc), rtol=1e-12)
    np.testing.assert_allclose(sched.time_fraction_for_accuracy(acc),
                               jax_sched.time_fraction_for_accuracy(acc),
                               rtol=1e-12)
    for avail in (None, {"rpi4", "c5.large"}, {"njn"}):
        got = ContinuumScheduler().place(acc, epochs=10, available=avail)
        want = JaxScheduler().place(acc, epochs=10, available=avail)
        assert got.resource == want.resource
        for f in ("est_time_s", "width_scale", "target_accuracy"):
            np.testing.assert_allclose(getattr(got, f), getattr(want, f),
                                       rtol=1e-12)
        assert sorted(got.per_resource_times) == \
            sorted(want.per_resource_times)
        for k, v in got.per_resource_times.items():
            np.testing.assert_allclose(v, want.per_resource_times[k],
                                       rtol=1e-12)


@pytest.mark.parametrize("width", [0.1, 0.25, 0.5, 1.0])
def test_cnn_workload_matches_jax(width):
    got = cnn_workload(epochs=7, width_scale=width)
    want = jax_cnn_workload(epochs=7, width_scale=width)
    assert dataclasses.asdict(got).keys() == dataclasses.asdict(want).keys()
    for k, v in dataclasses.asdict(got).items():
        np.testing.assert_allclose(v, getattr(want, k), rtol=1e-12)
