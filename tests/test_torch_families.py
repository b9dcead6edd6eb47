"""The MoE, audio and VLM families of the port's transformer (olmoe, dbrx,
hubert, llava), its trainer on them, `LMFederation` with an MoE model and
the serving launcher, held against the JAX package on the CPU: the same
numpy-seeded inputs, and the JAX package's own initialised params carried
across with `params_from_jax`.

Tolerances, stated per comparison:
  * exact: the MoE routing on identical inputs (each token's experts,
    the stable sort of the flat expert ids, every buffer row and which
    assignments a capacity drops), and in the reduced models at seed 0,
    layer by layer, in fp32 and in bf16 compute.  The router's logits are
    fp32 sums that XLA and PyTorch add in other orders, so a token whose
    k-th and (k+1)-th probabilities sat within an ulp of each other
    could flip; none does at these seeds.  ``lax.top_k`` puts the lower
    index first on a tie and ``torch.topk`` promises no order there:
    no two fp32 probabilities tie here;
  * the MoE FFN: gates and aux within 1e-6 (fp32 softmax and logsumexp
    of two libraries), the bf16 output within 2 bf16 ulps of its largest
    magnitude; under ``vmap(grad)`` in fp32 the gradients within 1e-6
    of each leaf's largest;
  * the reduced models in fp32 compute (both packages' COMPUTE_DTYPE
    set to float32): atol = rtol = 1e-4, the router aux within rtol
    1e-5; in bf16, 8 bf16 ulps of the largest logit (XLA and PyTorch
    round bf16 products at different places, compounded over the
    layers), the router aux within rtol 1e-3 (its mean probabilities
    come from router inputs an ulp or so apart); the dropped fraction
    within 1e-7 (the same drops, averaged in another order);
  * the trainer, 2 steps in fp32 compute: m within 1e-7, v within 2% of
    each leaf's largest, loss and router aux within rtol 1e-5, params
    within atol 5e-5 (as the dense trainer's hymba case: AdamW's second
    step moves a param by about lr whatever its gradient's size, and
    olmoe's embedding rows of tokens seen once get gradients near 1e-10
    that round differently in the two packages);
  * `LMFederation`, one round in fp32 compute: loss within rtol 1e-5,
    routing equal, params within atol 1e-6 (a round moves them by
    0.02-0.04);
  * the launcher in fp32 compute: greedy tokens equal.

**Routing flips in bf16** (ROADMAP queue C).  In bf16 compute the
second layer's router inputs come from bf16 activations that XLA and
PyTorch round differently, and at seed 0 one token of each institution's
first batch in the `LMFederation` chooses another expert in the port
than in the JAX package (and the capacity's drops move with it).  The
test holds those flips by `repro_torch.models.compare.routing_flips`'
rule: until the first flip the two packages' router inputs agree within
8 bf16 ulps of the call's largest, and each flip of that call has its
router logits within 8 bf16 ulps of the call's largest logit of the JAX
package's.  The federation round's params and the launcher's tokens are
held in fp32 compute, where no token flips.
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax import lax

import repro.models.layers as JL
from repro import models as jax_models
from repro.configs import ARCHS as JAX_ARCHS
from repro.configs import reduced as jax_reduced
from repro.data import DataConfig as JaxDataConfig
from repro.data import SyntheticTokenDataset as JaxDataset
from repro.launch import serve as jax_serve
from repro.optim import AdamWConfig as JaxAdamWConfig
from repro.optim import adamw_init as jax_adamw_init
from repro.serving import engine as jax_engine
from repro.serving.harness import LMFederation as JaxLMFederation
from repro.training import TrainConfig as JaxTrainConfig
from repro.training import make_train_step as jax_make_train_step
from repro_torch import models
from repro_torch.configs import ARCHS, reduced
from repro_torch.convert import params_from_jax
from repro_torch.data import DataConfig, SyntheticTokenDataset
from repro_torch.launch import serve
from repro_torch.models import layers as L
from repro_torch.models.compare import RouterTap, routes, routing_flips
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.pytree import tree_flatten
from repro_torch.serving import ServeConfig, ServingEngine
from repro_torch.serving.harness import LMFederation
from repro_torch.training import TrainConfig, make_train_step
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

MOE = ["olmoe-1b-7b", "dbrx-132b"]
HUBERT, LLAVA = "hubert-xlarge", "llava-next-mistral-7b"
LR = 3e-4


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def assert_bf16_close(got, want, ulps):
    got, want = _np(got), _np(want)
    atol = ulps * 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
    np.testing.assert_allclose(got, want, atol=atol, rtol=0)


def assert_f32_close(got, want, tol=1e-4):
    np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=tol)


def _t(x, dtype=None):
    t = torch.from_numpy(np.array(x))
    return t if dtype is None else t.to(dtype)


def _bf16_pair(x):
    """The same bf16 values in both packages."""
    xb = jnp.asarray(x, jnp.bfloat16)
    return xb, _t(np.asarray(xb, np.float32), torch.bfloat16)


def _fp32(monkeypatch):
    monkeypatch.setattr(JL, "COMPUTE_DTYPE", jnp.float32)
    monkeypatch.setattr(L, "COMPUTE_DTYPE", torch.float32)


_PARAMS = {}


def _pair(arch):
    """(JAX cfg, JAX params as numpy, port cfg, port params), reduced."""
    if arch not in _PARAMS:
        jcfg = jax_reduced(JAX_ARCHS[arch])
        _PARAMS[arch] = (jcfg, jax.device_get(jax_models.init_params(
            jcfg, jax.random.PRNGKey(0))))
    jcfg, jp = _PARAMS[arch]
    return jcfg, jp, reduced(ARCHS[arch]), params_from_jax(jp)


def _jax_fns(jcfg):
    """The JAX package's forward, prefill and decode step of `jcfg`,
    jitted: one trace each, under the COMPUTE_DTYPE of the first call."""
    fwd = jax.jit(lambda p, b: jax_models.forward(jcfg, p, b, impl="ref"))
    pre = jax.jit(lambda p, b, W: jax_models.prefill(jcfg, p, b, W,
                                                     impl="ref"),
                  static_argnums=2)
    dec = jax.jit(lambda p, s, t, pos: jax_models.decode_step(jcfg, p, s, t,
                                                              pos))
    return fwd, pre, dec


def _tokens(B, S, vocab, seed=0):
    return np.random.default_rng(seed).integers(1, vocab, (B, S)).astype(
        np.int32)


def _embeddings(B, S, d, seed=0):
    return np.random.default_rng([seed, 7]).standard_normal(
        (B, S, d)).astype(np.float32)


# ----------------------------------------------------------------------
# the MoE FFN on identical inputs

def _moe_case(G, T, d=64, E=8, f=32, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((G, T, d)).astype(np.float32)
    w = [(rng.standard_normal((d, E)) * 0.1).astype(np.float32)] + [
        (rng.standard_normal(s) / 8).astype(np.float32)
        for s in ((E, d, f), (E, d, f), (E, f, d))]
    return x, w


@functools.partial(jax.jit, static_argnums=(2, 3))
def _jax_routing(x, router_w, top_k, C):
    """The reference's per-group dispatch over the groups, and each
    token's experts (its own top-k, as `_moe_dispatch_one` takes it)."""
    buf, dest, order, keep, gate, aux = jax.vmap(
        lambda g: JL._moe_dispatch_one(g, router_w, top_k=top_k,
                                       capacity=C))(x)
    probs = jax.nn.softmax(x.astype(jnp.float32)
                           @ jnp.asarray(router_w, jnp.float32), axis=-1)
    _, idx = lax.top_k(probs, top_k)
    return buf, idx, dest, order, keep, gate, aux


# (groups, tokens a group, top_k, capacity factor): prefill-like groups,
# a capacity of half the need (tokens drop), one decode group of 8 slots
MOE_CASES = [(3, 16, 2, 1.25), (3, 16, 2, 0.5), (1, 8, 2, 1.25),
             (2, 24, 4, 1.0)]


@pytest.mark.parametrize("G,T,k,cf", MOE_CASES)
def test_moe_dispatch_and_ffn_match_jax(G, T, k, cf):
    x, (r, wg, wu, wd) = _moe_case(G, T)
    xb, xt = _bf16_pair(x)
    E = r.shape[-1]
    C = L.moe_capacity(T, E, k, cf)
    assert C == max(int(np.ceil(T * k * cf / E)), k)
    jb, jidx, jdest, jorder, jkeep, jgate, jaux = _jax_routing(xb, r, k, C)
    tb, tidx, tdest, torder, tkeep, tgate, taux = L._moe_dispatch(
        xt, _t(r), top_k=k, capacity=C)
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(torder.numpy(), np.asarray(jorder))
    np.testing.assert_array_equal(tdest.numpy(), np.asarray(jdest))
    np.testing.assert_array_equal(tkeep.numpy(), np.asarray(jkeep))
    np.testing.assert_array_equal(_np(tb), _np(jb))     # a scatter: exact
    np.testing.assert_allclose(_np(tgate), _np(jgate), atol=1e-6, rtol=0)
    for key in jaux:
        np.testing.assert_allclose(_np(taux[key]), _np(jaux[key]),
                                   atol=1e-6, rtol=1e-6)
    if cf < 1:
        assert float(taux["dropped_frac"].mean()) > 0
    jo, ja = jax.jit(JL.moe_ffn, static_argnames=("top_k", "capacity_factor"))(
        xb, r, wg, wu, wd, top_k=k, capacity_factor=cf)
    to, ta = L.moe_ffn(xt, *map(_t, (r, wg, wu, wd)), top_k=k,
                       capacity_factor=cf)
    assert to.dtype == torch.bfloat16 and to.shape == (G, T, x.shape[-1])
    assert_bf16_close(to, jo, ulps=2)
    for key in ja:
        np.testing.assert_allclose(_np(ta[key]), _np(ja[key]), atol=1e-6,
                                   rtol=1e-6)


def test_moe_vmap_grad_matches_jax():
    """Router and expert gradients under ``vmap(grad)`` over two
    institutions, as the federation's local step takes them, in fp32,
    with tokens dropped (capacity factor 0.5)."""
    x, w = _moe_case(3, 16, seed=1)
    names = ("router", "w_gate", "w_up", "w_down")
    stacked = {n: np.stack([a, a * s]) for n, a, s in
               zip(names, w, (1.0, 1.1, 0.9, 1.0))}
    xs = np.stack([x, x[:, ::-1].copy()])

    def loss(moe, p, x, square, f32):
        out, aux = moe(x, p["router"], p["w_gate"], p["w_up"], p["w_down"],
                       top_k=2, capacity_factor=0.5)
        return (square(f32(out)).mean() + 0.01 * aux["load_balance"]
                + 1e-3 * aux["router_z"])

    want = jax.jit(jax.vmap(jax.grad(lambda p, x: loss(
        JL.moe_ffn, p, x, jnp.square, lambda a: a.astype(jnp.float32)))))(
        stacked, xs)
    got = torch.func.vmap(torch.func.grad(lambda p, x: loss(
        L.moe_ffn, p, x, torch.square, torch.Tensor.float)))(
        {n: _t(a) for n, a in stacked.items()}, _t(xs))
    for n in names:
        w_ = np.asarray(want[n])
        assert np.abs(w_).max() > 0
        np.testing.assert_allclose(_np(got[n]), w_, rtol=0,
                                   atol=1e-6 * np.abs(w_).max())


# ----------------------------------------------------------------------
# the reduced models: routing layer by layer, logits

def _spy_jax_router_inputs(monkeypatch):
    """Each MoE call's router input, weights, top_k and capacity, as the
    JAX package's models make them: a host callback, in order, from
    inside its layer scan."""
    seen = []
    real = JL.moe_ffn

    def spy(x, router_w, *w, top_k, capacity_factor=1.25):
        C = max(int(np.ceil(x.shape[1] * top_k * capacity_factor
                            / router_w.shape[-1])), top_k)
        jax.debug.callback(lambda a, b: seen.append(
            (np.asarray(a), np.asarray(b), top_k, C)), x, router_w,
            ordered=True)
        return real(x, router_w, *w, top_k=top_k,
                    capacity_factor=capacity_factor)
    monkeypatch.setattr(JL, "moe_ffn", spy)
    return seen


def _jax_routes(ref_calls):
    """`compare.routes` of the JAX package's calls, by its own dispatch."""
    jax.effects_barrier()
    out = []
    for jx, jr, k, C in ref_calls:
        _, idx, dest, _, keep, _, _ = _jax_routing(jnp.asarray(jx), jr, k,
                                                   C)
        x = np.asarray(jx, np.float32)
        out.append(tuple(_t(np.asarray(a)) for a in (
            x, idx, dest, keep, x @ np.asarray(jr, np.float32))))
    return out


def _assert_same_routing(port_calls, ref_calls, n_calls):
    port, ref = routes(port_calls), _jax_routes(ref_calls)
    assert len(port) == len(ref) == n_calls
    for n, (a, b) in enumerate(zip(port, ref)):
        for name, x, y in zip(("idx", "dest", "keep"), a[1:4], b[1:4]):
            np.testing.assert_array_equal(x.numpy(), y.numpy(),
                                          err_msg=f"{name} of MoE call {n}")


def _flip_case(case):
    """Two runs' routes of one MoE call, or two, in which the router is
    the identity (d = E = 8, k = 2), so the router input is the logits:
    the `want` run's token 0 ties experts 1 and 2 within one bf16 ulp."""
    x = torch.from_numpy(np.random.default_rng(0).uniform(
        -1, 1, (1, 16, 8)).astype(np.float32)).to(torch.bfloat16)
    x[0, 0] = torch.tensor([1.5, 0.5, 0.49609375] + [-1.0] * 5)
    w = torch.eye(8)
    y, v = x.clone(), w.clone()
    if case != "equal":
        y[0, 0, 1:3] = x[0, 0, [2, 1]]     # swapped: token 0 flips
    if case == "inputs off":
        y = (y.float() + 0.2).to(torch.bfloat16)
    if case == "logits off":
        v[2, 2] = 1.5                         # router inputs equal
    calls = [[(y, v, 2, 4)], [(x, w, 2, 4)]]
    if case == "later calls off":
        z = torch.from_numpy(np.random.default_rng(1).uniform(
            -1, 1, (1, 16, 8)).astype(np.float32)).to(torch.bfloat16)
        calls[0].append((z, w, 2, 4))
        calls[1].append((x, w, 2, 4))
    return routes(calls[0]), routes(calls[1])


@pytest.mark.parametrize("case,holds", [
    ("equal", True), ("one flip", True), ("later calls off", True),
    ("inputs off", False), ("logits off", False)])
def test_routing_flips_rule(case, holds):
    """`compare.routing_flips`: routing equal; one flip within rounding;
    calls after the first flip not held; router inputs apart by more
    than 8 bf16 ulps, or a flip's logits by more than 8 bf16 ulps of the
    call's largest, refused."""
    got, want = _flip_case(case)
    if not holds:
        with pytest.raises(AssertionError):
            routing_flips(got, want)
        return
    report = routing_flips(got, want)
    assert report.first == (None if case == "equal" else 0)
    assert [f[:3] for f in report.flips if f[0] == 0] == (
        [] if case == "equal" else [(0, 0, 0)])
    assert report.input_ulps <= 1.0
    if case == "later calls off":
        assert any(f[0] == 1 for f in report.flips)


def _model_pair_run(arch, aux_rtol):
    """Forward, prefill and 4 decode steps of reduced `arch` in both
    packages on the same tokens, the forward's aux held within
    `aux_rtol` (the dropped fraction within 1e-7: the same drops, averaged
    in another order); returns [(port logits, JAX logits)]."""
    jcfg, jp, cfg, tp = _pair(arch)
    B, S, W = 2, 11, 32
    toks = _tokens(B, S, cfg.vocab_size)
    out = []
    jfwd, jpre, jdec = _jax_fns(jcfg)
    want, jaux = jfwd(jp, {"tokens": jnp.asarray(toks)})
    got, aux = models.forward(cfg, tp, {"tokens": _t(toks)}, impl="ref")
    out.append((got, want))
    for key in jaux:
        np.testing.assert_allclose(
            _np(aux[key]), _np(jaux[key]),
            **({"atol": 1e-7, "rtol": 0} if key == "dropped_frac"
               else {"atol": 0, "rtol": aux_rtol}))
    jl, js, _ = jpre(jp, {"tokens": jnp.asarray(toks)}, W)
    tl, ts, _ = models.prefill(cfg, tp, {"tokens": _t(toks)}, W, impl="ref")
    out.append((tl, jl))
    nxt = _tokens(B, 4, cfg.vocab_size, seed=2)
    for t in range(4):
        pos = np.full(B, S + t, np.int32)
        jd, js = jdec(jp, js, jnp.asarray(nxt[:, t]), jnp.asarray(pos))
        td, ts = models.decode_step(cfg, tp, ts, _t(nxt[:, t]), _t(pos))
        out.append((td, jd))
        np.testing.assert_array_equal(ts["pos"].numpy(),
                                      np.asarray(js["pos"]))
    return out


@pytest.mark.parametrize("arch", MOE)
@pytest.mark.parametrize("compute", ["fp32", "bf16"])
def test_moe_models_match_jax(monkeypatch, arch, compute):
    if compute == "fp32":
        _fp32(monkeypatch)
    ref = _spy_jax_router_inputs(monkeypatch)
    with RouterTap() as port:
        pairs = _model_pair_run(arch, 1e-5 if compute == "fp32" else 1e-3)
    n_layers = reduced(ARCHS[arch]).n_layers
    # forward, prefill, 4 decode steps: one MoE call a layer each
    _assert_same_routing(port.calls, ref, 6 * n_layers)
    for got, want in pairs:
        assert got.shape == want.shape
        if compute == "fp32":
            assert got.dtype == torch.float32
            assert_f32_close(got, want)
        else:
            assert got.dtype == torch.bfloat16
            assert_bf16_close(got, want, ulps=8)


@pytest.mark.parametrize("compute", ["fp32", "bf16"])
def test_hubert_encoder_matches_jax(monkeypatch, compute):
    if compute == "fp32":
        _fp32(monkeypatch)
    jcfg, jp, cfg, tp = _pair(HUBERT)
    assert cfg.encoder_only and not cfg.causal
    frames = _embeddings(2, 40, cfg.d_model)
    want, _ = _jax_fns(jcfg)[0](jp, {"frame_embeddings": frames})
    got, aux = models.forward(cfg, tp, {"frame_embeddings": _t(frames)},
                              impl="ref")
    assert got.shape == (2, 40, cfg.vocab_size)
    if compute == "fp32":
        assert_f32_close(got, want)
    else:
        assert_bf16_close(got, want, ulps=8)
    assert float(aux["load_balance"]) == 0.0
    # no rope and no causal mask: reversing the frames reverses the output
    rev, _ = models.forward(cfg, tp, {"frame_embeddings": _t(
        frames[:, ::-1].copy())}, impl="ref")
    assert_f32_close(rev.flip(1), got, 1e-5 if compute == "fp32" else 2e-2)


def test_hubert_has_no_decode_path():
    _, _, cfg, tp = _pair(HUBERT)
    batch = {"frame_embeddings": _t(_embeddings(1, 8, cfg.d_model))}
    with pytest.raises(ValueError, match="encoder-only"):
        models.prefill(cfg, tp, batch, 16)
    with pytest.raises(ValueError, match="encoder-only"):
        models.init_decode_state(cfg, 1, 16)
    with pytest.raises(ValueError, match="encoder-only"):
        ServingEngine(cfg, tp, ServeConfig(max_seq_len=16, batch_size=1),
                      device="cpu")


@pytest.mark.parametrize("compute", ["fp32", "bf16"])
def test_llava_matches_jax(monkeypatch, compute):
    """Forward, and a prefill of 16 patches and 60 text tokens (past the
    reduced window of 64, so the rolling cache wraps) with 4 decode
    steps after it."""
    if compute == "fp32":
        _fp32(monkeypatch)
    jcfg, jp, cfg, tp = _pair(LLAVA)
    assert cfg.attn_window == 64 and cfg.n_image_patches == 16
    P, S, B = cfg.n_image_patches, 60, 2

    def close(got, want):
        if compute == "fp32":
            assert_f32_close(got, want)
        else:
            assert_bf16_close(got, want, ulps=8)

    toks = _tokens(B, S, cfg.vocab_size, seed=3)
    patches = _embeddings(B, P, cfg.d_model, seed=3)
    jbatch = {"tokens": jnp.asarray(toks), "patch_embeddings": patches}
    tbatch = {"tokens": _t(toks), "patch_embeddings": _t(patches)}
    jfwd, jpre, jdec = _jax_fns(jcfg)
    want, _ = jfwd(jp, jbatch)
    got, _ = models.forward(cfg, tp, tbatch, impl="ref")
    assert got.shape == (B, P + S, cfg.vocab_size)
    close(got, want)
    jl, js, _ = jpre(jp, jbatch, 128)
    tl, ts, _ = models.prefill(cfg, tp, tbatch, 128, impl="ref")
    close(tl, jl)
    assert ts["k"].shape[2] == 64
    np.testing.assert_array_equal(ts["pos"].numpy(), np.asarray(js["pos"]))
    assert int(ts["pos"].max()) == P + S - 1
    nxt = _tokens(B, 4, cfg.vocab_size, seed=4)
    for t in range(4):
        pos = np.full(B, P + S + t, np.int32)
        jd, js = jdec(jp, js, jnp.asarray(nxt[:, t]), jnp.asarray(pos))
        td, ts = models.decode_step(cfg, tp, ts, _t(nxt[:, t]), _t(pos))
        close(td, jd)
        np.testing.assert_array_equal(ts["pos"].numpy(),
                                      np.asarray(js["pos"]))


# ----------------------------------------------------------------------
# the trainer

def _train_both(arch, steps, global_batch=4, seq_len=32):
    """`steps` train steps of reduced `arch` in both packages from the JAX
    package's params on the modality's synthetic batches; returns ((params,
    opt, metrics) port, (params, opt, metrics) JAX)."""
    jcfg, jp, cfg, tp = _pair(arch)
    tcfg = dict(total_steps=10, warmup_steps=1, remat=False)
    jstep = jax.jit(jax_make_train_step(jcfg, JaxTrainConfig(
        optimizer=JaxAdamWConfig(learning_rate=LR), **tcfg)))
    tstep = make_train_step(cfg, TrainConfig(
        optimizer=AdamWConfig(learning_rate=LR), **tcfg))
    jds = JaxDataset(jcfg, JaxDataConfig(seq_len=seq_len,
                                         global_batch=global_batch))
    ds = SyntheticTokenDataset(cfg, DataConfig(seq_len=seq_len,
                                               global_batch=global_batch))
    po, oo = jp, jax_adamw_init(jp)
    pt, ot = tp, adamw_init(tp)
    for s in range(steps):
        jb, tb = jds.batch(s), ds.batch(s)
        assert jb.keys() == tb.keys()
        for key in jb:
            np.testing.assert_array_equal(jb[key], tb[key])
        po, oo, jm = jstep(po, oo, jnp.int32(s),
                           {k: jnp.asarray(v) for k, v in jb.items()})
        pt, ot, tm = tstep(pt, ot, torch.tensor(s, dtype=torch.int32),
                           {k: _t(v) for k, v in tb.items()})
    assert set(tm) == set(jm)
    return (pt, ot, tm), (po, oo, jm)


def _assert_trained_alike(port, ref):
    (pt, ot, tm), (po, oo, jm) = port, ref
    for key in ("loss", "nll", "load_balance", "dropped_frac"):
        np.testing.assert_allclose(float(tm[key]), float(jm[key]),
                                   rtol=1e-5, atol=1e-7)
    for got, want in zip(tree_flatten(ot["m"])[0], jax.tree.leaves(oo["m"])):
        np.testing.assert_allclose(_np(got), np.asarray(want), rtol=0,
                                   atol=1e-7)
    for got, want in zip(tree_flatten(pt)[0], jax.tree.leaves(po)):
        np.testing.assert_allclose(_np(got), np.asarray(want), rtol=0,
                                   atol=5e-5)
    for got, want in zip(tree_flatten(ot["v"])[0], jax.tree.leaves(oo["v"])):
        want = np.asarray(want)
        np.testing.assert_allclose(_np(got), want, rtol=0,
                                   atol=0.02 * float(np.abs(want).max()))


def test_moe_train_steps_match_jax(monkeypatch):
    """Two steps of reduced olmoe in fp32 compute: the router terms of
    the loss carry gradients into the router, as the reference's do."""
    _fp32(monkeypatch)
    port, ref = _train_both("olmoe-1b-7b", 2)
    _assert_trained_alike(port, ref)
    (_, ot, tm) = port
    assert float(tm["load_balance"]) > 0
    assert float(ot["m"]["block"]["router"].abs().max()) > 0


@pytest.mark.parametrize("arch", [HUBERT, LLAVA])
def test_audio_and_vlm_train_steps_match_jax(monkeypatch, arch):
    """Two steps of reduced hubert (per-frame labels) and llava (the text
    after the patches) in fp32 compute.  hubert's untied `embed` is in no
    path of its loss: its gradient and moments are 0 in both packages,
    and AdamW's weight decay still moves it (step 1; step 0's lr is 0),
    as JAX's does."""
    _fp32(monkeypatch)
    port, ref = _train_both(arch, 2)
    _assert_trained_alike(port, ref)
    if arch == HUBERT:
        (pt, ot, _), (po, oo, _) = port, ref
        for opt in (ot, oo):
            assert not np.asarray(_np(opt["m"]["embed"])).any()
            assert not np.asarray(_np(opt["v"]["embed"])).any()
        start = _pair(HUBERT)[1]["embed"]
        moved = _np(pt["embed"]) - start
        assert np.abs(moved).max() > 0
        np.testing.assert_allclose(_np(pt["embed"]), np.asarray(po["embed"]),
                                   rtol=1e-6, atol=0)


# ----------------------------------------------------------------------
# LMFederation with an MoE model, and the serving launcher

def _first_step_routing(monkeypatch, jf, start):
    """Both packages' router inputs of each institution's first local
    batch of the reference harness `jf`, from its starting params
    `start` (the forward alone)."""
    ref = _spy_jax_router_inputs(monkeypatch)
    toks = np.asarray(jf._round_batches(0))[0]           # (P, B, S)
    cfg = reduced(ARCHS[jf.cfg.name.removesuffix("-reduced")])
    jfwd = _jax_fns(jf.cfg)[0]
    with RouterTap() as port:
        for i in range(jf.P):
            p = jax.tree.map(lambda a: a[i], start)
            jfwd(p, {"tokens": jnp.asarray(toks[i])})
            models.forward(cfg, params_from_jax(p), {"tokens": _t(toks[i])},
                           impl="ref")
    return port.calls, ref


def test_moe_federation_round_matches_jax(monkeypatch):
    """One round of reduced olmoe in `LMFederation` (P = 3, vmap(grad)
    through the routing) against the reference harness, from its params,
    in fp32 compute."""
    _fp32(monkeypatch)
    arch = "olmoe-1b-7b"
    jf = JaxLMFederation(jax_reduced(JAX_ARCHS[arch]), seed=0)
    start = jax.device_get(jf.stacked)
    jm, jtrs = jf.run_rounds(1)
    tf = LMFederation(reduced(ARCHS[arch]), seed=0,
                      stacked=params_from_jax(start), device="cpu")
    tm, ttrs = tf.run_rounds(1)
    assert [t.committed for t in ttrs] == [t.committed for t in jtrs] == [
        True]
    np.testing.assert_allclose(_np(tm["loss"]), _np(jm["loss"]), rtol=1e-5)
    jleaves = jax.tree.leaves(jax.device_get(jf.stacked))
    tleaves = tree_flatten(tf.stacked)[0]
    assert len(jleaves) == len(tleaves)
    for a, b in zip(tleaves, jleaves):
        np.testing.assert_allclose(_np(a), _np(b), rtol=0, atol=1e-6)
    assert float((tf.stacked["block"]["router"]
                  - _t(start["block"]["router"])).abs().max()) > 0.01
    port, ref = _first_step_routing(monkeypatch, jf, start)
    _assert_same_routing(port, ref, tf.P * tf.cfg.n_layers)


def test_moe_federation_bf16_flips_within_rounding(monkeypatch):
    """The federation's first batches in bf16 compute: tokens flip to
    another expert, each within the router logits' rounding, held
    institution by institution by `compare.routing_flips` (see the
    module docstring)."""
    jf = JaxLMFederation(jax_reduced(JAX_ARCHS["olmoe-1b-7b"]), seed=0)
    port, ref = _first_step_routing(monkeypatch, jf,
                                    jax.device_get(jf.stacked))
    port, ref, n = routes(port), _jax_routes(ref), jf.cfg.n_layers
    assert len(port) == len(ref) == jf.P * n
    reports = [routing_flips(port[i:i + n], ref[i:i + n])
               for i in range(0, len(ref), n)]
    for r in reports:
        print(r.note())
    assert any(r.flips for r in reports), "seed 0 shows bf16 routing flips"


def _reference_served(monkeypatch, argv):
    """The reference launcher's finished requests."""
    done = []
    real = jax_serve.ServingEngine.run

    def run(self, *a, **kw):
        done.extend(real(self, *a, **kw))
        return done
    monkeypatch.setattr(jax_serve.ServingEngine, "run", run)
    jax_serve.main(argv)
    return done


def test_serve_launcher_matches_jax(monkeypatch):
    """`launch.serve.main` on reduced olmoe, with the JAX package's params
    carried in through `initial_params`, serves the reference launcher's
    greedy tokens, in fp32 compute (the reference engine's jitted steps,
    cached by config, are traced afresh for it)."""
    _fp32(monkeypatch)
    monkeypatch.setattr(jax_engine, "_STEP_CACHE", {})
    monkeypatch.setattr(jax_engine, "_PREFILL_CACHE", {})
    argv = ["--arch", "olmoe-1b-7b", "--reduced"]
    want = _reference_served(monkeypatch, argv)
    jp = _pair("olmoe-1b-7b")[1]
    monkeypatch.setattr(serve, "initial_params",
                        lambda cfg, dev: params_from_jax(jp, dev))
    got = serve.main(argv + ["--device", "cpu"])
    assert len(got) == len(want) == 8
    assert [(r.uid, r.prompt, r.generated) for r in got] == [
        (r.uid, r.prompt, r.generated) for r in want]


def test_serve_launcher_refuses_encoder_only_and_defaults_to_cuda(
        monkeypatch):
    for main in (jax_serve.main, serve.main):
        with pytest.raises(SystemExit, match="encoder-only"):
            main(["--arch", HUBERT, "--reduced"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--reduced", "--requests", "1"])


def test_moe_decode_groups_the_whole_batch(monkeypatch):
    """A one-token decode routes the batch as one group (its capacity
    counts every slot, empty ones too), a prefill one group a sequence."""
    cfg = dataclasses.replace(reduced(ARCHS["dbrx-132b"]), n_layers=1)
    tp = models.init_params(cfg, torch.Generator().manual_seed(0))
    shapes = []
    real = L.moe_ffn

    def spy(x, *a, **kw):
        shapes.append(tuple(x.shape))
        return real(x, *a, **kw)
    monkeypatch.setattr(L, "moe_ffn", spy)
    toks = _t(_tokens(3, 5, cfg.vocab_size))
    _, st, _ = models.prefill(cfg, tp, {"tokens": toks}, 16, impl="ref")
    models.decode_step(cfg, tp, st, toks[:, 0],
                       torch.full((3,), 5, dtype=torch.int32))
    assert shapes == [(3, 5, cfg.d_model), (1, 3, cfg.d_model)]
