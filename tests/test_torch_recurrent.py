"""The port's recurrent families (rwkv6: ``ssm``, hymba: ``hybrid``) held
against the JAX package on the CPU, on the same inputs: numpy-seeded
tokens and the JAX package's own initialised params carried across with
`params_from_jax`; then the serve path on TINY_SERVE_SSM (federation,
verified pull, engine admission paths, hot-swap).

Tolerances, stated per comparison:
  * exact: param trees (``str(treedef)``, leaf shapes and order),
    parameter counts, fingerprints of identical bytes, cache positions,
    commit flags, the port's own determinism and hot-swap identity;
  * bf16 (the models' COMPUTE_DTYPE): logits, shift states and k/v caches
    within 8 bf16 ulps of the largest magnitude compared (atol = 8 *
    2^(e - 7) for 2^e <= max |x| < 2^(e+1), rtol = 0); the fp32 WKV and
    SSM states within the same atol.  The dense family is held to 4 ulps
    (test_torch_lm.py); these families need more because a bf16 value
    passes through more rounded elementwise stages per layer (rwkv6: five
    token-shift interpolations, a LoRA decay through exp(-exp(.)), a
    group norm, gates; hymba: two branches, each normalised, then
    averaged) and through an fp32 state that integrates every token's
    bf16 k·v or bx·B products, so a 1-ulp rounding difference between
    XLA and PyTorch reaches the logits through more steps (at 4 ulps the
    rwkv6 forward below fails).  In fp32 compute the same models agree
    within atol = rtol = 1e-4;
  * the TINY_SERVE_SSM federation round: per-institution loss within
    rtol 1e-2 (the dense round's bound in test_torch_serving.py: the loss
    is a bf16 value).  Its params are held in fp32 compute (both
    packages' COMPUTE_DTYPE set to float32), within atol = rtol = 1e-4:
    in bf16 the rwkv6 block is ill-conditioned at the first token, where
    the WKV output is a sum of products with u near 0 and the group norm
    (eps 1e-5) scales it up by up to 316x, so rounding at different
    places moves some gradients (u, wr, wk, wg, the embedding) far beyond
    bf16's relative precision, in either package;
  * prefill vs token-wise admission on TINY_SERVE_SSM: logits within the
    same 8-ulp bound, tokens equal up to the first near tie (top-two
    margin within twice the bound).  hymba's meta tokens exist only on
    the prefill path, so the A/B does not apply to it.
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import repro.models.layers as jax_layers
from repro import models as jax_models
from repro.configs import ARCHS as JAX_ARCHS
from repro.configs import reduced as jax_reduced
from repro.core.registry import fingerprint_pytree as jax_fingerprint
from repro.serving.harness import LMFederation as JaxLMFederation
from repro.serving.harness import TINY_SERVE_SSM as JAX_TINY_SERVE_SSM
from repro_torch import models
from repro_torch.configs import ARCHS, get_config, reduced
from repro_torch.convert import params_from_jax
from repro_torch.core.registry import fingerprint_pytree
from repro_torch.models import layers as L
from repro_torch.pytree import tree_flatten, treedef_str
from repro_torch.serving import (
    FederatedServer, ModelStore, Request, ServeConfig, ServingEngine,
    pull_latest_model,
)
from repro_torch.serving.harness import LMFederation, TINY_SERVE_SSM
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

ARCH_IDS = ["rwkv6-3b", "hymba-1.5b"]
ULPS = 8
RWKV6_TREEDEF = (
    "PyTreeDef({'block': {'decay_A': *, 'decay_B': *, 'ln1': *, 'ln2': *, "
    "'ln_x': *, 'mix_A': *, 'mix_B': *, 'mu_ck': *, 'mu_cr': *, "
    "'mu_rkvwg': *, 'mu_x': *, 'u': *, 'w0': *, 'w_ck': *, 'w_cr': *, "
    "'w_cv': *, 'wg': *, 'wk': *, 'wo': *, 'wr': *, 'wv': *}, 'embed': *, "
    "'final_norm': *, 'lm_head': *})")
HYMBA_TREEDEF = (
    "PyTreeDef({'block': {'a_log': *, 'attn_out_norm': *, 'd_skip': *, "
    "'dt_bias': *, 'ffn_norm': *, 'in_norm': *, 'in_proj': *, "
    "'ssm_out_norm': *, 'w_B': *, 'w_C': *, 'w_dt': *, 'wi_gate': *, "
    "'wi_up': *, 'wk': *, 'wo_attn': *, 'wo_ffn': *, 'wo_ssm': *, 'wq': *, "
    "'wv': *}, 'embed': *, 'final_norm': *, 'lm_head': *, "
    "'meta_tokens': *})")
FULL = {"rwkv6-3b": (RWKV6_TREEDEF, 3_099_609_600),
        "hymba-1.5b": (HYMBA_TREEDEF, 1_638_456_000)}
SCFG = ServeConfig(max_seq_len=48, batch_size=2)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _bf16_atol(want, ulps=ULPS):
    return ulps * 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)


def assert_bf16_close(got, want, ulps=ULPS):
    got, want = _np(got), _np(want)
    np.testing.assert_allclose(got, want, atol=_bf16_atol(want, ulps),
                               rtol=0)


def _t(x, dtype=None):
    t = torch.from_numpy(np.array(x))
    return t if dtype is None else t.to(dtype)


@functools.lru_cache(maxsize=None)
def _jax_params(arch):
    cfg = jax_reduced(JAX_ARCHS[arch])
    return cfg, jax.device_get(jax_models.init_params(
        cfg, jax.random.PRNGKey(0)))


def _pair(arch):
    jcfg, jp = _jax_params(arch)
    return jcfg, jp, reduced(ARCHS[arch]), params_from_jax(jp)


def _tokens(B, S, vocab, seed=0):
    return np.random.default_rng(seed).integers(1, vocab, (B, S)).astype(
        np.int32)


# ----------------------------------------------------------------------
# param trees: exact, at full width and reduced

@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_tree_matches_jax_at_full_width(arch):
    cfg, jcfg = get_config(arch), JAX_ARCHS[arch]
    specs = models.param_specs(cfg)
    abstract = jax_models.abstract_params(jcfg)
    leaves, spec = tree_flatten(specs)
    treedef, count = FULL[arch]
    assert treedef_str(spec) == str(jax.tree.structure(abstract)) == treedef
    assert [s.shape for s in leaves] == [
        x.shape for x in jax.tree.leaves(abstract)]
    assert models.param_count(cfg) == jax_models.param_count(jcfg) == count


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_params_from_jax_round_trip_in_jax_leaf_order(arch):
    _, jp, cfg, tp = _pair(arch)
    jleaves = jax.tree.leaves(jp)
    tleaves, spec = tree_flatten(tp)
    assert treedef_str(spec) == str(jax.tree.structure(jp))
    assert [tuple(x.shape) for x in tleaves] == [
        tuple(s.shape) for s in tree_flatten(models.param_specs(cfg))[0]]
    for a, b in zip(tleaves, jleaves):
        assert a.dtype == L.PARAM_DTYPE
        assert a.numpy().tobytes() == np.asarray(b).tobytes()
    assert fingerprint_pytree(tp) == jax_fingerprint(jp)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_init_params_follow_the_specs(arch):
    cfg = reduced(ARCHS[arch])
    p = models.init_params(cfg, torch.Generator().manual_seed(0))
    leaves = tree_flatten(p)[0]
    specs = tree_flatten(models.param_specs(cfg))[0]
    assert [tuple(x.shape) for x in leaves] == [s.shape for s in specs]
    assert all(x.dtype == L.PARAM_DTYPE for x in leaves)
    assert bool((p["final_norm"] == 1).all())


# ----------------------------------------------------------------------
# models (reduced rwkv6 and hymba) against the JAX package

@pytest.mark.parametrize("arch", ARCH_IDS)
@pytest.mark.parametrize("impl", ["ref", "auto"])
def test_forward_matches_jax(arch, impl):
    jcfg, jp, cfg, tp = _pair(arch)
    toks = _tokens(2, 11, cfg.vocab_size)
    want, _ = jax_models.forward(jcfg, jp, {"tokens": jnp.asarray(toks)},
                                 impl="ref")
    got, aux = models.forward(cfg, tp, {"tokens": _t(toks)}, impl=impl)
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    assert_bf16_close(got, want)
    assert float(aux["load_balance"]) == 0.0


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_prefill_and_chained_decode_match_jax(arch):
    jcfg, jp, cfg, tp = _pair(arch)
    B, S, W = 2, 9, 16
    toks = _tokens(B, S, cfg.vocab_size, seed=1)
    jl, js, _ = jax_models.prefill(jcfg, jp, {"tokens": jnp.asarray(toks)},
                                   W, impl="ref")
    tl, ts, _ = models.prefill(cfg, tp, {"tokens": _t(toks)}, W)
    assert_bf16_close(tl, jl)

    def check_state(ts, js):
        assert sorted(ts) == sorted(js)
        for key in ts:
            assert tuple(ts[key].shape) == tuple(js[key].shape), key
            if key == "pos":
                np.testing.assert_array_equal(ts[key].numpy(),
                                              np.asarray(js[key]))
            else:
                assert ts[key].dtype == getattr(torch, str(js[key].dtype))
                assert_bf16_close(ts[key], js[key])
    check_state(ts, js)
    nxt = _tokens(B, 4, cfg.vocab_size, seed=2)
    for t in range(4):
        pos = np.full(B, S + t, np.int32)
        jd, js = jax_models.decode_step(jcfg, jp, js, jnp.asarray(nxt[:, t]),
                                        jnp.asarray(pos))
        td, ts = models.decode_step(cfg, tp, ts, _t(nxt[:, t]), _t(pos))
        assert_bf16_close(td, jd)
        check_state(ts, js)


def test_hymba_prefill_keeps_the_meta_inclusive_tail():
    """The prompt plus 128 meta tokens exceeds the reduced window (64):
    the cache holds exactly the last W absolute positions at their
    rolling slots, and decode positions continue after them."""
    jcfg, jp, cfg, tp = _pair("hymba-1.5b")
    toks = _tokens(1, 10, cfg.vocab_size, seed=3)
    _, js, _ = jax_models.prefill(jcfg, jp, {"tokens": jnp.asarray(toks)},
                                  256, impl="ref")
    _, ts, _ = models.prefill(cfg, tp, {"tokens": _t(toks)}, 256)
    W = cfg.attn_window
    assert ts["k"].shape[2] == W
    np.testing.assert_array_equal(ts["pos"].numpy(), np.asarray(js["pos"]))
    assert sorted(ts["pos"][0, 0].tolist()) == list(range(138 - W, 138))
    _, st = models.decode_step(cfg, tp, ts, _t(toks[:, 0]),
                               torch.tensor([10], dtype=torch.int32))
    assert 138 in st["pos"][0, 0].tolist()


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_models_match_jax_in_fp32_compute(arch, monkeypatch):
    """The same forward and prefill with COMPUTE_DTYPE = float32 on both
    sides: the algorithms agree to fp32 rounding (atol = rtol = 1e-4)."""
    monkeypatch.setattr(jax_layers, "COMPUTE_DTYPE", jnp.float32)
    monkeypatch.setattr(L, "COMPUTE_DTYPE", torch.float32)
    jcfg, jp, cfg, tp = _pair(arch)
    toks = _tokens(2, 7, cfg.vocab_size, seed=4)
    jl, js, _ = jax_models.prefill(jcfg, jp, {"tokens": jnp.asarray(toks)},
                                   16, impl="ref")
    tl, ts, _ = models.prefill(cfg, tp, {"tokens": _t(toks)}, 16)
    assert tl.dtype == torch.float32
    np.testing.assert_allclose(_np(tl), _np(jl), atol=1e-4, rtol=1e-4)
    for key in ts:
        np.testing.assert_allclose(_np(ts[key]), _np(js[key]), atol=1e-4,
                                   rtol=1e-4)


# ----------------------------------------------------------------------
# the serve path on TINY_SERVE_SSM

def _fed_pair(rounds=1):
    jf = JaxLMFederation(JAX_TINY_SERVE_SSM, seed=0)
    start = jax.device_get(jf.stacked)
    jm, jtrs = jf.run_rounds(rounds)
    tf = LMFederation(TINY_SERVE_SSM, seed=0,
                      stacked=params_from_jax(start), device="cpu")
    tm, ttrs = tf.run_rounds(rounds)
    return jf, tf, jm, tm, jtrs, ttrs


def test_tiny_serve_ssm_config_equals_jax():
    ours = dataclasses.asdict(TINY_SERVE_SSM)
    theirs = dataclasses.asdict(JAX_TINY_SERVE_SSM)
    ours.pop("citation")
    theirs.pop("citation")
    assert ours == theirs


def test_federation_round_loss_matches_jax():
    jf, tf, jm, tm, jtrs, ttrs = _fed_pair()
    assert [t.committed for t in ttrs] == [t.committed for t in jtrs]
    np.testing.assert_allclose(_np(tm["loss"]), _np(jm["loss"]), rtol=1e-2)
    for x in tree_flatten(tf.stacked)[0]:
        assert bool(torch.isfinite(x).all())
    tx, jtx = (f.overlay.registry.chain for f in (tf, jf))
    assert [(t.kind, t.institution, t.arch_family) for t in tx] == [
        (t.kind, t.institution, t.arch_family) for t in jtx]


def test_federation_round_params_match_jax_in_fp32_compute(monkeypatch):
    monkeypatch.setattr(jax_layers, "COMPUTE_DTYPE", jnp.float32)
    monkeypatch.setattr(L, "COMPUTE_DTYPE", torch.float32)
    jf, tf, jm, tm, _, _ = _fed_pair()
    np.testing.assert_allclose(_np(tm["loss"]), _np(jm["loss"]), rtol=1e-5)
    jleaves = jax.tree.leaves(jax.device_get(jf.stacked))
    tleaves = tree_flatten(tf.stacked)[0]
    assert len(jleaves) == len(tleaves)
    for a, b in zip(tleaves, jleaves):
        np.testing.assert_allclose(_np(a), _np(b), atol=1e-4, rtol=1e-4)


@pytest.fixture(scope="module")
def served():
    """A TINY_SERVE_SSM federation after one round, published."""
    fed = LMFederation(TINY_SERVE_SSM, seed=1, device="cpu")
    fed.run_rounds(1)
    store = ModelStore()
    fed.publish(store)
    return fed, store


def _submit(eng, uids, tokens_each=5):
    for i in uids:
        eng.submit(Request(uid=i, prompt=[3 + (i % 7), 5, 9 + (i % 3)],
                           max_new_tokens=tokens_each))


def _gen(done):
    return {r.uid: r.generated for r in done}


def test_verified_pull_serves_the_committed_ssm_model(served):
    fed, store = served
    reg = fed.overlay.registry
    model = pull_latest_model(reg, store, arch_family=TINY_SERVE_SSM.name)
    assert model.fingerprint == fingerprint_pytree(model.params)
    assert model.parents_verified == len(model.tx.parents) > 0
    srv = FederatedServer(TINY_SERVE_SSM, reg, store, SCFG,
                          arch_family=TINY_SERVE_SSM.name, device="cpu")
    _submit(srv.engine, range(3))
    done = srv.engine.run()
    assert len(done) == 3 and all(len(r.generated) == 5 for r in done)
    assert all(r.params_version == srv.model.version for r in done)


def test_refresh_hot_swap_is_identical_to_a_fresh_engine():
    """Mid-traffic refresh() onto a newer committed round: no request is
    dropped, and the post-swap admissions are token-identical to a fresh
    engine on the new params."""
    fed = LMFederation(TINY_SERVE_SSM, seed=2, device="cpu")
    fed.run_rounds(1)
    store = ModelStore()
    fed.publish(store)
    srv = FederatedServer(TINY_SERVE_SSM, fed.overlay.registry, store, SCFG,
                          device="cpu")
    assert srv.refresh() is None              # nothing newer committed
    _submit(srv.engine, range(4))
    while srv.engine.tick < 3:
        srv.engine.step()
    fed.run_rounds(1)
    fed.publish(store)
    model = srv.refresh()
    assert model is not None
    _submit(srv.engine, range(4, 7))
    done = {r.uid: r for r in srv.engine.run()}
    assert len(done) == 7 and srv.engine.swap_log[0]["applied_tick"] > 0
    after = sorted(u for u, r in done.items()
                   if r.params_version == model.version)
    assert set(range(4, 7)) <= set(after)
    fresh = ServingEngine(TINY_SERVE_SSM, model.params, SCFG, device="cpu")
    _submit(fresh, after)
    want = _gen(fresh.run())
    assert all(done[u].generated == want[u] for u in after)


def _path_logits(cfg, params, prompt, gen, use_prefill):
    """Logits before each token of `gen`, teacher-forced through prefill
    admission or token-wise admission (decode steps from a fresh state)."""
    W = SCFG.max_seq_len
    if use_prefill:
        lg, st, _ = models.prefill(cfg, params,
                                   {"tokens": torch.tensor([prompt])}, W)
        out, start, seq = [_np(lg[0, -1])], len(prompt), gen[:-1]
    else:
        st = models.init_decode_state(cfg, 1, W)
        out, start, seq = [], 0, prompt + gen[:-1]
    for t, tok in enumerate(seq):
        lg, st = models.decode_step(cfg, params, st,
                                    torch.tensor([tok], dtype=torch.int32),
                                    torch.tensor([start + t],
                                                 dtype=torch.int32))
        if start + t >= len(prompt) - 1:
            out.append(_np(lg[0]))
    return out


def test_prefill_and_tokenwise_admission_agree_and_slots_are_hermetic(
        served):
    params = served[0].merged_params()
    gens = {}
    for use_prefill in (True, False):
        eng = ServingEngine(TINY_SERVE_SSM, params, SCFG,
                            use_prefill=use_prefill, device="cpu")
        _submit(eng, range(5), tokens_each=4)      # 5 requests, 2 slots
        done = eng.run()
        assert len(done) == 5
        gens[use_prefill] = _gen(done)
    for uid, gen in gens[True].items():
        prompt = [3 + (uid % 7), 5, 9 + (uid % 3)]
        a = _path_logits(TINY_SERVE_SSM, params, prompt, gen, True)
        b = _path_logits(TINY_SERVE_SSM, params, prompt, gen, False)
        clear = []
        for x, y in zip(a, b):
            atol = _bf16_atol(x)
            np.testing.assert_allclose(y, x, atol=atol, rtol=0)
            top2 = np.sort(x)[-2:]
            clear.append(top2[1] - top2[0] > 2 * atol)
        n = clear.index(False) if False in clear else len(clear)
        assert gens[False][uid][:n] == gen[:n]
    # a reused slot starts from a fresh recurrent state
    scfg = ServeConfig(max_seq_len=48, batch_size=1)
    eng = ServingEngine(TINY_SERVE_SSM, params, scfg, use_prefill=False,
                        device="cpu")
    _submit(eng, [0], tokens_each=6)
    eng.submit(Request(uid=1, prompt=[9, 8, 7], max_new_tokens=6))
    reused = _gen(eng.run())[1]
    fresh = ServingEngine(TINY_SERVE_SSM, params, scfg, use_prefill=False,
                          device="cpu")
    fresh.submit(Request(uid=1, prompt=[9, 8, 7], max_new_tokens=6))
    assert reused == _gen(fresh.run())[1]


def test_hymba_engine_serves_with_prefill_and_is_deterministic():
    """The reduced hymba through the engine: continuous batching over 2
    slots, prefill admission, the same streams on a second run."""
    cfg, p = reduced(ARCHS["hymba-1.5b"]), _pair("hymba-1.5b")[3]
    runs = []
    for _ in range(2):
        eng = ServingEngine(cfg, p, SCFG, device="cpu")
        _submit(eng, range(3), tokens_each=3)
        done = eng.run()
        assert len(done) == 3 and all(len(r.generated) == 3 for r in done)
        runs.append(_gen(done))
    assert runs[0] == runs[1]
