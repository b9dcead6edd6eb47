"""The port's dense LM stack (configs, layers, transformer) held against
the JAX package on the CPU, on the same inputs: numpy-seeded activations
and the JAX package's own initialised params carried across with
`params_from_jax`.

Tolerances, stated per comparison:
  * exact: configs and param counts, spec shapes and ``str(treedef)``,
    fingerprints of identical bytes, cache positions, `cache_update`;
  * fp32 elementwise layers (norms, rope at theta up to 1e6): atol = rtol
    = 1e-5 (cos / sin / rsqrt from different libraries, an ulp apart);
  * fp32 attention: atol = rtol = 2e-5 (the flash kernel tests' bound);
  * bf16 (the models' COMPUTE_DTYPE): XLA and PyTorch round bf16 matmuls
    at different places, so a value may land some bf16 ulps away; held to
    4 ulps of the largest magnitude compared (atol = 4 * 2^(e - 7) for
    2^e <= max |x| < 2^(e+1), rtol = 0).
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import models as jax_models
from repro.configs import ARCHS as JAX_ARCHS
from repro.configs import reduced as jax_reduced
from repro.core.registry import fingerprint_pytree as jax_fingerprint
from repro.models import layers as JL
from repro_torch import models
from repro_torch.configs import ARCHS, get_config, reduced
from repro_torch.convert import params_from_jax
from repro_torch.core.registry import fingerprint_pytree
from repro_torch.models import layers as L
from repro_torch.pytree import tree_flatten, treedef_str
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

LM_ARCHS = ["qwen3-0.6b", "smollm-360m"]
QWEN3_TREEDEF = (
    "PyTreeDef({'block': {'attn_norm': *, 'ffn_norm': *, 'k_norm': *, "
    "'q_norm': *, 'wi_gate': *, 'wi_up': *, 'wk': *, 'wo': *, 'wo_ffn': *, "
    "'wq': *, 'wv': *}, 'embed': *, 'final_norm': *})")


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def assert_bf16_close(got, want, ulps=4):
    got, want = _np(got), _np(want)
    atol = ulps * 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
    np.testing.assert_allclose(got, want, atol=atol, rtol=0)


def assert_f32_close(got, want, tol=1e-5):
    np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=tol)


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
# configs and param trees: exact

@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_configs_and_param_counts_match_jax(arch):
    cfg, jcfg = get_config(arch), JAX_ARCHS[arch]
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert dataclasses.asdict(reduced(cfg)) == dataclasses.asdict(
        jax_reduced(jcfg))
    assert cfg.param_count() == jcfg.param_count()
    assert cfg.active_param_count() == jcfg.active_param_count()
    assert models.param_count(cfg) == jax_models.param_count(jcfg)


def test_qwen3_param_tree_matches_jax_at_full_width():
    cfg, jcfg = get_config("qwen3-0.6b"), JAX_ARCHS["qwen3-0.6b"]
    specs = models.param_specs(cfg)
    abstract = jax_models.abstract_params(jcfg)
    leaves, spec = tree_flatten(specs)
    assert treedef_str(spec) == str(jax.tree.structure(abstract)) \
        == QWEN3_TREEDEF
    assert [s.shape for s in leaves] == [
        x.shape for x in jax.tree.leaves(abstract)]
    assert models.param_count(cfg) == 596_049_920


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_fingerprint_of_identical_bytes_equals_jax(arch):
    _, jp, _, tp = _pair(arch)
    assert fingerprint_pytree(tp) == jax_fingerprint(jp)
    assert treedef_str(tree_flatten(tp)[1]) == str(jax.tree.structure(jp))


def test_init_params_follow_the_specs():
    cfg = reduced(ARCHS["qwen3-0.6b"])
    p = models.init_params(cfg, torch.Generator().manual_seed(0))
    leaves = tree_flatten(p)[0]
    specs = tree_flatten(models.param_specs(cfg))[0]
    assert [tuple(x.shape) for x in leaves] == [s.shape for s in specs]
    assert all(x.dtype == L.PARAM_DTYPE for x in leaves)
    assert bool((p["final_norm"] == 1).all())
    std = float(p["block"]["wq"].std())
    assert abs(std - 1 / np.sqrt(cfg.d_model)) < 0.1 / np.sqrt(cfg.d_model)


# ----------------------------------------------------------------------
# layers

def test_norms_match_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 3, 32)).astype(np.float32) * 3
    w = rng.standard_normal(32).astype(np.float32)
    assert_f32_close(L.rms_norm(_t(x), _t(w)), JL.rms_norm(x, w))
    assert_f32_close(L.head_rms_norm(_t(x), _t(w), 1e-6),
                     JL.head_rms_norm(x, w, 1e-6))
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    got = L.rms_norm(_t(np.asarray(xb, np.float32), torch.bfloat16), _t(w))
    assert got.dtype == torch.bfloat16
    assert_bf16_close(got, JL.rms_norm(xb, w), ulps=1)


@pytest.mark.parametrize("style,theta", [("full", 1e6), ("full", 1e4),
                                         ("half", 1e4)])
def test_apply_rope_matches_jax(style, theta):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 64, 4, 128)).astype(np.float32)
    pos = np.stack([np.arange(64), np.arange(1000, 1064)]).astype(np.int32)
    assert_f32_close(L.rope_frequencies(128, theta, style),
                     JL.rope_frequencies(128, theta, style))
    # angles reach ~1e3 rad, where fp32 cos/sin of two libraries differ
    # by an ulp of the angle's reduction: held at 1e-5 of the O(1) values
    assert_f32_close(L.apply_rope(_t(x), _t(pos), theta, style),
                     JL.apply_rope(x, pos, theta, style))


def _qkv(B, Sq, Skv, Hq, Hkv, hd, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, Sq, Hq, hd)).astype(np.float32),
            rng.standard_normal((B, Skv, Hkv, hd)).astype(np.float32),
            rng.standard_normal((B, Skv, Hkv, hd)).astype(np.float32))


@pytest.mark.parametrize("causal,window", [(True, 0), (True, 5),
                                           (False, 0)])
def test_mha_reference_matches_jax(causal, window):
    q, k, v = _qkv(2, 12, 12, 6, 2, 16)
    rng = np.random.default_rng(3)
    qp = rng.integers(0, 20, (2, 12)).astype(np.int32)
    kp = rng.integers(-1, 20, (2, 12)).astype(np.int32)
    kvm = kp >= 0
    want = JL.mha_reference(q, k, v, causal=causal, window=window,
                            q_positions=qp, kv_positions=kp, kv_mask=kvm)
    got = L.mha_reference(_t(q), _t(k), _t(v), causal=causal, window=window,
                          q_positions=_t(qp), kv_positions=_t(kp),
                          kv_mask=_t(kvm))
    assert_f32_close(got, want, 2e-5)


@pytest.mark.parametrize("window", [0, 24])
def test_mha_chunked_matches_jax(window):
    q, k, v = _qkv(1, 132, 132, 4, 2, 32, seed=4)
    want = JL.mha_chunked(q, k, v, causal=True, window=window, q_chunk=32,
                          kv_chunk=64)
    got = L.mha_chunked(_t(q), _t(k), _t(v), causal=True, window=window,
                        q_chunk=32, kv_chunk=64)
    assert_f32_close(got, want, 2e-5)
    assert_f32_close(got, L.mha_reference(_t(q), _t(k), _t(v),
                                          window=window), 2e-5)


def test_attention_dispatch_on_the_cpu():
    q, k, v = map(_t, _qkv(1, 16, 16, 4, 2, 32, seed=5))
    ref = L.attention(q, k, v, impl="ref")
    for impl in ("auto", "pallas", "fused", "chunked"):
        assert_f32_close(L.attention(q, k, v, impl=impl), ref, 2e-5)
    with pytest.raises(ValueError, match="unknown attention impl"):
        L.attention(q, k, v, impl="sdpa")


def test_decode_attention_and_cache_update_match_jax():
    B, W, Hq, Hkv, hd = 2, 8, 4, 2, 32
    rng = np.random.default_rng(6)
    bf = jnp.bfloat16
    kc = jnp.asarray(rng.standard_normal((B, W, Hkv, hd)), bf)
    vc = jnp.asarray(rng.standard_normal((B, W, Hkv, hd)), bf)
    pc = jnp.asarray(np.array([[0, 1, 2, -1, -1, -1, -1, -1],
                               [8, 9, 2, 3, 4, 5, 6, 7]], np.int32))
    kn = jnp.asarray(rng.standard_normal((B, 1, Hkv, hd)), bf)
    vn = jnp.asarray(rng.standard_normal((B, 1, Hkv, hd)), bf)
    pos = jnp.asarray(np.array([3, 10], np.int32))
    tb = lambda x: _t(np.asarray(x, np.float32), torch.bfloat16)  # noqa
    jk, jv, jpc = JL.cache_update(kc, vc, pc, kn, vn, pos)
    tk, tv, tpc = L.cache_update(tb(kc), tb(vc), _t(pc), tb(kn), tb(vn),
                                 _t(pos))
    np.testing.assert_array_equal(_np(tk), _np(jk))
    np.testing.assert_array_equal(_np(tv), _np(jv))
    np.testing.assert_array_equal(tpc.numpy(), np.asarray(jpc))
    q = jnp.asarray(rng.standard_normal((B, 1, Hq, hd)), bf)
    want = JL.decode_attention(q, jk, jv, jpc)
    got = L.decode_attention(tb(q), tk, tv, tpc)
    assert got.dtype == torch.bfloat16
    assert_bf16_close(got, want, ulps=2)


def test_ffn_swiglu_matches_jax():
    rng = np.random.default_rng(7)
    x = jnp.asarray(rng.standard_normal((2, 5, 64)), jnp.bfloat16)
    w = [rng.standard_normal(s).astype(np.float32) / 8
         for s in ((64, 128), (64, 128), (128, 64))]
    want = JL.ffn_swiglu(x, *w)
    got = L.ffn_swiglu(_t(np.asarray(x, np.float32), torch.bfloat16),
                       *map(_t, w))
    assert_bf16_close(got, want)


# ----------------------------------------------------------------------
# models (reduced qwen3 and smollm)

@pytest.mark.parametrize("arch", LM_ARCHS)
def test_forward_matches_jax(arch):
    jcfg, jp, cfg, tp = _pair(arch)
    toks = _tokens(2, 11, cfg.vocab_size)
    want, _ = jax_models.forward(jcfg, jp, {"tokens": jnp.asarray(toks)},
                                 impl="ref")
    got, aux = models.forward(cfg, tp, {"tokens": _t(toks)}, impl="ref")
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    assert_bf16_close(got, want)
    assert float(aux["load_balance"]) == 0.0


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_prefill_and_chained_decode_match_jax(arch):
    jcfg, jp, cfg, tp = _pair(arch)
    B, S, W = 2, 9, 16
    toks = _tokens(B, S, cfg.vocab_size, seed=1)
    jl, js, _ = jax_models.prefill(jcfg, jp, {"tokens": jnp.asarray(toks)},
                                   W, impl="ref")
    tl, ts, _ = models.prefill(cfg, tp, {"tokens": _t(toks)}, W, impl="ref")
    assert_bf16_close(tl, jl)
    np.testing.assert_array_equal(ts["pos"].numpy(), np.asarray(js["pos"]))
    for key in ("k", "v"):
        assert ts[key].dtype == torch.bfloat16
        assert_bf16_close(ts[key], js[key])
    nxt = _tokens(B, 4, cfg.vocab_size, seed=2)
    for t in range(4):
        pos = np.full(B, S + t, np.int32)
        jd, js = jax_models.decode_step(jcfg, jp, js, jnp.asarray(nxt[:, t]),
                                        jnp.asarray(pos))
        td, ts = models.decode_step(cfg, tp, ts, _t(nxt[:, t]), _t(pos))
        assert_bf16_close(td, jd)
        np.testing.assert_array_equal(ts["pos"].numpy(),
                                      np.asarray(js["pos"]))


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_prefill_state_matches_chained_decode(arch):
    """Port-internal, as the reference's test_prefill.py: the prefill
    state equals chained decode within its 5e-2 bound."""
    _, _, cfg, tp = _pair(arch)
    B, S = 2, 9
    toks = _t((np.arange(B * S).reshape(B, S) % 60 + 1).astype(np.int32))
    lg_p, state, _ = models.prefill(cfg, tp, {"tokens": toks}, 32,
                                    impl="ref")
    st = models.init_decode_state(cfg, B, 32)
    for t in range(S):
        lg_c, st = models.decode_step(cfg, tp, st, toks[:, t],
                                      torch.full((B,), t, dtype=torch.int32))
    np.testing.assert_allclose(_np(lg_p[:, -1]), _np(lg_c), atol=5e-2,
                               rtol=5e-2)
    nxt = torch.full((B,), 7, dtype=torch.int32)
    pos = torch.full((B,), S, dtype=torch.int32)
    a, _ = models.decode_step(cfg, tp, state, nxt, pos)
    b, _ = models.decode_step(cfg, tp, st, nxt, pos)
    np.testing.assert_allclose(_np(a), _np(b), atol=5e-2, rtol=5e-2)


def test_prefill_rolling_window_keeps_tail():
    """Prompt longer than the window: the cache holds exactly the last W
    positions at their rolling slots, as in the reference."""
    jcfg, jp, cfg, tp = _pair("smollm-360m")
    jcfg = dataclasses.replace(jcfg, attn_window=4)
    cfg = dataclasses.replace(cfg, attn_window=4)
    toks = (np.arange(10, dtype=np.int32)[None] % 60) + 1
    _, js, _ = jax_models.prefill(jcfg, jp, {"tokens": jnp.asarray(toks)},
                                  32, impl="ref")
    _, ts, _ = models.prefill(cfg, tp, {"tokens": _t(toks)}, 32, impl="ref")
    assert ts["k"].shape[2] == 4
    np.testing.assert_array_equal(ts["pos"].numpy(), np.asarray(js["pos"]))
    assert sorted(ts["pos"][0, 0].tolist()) == [6, 7, 8, 9]
    assert_bf16_close(ts["k"], js["k"])
