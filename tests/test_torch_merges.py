"""The port's merge strategies held against the JAX package's on the same
numpy inputs.

Exact: the gossip shift schedule, the re-stitched ring's indices, the
quantized merge's int8 operands (P = 128 too, where the accumulator
widens to int32), the trimmed mean's windows and the coordinate median at
alpha 1 (inputs whose sums are exact), the norm gate's accept set (inputs
with margin from the gate), block-schedule rows, block assignment by leaf
path, shared views, partial merges' pass-through leaves (the same tensor
objects) and the full-selection partial merge's chain digest (equal to
its inner merge's).

Within atol = rtol = 1e-6: every float merge on (P, 37) and (P, 3, 5)
leaves at P = 5 and 8, masked and unmasked, alpha 1 and 0.7.  XLA and
PyTorch sum the institution axis in other orders, and a mean of P = 5 may
divide by 5 or multiply by 0.2.

Within loss rtol = 1e-4 and params atol = 1e-4 (the federation tests'
bounds, tests/test_torch_federation.py): a P = 5, width 0.25, 16x16
CNNFederation for 3 rounds under ring, trimmed_mean with sign_flip_30,
and partial (backbone merged by the mean, personal heads).  Inside the
port, eager and batched runs of those are bit-identical.
"""
import dataclasses
import json
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.chaos import attack_scenarios as jax_attack_scenarios
from repro.chaos.harness import CNNFederation as JaxFederation
from repro.core.merges import BlockSchedule as JaxBlockSchedule
from repro.core.merges import BlockSpec as JaxBlockSpec
from repro.core.merges import MergeContext as JaxContext
from repro.core.merges import get_merge as jax_get_merge
from repro.core.merges import gossip_shift as jax_gossip_shift
from repro.core.merges import ring_neighbor_indices as jax_ring_neighbors
from repro.core.merges.toolkit import mask_nd as jax_mask_nd
from repro.core.merges.toolkit import masked_abs_max as jax_masked_abs_max
from repro.core.overlay import DecentralizedOverlay as JaxOverlay
from repro.core.overlay import OverlayConfig as JaxOverlayConfig
from repro.core.registry import ModelRegistry as JaxRegistry
from repro_torch import random as prng
from repro_torch.chaos import attack_scenarios
from repro_torch.chaos.harness import CNNFederation
from repro_torch.convert import params_from_jax
from repro_torch.core import stack_params, unstack_params
from repro_torch.core.merges import (
    BlockSchedule, BlockSpec, MergeContext, available_merges, get_merge,
    gossip_shift, ring_neighbor_indices,
)
from repro_torch.core.merges.strategies import quantize_leaf
from repro_torch.core.overlay import DecentralizedOverlay, OverlayConfig
from repro_torch.core.registry import ModelRegistry
from repro_torch.pytree import tree_flatten
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

FLOAT_MERGES = ["ring", "hierarchical", "quantized", "trimmed_mean",
                "coordinate_median", "norm_gated_mean"]


def _tree(P, seed, dead=()):
    """{"a": (P, 37), "b": [(P, 3, 5)]} f32 rows from `seed`; row 1 scaled
    10x (the norm gate rejects it with margin); dead rows hold inf and
    NaN."""
    rng = np.random.default_rng([seed, P])
    tree = {"a": rng.standard_normal((P, 37)).astype(np.float32),
            "b": [rng.standard_normal((P, 3, 5)).astype(np.float32)]}
    for leaf in (tree["a"], tree["b"][0]):
        leaf[1] *= 10.0
        for d, bad in zip(dead, (np.inf, np.nan)):
            leaf[d] = bad
    return tree


def _mask(P, dead):
    m = np.ones(P, bool)
    m[list(dead)] = False
    return m


def _contexts(P, mask, alpha, commit, **kw):
    kw = dict(commit=commit, alpha=alpha, group_size=5 if P == 5 else 2,
              shift=2, n_institutions=P, **kw)
    return (JaxContext(mask=None if mask is None else jnp.asarray(mask),
                       **kw),
            MergeContext(mask=None if mask is None
                         else torch.from_numpy(mask), **kw))


def _run_both(name, tree, jctx, tctx):
    want = jax_get_merge(name).merge(jax.tree.map(jnp.asarray, tree), jctx)
    got = get_merge(name).merge(params_from_jax(tree), tctx)
    return ([x.numpy() for x in tree_flatten(got)[0]],
            [np.asarray(x) for x in jax.tree.leaves(want)])


def test_registry_resolves_the_ported_merges():
    assert set(available_merges()) >= {
        "mean", "secure_mean", "ring", "hierarchical", "quantized",
        "trimmed_mean", "coordinate_median", "norm_gated_mean", "partial"}


# ----------------------------------------------------------------------
# schedules and indices: exact

def test_gossip_shift_sequences_equal():
    for P in range(1, 13):
        assert [gossip_shift(r, P) for r in range(40)] == \
            [int(jax_gossip_shift(r, P)) for r in range(40)]


@pytest.mark.parametrize("P", [1, 2, 5, 8, 13])
def test_ring_neighbor_indices_equal_on_random_masks(P):
    rng = np.random.default_rng(P)
    masks = [np.ones(P, bool), np.zeros(P, bool)] + [
        rng.random(P) < 0.6 for _ in range(12)]
    for m in masks:
        for shift in range(P + 2):
            got = ring_neighbor_indices(torch.from_numpy(m), shift)
            want = jax_ring_neighbors(jnp.asarray(m), shift)
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ----------------------------------------------------------------------
# the float merges: within 1e-6, and a rejected round bit-untouched

@pytest.mark.parametrize("alpha", [1.0, 0.7])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("P", [5, 8])
@pytest.mark.parametrize("name", FLOAT_MERGES)
def test_float_merges_match_jax(name, P, masked, alpha):
    dead = (0, P - 2) if masked else ()
    tree = _tree(P, 3, dead)
    mask = _mask(P, dead) if masked else None
    got, want = _run_both(name, tree, *_contexts(P, mask, alpha, True))
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_allclose(a, b, atol=1e-6, rtol=1e-6)
    for d in dead:    # dead rows pass through bit for bit
        for a, leaf in zip(got, [tree["a"], tree["b"][0]]):
            assert a[d].tobytes() == leaf[d].tobytes()
    # a rejected round: both hand the rows back bit-untouched
    got, want = _run_both(name, tree, *_contexts(P, mask, alpha, False))
    for a, b, leaf in zip(got, want, [tree["a"], tree["b"][0]]):
        assert a.tobytes() == b.tobytes() == leaf.tobytes()


# ----------------------------------------------------------------------
# exact parts of the float merges

def _jax_int8_operands(x, m, bits=8):
    """The JAX quantized merge's wire operands, in its own expressions
    (repro/core/merges/strategies.py:quantized_mean_merge)."""
    P = x.shape[0]
    qmax = max((2 ** (bits - 1) - 1) // P, 1)
    mb = None if m is None else jax_mask_nd(m, x).astype(bool)
    absx_max = jnp.abs(x).max() if m is None else jax_masked_abs_max(x, mb)
    scale = jnp.maximum(absx_max, 1e-12) / qmax
    q = jnp.clip(jnp.round(x / scale), -qmax, qmax).astype(jnp.int8)
    return q if m is None else jnp.where(mb, q, jnp.int8(0))


@pytest.mark.parametrize("P", [5, 8, 127, 128])
def test_quantized_int8_operands_exact(P):
    rng = np.random.default_rng(P)
    x = rng.standard_normal((P, 37)).astype(np.float32)
    for m in (None, rng.random(P) < 0.7):
        tm = None if m is None else torch.from_numpy(m)
        q, _ = quantize_leaf(torch.from_numpy(x), None if m is None else
                             tm.reshape(P, 1).expand(P, 37))
        want = _jax_int8_operands(jnp.asarray(x),
                                  None if m is None else jnp.asarray(m))
        assert q.dtype == torch.int8
        np.testing.assert_array_equal(q.numpy(), np.asarray(want))
        got, want = _run_both("quantized", {"w": x},
                              *_contexts(P, m, 1.0, True))
        np.testing.assert_allclose(got[0], want[0], atol=1e-6, rtol=1e-6)


def test_quantized_p128_widens_the_accumulator():
    """128 rows of +1 quantize to q = +1 each: an int8 sum would wrap to
    -128; both packages' int32 accumulator keeps the mean exactly 1."""
    got, want = _run_both("quantized", {"w": np.ones((128, 4), np.float32)},
                          *_contexts(128, None, 1.0, True))
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[0], 1.0)


@pytest.mark.parametrize("masked", [False, True])
def test_trimmed_mean_windows_exact(masked):
    """Small integers, so every window sum is exact, and windows of 4
    rows (P = 8, trim 0.25: 2 dropped at each end; with 2 dead rows, 1 of
    6 at each end), so the mean is exact in any order."""
    P = 8
    rng = np.random.default_rng(11)
    tree = {"w": rng.integers(-8, 9, (P, 41)).astype(np.float32)}
    mask = _mask(P, (2, 5)) if masked else None
    got, want = _run_both("trimmed_mean", tree,
                          *_contexts(P, mask, 1.0, True))
    np.testing.assert_array_equal(got[0], want[0])


@pytest.mark.parametrize("P", [5, 8])
@pytest.mark.parametrize("masked", [False, True])
def test_coordinate_median_at_alpha_1_bit_equal(P, masked):
    dead = (0, P - 2) if masked else ()
    got, want = _run_both("coordinate_median", _tree(P, 5, dead),
                          *_contexts(P, _mask(P, dead) if masked else None,
                                     1.0, True))
    for a, b in zip(got, want):
        assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize("masked", [False, True])
def test_norm_gate_accept_set_equal(masked):
    """Row 1 holds 10x the others' norm, far past the gate (3x the median)
    and the rest far inside it: at alpha 0.5 an accepted row moves halfway
    to the gated mean and a rejected one becomes it, so both packages
    accept the same rows exactly when these agree."""
    P = 8
    dead = (0, 6) if masked else ()
    tree = _tree(P, 9, dead)
    mask = _mask(P, dead) if masked else None
    got, want = _run_both("norm_gated_mean", tree,
                          *_contexts(P, mask, 0.5, True))
    accepted = [p for p in range(P) if p not in dead and p != 1]
    for a, b, leaf in zip(got, want, [tree["a"], tree["b"][0]]):
        agg = leaf[accepted].mean(axis=0)
        for out in (a, b):
            np.testing.assert_allclose(out[1], agg, atol=1e-5)
            np.testing.assert_allclose(out[accepted],
                                       leaf[accepted] + 0.5 * (
                                           agg - leaf[accepted]), atol=1e-5)


# ----------------------------------------------------------------------
# block specs, schedules and the partial merge

def _cnn_like(P=3):
    rng = np.random.default_rng(0)
    return {"conv": [{"w": rng.standard_normal((P, 3, 2)).astype(np.float32),
                      "b": rng.standard_normal((P, 2)).astype(np.float32)}
                     for _ in range(2)],
            "head": {"w": rng.standard_normal((P, 4, 2)).astype(np.float32),
                     "b": rng.standard_normal((P, 2)).astype(np.float32)}}


SPECS = [
    (lambda m: m.BlockSpec.by_prefix(backbone="conv", head="head")),
    (lambda m: m.BlockSpec.by_prefix(default="rest", first=("conv/0",))),
    (lambda m: m.BlockSpec(rules=(("biases", lambda p: p.endswith("/b")),),
                           default="weights")),
]


PORT = SimpleNamespace(BlockSpec=BlockSpec, BlockSchedule=BlockSchedule)
REF = SimpleNamespace(BlockSpec=JaxBlockSpec, BlockSchedule=JaxBlockSchedule)


@pytest.mark.parametrize("make", SPECS)
def test_leaf_blocks_and_shared_views_equal(make):
    tree = _cnn_like()
    ours, theirs = make(PORT), make(REF)
    assert ours.block_names == theirs.block_names
    assert ours.leaf_blocks(tree) == theirs.leaf_blocks(tree)
    for blocks in [ours.block_names[:1], ours.block_names]:
        assert ours.covers(tree, blocks) == theirs.covers(tree, blocks)
        a, b = ours.select_tree(tree, blocks), theirs.select_tree(tree,
                                                                  blocks)
        assert (a is tree) == (b is tree)
        if a is not tree:
            assert list(a) == list(b)
            assert all(a[k] is b[k] for k in a)


def test_block_spec_errors_equal():
    tree = _cnn_like()
    for mods in (PORT, REF):
        with pytest.raises(ValueError, match="matches no BlockSpec rule"):
            mods.BlockSpec.by_prefix(backbone="conv").leaf_blocks(tree)
        with pytest.raises(ValueError, match="duplicate block name"):
            mods.BlockSpec(rules=(("a", ("x",)), ("a", ("y",))))
        with pytest.raises(ValueError, match="non-empty"):
            mods.BlockSchedule(groups=((),))


def test_block_schedule_mask_rows_equal():
    for make in SPECS:
        ours, theirs = make(PORT), make(REF)
        names = ours.block_names
        for sched in (lambda m: m.BlockSchedule.round_robin(names),
                      lambda m: m.BlockSchedule(groups=(names, names[:1]))):
            a, b = sched(PORT), sched(REF)
            for r in range(7):
                assert a.active(r) == b.active(r)
                np.testing.assert_array_equal(a.mask_row(ours, r),
                                              b.mask_row(theirs, r))


@pytest.mark.parametrize("scheduled", [False, True])
def test_partial_merge_passes_unselected_leaves_through(scheduled):
    """The head is personal: its leaves come back as the very tensors that
    went in; the backbone equals JAX's partial merge within 1e-6, and with
    a schedule whose round turns the backbone off it comes back too."""
    P = 3
    tree = _cnn_like(P)
    spec_kw = dict(blocks=("backbone",), inner_merge="mean")
    for r in range(2 if scheduled else 1):
        ours = BlockSpec.by_prefix(backbone="conv", head="head")
        theirs = JaxBlockSpec.by_prefix(backbone="conv", head="head")
        sched = (BlockSchedule(groups=(("backbone",), ("head",)))
                 if scheduled else None)
        bm = None if sched is None else sched.mask_row(ours, r)
        stacked = params_from_jax(tree)
        got = get_merge("partial").merge(stacked, MergeContext(
            block_spec=ours, block_mask=bm, n_institutions=P, **spec_kw))
        want = jax_get_merge("partial").merge(
            jax.tree.map(jnp.asarray, tree), JaxContext(
                block_spec=theirs, n_institutions=P,
                block_mask=None if bm is None else jnp.asarray(bm),
                **spec_kw))
        for k in ("w", "b"):
            assert got["head"][k] is stacked["head"][k]
        for layer, jl, sl in zip(got["conv"], want["conv"], stacked["conv"]):
            for k in ("w", "b"):
                np.testing.assert_allclose(layer[k].numpy(),
                                           np.asarray(jl[k]), atol=1e-6)
                if bm is not None and not bm[0]:
                    assert layer[k] is sl[k]


def _merge_only_chain(merge, **cfg):
    """Two merge-only rounds of a P = 4 overlay on fixed rows: the chain's
    head digest and its transactions."""
    tree = _cnn_like(4)
    ov = DecentralizedOverlay(
        OverlayConfig(n_institutions=4, merge=merge, **cfg),
        registry=ModelRegistry(logical_clock=True))
    state = params_from_jax(tree)
    for rnd in range(2):
        state, _ = ov.merge_phase(state, prng.PRNGKey(rnd))
    return ov.registry


@pytest.mark.parametrize("inner", ["mean", "secure_mean"])
def test_full_selection_partial_digest_equals_inner_merge(inner):
    spec = BlockSpec.by_prefix(backbone="conv", head="head")
    inner_chain = _merge_only_chain(inner)
    full = _merge_only_chain("partial", block_spec=spec, inner_merge=inner)
    assert full.chain[-1].hash() == inner_chain.chain[-1].hash()
    assert full.merkle_root() == inner_chain.merkle_root()
    # a real selection attests the shared view and says so
    part = _merge_only_chain("partial", block_spec=spec, inner_merge=inner,
                             merge_blocks=("backbone",))
    meta = json.loads(part.chain[-1].metadata)
    assert meta["merge"] == "partial" and meta["blocks"] == {
        "inner": inner, "shared": ["backbone"], "merged": ["backbone"]}
    assert part.verify_log()


def test_partial_registrations_attest_the_shared_view_like_jax():
    """A merge-only partial round: every survivor registers the bytes it
    holds, so the shared views' fingerprints, the metadata and the
    attested blocks equal the JAX package's."""
    tree = _cnn_like(4)
    cfg = dict(n_institutions=4, merge="partial", inner_merge="mean",
               merge_blocks=("backbone",), arch_family="cnn")
    theirs = JaxOverlay(JaxOverlayConfig(
        **cfg, merge_subtree=None,
        block_spec=JaxBlockSpec.by_prefix(backbone="conv", head="head")),
        registry=JaxRegistry(logical_clock=True))
    ours = DecentralizedOverlay(OverlayConfig(
        **cfg, block_spec=BlockSpec.by_prefix(backbone="conv", head="head")),
        registry=ModelRegistry(logical_clock=True))
    theirs.merge_phase(jax.tree.map(jnp.asarray, tree), jax.random.PRNGKey(0))
    ours.merge_phase(params_from_jax(tree), prng.PRNGKey(0))
    regs = [(a, b) for a, b in zip(ours.registry.chain, theirs.registry.chain)
            if a.kind == "register"]
    assert len(regs) == 4
    assert all(a.model_fingerprint == b.model_fingerprint for a, b in regs)
    assert _metadata(ours) == _metadata(theirs)


def test_overlay_validates_partial_config_like_jax():
    spec = BlockSpec.by_prefix(backbone="conv", head="head")
    bad = [dict(merge="partial", inner_merge="partial"),
           dict(merge="partial", merge_blocks=("backbone",)),
           dict(merge="partial", block_spec=spec, merge_blocks=("nope",)),
           dict(merge="partial", block_spec=spec, merge_blocks=("backbone",),
                block_schedule=BlockSchedule.round_robin(("head",))),
           dict(merge="mean", block_spec=spec)]
    for kw in bad:
        with pytest.raises(ValueError):
            DecentralizedOverlay(OverlayConfig(n_institutions=4, **kw))
    with pytest.raises(ValueError, match="divisible by group_size"):
        get_merge("hierarchical").merge(
            params_from_jax(_cnn_like(3)), MergeContext(group_size=2))


def test_stack_and_unstack_params_round_trip():
    rows = unstack_params(params_from_jax(_cnn_like(3)), 3)
    assert len(rows) == 3 and rows[1]["head"]["w"].shape == (4, 2)
    again = stack_params(rows)
    for a, b in zip(tree_flatten(again)[0],
                    tree_flatten(params_from_jax(_cnn_like(3)))[0]):
        assert torch.equal(a, b)


# ----------------------------------------------------------------------
# the CNN federation under the new merges against JAX

P_FED, ROUNDS = 5, 3


def _knobs(case, port):
    scen = attack_scenarios(0) if port else jax_attack_scenarios(0)
    spec = BlockSpec if port else JaxBlockSpec
    return {"ring": dict(merge="ring"),
            "trimmed_mean": dict(merge="trimmed_mean", trim_fraction=0.34,
                                 attack_schedule=scen["sign_flip_30"]),
            "partial": dict(merge="partial", inner_merge="mean",
                            block_spec=spec.by_prefix(backbone="conv",
                                                      head="head"),
                            merge_blocks=("backbone",))}[case]


def _metadata(overlay):
    return [{k: v for k, v in json.loads(tx.metadata).items()
             if k != "ledger_root"}
            for tx in overlay.registry.chain
            if tx.kind == "rolling_update"]


@pytest.mark.parametrize("case", ["ring", "trimmed_mean", "partial"])
def test_federation_matches_jax(case):
    jf = JaxFederation(None, 0, n_institutions=P_FED, **_knobs(case, False))
    tf = CNNFederation(None, 0, n_institutions=P_FED, device="cpu",
                       stacked=params_from_jax(jax.device_get(jf.stacked)),
                       **_knobs(case, True))
    jm, jtrs = jf.run_rounds(ROUNDS)
    tm, ttrs = tf.run_rounds(ROUNDS)
    for a, b in zip(ttrs, jtrs):
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
    assert _metadata(tf.overlay) == _metadata(jf.overlay)
    np.testing.assert_allclose(tm["loss"].numpy(), np.asarray(jm["loss"]),
                               rtol=1e-4)
    for a, b in zip(tree_flatten(tf.stacked)[0], jax.tree.leaves(jf.stacked)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4,
                                   rtol=0)
    assert tf.overlay.registry.verify_log()
    if case == "partial":
        # personal heads: every hospital's head differs from the others'
        head = tf.stacked["head"]["w"]
        assert not torch.equal(head[0], head[1])
        np.testing.assert_allclose(
            tf.per_institution_eval(16)["loss"],
            jf.per_institution_eval(16)["loss"], rtol=1e-4)


@pytest.mark.parametrize("case", ["ring", "trimmed_mean", "partial"])
def test_eager_equals_run_rounds(case):
    kw = dict(n_institutions=P_FED, device="cpu", **_knobs(case, True))
    eager, batched = CNNFederation(None, 0, **kw), CNNFederation(None, 0,
                                                                 **kw)
    losses = [eager.run_round(r)[0]["loss"] for r in range(ROUNDS)]
    metrics, _ = batched.run_rounds(ROUNDS)
    assert torch.equal(torch.stack(losses), metrics["loss"])
    for a, b in zip(tree_flatten(eager.stacked)[0],
                    tree_flatten(batched.stacked)[0]):
        assert torch.equal(a, b)
    assert eager.chain_digest() == batched.chain_digest()


def test_eval_batches_byte_identical():
    from repro.data import SyntheticGlendaDataset as JaxDataset
    from repro_torch.data.pipeline import SyntheticGlendaDataset
    kw = dict(image_size=16, n_samples=60, n_institutions=5, seed=3)
    ours, theirs = SyntheticGlendaDataset(**kw), JaxDataset(**kw)
    for seed in (0, 7):
        a, b = ours.eval_batches(9, seed=seed), theirs.eval_batches(9,
                                                                    seed=seed)
        assert a[0].tobytes() == b[0].tobytes()
        assert a[1].tobytes() == b[1].tobytes()
        assert ours.eval_batch(4, 2, seed)[0].tobytes() == \
            theirs.eval_batch(4, 2, seed)[0].tobytes()
