"""The port's device tier held against the JAX package.

Bit-exact: the tensor twins of the counter hash (against the numpy hash
and JAX's twins, counters at and past 2^31 and negative int32 included),
`DeviceSchedule.draw`, the per-device shards and updates, and
`device_sweep`'s limbs, stats and decoded means at every chunk size tested,
over chained sweeps with faults under both staleness bounds.  Inside the
port, the chunked sweep equals its per-device loop reference and its
stacked baseline bit for bit, and the overlay's eager rounds equal
`run_rounds`.  The float weighted institution merge sums in another order
than XLA may, so params after a merge are held within 1e-6; every integer
leaf of a two-tier federation's state is held bit-equal.
"""
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import checkpoint as jax_ckpt
from repro.chaos import rng as jax_rng
from repro.chaos.schedule import DeviceSchedule as JaxDeviceSchedule
from repro.core import device_tier as jdt
from repro.core.merges.strategies import (
    hierarchical_device_merge as jax_hd_merge,
)
from repro.core.overlay import DecentralizedOverlay as JaxOverlay
from repro.core.overlay import OverlayConfig as JaxOverlayConfig
from repro.data import pipeline as jpipe
from repro_torch import random as prng
from repro_torch.chaos import DeviceSchedule, rng
from repro_torch.checkpoint import latest_verified_snapshot
from repro_torch.convert import params_from_jax
from repro_torch.core import DecentralizedOverlay, OverlayConfig
from repro_torch.core.device_tier import (
    DeviceTierConfig, _decode_mean, _from_limbs, device_sweep,
    device_sweep_ids, device_sweep_reference, device_sweep_stacked,
    encode_update, make_device_local_step, make_device_state, zero_stale,
)
from repro_torch.core.merges import (
    get_merge, hierarchical_device_merge, mean_merge,
)
from repro_torch.data import (
    DeviceShardSpec, DirichletPartitioner, class_centroids,
    institution_class_mixes, make_centroid_pull_update, make_device_data_fn,
)
from repro_torch.pytree import tree_flatten
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

P = 4
SPEC_KW = dict(n_classes=4, n_features=6, min_samples=1, max_samples=9,
               pull_lr=0.05, seed=3)
SCHED_KW = dict(dropout_rate=0.25, straggler_rate=0.3, max_delay_s=2.0,
                deadline_s=1.0, seed=5)
SPEC, JSPEC = DeviceShardSpec(**SPEC_KW), jpipe.DeviceShardSpec(**SPEC_KW)
MIXES = institution_class_mixes(
    DirichletPartitioner(alpha=0.5, n_institutions=P, seed=1), 4)
JMIXES = jpipe.institution_class_mixes(
    jpipe.DirichletPartitioner(alpha=0.5, n_institutions=P, seed=1), 4)
DATA_FN, UPDATE_FN = make_device_data_fn(SPEC, MIXES), \
    make_centroid_pull_update(SPEC)
JDATA_FN, JUPDATE_FN = jpipe.make_device_data_fn(JSPEC, JMIXES), \
    jpipe.make_centroid_pull_update(JSPEC)
SCHED, JSCHED = DeviceSchedule(**SCHED_KW), JaxDeviceSchedule(**SCHED_KW)
BASE = np.linspace(-1.0, 1.0, 6, dtype=np.float32)
CHUNKS = (1, 7, 16, 60, 64)


def _cfg(mod, sched, **kw):
    base = dict(n_devices=60, chunk_size=16, clip=4.0, max_weight=16,
                staleness_bound=1, faults=sched)
    base.update(kw)
    return mod.DeviceTierConfig(**base)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.numpy()
    return np.asarray(x)


def _leaves_equal(a, b):
    la = tree_flatten(a)[0] if not isinstance(a, np.ndarray) else [a]
    lb = jax.tree.leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        x, y = _np(x), np.asarray(y)
        assert x.dtype == y.dtype, (x.dtype, y.dtype)
        np.testing.assert_array_equal(x, y)


# ----------------------------------------------------------------------
# the counter-hash twins, the device schedule and the shards

COUNTERS = [(0, (1, 2)), (7, (0xDE0D, 3, 99)), (123456, (42,)),
            (2 ** 31, (0, 0, 0)), (2 ** 32 - 1, (2 ** 31 + 5, 2 ** 32 - 1)),
            (5, (-3, -2 ** 31, 2 ** 31 - 1))]


@pytest.mark.parametrize("seed,counters", COUNTERS)
def test_hash_twins_bitequal_to_numpy_and_jax(seed, counters):
    u32 = [np.int64(c) & 0xFFFFFFFF for c in counters]
    host = rng.hash_u32(seed, *u32)
    jaxed = jax_rng.hash_u32_traced(
        jnp.uint32(seed), *[jnp.asarray(c, jnp.int32 if c < 2 ** 31
                                        else jnp.uint32) for c in counters])
    for ours in (rng.hash_u32_traced(seed, *counters),
                 rng.hash_u32_traced(torch.tensor(seed),
                                     *[torch.tensor(c) for c in counters])):
        assert ours.dtype == torch.int64
        assert int(ours) == int(host) == int(np.asarray(jaxed))
    uf = rng.uniform_traced(seed, *counters)
    assert uf.dtype == torch.float32
    assert uf.numpy() == np.float32(rng.uniform(seed, *u32)) == np.asarray(
        jax_rng.uniform_traced(jnp.uint32(seed), *[jnp.uint32(c)
                                                   for c in u32]))


def test_hash_twins_broadcast_random_counters():
    g = np.random.default_rng(0)
    ids = g.integers(-2 ** 31, 2 ** 31, 300, dtype=np.int64).astype(np.int32)
    for sweep, inst in [(0, 0), (3, 2 ** 31 + 7), (-1, 5)]:
        ours = rng.hash_u32_traced(9, 0x5A3F, torch.tensor(sweep),
                                   inst, torch.from_numpy(ids))
        theirs = jax_rng.hash_u32_traced(
            9, 0x5A3F, jnp.asarray(np.int64(sweep) & 0xFFFFFFFF, jnp.uint32),
            jnp.uint32(inst & 0xFFFFFFFF), jnp.asarray(ids))
        np.testing.assert_array_equal(ours.numpy(),
                                      np.asarray(theirs).astype(np.int64))
        host = rng.hash_u32(9, 0x5A3F, np.int64(sweep) & 0xFFFFFFFF, inst,
                            ids.astype(np.int64) & 0xFFFFFFFF)
        np.testing.assert_array_equal(ours.numpy(), host.astype(np.int64))
        uo = rng.uniform_traced(9, 1, torch.from_numpy(ids))
        np.testing.assert_array_equal(
            uo.numpy(), np.asarray(jax_rng.uniform_traced(
                9, 1, jnp.asarray(ids))))


def test_device_schedule_draw_equals_jax_and_host():
    ids = np.arange(257, dtype=np.int32)
    for sweep, inst in [(0, 0), (3, 1), (17, 6)]:
        on_t, late_t = SCHED.draw(torch.tensor(sweep, dtype=torch.int32),
                                  torch.tensor(inst, dtype=torch.int32),
                                  torch.from_numpy(ids))
        on_j, late_j = JSCHED.draw(jnp.uint32(sweep), jnp.uint32(inst),
                                   jnp.asarray(ids))
        on_h, late_h = SCHED.draw_host(sweep, inst, ids.astype(np.uint32))
        for ours, theirs, host in ((on_t, on_j, on_h),
                                   (late_t, late_j, late_h)):
            assert ours.dtype == torch.bool
            np.testing.assert_array_equal(ours.numpy(), np.asarray(theirs))
            np.testing.assert_array_equal(ours.numpy(), host)
        assert on_h.any() and late_h.any() and not (on_h & late_h).any()
    never = DeviceSchedule(straggler_rate=1.0)
    assert not never.draw(0, 0, torch.from_numpy(ids))[1].any()


def test_shards_and_updates_bitequal():
    np.testing.assert_array_equal(MIXES, JMIXES)
    np.testing.assert_array_equal(class_centroids(SPEC),
                                  jpipe.class_centroids(JSPEC))
    part = DirichletPartitioner(alpha=0.3, n_institutions=5, seed=2)
    np.testing.assert_array_equal(
        part.proportions(3),
        jpipe.DirichletPartitioner(alpha=0.3, n_institutions=5,
                                   seed=2).proportions(3))
    ids = np.arange(100, 300, dtype=np.int32)
    params = {"w": torch.from_numpy(BASE)}
    for sweep, inst in [(0, 0), (5, 3)]:
        batch, w = DATA_FN(torch.tensor(sweep, dtype=torch.int32),
                           torch.tensor(inst, dtype=torch.int32),
                           torch.from_numpy(ids))
        jbatch, jw = JDATA_FN(jnp.uint32(sweep), jnp.uint32(inst),
                              jnp.asarray(ids))
        assert batch["label"].dtype == torch.int32
        assert batch["pull"].dtype == torch.float32
        assert w.dtype == torch.int64
        _leaves_equal(batch, jbatch)
        np.testing.assert_array_equal(w.numpy(),
                                      np.asarray(jw).astype(np.int64))
        upd = torch.func.vmap(UPDATE_FN, in_dims=(None, 0))(params, batch)
        jupd = jax.vmap(lambda b: JUPDATE_FN({"w": jnp.asarray(BASE)},
                                             b))(jbatch)
        _leaves_equal(upd, jupd)
        np.testing.assert_array_equal(
            encode_update(upd["w"], _cfg(jdt, None)).numpy(),
            np.asarray(jdt.encode_update(jupd["w"], _cfg(jdt, None))))
    with pytest.raises(ValueError, match=r"class_mixes must be \(P, 4\)"):
        make_device_data_fn(SPEC, MIXES[:, :3])
    with pytest.raises(ValueError, match="min_samples <= max_samples"):
        DeviceShardSpec(min_samples=5, max_samples=2)


def test_decode_reads_the_high_limb_as_int32():
    lo = np.array([0, 1, 2 ** 32 - 1, 12345, 2 ** 31], np.uint32)
    hi = np.array([0, 2 ** 31, 2 ** 32 - 1, 7, 2 ** 31 + 3], np.uint32)
    for w in (0, 1, 37):
        ours = _decode_mean(torch.from_numpy(lo), torch.from_numpy(hi),
                            torch.tensor(w), 16)
        theirs = jdt._decode_mean(jnp.asarray(lo), jnp.asarray(hi),
                                  jnp.uint32(w), 16)
        np.testing.assert_array_equal(ours.numpy(), np.asarray(theirs))
    acc = _from_limbs(torch.from_numpy(lo), torch.from_numpy(hi))
    np.testing.assert_array_equal(
        acc.numpy(), (lo.astype(np.uint64)
                      | (hi.astype(np.uint64) << np.uint64(32))).view(
                          np.int64))


# ----------------------------------------------------------------------
# the sweep: limbs, stats and means equal to JAX's at every chunk size

_JAX_CHAINS = {}


def _jax_chain(chunk, bound, n_sweeps=3, inst=2):
    key = (chunk, bound)
    if key not in _JAX_CHAINS:
        cfg = _cfg(jdt, JSCHED, chunk_size=chunk, staleness_bound=bound)
        sweep = jax.jit(lambda p, s, st: jdt.device_sweep(
            p, s, jnp.uint32(inst), st, cfg, JDATA_FN, JUPDATE_FN))
        p = {"w": jnp.asarray(BASE)}
        stale, outs = jdt.zero_stale(p), []
        for s in range(n_sweeps):
            upd, stale, stats = sweep(p, jnp.uint32(s), stale)
            p = jax.tree.map(lambda a, b: a + b, p, upd)
            outs.append(jax.device_get((upd, stale, stats)))
        _JAX_CHAINS[key] = outs
    return _JAX_CHAINS[key]


def _port_chain(cfg, fn=device_sweep, n_sweeps=3, inst=2):
    p = {"w": torch.from_numpy(BASE)}
    stale, outs = zero_stale(p), []
    for s in range(n_sweeps):
        upd, stale, stats = fn(p, torch.tensor(s, dtype=torch.int32),
                               torch.tensor(inst, dtype=torch.int32), stale,
                               cfg, DATA_FN, UPDATE_FN)
        p = {"w": p["w"] + upd["w"]}
        outs.append((upd, stale, stats))
    return outs


def _chains_equal(ours, theirs):
    for (upd, stale, stats), (jupd, jstale, jstats) in zip(ours, theirs):
        _leaves_equal(upd, jupd)
        _leaves_equal(stale, jstale)
        _leaves_equal(stats, jstats)


@pytest.mark.parametrize("bound", [1, 0])
@pytest.mark.parametrize("chunk", CHUNKS)
def test_sweep_bitequal_to_jax(chunk, bound):
    ours = _port_chain(_cfg(jdt, SCHED, chunk_size=chunk,
                            staleness_bound=bound))
    _chains_equal(ours, _jax_chain(chunk, bound))
    stats = [s for _, _, s in ours]
    assert sum(int(s["late"]) for s in stats) > 0
    if bound == 1:
        assert int(ours[0][1]["w"]) > 0       # late devices banked
    else:
        assert all(int(st["w"]) == 0 for _, st, _ in ours)


@pytest.mark.parametrize("bound", [1, 0])
def test_sweep_equals_loop_reference_and_stacked(bound):
    cfg = _cfg(jdt, SCHED, chunk_size=7, staleness_bound=bound)
    chunked = _port_chain(cfg)
    loop = _port_chain(cfg, fn=lambda p, s, i, st, *a: device_sweep_reference(
        p, int(s), int(i), st, *a))
    stacked = _port_chain(cfg, fn=device_sweep_stacked)
    for other in (loop, stacked):
        for (u0, st0, s0), (u1, st1, s1) in zip(chunked, other):
            for a, b in zip(tree_flatten((u0, st0, s0))[0],
                            tree_flatten((u1, st1, s1))[0]):
                assert a.dtype == b.dtype
                assert torch.equal(a.to(torch.float64), b.to(torch.float64))
    # no faults: every device is on time, none late
    _, _, s = _port_chain(_cfg(jdt, None), n_sweeps=1)[0]
    assert int(s["on_time"]) == 60 and int(s["late"]) == 0


def test_sweep_copies_no_host_value_to_the_device(monkeypatch):
    """On the card a tensor built from a host value is a blocking copy
    that synchronizes the stream.  Once the shard tables sit on the
    device, a sweep (data and fault draws, encode, folds, decode) builds
    no tensor from a host value."""
    cfg = _cfg(jdt, SCHED, chunk_size=16)
    p = {"w": torch.from_numpy(BASE)}
    stale = zero_stale(p)
    sweep, inst = torch.tensor(1, dtype=torch.int32), torch.tensor(
        2, dtype=torch.int32)
    device_sweep(p, sweep, inst, stale, cfg, DATA_FN, UPDATE_FN)
    made = []
    for name in ("as_tensor", "tensor", "from_numpy"):
        def spy(x, *a, _real=getattr(torch, name), _name=name, **k):
            if not isinstance(x, torch.Tensor):
                made.append(_name)
            return _real(x, *a, **k)
        monkeypatch.setattr(torch, name, spy)
    device_sweep(p, sweep, inst, stale, cfg, DATA_FN, UPDATE_FN)
    assert made == []


def test_config_validation_messages_equal():
    bad = [dict(n_devices=0), dict(n_devices=10, chunk_size=0),
           dict(n_devices=10, chunk_size=65537),
           dict(n_devices=10, staleness_bound=2),
           dict(n_devices=10, max_weight=0),
           dict(n_devices=10, clip=1e6, max_weight=2 ** 16),
           dict(n_devices=2 ** 30, clip=1.0, frac_bits=4, max_weight=4)]
    for kw in bad:
        with pytest.raises(ValueError) as ours:
            DeviceTierConfig(**kw)
        with pytest.raises(ValueError) as theirs:
            jdt.DeviceTierConfig(**kw)
        assert str(ours.value) == str(theirs.value)
    assert DeviceTierConfig(n_devices=60, chunk_size=7).n_chunks == 9


# ----------------------------------------------------------------------
# the hierarchical_device merge

def test_hierarchical_device_merge():
    g = np.random.default_rng(1)
    x = g.standard_normal((P, 6)).astype(np.float32)
    xt = {"w": torch.from_numpy(x)}
    mask = np.array([True, False, True, True])
    # weights=None is mean_merge, bit for bit
    for m in (None, torch.from_numpy(mask)):
        a = hierarchical_device_merge(xt, True, mask=m)
        b = mean_merge(xt, True, mask=m)
        assert torch.equal(a["w"], b["w"])
    w = np.array([227, 212, 163, 180], np.uint32)
    for m in (None, mask):
        ours = hierarchical_device_merge(
            xt, True, weights=torch.from_numpy(w),
            mask=None if m is None else torch.from_numpy(m))
        theirs = jax_hd_merge({"w": jnp.asarray(x)}, True,
                              weights=jnp.asarray(w),
                              mask=None if m is None else jnp.asarray(m))
        np.testing.assert_allclose(ours["w"].numpy(),
                                   np.asarray(theirs["w"]), atol=1e-6)
        if m is not None:                       # dead rows pass through
            assert torch.equal(ours["w"][1], xt["w"][1])
    # a rejected round and all-zero weights are the identity
    for commit, ww in ((False, w), (True, np.zeros(P, np.uint32))):
        out = hierarchical_device_merge(xt, commit,
                                        weights=torch.from_numpy(ww))
        assert torch.equal(out["w"], xt["w"])
    assert get_merge("hierarchical_device") is not None


# ----------------------------------------------------------------------
# the two-tier federation through the overlay

R, LS = 3, 2
FED_CFG = dict(n_devices=50, chunk_size=16, clip=4.0, max_weight=16,
               staleness_bound=1)


def _overlay_cfg(port):
    if port:
        dev = DeviceTierConfig(**FED_CFG, faults=SCHED)
        cls = OverlayConfig
    else:
        dev = jdt.DeviceTierConfig(**FED_CFG, faults=JSCHED)
        cls = JaxOverlayConfig
    extra = {} if port else {"device_tier": dev}
    return cls(n_institutions=P, local_steps=LS,
               merge="hierarchical_device", merge_subtree="params",
               **extra), dev


@pytest.fixture(scope="module")
def jax_fed():
    ocfg, dev = _overlay_cfg(port=False)
    local_step = jdt.make_device_local_step(dev, JDATA_FN, JUPDATE_FN)
    state0 = jdt.make_device_state({"w": jnp.asarray(BASE)}, P)
    host0 = jax.device_get(state0)
    ov = JaxOverlay(ocfg)
    state, metrics, trs = ov.run_rounds(
        state0, jdt.device_sweep_ids(R, LS, P), local_step,
        jax.random.PRNGKey(0), R)
    return {"state0": host0, "state": jax.device_get(state),
            "metrics": jax.device_get(metrics), "overlay": ov}


def _port_fed(state0=None, eager=False):
    ocfg, dev = _overlay_cfg(port=True)
    local_step = make_device_local_step(dev, DATA_FN, UPDATE_FN)
    state = state0 if state0 is not None else make_device_state(
        {"w": torch.from_numpy(BASE)}, P)
    ov = DecentralizedOverlay(ocfg)
    ids = device_sweep_ids(R, LS, P)
    keys = prng.split(prng.PRNGKey(0), R)
    if eager:
        for r in range(R):
            state, _, _ = ov.round(state, ids[r], local_step, keys[r])
        return state, None, ov
    state, metrics, _ = ov.run_rounds(state, ids, local_step,
                                      prng.PRNGKey(0), R)
    return state, metrics, ov


def _state_matches(ours, theirs):
    """Integer leaves bit-equal (uint32 and int32 as in JAX); params within
    1e-6."""
    assert sorted(ours) == sorted(theirs)
    for k in ours:
        for a, b in zip(tree_flatten(ours[k])[0], jax.tree.leaves(theirs[k])):
            a, b = a.numpy(), np.asarray(b)
            assert a.dtype == b.dtype, (k, a.dtype, b.dtype)
            if k == "params":
                np.testing.assert_allclose(a, b, atol=1e-6, rtol=0)
            else:
                np.testing.assert_array_equal(a, b)


def test_two_tier_federation_matches_jax_and_eager(jax_fed):
    state, metrics, ov = _port_fed()
    _state_matches(state, jax_fed["state"])
    for k in ("device_on_time", "device_late", "device_weight"):
        assert metrics[k].shape == (R, P)
        np.testing.assert_array_equal(metrics[k].numpy(),
                                      jax_fed["metrics"][k])
    assert [s["n_survivors"] for s in ov.stats] == \
        [s["n_survivors"] for s in jax_fed["overlay"].stats]
    # the merge synchronized the institutions' models
    w = state["params"]["w"]
    assert all(torch.equal(w[0], w[i]) for i in range(P))
    eager, _, _ = _port_fed(eager=True)
    for a, b in zip(tree_flatten(eager)[0], tree_flatten(state)[0]):
        assert a.dtype == b.dtype
        assert torch.equal(a.to(torch.float64), b.to(torch.float64))
    # the ledger fingerprints the merged subtree alone, as JAX's does
    jtx = [tx for tx in jax_fed["overlay"].registry.chain
           if tx.kind == "register"]
    otx = [tx for tx in ov.registry.chain if tx.kind == "register"]
    assert [t.institution for t in otx] == [t.institution for t in jtx]
    assert ov.registry.verify_log()


def test_jax_device_state_runs_in_the_port(jax_fed, tmp_path):
    """A JAX-made device state carries across with its dtypes and runs,
    and the port's snapshot of the run writes the reference's dtypes,
    which the JAX package verifies and loads."""
    carried = params_from_jax(jax_fed["state0"])
    assert carried["stale_lo"]["w"].dtype == torch.uint32
    assert carried["inst"].dtype == torch.int32
    state, _, ov = _port_fed(state0=carried)
    _state_matches(state, jax_fed["state"])
    ov.snapshot(str(tmp_path), state)
    with open(os.path.join(str(tmp_path), f"round_{R:06d}",
                           "manifest.json")) as f:
        leaves = json.load(f)["leaves"]
    assert leaves["stale_lo/w"]["dtype"] == leaves["device_w"]["dtype"] \
        == "uint32" and leaves["inst"]["dtype"] == "int32"
    restored, snap, _, skipped = latest_verified_snapshot(
        str(tmp_path), state, cfg=ov.cfg)
    assert not skipped and snap.round_index == R
    for a, b in zip(tree_flatten(restored)[0], tree_flatten(state)[0]):
        assert a.dtype == b.dtype
        assert torch.equal(a.to(torch.float64), b.to(torch.float64))
    j_state, j_snap = jax_ckpt.load_snapshot(
        os.path.join(str(tmp_path), f"round_{R:06d}"), jax_fed["state"])
    assert j_snap.round_index == R
    _state_matches(state, jax.device_get(j_state))


def test_subtree_merge_keeps_other_leaves_local():
    """Only "params" is merged and fingerprinted; every other leaf of the
    state (optimizer moments, counters) keeps each institution's value bit
    for bit, in rounds that commit and under a dead institution."""
    from repro_torch.chaos import RoundFaults
    g = torch.Generator().manual_seed(3)
    state = {"params": {"w": torch.randn((P, 5), generator=g)},
             "opt": {"m": torch.randn((P, 5), generator=g),
                     "step": torch.arange(P, dtype=torch.int32)}}
    ov = DecentralizedOverlay(OverlayConfig(n_institutions=P, local_steps=1,
                                            merge="mean"))
    faults = RoundFaults(np.array([True, True, False, True]), np.zeros(P))
    for f in (None, faults):
        merged, tr = ov.merge_phase(state, prng.PRNGKey(0), faults=f)
        assert tr.committed
        for a, b in zip(tree_flatten(merged["opt"])[0],
                        tree_flatten(state["opt"])[0]):
            assert torch.equal(a, b)
        alive = [0, 1, 3] if f is not None else list(range(P))
        want = state["params"]["w"][alive].mean(dim=0)
        for i in alive:
            assert torch.allclose(merged["params"]["w"][i], want)
    assert torch.equal(merged["params"]["w"][2], state["params"]["w"][2])
    # without a subtree the whole (float) tree federates
    whole = DecentralizedOverlay(OverlayConfig(
        n_institutions=P, local_steps=1, merge="mean", merge_subtree=None))
    out, _ = whole.merge_phase({"params": state["params"],
                                "opt": {"m": state["opt"]["m"]}},
                               prng.PRNGKey(0))
    assert torch.allclose(out["opt"]["m"][0], state["opt"]["m"].mean(0))


def test_device_tier_config_rides_into_the_merge_context():
    """The device tier reaches a merge through the state alone: the
    round's "device_w" leaf rides into `MergeContext.device_weights`, and
    neither the overlay config nor the context carries the tier's config
    (the JAX package's `device_tier` / `donate_scan` fields have no reader
    in the port)."""
    seen = []

    class Spy:
        def merge(self, stacked, ctx):
            seen.append(ctx)
            return stacked
    from repro_torch.core.merges import base, register_merge
    register_merge("_device_spy")(Spy())
    try:
        ov = DecentralizedOverlay(OverlayConfig(
            n_institutions=P, merge="_device_spy"))
        state = make_device_state({"w": torch.zeros(3)}, P)
        state["device_w"] = torch.tensor([1, 2, 3, 4], dtype=torch.uint32)
        ov.merge_phase(state, prng.PRNGKey(0))
    finally:
        base._REGISTRY.pop("_device_spy")
    assert seen[0].device_weights is state["device_w"]
    for name in ("device", "device_tier", "donate_scan"):
        assert not hasattr(seen[0], name)
        assert not hasattr(OverlayConfig, name)
