"""The port's sharding rules (`repro_torch/sharding/api.py`), meshes
(`repro_torch/launch/mesh.py`) and the `force_impl` dispatch override,
against the JAX package's on the same inputs.

Specs compare element by element with the reference's ``PartitionSpec``;
a leaf's institution layout is ``Shard(dim)`` exactly where the
reference's `institution_spec` names the "inst" axis.  The reference's
mesh constructors are called with its `_make_mesh` replaced by a
recorder, so its choice of shape is compared without its devices.
"""
import threading

import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.distributed.tensor import Replicate, Shard

from repro.launch import mesh as jax_mesh
from repro.sharding import api as jax_api
from repro_torch.kernels.dp import ops as dp_ops
from repro_torch.kernels.secure_agg import ops as agg_ops
from repro_torch.launch import mesh as port_mesh
from repro_torch.sharding import api
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)


class _FakeMesh:
    def __init__(self, shape):
        self.shape = shape


def _rules(mod, multi=False):
    mesh = _FakeMesh({"pod": 2, "data": 16, "model": 16} if multi
                     else {"data": 16, "model": 16})
    return mod.LogicalRules(mod.MULTI_POD_RULES if multi
                            else mod.SINGLE_POD_RULES, mesh=mesh)


@pytest.mark.parametrize("name,dim", [("heads", 25), ("heads", 32),
                                      ("kv_heads", 8), ("mlp", 13696),
                                      ("vocab", 151936), ("embed", 1024),
                                      ("batch", 24), (None, 4)])
@pytest.mark.parametrize("multi", [False, True])
def test_resolve_guard_matches_reference(name, dim, multi):
    assert _rules(api, multi).resolve(name, dim) == \
        _rules(jax_api, multi).resolve(name, dim)


SPEC_CASES = [
    (("fsdp", "batch"), (64, 32), False),            # no duplicate axes
    (("batch", None, None), (256, 4096, 64), True),  # pod and data
    (("layers", "batch", "kv_seq", None, None), (32, 128, 32768, 8, 128),
     False),                                          # kv_seq
    (("batch", "heads", None), (8, 25, 64), False),  # the guard
    (("batch", "expert_batch"), (64, 64), True),
    ((), (), False),
]


@pytest.mark.parametrize("axes,shape,multi", SPEC_CASES)
def test_logical_spec_matches_reference(axes, shape, multi):
    want = jax_api.logical_spec(axes, shape, rules=_rules(jax_api, multi))
    got = api.logical_spec(axes, shape, rules=_rules(api, multi))
    assert got == tuple(want)


def test_reference_spec_values():
    """The reference's own expectations (tests/test_sharding_and_analysis
    .py) on the port."""
    r = _rules(api)
    assert r.resolve("heads", 25) is None
    assert r.resolve("heads", 32) == "model"
    assert api.logical_spec(("fsdp", "batch"), (64, 32), rules=r) == \
        ("data",)
    assert api.logical_spec(("batch", None, None), (256, 4096, 64),
                            rules=_rules(api, True)) == (("pod", "data"),)
    assert api.logical_spec(("layers", "batch", "kv_seq", None, None),
                            (32, 128, 32768, 8, 128), rules=r) == \
        (None, "data", "model")


def test_use_rules_context_and_pad_ok():
    r = _rules(api)
    assert api.current_rules() is None
    with api.use_rules(r):
        assert api.current_rules() is r
        assert api.logical_spec(("batch",), (32,)) == ("data",)
    assert api.current_rules() is None and api.logical_spec(("batch",)) == ()
    padded = api.LogicalRules(api.SINGLE_POD_RULES, mesh=r.mesh,
                              pad_ok={"heads"})
    ref = jax_api.LogicalRules(jax_api.SINGLE_POD_RULES, mesh=r.mesh,
                               pad_ok={"heads"})
    assert padded.resolve("heads", 25) == ref.resolve("heads", 25) == "model"
    x = torch.ones(3)
    assert api.logical_shard(x, "batch") is x


def test_param_sharding_tree_places_each_leaf():
    r = _rules(api)
    axes = {"w": ("embed", "mlp"), "blocks": [{"q": ("heads", None)}],
            "b": ("mlp",)}
    shapes = {"w": (64, 256), "blocks": [{"q": torch.zeros(25, 8)}],
              "b": (256,)}
    got = api.param_sharding_tree(axes, shapes, r)
    assert got == {"w": (Replicate(), Shard(1)),
                   "blocks": [{"q": (Replicate(), Replicate())}],
                   "b": (Replicate(), Shard(0))}


@pytest.mark.parametrize("P", [4, 5, 8, 16])
@pytest.mark.parametrize("inst", [1, 2, 4])
@pytest.mark.parametrize("dim", [0, 1, 2])
def test_institution_layout_follows_the_guard(P, inst, dim):
    mesh = _FakeMesh({"inst": inst})
    want = jax_api.institution_spec(
        dim + 2, dim, rules=jax_api.LogicalRules(
            {jax_api.INSTITUTION_AXIS: "inst"}, mesh=mesh), size=P)
    rules = api.LogicalRules({api.INSTITUTION_AXIS: "inst"}, mesh=mesh)
    assert api.institution_spec(dim + 2, dim, rules=rules, size=P) == \
        tuple(want)
    tree = {"x": torch.zeros((3,) * dim + (P, 2)), "low": torch.zeros(
        (3,) * dim)}
    placed = api.stacked_sharding(port_mesh.MeshShape({"inst": inst}), tree,
                                  dim=dim)
    assert placed["x"] == (Shard(dim) if tuple(want) else Replicate())
    assert placed["low"] == Replicate()    # no institution dimension
    sharded = P % inst == 0
    assert bool(tuple(want)) == sharded


def test_institution_spec_on_the_reference_mesh():
    """On a real 1-device mesh the reference's stacked_sharding shards the
    institution axis; the port's layout at size 1 is Shard too."""
    mesh = jax_api.make_institution_mesh(1)
    leaf = np.zeros((5, 3), np.float32)
    spec = jax_api.stacked_sharding(mesh, {"a": leaf})["a"].spec
    assert tuple(spec) == ("inst",)
    assert api.stacked_sharding(port_mesh.MeshShape({"inst": 1}),
                                {"a": torch.zeros(5, 3)})["a"] == Shard(0)


def _record(monkeypatch):
    monkeypatch.setattr(jax_mesh, "_make_mesh",
                        lambda shape, axes, devices=None: (tuple(shape),
                                                           tuple(axes)))


@pytest.mark.parametrize("n_devices,n_inst", [
    (1, 1), (8, 8), (8, 2), (8, 1), (24, 2), (6, 3), (10, 5), (7, 7),
    (96, 3), (512, 2), (64, 4)])
def test_overlay_mesh_shape_matches_reference(monkeypatch, n_devices,
                                              n_inst):
    _record(monkeypatch)
    shape, axes = jax_mesh.make_overlay_mesh(n_inst,
                                             devices=list(range(n_devices)))
    assert axes == ("inst", "data", "model")
    assert port_mesh.overlay_mesh_shape(n_devices, n_inst) == shape


def test_overlay_mesh_shape_refuses_uneven_split():
    with pytest.raises(ValueError, match="do not split"):
        port_mesh.overlay_mesh_shape(9, 2)


@pytest.mark.parametrize("multi", [False, True])
def test_production_mesh_matches_reference(monkeypatch, multi):
    _record(monkeypatch)
    shape, axes = jax_mesh.make_production_mesh(multi_pod=multi)
    got = port_mesh.make_production_mesh(multi_pod=multi)
    assert tuple(got.shape) == axes and tuple(got.shape.values()) == shape
    rules = port_mesh.make_rules(got, multi_pod=multi)
    want = jax_mesh.make_rules(_FakeMesh(dict(zip(axes, shape))),
                               multi_pod=multi)
    for name, dim in [("batch", 256), ("institutions", 2), ("heads", 25),
                      ("heads", 32)]:
        assert rules.resolve(name, dim) == want.resolve(name, dim)


def test_meshes_on_a_one_rank_group():
    with pytest.raises(RuntimeError, match="process group"):
        api.make_institution_mesh()
    with port_mesh.process_group("gloo"):
        mesh = api.make_institution_mesh(device="cpu")
        assert api.mesh_axis_sizes(mesh) == {"inst": 1}
        assert api.institution_rows(mesh, 5)[1:] == (0, 5)
        with pytest.raises(ValueError, match="outside"):
            api.make_institution_mesh(2, device="cpu")
        overlay = port_mesh.make_overlay_mesh(1, device="cpu")
        assert api.mesh_axis_sizes(overlay) == {"inst": 1, "data": 1,
                                                "model": 1}
        tree = {"a": torch.arange(6.0).reshape(3, 2),
                "u": torch.tensor([1, 2 ** 32 - 1, 7],
                                  dtype=torch.int64).to(torch.uint32),
                "m": torch.tensor([True, False, True])}
        back = api.all_gather_rows(tree, mesh.get_group("inst"))
        assert back is tree                 # one rank: as it is
        for k in tree:
            assert back[k].dtype == tree[k].dtype
            assert torch.equal(back[k].view(torch.uint8),
                               tree[k].view(torch.uint8))
    assert not dist.is_initialized()


# ----------------------------------------------------------------------
# the secure-agg / DP dispatch override (reference
# tests/test_shard_parity.py:235-310)

def _inputs():
    rng = np.random.default_rng(0)
    return torch.from_numpy(rng.standard_normal((4, 16)).astype(np.float32))


def test_force_impl_overrides_auto_dispatch_only():
    upd = _inputs()
    ref = agg_ops.masked_rolling_update(upd, 0, 0.7, impl="ref")
    with agg_ops.force_impl("ref"):
        auto = agg_ops.masked_rolling_update(upd, 0, 0.7, impl="auto")
        fused = agg_ops.masked_rolling_update(upd, 0, 0.7, impl="fused")
    assert torch.equal(ref, auto)
    torch.testing.assert_close(fused, ref, rtol=2e-5, atol=1e-6)
    assert getattr(agg_ops._dispatch, "forced", None) is None


def test_force_impl_none_is_a_noop():
    with agg_ops.force_impl("ref"):
        with agg_ops.force_impl(None):
            assert agg_ops._dispatch.forced == "ref"
    assert agg_ops._dispatch.forced is None


def test_force_impl_nested_contexts_restore_outer_override():
    assert getattr(agg_ops._dispatch, "forced", None) is None
    with agg_ops.force_impl("ref"):
        assert agg_ops._dispatch.forced == "ref"
        with agg_ops.force_impl("fused"):
            assert agg_ops._dispatch.forced == "fused"
            with agg_ops.force_impl("ref"):
                assert agg_ops._dispatch.forced == "ref"
            assert agg_ops._dispatch.forced == "fused"
        assert agg_ops._dispatch.forced == "ref"
    assert agg_ops._dispatch.forced is None


def test_force_impl_restores_on_exception():
    with pytest.raises(RuntimeError, match="boom"):
        with agg_ops.force_impl("ref"):
            raise RuntimeError("boom")
    assert getattr(agg_ops._dispatch, "forced", None) is None


def test_force_impl_is_thread_local():
    seen = {}

    def probe(barrier):
        barrier.wait()
        seen["other"] = getattr(agg_ops._dispatch, "forced", None)

    barrier = threading.Barrier(2)
    t = threading.Thread(target=probe, args=(barrier,))
    with agg_ops.force_impl("ref"):
        t.start()
        barrier.wait()
        t.join()
        assert agg_ops._dispatch.forced == "ref"
    assert seen["other"] is None


def test_force_impl_governs_dp_auto_dispatch_too():
    u = _inputs()
    with dp_ops.force_impl("bogus"):
        with pytest.raises(ValueError, match="unknown impl"):
            dp_ops.dp_clip_noise(u, 0, 1.0, 0.5, impl="auto")
        with pytest.raises(ValueError, match="unknown impl"):
            agg_ops.masked_rolling_update(u, 0, 0.7, impl="auto")
        a = dp_ops.dp_clip_noise(u, 0, 1.0, 0.5, impl="ref")
    b = dp_ops.dp_clip_noise(u, 0, 1.0, 0.5, impl="auto")  # cpu: plain
    assert torch.equal(a, b)
