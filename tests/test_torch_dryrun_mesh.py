"""The dry-run on meshes (`launch.dryrun` with a mesh, `launch.mesh
.fake_production_mesh`, the DTensor count of `launch.op_cost`, the
links of `launch.analysis`), held against the JAX package's dry-run.

The reference lowers its own `lower_one` onto 8 placeholder XLA CPU
devices in a child process (`tests/_torch_dryrun_mesh_child.py`), on a
(2, 4) ("data", "model") or (2, 2, 2) ("pod", "data", "model") mesh and
a reduced config; the port counts the same config on a fake 8-rank
group of the same shape, as rank 0 sees it.

Exact: per-device argument bytes for train, prefill, decode, overlay,
pad-heads (a prefill, and a train step whose heads shard unevenly) and
an MoE train and prefill step; per-device matmul FLOPs
against the HLO dot FLOPs (prefill, decode, MoE prefill); `_wire_bytes`
against both reference copies; the collectives of three micro steps; a
world-size-1 mesh against the one-card count.  Bounded (stated at the
tests): the reduced dense train step's and the MoE steps' FLOPs and wire
bytes, where DTensor's propagation and GSPMD's differ.
"""
import dataclasses
import json
import os
import subprocess
import sys

import pytest
import torch
import torch.distributed as dist
from torch.distributed.tensor import Replicate, Shard, distribute_tensor
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch.configs import ARCHS, reduced
from repro_torch.configs.base import InputShape
from repro_torch.launch import analysis, dryrun, mesh as mesh_mod, op_cost
from repro_torch.models import layers
from repro_torch.sharding import api
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

HERE = os.path.dirname(__file__)
SRC = os.path.join(HERE, os.pardir, "src")
CHILD = os.path.join(HERE, "_torch_dryrun_mesh_child.py")


def _load_child():
    """The child's CASES without importing it (it starts jax on 8
    devices)."""
    import ast
    with open(CHILD) as f:
        tree = ast.parse(f.read())
    for node in tree.body:
        if (isinstance(node, ast.Assign)
                and getattr(node.targets[0], "id", None) == "CASES"):
            return ast.literal_eval(node.value)
    raise AssertionError("no CASES in the child")


CASES = _load_child()


@pytest.fixture(scope="module")
def reference():
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join(
                   [SRC, os.environ.get("PYTHONPATH", "")]))
    proc = subprocess.run([sys.executable, CHILD], capture_output=True,
                          text=True, env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.fixture(scope="module", autouse=True)
def no_group_left_behind():
    """Every fake group here is scoped; none may outlive this file, whose
    xdist worker runs other files after it."""
    yield
    leaked = dist.is_initialized()
    if leaked:
        dist.destroy_process_group()
    assert not leaked, "a fake process group outlived its block"


def _case(name):
    arch, changes, (kind, seq, batch), shape, axes, flags = CASES[name]
    cfg = dataclasses.replace(reduced(ARCHS[arch]), **changes)
    return cfg, InputShape(f"{kind}_small", seq, batch, kind), shape, axes, \
        flags


def _port_count(name):
    cfg, shape, mshape, axes, flags = _case(name)
    with mesh_mod.fake_production_mesh(shape=mshape, names=axes) as mesh:
        rules = dryrun.mesh_rules(mesh, multi_pod="pod" in axes,
                                  pad_heads=flags.get("pad_heads", False),
                                  overlay=flags.get("overlay", False))
        fn, args = dryrun.mesh_step_and_args(
            cfg, shape, rules, "ref", overlay=flags.get("overlay", False))
        counts, mem = dryrun.count_step(fn, args, rules)
    return counts, mem


_COUNTS = {}


def port_count(name):
    if name not in _COUNTS:
        _COUNTS[name] = _port_count(name)
    return _COUNTS[name]


# ----------------------------------------------------------------------
# exact

@pytest.mark.parametrize("kind", ["all-reduce", "all-gather",
                                  "reduce-scatter", "all-to-all",
                                  "collective-permute"])
@pytest.mark.parametrize("group", [2, 4, 16])
def test_wire_bytes_equal_both_reference_copies(reference, kind, group):
    ours = op_cost._wire_bytes(kind, 4096.0, group)
    assert reference["wire"][f"{kind}/{group}"] == [ours, ours]


@pytest.mark.parametrize("name", sorted(CASES))
def test_args_bytes_equal_the_reference(reference, name):
    """Rank 0's shards of params, optimizer state, batch, cache (and the
    overlay's institution axis; padded heads' uneven shards) hold as many
    bytes as a device's arguments in the reference's SPMD module."""
    _, mem = port_count(name)
    assert mem["args"] == reference["steps"][name]["args"]


@pytest.mark.parametrize("name", ["prefill", "decode", "moe_prefill"])
def test_matmul_flops_equal_the_reference_dots(reference, name):
    """At widths that divide the axes every product splits evenly, and
    rank 0's matmul FLOPs are the per-device HLO's dot FLOPs."""
    counts, _ = port_count(name)
    assert counts["matmul_flops"] == reference["steps"][name]["dot_flops"]


def _micro_steps(mesh):
    """The child's three micro steps on the port's side: (fn, args,
    the output's placements)."""
    def dt(shape, *pl):
        return distribute_tensor(torch.empty(shape, device="meta"), mesh,
                                 pl)
    R, S0, S1 = Replicate(), Shard(0), Shard(1)
    x_model = dt((8, 16), R, S0)
    x_data = dt((8, 16), S0, R)
    y_data = dt((8, 8), S0, R)

    def mlp(x, a, b):
        return ((x @ a) @ b).redistribute(mesh, (R, S0))

    def fsdp(x, a):
        return (x @ a).redistribute(mesh, (S0, S1))

    def dp_grad(w, x, y):
        g = torch.func.grad(lambda w: ((x @ w - y) ** 2).mean())(w)
        return g.redistribute(mesh, (R, R))
    return {
        "mlp": (mlp, (x_model, dt((16, 32), S1, R), dt((32, 16), S0, R))),
        "fsdp": (fsdp, (x_data, dt((16, 32), S0, S1))),
        "dp_grad": (dp_grad, (dt((16, 8), R, R), x_data, y_data)),
    }


@pytest.mark.parametrize("name", ["mlp", "fsdp", "dp_grad"])
def test_micro_step_collectives_equal_the_reference(reference, name):
    """A column-then-row-parallel MLP (one all-reduce), an FSDP weight
    (one all-gather), a data-parallel gradient (one all-reduce): the
    same kinds, counts and wire bytes as GSPMD's, on NVLink (8 ranks
    are one node)."""
    with mesh_mod.fake_production_mesh(shape=(2, 4),
                                       names=("data", "model")) as mesh:
        fn, args = _micro_steps(mesh)[name]
        counts = op_cost.analyze_ops(fn, *args)
    got = {k: {"bytes": v["bytes"], "count": v["count"]}
           for k, v in counts["collectives"].items()}
    assert got == reference["micro"][name]
    assert all(v["network"] == 0 and v["nvlink"] == v["bytes"]
               for v in counts["collectives"].values())


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_world_size_one_mesh_equals_the_one_card_count(kind):
    cfg = reduced(ARCHS["qwen3-0.6b"])
    shape = InputShape(f"{kind}_small", 64, 4, kind)
    fn, args = dryrun.step_and_args(cfg, shape)
    one, one_mem = dryrun.count_step(fn, args)
    with mesh_mod.fake_production_mesh(shape=(1, 1),
                                       names=("data", "model")) as mesh:
        rules = dryrun.mesh_rules(mesh)
        fn, dargs = dryrun.mesh_step_and_args(cfg, shape, rules)
        got, mem = dryrun.count_step(fn, dargs, rules)
    for k in ("flops", "matmul_flops", "bytes", "peak_bytes"):
        assert got[k] == one[k], k
    assert mem == one_mem
    assert got["collective_bytes"] == 0 and got["collectives"] == {}


# ----------------------------------------------------------------------
# bounded

def test_train_step_within_bound_of_the_reference(reference):
    """The reduced train step on (2, 4).  FLOPs within 10%: the products
    split alike, the rest is elementwise work that XLA fuses, remats and
    pads otherwise than eager PyTorch (4% apart when written).  Wire
    bytes within a factor of 2 (1.32 when written): DTensor reshards
    where its propagation needs it, GSPMD where its does, and the two
    choose other collectives; the reference also reads a group whose
    ranks XLA lists as 2 ranks (ROADMAP queue C)."""
    counts, _ = port_count("train")
    ref = reference["steps"]["train"]
    print(f"train (2, 4): flops {counts['flops']:.6e} vs {ref['flops']:.6e}"
          f", matmul {counts['matmul_flops']:.6e} vs dot "
          f"{ref['dot_flops']:.6e}, wire bytes "
          f"{counts['collective_bytes']:.6e} vs "
          f"{ref['collective_bytes']:.6e}")
    print("port", counts["collectives"])
    print("reference", ref["collectives"])
    assert abs(counts["flops"] / ref["flops"] - 1) <= 0.10
    assert 0.5 <= counts["collective_bytes"] / ref["collective_bytes"] <= 2


@pytest.mark.parametrize("name", ["moe_train", "moe_prefill"])
def test_moe_step_within_bound_of_the_reference(reference, name):
    """A one-layer reduced olmoe step on (2, 4), experts over "model",
    groups over "data", held as the dense train step is: FLOPs within 10%
    (1.3% and 0.5% apart when written), wire bytes within a factor of 2
    (train 1.05x, prefill 0.76x when written).  A 2-wide data axis
    cannot show a replicated capacity scatter within this bound (1.8x);
    `test_capacity_scatter_stays_group_local` holds that apart."""
    counts, _ = port_count(name)
    ref = reference["steps"][name]
    print(f"{name} (2, 4): flops {counts['flops']:.6e} vs "
          f"{ref['flops']:.6e}, wire bytes {counts['collective_bytes']:.6e}"
          f" vs {ref['collective_bytes']:.6e}")
    print("port", counts["collectives"])
    print("reference", ref["collectives"])
    assert abs(counts["flops"] / ref["flops"] - 1) <= 0.10
    assert 0.5 <= counts["collective_bytes"] / ref["collective_bytes"] <= 2


def test_capacity_scatter_stays_group_local():
    """The MoE dispatch and combine on groups sharded over "data": each
    rank scatters and gathers its own groups and no collective runs.  A
    torch whose DTensor replicates every scatter (2.11) would gather each
    group's buffer to every rank, 67x the modelled collective bytes of
    olmoe's train step on 16x16; the fake mesh gives it a strategy that
    keeps the groups apart."""
    with mesh_mod.fake_production_mesh(shape=(2, 4),
                                       names=("data", "model")) as mesh:
        x = distribute_tensor(torch.empty(4, 16, 8, device="meta"), mesh,
                              (Shard(0), Replicate()))
        router = distribute_tensor(torch.empty(8, 4, device="meta"), mesh,
                                   (Replicate(), Replicate()))

        def moe(x, router):
            buf, _, dest, order, _, gate, _ = layers._moe_dispatch(
                x, router, top_k=2, capacity=8)
            return layers._moe_combine(buf, dest, order, gate, top_k=2)
        with implicit_replication():
            counts = op_cost.analyze_ops(moe, x, router)
    assert counts["collectives"] == {}
    assert counts["out"].placements == (Shard(0), Replicate())


# ----------------------------------------------------------------------
# the mesh, the rules, the flags

def test_fake_mesh_is_scoped_and_rank_major():
    with mesh_mod.fake_production_mesh(multi_pod=True) as mesh:
        assert dist.get_world_size() == 512 and dist.get_rank() == 0
        assert mesh.mesh_dim_names == ("pod", "data", "model")
        assert dist.get_process_group_ranks(mesh.get_group("model")) == \
            list(range(16))
        assert dist.get_process_group_ranks(mesh.get_group("pod")) == \
            [0, 256]
        with pytest.raises(RuntimeError, match="default process group"):
            with mesh_mod.fake_production_mesh():
                pass
    assert not dist.is_initialized()
    with pytest.raises(ValueError):
        with mesh_mod.fake_production_mesh(shape=(2, 4),
                                           names=("data", "model")):
            raise ValueError
    assert not dist.is_initialized()


def test_links_follow_the_nodes():
    assert analysis.link_of(range(8)) == "nvlink"
    assert analysis.link_of(range(16)) == "network"
    assert analysis.link_of([0, 16]) == "network"
    assert analysis.link_of([8, 9]) == "nvlink"
    assert analysis.NETWORK_BANDWIDTH == 50e9
    roof = analysis.Roofline(
        arch="a", shape="s", mesh="16x16", n_chips=256,
        flops_per_device=0.0, bytes_per_device=0.0,
        collective_bytes_per_device=9e9,
        collectives={"all-reduce": {"bytes": 9e9, "count": 2.0,
                                    "nvlink": 4.5e9, "network": 4.5e9}},
        model_flops_global=1.0, peak_memory_bytes=0.0, compile_seconds=0.0)
    assert roof.t_collective_by_link == {"nvlink": 4.5e9 / 450e9,
                                         "network": 4.5e9 / 50e9}
    assert roof.t_collective == 0.01 + 0.09
    assert roof.bottleneck == "collective"


def test_logical_shard_is_the_identity_off_a_mesh():
    """No rules, a device-free mesh, or a plain tensor: `x` itself."""
    x = torch.randn(2, 3, 4)
    assert api.logical_shard(x, "batch", "seq", "embed") is x
    rules = mesh_mod.make_rules(mesh_mod.make_production_mesh())
    with api.use_rules(rules):
        assert api.logical_shard(x, "batch", "seq", "embed") is x
        y = api.split_last(x, 2, "batch", "seq", "heads", None)
    assert torch.equal(y, x.reshape(2, 3, 2, 2))


def test_logical_shard_redistributes_a_dtensor_under_grad_and_vmap():
    """The constraint reaches the DTensor beneath ``vmap(grad(...))``,
    keeps the vmapped dim's placement, and lays the gradient out alike."""
    with mesh_mod.fake_production_mesh(shape=(2, 4),
                                       names=("data", "model")) as mesh:
        rules = api.LogicalRules({"batch": "data", "mlp": "model"},
                                 mesh=mesh)
        w = distribute_tensor(torch.empty(2, 16, 32, device="meta"), mesh,
                              (Shard(0), Replicate()))
        seen = []

        def loss(w):
            h = api.logical_shard(w, None, "mlp")
            seen.append(api.beneath(api.beneath(h)))
            return h.sum()
        with api.use_rules(rules):
            g = torch.func.vmap(torch.func.grad(loss))(w)
        assert seen[0].placements == (Shard(0), Shard(2))
        assert g.placements == (Shard(0), Shard(2))


def _small_lower_one(monkeypatch):
    """`lower_one` with the overlay case's reduced config and short
    shapes, on 8-rank stand-ins for the production meshes (2, 4) and
    (2, 2, 2), as the child runs the reference's: the same schemas as
    the overlay case, whose sharding propagation DTensor has cached."""
    cfg, shape, _, _, _ = _case("overlay")
    small = {False: ((2, 4), ("data", "model")),
             True: ((2, 2, 2), ("pod", "data", "model"))}
    monkeypatch.setattr(dryrun, "get_config", lambda arch: cfg)
    monkeypatch.setattr(dryrun, "INPUT_SHAPES", {
        "train_4k": dataclasses.replace(shape, name="train_4k"),
        "prefill_32k": InputShape("prefill_32k", 64, 8, "prefill")})
    monkeypatch.setattr(
        dryrun, "fake_production_mesh",
        lambda multi_pod=False: mesh_mod.fake_production_mesh(
            shape=small[multi_pod][0], names=small[multi_pod][1]))


@pytest.mark.parametrize("flags,mesh,shape", [
    ({"single_pod": True}, "16x16", "train_4k"),
    ({"multi_pod": True}, "2x16x16", "prefill_32k"),
    ({"multi_pod": True, "overlay": True}, "2x16x16+overlay", "train_4k"),
    ({"pad_heads": True}, "16x16", "train_4k"),
])
def test_mesh_flags_are_accepted(monkeypatch, flags, mesh, shape):
    _small_lower_one(monkeypatch)
    roof, mem = dryrun.lower_one("qwen3-0.6b", shape, **flags)
    assert roof.mesh == mesh and roof.n_chips == 8
    assert roof.variant == ("+pad_heads" if "pad_heads" in flags else "")
    assert mem["args"] > 0 and roof.collective_bytes_per_device > 0
    assert set(roof.t_collective_by_link) == {"nvlink", "network"}
    assert not dist.is_initialized()


def test_overlay_needs_multi_pod_and_a_train_shape(monkeypatch):
    _small_lower_one(monkeypatch)
    with pytest.raises(AssertionError, match="needs --multi-pod"):
        dryrun.lower_one("qwen3-0.6b", "train_4k", overlay=True)
    with pytest.raises(AssertionError, match="training-time"):
        dryrun.lower_one("qwen3-0.6b", "prefill_32k", multi_pod=True,
                         overlay=True)
    with pytest.raises(SystemExit):
        dryrun.main(["--arch", "qwen3-0.6b", "--shape", "train_4k",
                     "--overlay"])
    assert not dist.is_initialized()


def test_one_card_count_is_unchanged_by_the_mesh_code():
    """No mesh flag: the one-card count, 1xH100, no collectives."""
    roof, _ = dryrun.lower_one("rwkv6-3b", "decode_32k")
    assert roof.mesh == "1xH100" and roof.n_chips == 1
    assert roof.collectives == {} and roof.t_collective == 0.0
