"""Meshes and process groups.

`make_overlay_mesh` builds the federation's ("inst", "data", "model")
`DeviceMesh` over the world; `make_production_mesh` describes the
reference's 256- and 512-device production meshes without devices, and
`fake_production_mesh` gives them as a `DeviceMesh` over a fake group,
for the dry-run's per-device count;
`process_group` and `spawn_ranks` start the ranks the meshes span.  A
group starts from a store, never from a fixed TCP port: a `HashStore` for
one rank, a `FileStore` under a fresh temporary directory for several,
so that runs side by side on one machine cannot collide.  The backend is
always the caller's: NCCL where each rank has its own card (and for one
rank on the card), gloo on the CPU and for several ranks sharing one
card (NCCL refuses two ranks on one device).
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
import shutil
import tempfile
from typing import Dict, Tuple

import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from torch.distributed.device_mesh import DeviceMesh

from repro_torch.sharding.api import (
    LogicalRules, MULTI_POD_RULES, SINGLE_POD_RULES, rank_device,
)


@dataclasses.dataclass(frozen=True)
class MeshShape:
    """A mesh by its axis names and sizes alone, with no devices behind
    it: what `LogicalRules` sizes its guard from."""
    shape: Dict[str, int]


PRODUCTION_MESHES = {
    False: ((16, 16), ("data", "model")),
    True: ((2, 16, 16), ("pod", "data", "model")),
}


def make_production_mesh(*, multi_pod: bool = False) -> MeshShape:
    """The reference's production mesh, (16, 16) ("data", "model") = 256
    devices a pod, or (2, 16, 16) ("pod", "data", "model") = 512, as a
    device-free `MeshShape`: what `LogicalRules` sizes its guard from.
    `fake_production_mesh` gives the same mesh with a (fake) group."""
    shape, names = PRODUCTION_MESHES[multi_pod]
    return MeshShape(dict(zip(names, shape)))


@contextlib.contextmanager
def fake_production_mesh(*, multi_pod: bool = False, shape=None,
                         names=None):
    """The production mesh (or `shape` / `names`) as a `DeviceMesh` over a
    fake process group, seen from rank 0, for the block's duration: one
    process holds the 256 or 512 ranks' group, and DTensors on it carry
    rank 0's shards.  A fake group's collectives move nothing, so their
    values are garbage; on ``meta`` tensors they only give shapes.  Ranks
    lie row-major over the mesh.  The group is the default group while
    the block runs and is destroyed on the way out, an exception
    included; entering with a default group already up raises.

    The "fake" backend is registered by importing
    ``torch.testing._internal.distributed.fake_pg``, here and only here
    (torch keeps the backend in that testing module)."""
    import torch.testing._internal.distributed.fake_pg as fake_pg

    _squeeze_dims_strategy()
    if shape is None:
        shape, names = PRODUCTION_MESHES[multi_pod]
    shape, names = tuple(shape), tuple(names)
    world = 1
    for n in shape:
        world *= n
    if dist.is_initialized():
        raise RuntimeError("a default process group is up: the fake "
                           "production mesh needs its own")
    dist.init_process_group("fake", store=fake_pg.FakeStore(), rank=0,
                            world_size=world)
    try:
        mesh = DeviceMesh("cuda", torch.arange(world).reshape(shape),
                          mesh_dim_names=names)
        _scatter_strategy(mesh)
        yield mesh
    finally:
        dist.destroy_process_group()


def _squeeze_dims_strategy() -> None:
    """Give DTensor a sharding strategy for ``aten.squeeze.dims`` where
    the torch release has none (2.11 has none; an unsqueeze's backward
    under ``vmap`` dispatches it): a squeezed dim has size 1 and shards
    nothing, every other dim keeps its shard, a partial sum stays one."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import register_sharding
    op = torch.ops.aten.squeeze.dims
    prop = DTensor._op_dispatcher.sharding_propagator
    if op in prop.op_strategy_funcs or op in getattr(prop, "op_to_rules", {}):
        return

    @register_sharding(op)
    def squeeze_dims(x, dims):
        n = len(x.shape)
        gone = {d % n for d in dims if x.shape[d] == 1}
        out = [([Replicate()], [Replicate(), None]),
               ([Partial()], [Partial(), None])]
        for d in range(n):
            if d not in gone:
                out.append(([Shard(d - sum(g < d for g in gone))],
                            [Shard(d), None]))
        return out


def _scatter_strategy(mesh) -> None:
    """Give DTensor a sharded strategy for ``aten.scatter`` where the
    torch release replicates every scatter (2.11 does): the MoE's
    capacity scatter would then gather every group's buffer to every
    rank, where GSPMD keeps the groups apart.  A dim other than the
    scatter's, on which input, index and src agree in size, is sharded
    alike on all three and the scatter stays local, as later releases'
    own strategy allows.  Probed on `mesh` once a process."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from torch.distributed.tensor.experimental import register_sharding
    pl = (Shard(0),) + (Replicate(),) * (mesh.ndim - 1)
    x = distribute_tensor(torch.empty(2 * mesh.size(0), 2, device="meta"),
                          mesh, pl)
    i = distribute_tensor(torch.zeros(x.shape, dtype=torch.long,
                                      device="meta"), mesh, pl)
    if x.scatter(1, i, x).placements == pl:
        return

    @register_sharding([torch.ops.aten.scatter.src,
                        torch.ops.aten.scatter.value])
    def scatter(inp, dim, index, src):
        tensor_src = not isinstance(src, (int, float, bool))
        extra = [Replicate()] if tensor_src else [None]
        out = [([Replicate()], [Replicate(), None, Replicate()] + extra)]
        n = len(inp.shape)
        if len(index.shape) != n:
            return out
        for d in range(n):
            if (d == dim % n or inp.shape[d] != index.shape[d]
                    or (tensor_src and src.shape[d] != index.shape[d])):
                continue
            out.append(([Shard(d)], [Shard(d), None, Shard(d)]
                        + ([Shard(d)] if tensor_src else [None])))
        return out


def make_rules(mesh, *, multi_pod: bool = False) -> LogicalRules:
    return LogicalRules(MULTI_POD_RULES if multi_pod else SINGLE_POD_RULES,
                        mesh=mesh)


def overlay_mesh_shape(n_devices: int, n_institutions: int
                       ) -> Tuple[int, int, int]:
    """(inst, data, model) sizes: n_institutions institution groups, each
    of n_devices / n_institutions devices, whose model axis is the first
    of 16, 8, 4, 2, 1 that divides the group."""
    if n_devices % n_institutions:
        raise ValueError(f"{n_devices} devices do not split into "
                         f"{n_institutions} institution groups")
    per = n_devices // n_institutions
    model = next(m for m in (16, 8, 4, 2, 1) if per % m == 0)
    return n_institutions, per // model, model


def make_overlay_mesh(n_institutions: int, *, device=None) -> DeviceMesh:
    """The training mesh with an explicit institution axis, ("inst",
    "data", "model"), over every rank of the initialized default process
    group (`overlay_mesh_shape` picks the sizes).  Each rank's device is
    `sharding.api.rank_device(device)`.  On the multi-pod production mesh
    the "pod" axis itself is the institution boundary."""
    if not dist.is_initialized():
        raise RuntimeError("make_overlay_mesh needs the default process "
                           "group initialized (torch.distributed)")
    world = dist.get_world_size()
    shape = overlay_mesh_shape(world, n_institutions)
    ranks = [[list(range(i * shape[1] * shape[2] + d * shape[2],
                         i * shape[1] * shape[2] + (d + 1) * shape[2]))
              for d in range(shape[1])] for i in range(shape[0])]
    return DeviceMesh(rank_device(device).type, ranks,
                      mesh_dim_names=("inst", "data", "model"))


@contextlib.contextmanager
def process_group(backend: str, rank: int = 0, world_size: int = 1,
                  store=None):
    """The default process group for the block's duration, destroyed on
    the way out (an exception included).  Without a `store`, one rank
    starts from a `HashStore`."""
    if store is None:
        if world_size != 1:
            raise ValueError("several ranks need a shared store")
        store = dist.HashStore()
    dist.init_process_group(backend, store=store, rank=rank,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _rank_main(rank, fn, world_size, backend, store_path, args):
    os.environ["LOCAL_RANK"] = str(rank)
    store = dist.FileStore(store_path, world_size)
    with process_group(backend, rank, world_size, store):
        fn(rank, world_size, *args)


def spawn_ranks(fn, world_size: int, *, backend: str, args=()) -> None:
    """``fn(rank, world_size, *args)`` in `world_size` fresh processes
    (start method ``spawn``), each inside `process_group` on `backend`
    over a `FileStore` in a temporary directory removed after.  Returns
    when every rank has returned; a rank that raises fails the call.
    `fn` must be importable by name (a module-level function).  CUDA
    kernels are built before this is called, so that the ranks only load
    them."""
    tmp = tempfile.mkdtemp(prefix="ranks_")
    try:
        mp.start_processes(_rank_main, nprocs=world_size, join=True,
                           args=(fn, world_size, backend,
                                 os.path.join(tmp, "store"), args),
                           start_method="spawn")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
