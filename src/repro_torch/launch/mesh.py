"""Meshes and process groups.

`make_overlay_mesh` builds the federation's ("inst", "data", "model")
`DeviceMesh` over the world; `make_production_mesh` describes the
reference's 256- and 512-device production meshes without devices;
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


def make_production_mesh(*, multi_pod: bool = False) -> MeshShape:
    """The reference's production mesh, (16, 16) ("data", "model") = 256
    devices a pod, or (2, 16, 16) ("pod", "data", "model") = 512, as a
    device-free `MeshShape`: no machine here holds 256 cards.  It sizes
    `LogicalRules` only; pricing the dry-run's steps on it (wire bytes of
    its collectives, per-device shards) is the dry-run half of item 27."""
    if multi_pod:
        return MeshShape({"pod": 2, "data": 16, "model": 16})
    return MeshShape({"data": 16, "model": 16})


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
