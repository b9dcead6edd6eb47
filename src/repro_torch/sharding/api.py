"""Logical-axis sharding rules, and the institution axis over
``torch.distributed``.

Models name tensor dimensions with *logical* axes ("batch", "heads",
"mlp", ...).  A :class:`LogicalRules` maps logical names to mesh axes,
and :func:`logical_spec` turns a tensor's logical names into a spec: a
tuple of mesh-axis names, ``None`` where a dimension is replicated,
trailing ``None``s dropped, so that it compares element by element with
the JAX package's ``PartitionSpec``.  A mesh is a
``torch.distributed.device_mesh.DeviceMesh`` with ``mesh_dim_names``, or
any object whose ``.shape`` maps axis names to sizes (the device-free
production meshes of `launch.mesh`).

Divisibility guard: a rule applies to a tensor dimension only when the
dimension divides by the mesh axes' total size; otherwise that dimension
stays replicated (padding 25 heads over 16 devices would waste ~28% of
the attention), unless its logical name is in ``pad_ok``.

The one axis the port executes sharded is the institution axis: a
federation's stacked ``(P, ...)`` state laid out ``Shard(0)`` over the
mesh's ``"inst"`` axis, each rank training its own contiguous block of
hospitals (`institution_rows`), and one `all_gather_rows` a round bringing
every hospital's trained rows to the merge.  Inside a rank the models run
unsharded, so `logical_shard` is an identity.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Dict, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import Replicate, Shard

from repro_torch import resolve_device
from repro_torch.pytree import tree_flatten, tree_map, tree_unflatten

Axis = Union[None, str, Tuple[str, ...]]
Spec = Tuple[Axis, ...]

_state = threading.local()


def mesh_axis_sizes(mesh) -> Dict[str, int]:
    """{axis name: size} of a `DeviceMesh` (by its ``mesh_dim_names``) or
    of any object whose ``.shape`` maps names to sizes; {} for None."""
    if mesh is None:
        return {}
    if isinstance(mesh, DeviceMesh):
        names = mesh.mesh_dim_names or ()
        return {n: mesh.size(i) for i, n in enumerate(names)}
    return dict(mesh.shape)


def _axis_names(axis: Axis) -> Tuple[str, ...]:
    return () if axis is None else ((axis,) if isinstance(axis, str)
                                    else tuple(axis))


class LogicalRules:
    def __init__(self, rules: Dict[str, Axis], mesh=None,
                 pad_ok: Optional[set] = None):
        self.rules = dict(rules)
        self.mesh = mesh
        # logical names allowed to shard non-divisibly (padded): opt-in,
        # for when padding wastes less than replication
        self.pad_ok = set(pad_ok or ())

    def axis_size(self, axis: Axis) -> int:
        if axis is None or self.mesh is None:
            return 1
        sizes = mesh_axis_sizes(self.mesh)
        size = 1
        for n in _axis_names(axis):
            size *= sizes[n]
        return size

    def resolve(self, logical: Optional[str], dim: Optional[int] = None
                ) -> Axis:
        if logical is None:
            return None
        axis = self.rules.get(logical)
        if axis is None:
            return None
        if (dim is not None and dim % self.axis_size(axis) != 0
                and logical not in self.pad_ok):
            return None          # divisibility guard -> replicate
        return axis


def current_rules() -> Optional[LogicalRules]:
    return getattr(_state, "rules", None)


@contextlib.contextmanager
def use_rules(rules: LogicalRules):
    prev = current_rules()
    _state.rules = rules
    try:
        yield rules
    finally:
        _state.rules = prev


def logical_spec(logical_axes: Sequence[Optional[str]],
                 shape: Optional[Sequence[int]] = None,
                 rules: Optional[LogicalRules] = None) -> Spec:
    """The spec of a tensor whose dims carry the given logical names."""
    r = rules or current_rules()
    if r is None:
        return ()
    resolved = []
    used: set = set()
    for i, name in enumerate(logical_axes):
        axis = r.resolve(name, None if shape is None else shape[i])
        names = _axis_names(axis)
        if any(n in used for n in names):   # a mesh axis shards one dim
            axis = None
        else:
            used.update(names)
        resolved.append(axis)
    while resolved and resolved[-1] is None:
        resolved.pop()
    return tuple(resolved)


def logical_shard(x: torch.Tensor, *logical_axes: Optional[str]
                  ) -> torch.Tensor:
    """`x` as it is.  The JAX package constrains `x`'s layout here; inside
    a rank the port's models run unsharded (the only axis it executes
    sharded is the institution axis, split by the overlay itself), so
    there is nothing to constrain."""
    del logical_axes
    return x


def spec_placements(spec: Spec, mesh) -> tuple:
    """DTensor placements of a spec on `mesh`, one a mesh axis in the
    mesh's order: ``Shard(i)`` where tensor dim i maps to that axis,
    ``Replicate()`` elsewhere."""
    dims = {n: i for i, axis in enumerate(spec) for n in _axis_names(axis)}
    return tuple(Shard(dims[n]) if n in dims else Replicate()
                 for n in mesh_axis_sizes(mesh))


def _is_axes(x) -> bool:
    return isinstance(x, tuple) and all(a is None or isinstance(a, str)
                                        for a in x)


def param_sharding_tree(param_axes_tree, shapes_tree, rules: LogicalRules):
    """A tree of logical-axes tuples (and the matching shapes or tensors)
    -> a tree of each leaf's placements on ``rules.mesh``."""
    def walk(axes, shapes):
        if _is_axes(axes):
            shape = tuple(getattr(shapes, "shape", shapes))
            return spec_placements(logical_spec(axes, shape, rules),
                                   rules.mesh)
        if isinstance(axes, dict):
            return {k: walk(axes[k], shapes[k]) for k in axes}
        return type(axes)(walk(a, s) for a, s in zip(axes, shapes))
    return walk(param_axes_tree, shapes_tree)


# ----------------------------------------------------------------------
# Federation (institution-axis) sharding: the stacked overlay trees carry
# a leading (P, ...) institution dimension, the logical axis
# "institutions".  On the overlay mesh (`launch.mesh.make_overlay_mesh`:
# ("inst", "data", "model")) it maps to "inst"; on the multi-pod
# production mesh the pod boundary is the institution boundary.  The same
# divisibility guard applies: a federation whose P does not divide the
# institution axis is replicated, never padded (a padded phantom hospital
# would join every mean).

INSTITUTION_AXIS = "institutions"


def institution_spec(ndim: int, dim: int = 0,
                     rules: Optional[LogicalRules] = None,
                     size: Optional[int] = None) -> Spec:
    """The spec of one stacked-federation leaf: the institution axis at
    position `dim` of an `ndim`-rank tensor, everything else replicated.
    `size` is the institution count, checked against the guard."""
    del ndim
    r = rules or current_rules()
    if r is None:
        return ()
    axis = r.resolve(INSTITUTION_AXIS, size)
    if axis is None:
        return ()
    return (None,) * dim + (axis,)


def stacked_sharding(mesh, tree, dim: int = 0,
                     rules: Optional[LogicalRules] = None):
    """Each leaf's layout on the institution axis, for a stacked tree
    whose leaves carry the institution axis at `dim`: (P, ...) states
    (dim=0), per-round batch stacks (R, local_steps, P, ...) (dim=2),
    (R, P) masks (dim=1).  ``Shard(dim)`` where the leaf's institution
    dimension divides the "inst" size, else ``Replicate()`` (the guard)."""
    r = rules or LogicalRules({INSTITUTION_AXIS: "inst"}, mesh=mesh)

    def one(x):
        if x.dim() <= dim or not institution_spec(x.dim(), dim, rules=r,
                                                  size=x.shape[dim]):
            return Replicate()
        return Shard(dim)
    return tree_map(one, tree)


def rank_device(device=None) -> torch.device:
    """The device this rank computes on: the CPU when the caller asks for
    it; else CUDA device ``rank % torch.cuda.device_count()`` (an explicit
    index is kept), made the current device.  Raises without a card."""
    if device is not None and torch.device(device).type == "cpu":
        return torch.device("cpu")
    dev = resolve_device(device)
    if dev.index is None:
        rank = dist.get_rank() if dist.is_initialized() else 0
        dev = torch.device("cuda", rank % torch.cuda.device_count())
    torch.cuda.set_device(dev)
    return dev


def make_institution_mesh(n_devices: Optional[int] = None, *,
                          device=None) -> DeviceMesh:
    """1-D ("inst",) mesh over ranks ``0 .. n_devices - 1`` (default: the
    whole world) of the initialized default process group: the minimal
    mesh for sharding a federation's institution axis.  Each rank's
    device is `rank_device(device)`.  Every rank of the mesh calls it."""
    if not dist.is_initialized():
        raise RuntimeError("make_institution_mesh needs the default process "
                           "group initialized (torch.distributed)")
    world = dist.get_world_size()
    n = world if n_devices is None else int(n_devices)
    if not 1 <= n <= world:
        raise ValueError(f"n_devices={n} outside 1..{world} (the world)")
    return DeviceMesh(rank_device(device).type, list(range(n)),
                      mesh_dim_names=("inst",))


def institution_rows(mesh, n_institutions: int):
    """This rank's share of a P-institution federation on `mesh`:
    ``(group, lo, hi)`` where rank r of the "inst" axis owns rows
    ``[r*P/W, (r+1)*P/W)`` (``Shard(0)``), or None where P does not
    divide the axis's size W and every rank holds all P rows."""
    rules = LogicalRules({INSTITUTION_AXIS: "inst"}, mesh=mesh)
    if rules.resolve(INSTITUTION_AXIS, n_institutions) is None:
        return None
    group = mesh.get_group("inst")
    W = dist.get_world_size(group)
    r = dist.get_rank(group)
    per = n_institutions // W
    return group, r * per, (r + 1) * per


def mesh_barrier(mesh) -> None:
    """Every rank of `mesh` waits for the others: over the "inst" axis's
    group on a 1-D mesh, over the world on an N-D one (which spans it, as
    `launch.mesh.make_overlay_mesh` builds it)."""
    dist.barrier(group=mesh.get_group("inst") if mesh.ndim == 1 else None)


def host_staged(t: torch.Tensor, group) -> torch.Tensor:
    """`t` in the memory a collective over `group` works in.  gloo's
    collectives work in host memory: on a gloo group a CUDA tensor is
    copied to the host explicitly (the caller copies the result back to
    `t.device`); any other tensor comes back as it is."""
    return t.cpu() if t.is_cuda and dist.get_backend(group) == "gloo" else t


# torch 2.13 renames all_gather_into_tensor (which it keeps, deprecated)
_all_gather_single = getattr(dist, "all_gather_single",
                             dist.all_gather_into_tensor)


def all_gather_rows(tree, group):
    """Every rank's (b, ...) block of a stacked tree -> the (W*b, ...)
    tree, in group-rank order, bit for bit: one gather of the leaves'
    bytes (each leaf viewed as uint8, so uint32 and bool leaves cross as
    their bit patterns on any backend) into one (W*b, bytes) buffer.  On
    a 1-rank group the tree comes back as it is."""
    W = dist.get_world_size(group)
    if W == 1:
        return tree
    leaves, spec = tree_flatten(tree)
    b = leaves[0].shape[0]
    parts = [x.contiguous().reshape(b, x[0].numel()).view(torch.uint8)
             for x in leaves]
    buf = host_staged(torch.cat(parts, dim=1), group)
    full = buf.new_empty((W * b, buf.shape[1]))
    _all_gather_single(full, buf, group=group)
    full = full.to(leaves[0].device)
    rows, off = [], 0
    for x, p in zip(leaves, parts):
        n = p.shape[1]
        rows.append(full[:, off:off + n].contiguous().view(x.dtype)
                    .reshape((W * b,) + tuple(x.shape[1:])))
        off += n
    return tree_unflatten(spec, rows)


# Rule set for the overlay/federation mesh (inst, data, model).
FEDERATION_RULES: Dict[str, Axis] = {
    INSTITUTION_AXIS: "inst",
    "batch": "data",
    "heads": "model",
    "kv_heads": "model",
    "mlp": "model",
    "vocab": "model",
    "embed": None,
    "fsdp": "data",
    "seq": None,
    "layers": None,
}


# ----------------------------------------------------------------------
# Default rule sets for the production meshes.
#   data axis: batch + FSDP rows;  model axis: TP columns / heads / experts.
SINGLE_POD_RULES: Dict[str, Axis] = {
    "institutions": None,        # no institution axis on the serving mesh
    "batch": "data",
    "expert_batch": "data",      # MoE dispatch buffers
    "heads": "model",
    "kv_heads": "model",
    "mlp": "model",
    "experts": "model",
    "vocab": "model",
    "embed": None,               # activations keep embed replicated
    "fsdp": "data",              # weight row-sharding (gathered per layer)
    "seq": None,
    "act_seq": "model",          # residual-stream sequence parallelism
    "kv_seq": "model",           # decode caches: shard the cache length
    "layers": None,
}

MULTI_POD_RULES: Dict[str, Axis] = {
    **SINGLE_POD_RULES,
    "institutions": "pod",       # pod boundary == institution boundary
    "batch": ("pod", "data"),
    "expert_batch": ("pod", "data"),
}
