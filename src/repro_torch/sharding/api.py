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
unsharded, so there `logical_shard` is an identity.  The dry-run
(`launch.dryrun` on `launch.mesh.fake_production_mesh`) lays the models'
DTensors out by the same rules, and `logical_shard` redistributes them.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Dict, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch._C._functorch import get_unwrapped, is_functorch_wrapped_tensor
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

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


def axis_names(axis: Axis) -> Tuple[str, ...]:
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
        for n in axis_names(axis):
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
        names = axis_names(axis)
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
    """`x` laid out by its logical axes: the counterpart of the JAX
    package's ``with_sharding_constraint``.  Under `use_rules` whose mesh
    is a `DeviceMesh`, a DTensor `x` (beneath any ``torch.func`` levels)
    is redistributed to ``spec_placements(logical_spec(...))``; the
    gradient takes the same layout on the way back, as GSPMD transposes a
    constraint.  Everywhere else (no rules, a device-free mesh, a plain
    tensor) `x` comes back as it is."""
    r = mesh_rules_for(x)
    if r is None:
        return x
    return _Relayout.apply(x, _logical_layout(tuple(logical_axes), r), 0)


def split_last(x: torch.Tensor, n: int, *logical_axes: Optional[str]
               ) -> torch.Tensor:
    """(..., n·m) -> (..., n, m), the dims of the result named by
    `logical_axes`.  Under a mesh (as `logical_shard`) the fused dim is
    first laid out as the result's constraint lays out its n parts, and
    only where whole parts divide the axis: DTensor cannot unflatten a
    dim sharded across a part's boundary.  Where they do not (padded
    heads), the result is laid out with its parts whole too, so that the
    gradient reaches the split's backward, a flatten, in a layout DTensor
    can flatten (it cannot flatten an unevenly sharded dim)."""
    r = mesh_rules_for(x)
    if r is not None:
        x = _Relayout.apply(x, _parts_layout(logical_axes, n, True), 0)
    y = x.reshape(*x.shape[:-1], n, x.shape[-1] // n)
    if r is not None:
        axis = spec_dims(logical_spec(logical_axes, tuple(y.shape), r),
                         y.ndim - 2)[0]
        if axis is not None and n % r.axis_size(axis):
            y = _Relayout.apply(y, _parts_layout(logical_axes, n, False), 0)
    return y


def merge_last(x: torch.Tensor, *logical_axes: Optional[str]
               ) -> torch.Tensor:
    """(..., n, m) -> (..., n·m), the dims of `x` named by
    `logical_axes`: `split_last`'s inverse.  Under a mesh the n parts are
    laid out whole before the merge, and the merged dim after it, so that
    the gradient reaches the merge's backward (an unflatten) in a layout
    DTensor can split."""
    r = mesh_rules_for(x)
    n = x.shape[-2]
    if r is not None:
        x = _Relayout.apply(x, _parts_layout(logical_axes, n, False), 0)
    y = x.reshape(*x.shape[:-2], n * x.shape[-1])
    if r is not None:
        y = _Relayout.apply(y, _parts_layout(logical_axes, n, True), 0)
    return y


def gather_fsdp(w: torch.Tensor) -> torch.Tensor:
    """A weight with its "fsdp" rows gathered: the rules' comment, "weight
    row-sharding (gathered per layer)", made explicit where a layer takes
    its weights.  Under a mesh (as `logical_shard`) the mesh axes that
    "fsdp" maps to go from ``Shard`` to ``Replicate`` (an all-gather, a
    reduce-scatter of the gradient on the way back), so the products
    keep the batch sharded as GSPMD keeps it; DTensor alone would pick
    the cheapest redistribution and compute the whole batch on each
    rank.  Elsewhere `w` itself."""
    r = mesh_rules_for(w)
    if r is None:
        return w
    names = set(axis_names(r.rules.get("fsdp")))

    def layout(x, lead):
        return tuple(
            Replicate() if (isinstance(p, Shard) and p.dim >= lead
                            and x.device_mesh.mesh_dim_names[m] in names)
            else p for m, p in enumerate(x.placements))
    return _Relayout.apply(w, layout, 0)


def reduce_partial(x: torch.Tensor) -> torch.Tensor:
    """`x` with its pending partial sums reduced (an all-reduce of each
    mesh axis where a DTensor is ``Partial``), its shards kept.  A norm
    takes it first: DTensor would carry the partial sums through the
    norm's scaling into the next product and multiply that product's
    work by the axis's size, where GSPMD reduces before the norm.
    Elsewhere `x` itself."""
    if mesh_rules_for(x) is None:
        return x

    def layout(t, lead):
        return tuple(Replicate() if p.is_partial() else p
                     for p in t.placements)
    return _Relayout.apply(x, layout, 0)


def last_dim_sharded(x) -> bool:
    """Whether `x` is, beneath any ``torch.func`` levels, a DTensor whose
    last dim is split over a mesh axis of more than one rank."""
    t = beneath(x)
    if not isinstance(t, DTensor):
        return False
    return any(p.is_shard(t.ndim - 1) and t.device_mesh.size(m) > 1
               for m, p in enumerate(t.placements))


def mesh_rules_for(x) -> Optional[LogicalRules]:
    """The rules in force when `x` is a DTensor under a `DeviceMesh`'s
    rules, else None."""
    r = current_rules()
    if (r is None or not isinstance(r.mesh, DeviceMesh)
            or not isinstance(beneath(x), DTensor)):
        return None
    return r


def _parts_layout(logical_axes, n, fused: bool):
    """Layout of a tensor whose last dims are n parts of m (`fused`: as
    one dim of n·m), by `logical_axes` over the split shape; the parts'
    axis is dropped where it does not divide n evenly."""
    rules = current_rules()

    def layout(x, lead):
        shape = tuple(x.shape[lead:])
        if fused:
            shape = shape[:-1] + (n, shape[-1] // n)
        spec = list(spec_dims(logical_spec(logical_axes, shape, rules),
                              *range(len(shape))))
        k = len(shape) - 2
        if spec[k] is not None and n % rules.axis_size(spec[k]):
            spec[k] = None
        return relayout_placements(x, lead, tuple(spec[:k + 1] if fused
                                                  else spec))
    return layout


def beneath(t):
    """The tensor under `t`'s ``torch.func`` wrappers (grad, vmap): a
    DTensor stays one beneath them, where its placements can be read."""
    while is_functorch_wrapped_tensor(t):
        t = get_unwrapped(t)
    return t


def _logical_layout(logical_axes, rules):
    """A layout function for `_Relayout`: (DTensor, leading vmapped dims)
    -> placements, the leading dims' kept and the rest by `logical_axes`
    on the per-example shape."""
    def layout(x, lead):
        spec = logical_spec(logical_axes, tuple(x.shape[lead:]), rules)
        return relayout_placements(x, lead, spec)
    return layout


def relayout_placements(x, lead: int, spec) -> tuple:
    """Placements of DTensor `x` whose first `lead` dims are vmapped
    (their placements kept) and whose other dims take `spec`; a mesh
    axis that shards a leading dim shards nothing else."""
    mesh = x.device_mesh
    names = mesh.mesh_dim_names
    out = []
    dims = {n: i for i, axis in enumerate(spec) for n in axis_names(axis)}
    for m, p in enumerate(x.placements):
        if isinstance(p, Shard) and p.dim < lead:
            out.append(p)
        elif names[m] in dims:
            out.append(Shard(dims[names[m]] + lead))
        else:
            out.append(Replicate())
    return tuple(out)


def _region_layout(args, lead: int, specs, outs, partial_on=()):
    """A counted region's layout: each arg's placements from its spec
    (mesh-axis names per per-example dim; the vmapped `lead` dims'
    placements kept from the first arg), and each output's (placements,
    global shape) from ``outs``, pairs of (index of the arg whose spec
    and shape it takes, or a (spec, shape)).  Mesh axes in `partial_on`
    leave the outputs ``Partial``: a region that splits a reduction over
    them."""
    first = args[0]
    pls = [relayout_placements(first, lead, spec) for spec in specs]
    names = first.device_mesh.mesh_dim_names

    def out_pl(pl):
        return tuple(Partial() if names[m] in partial_on else p
                     for m, p in enumerate(pl))
    out = []
    for o in outs:
        if isinstance(o, int):
            out.append((out_pl(pls[o]), tuple(args[o].shape)))
        else:
            spec, shape = o
            out.append((out_pl(relayout_placements(first, lead, spec)),
                        tuple(shape)))
    return pls, out


def _spec(logical_axes, x, lead: int) -> Spec:
    return logical_spec(logical_axes, tuple(x.shape[lead:]))


def _attention_layout(args, lead):
    """Attention runs where q's heads are (its constraint, ("batch",
    "seq", "heads", None)); k and v follow q's heads there, unevenly
    where the kv heads do not divide the axis, so that rank 0 holds the
    kv heads of its q heads."""
    spec = _spec(("batch", "seq", "heads", None), args[0], lead)
    return _region_layout(args, lead, [spec] * 3, [0])


def _decode_attention_layout(args, lead):
    """One-token attention runs where the cache is (its length sharded:
    "kv_seq"), q replicated beside it; each rank's share of the keys
    gives a partial output, summed on the next use (the all-reduce of a
    split softmax's combine)."""
    q, kc = args[0], args[1]
    spec = _spec(("batch", "kv_seq", None, None), kc, lead)
    q_spec = spec_dims(spec, 0)
    return _region_layout(args, lead, [q_spec, spec, spec,
                                       spec_dims(spec, 0, 1)],
                          [(q_spec, q.shape)],
                          partial_on=axis_names(spec_dims(spec, 1)[0]))


def _wkv_layout(args, lead):
    """The WKV6 recurrence runs where r's heads are (its constraint,
    ("batch", "seq", "heads", None)): u and the state follow them."""
    spec = _spec(("batch", "seq", "heads", None), args[0], lead)
    state = spec_dims(spec, 0, 2)
    return _region_layout(args, lead, [spec] * 4 + [spec_dims(spec, 2),
                                                    state],
                          [0, (state, args[5].shape)])


def _ssm_layout(args, lead):
    """The selective scan runs where its channels are (the constraint on
    its input, ("batch", "seq", "mlp")): B and C follow the batch, the
    state the batch and the channels."""
    spec = _spec(("batch", "seq", "mlp"), args[0], lead)
    batch = spec_dims(spec, 0)
    state = spec_dims(spec, 0, 2)
    return _region_layout(args, lead, [spec, spec, batch, batch, state],
                          [1, (state, args[4].shape)])


def _gold_layout(args, lead):
    """``logits[..., labels]`` runs on rank 0's vocab shard, its rows
    where the logits' are: a gather across the vocab's shards is a
    masked partial sum over the vocab's axis."""
    spec = _spec(("batch", "seq", "vocab"), args[0], lead)
    rows = spec_dims(spec, 0, 1)
    return _region_layout(args, lead, [spec, rows], [(rows, args[1].shape)],
                          partial_on=axis_names(spec_dims(spec, 2)[0]))


# How each counted region (`launch.op_cost.OpCounter.region`'s `layout`)
# lies on a mesh: (args, leading vmapped dims) -> (each arg's placements,
# each output's (placements, global shape)).
REGION_LAYOUTS = {
    "attention": _attention_layout,
    "decode_attention": _decode_attention_layout,
    "wkv": _wkv_layout,
    "ssm": _ssm_layout,
    "gold": _gold_layout,
}


def relayout(args, layout: str):
    """DTensor `args` (no ``torch.func`` level around them) laid out as
    the counted region `layout` (a `REGION_LAYOUTS` name) lays out its
    inputs, when the same code runs on a mesh outside a count; any other
    args as they are."""
    if not all(isinstance(a, DTensor) for a in args):
        return args
    placements, _ = REGION_LAYOUTS[layout](args, 0)
    return tuple(a.redistribute(a.device_mesh, pl)
                 for a, pl in zip(args, placements))


def spec_dims(spec, *dims) -> Spec:
    """The entries of `spec` (padded with None) at `dims`, as a spec."""
    return tuple(spec[d] if d < len(spec) else None for d in dims)


class _Relayout(torch.autograd.Function):
    """A DTensor redistributed to ``layout(x, lead)``; its gradient to the
    same.  The ``vmap`` rule moves the batched dim to the front and counts
    it among the `lead` dims, so the constraint reaches the DTensor under
    ``vmap(grad(...))``."""

    @staticmethod
    def forward(x, layout, lead):
        if not isinstance(x, DTensor):
            return x.view_as(x)
        return x.redistribute(x.device_mesh, layout(x, lead)).view_as(x)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.layout, ctx.lead = inputs[1], inputs[2]

    @staticmethod
    def backward(ctx, grad):
        return _Relayout.apply(grad, ctx.layout, ctx.lead), None, None

    @staticmethod
    def vmap(info, in_dims, x, layout, lead):
        if in_dims[0] is None:
            return _Relayout.apply(x, layout, lead), None
        return _Relayout.apply(x.movedim(in_dims[0], 0), layout, lead + 1), 0


def spec_placements(spec: Spec, mesh) -> tuple:
    """DTensor placements of a spec on `mesh`, one a mesh axis in the
    mesh's order: ``Shard(i)`` where tensor dim i maps to that axis,
    ``Replicate()`` elsewhere."""
    dims = {n: i for i, axis in enumerate(spec) for n in axis_names(axis)}
    return tuple(Shard(dims[n]) if n in dims else Replicate()
                 for n in mesh_axis_sizes(mesh))


def is_axes(x) -> bool:
    return isinstance(x, tuple) and all(a is None or isinstance(a, str)
                                        for a in x)


def param_sharding_tree(param_axes_tree, shapes_tree, rules: LogicalRules):
    """A tree of logical-axes tuples (and the matching shapes or tensors)
    -> a tree of each leaf's placements on ``rules.mesh``."""
    def walk(axes, shapes):
        if is_axes(axes):
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
