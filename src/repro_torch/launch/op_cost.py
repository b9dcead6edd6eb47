"""FLOP, byte and memory count of one step, op by op on ``meta`` tensors.

The counterpart of the reference's ``launch/hlo_cost.py``.  Torch has no
HLO module to parse, so the count is a ``TorchDispatchMode``: every aten
op that the step dispatches is priced as it runs, on ``meta`` tensors
that carry shapes and dtypes and allocate nothing.

  * FLOPs follow the reference's ``_op_flops``: matmul-type ops
    2·M·N·K (the formulas of ``torch.utils.flop_counter``, kept apart as
    ``matmul_flops``), transcendental and elementwise ops 1 per output
    element, reductions the size of their operand.
  * Bytes are the operands plus the results of every aten op (views and
    uninitialised allocations move nothing).  Eager PyTorch fuses
    nothing, so this is the plain path's unfused traffic, where the
    reference counts the traffic between XLA's fused kernels.
  * Memory: every storage an op creates is live from then until its last
    tensor dies (a ``weakref.finalize`` on each tensor that holds it);
    ``peak`` is the largest live total.  Storages that existed before the
    count (params, optimizer state, batch) are not in it.

On a mesh.  The dry-run's args are DTensors on a fake production mesh
(`launch.mesh.fake_production_mesh`), and the count is rank 0's, the
counterpart of XLA's per-device SPMD module.  The counter steps aside
for every DTensor op (``NotImplemented``), so DTensor's dispatch runs
beneath it: the ops it runs on rank 0's shards come back as plain
tensors and are priced as above, at local sizes, and so do the
collectives of the redistributions it inserts, which the
``_c10d_functional`` ops carry.  Each collective is priced by the
reference's ring formulas (``_wire_bytes``) on its local result and
group size, and split by the link its group crosses
(`analysis.link_of`).  The fake-tensor ops of DTensor's sharding
propagation are not the step's and are left out.

Regions.  The port's three dispatchers (`models.layers.attention` and
``decode_attention``, ``kernels.rwkv6_scan.ops.wkv6``,
``kernels.ssm_scan.ops.ssm_scan``) ask `active()` whether a count is
running, a single context-variable read, and only then hand their work
to `OpCounter.region` under the reference's tags (``attention``,
``wkv``, ``ssm``: its ``jax.named_scope("attention_fallback" /
"wkv_fallback" / "ssm_scan_fallback")``).  A region is counted apart and
returns ``torch.empty`` outputs of the right shapes, so a count's time
does not grow with the sequence:

  * attention is counted on the one-shot `mha_reference` shapes, O(1)
    ops a layer, with the keys cut to the chunked path's window band
    where it visits one;
  * a recurrence (the WKV6 and selective-scan plain versions) is counted
    as the reference counts a ``lax.scan``, from its body: its plain loop
    runs at short lengths n = 2, 3, 4 steps (or chunks) and the count is
    extrapolated to T.  Every step dispatches the same ops on the same
    shapes, so the forward is linear in n; on the backward pass each
    step's slice of a time-major input returns a full-length gradient,
    which makes it a quadratic.  The quadratic through the three points
    is exact, in rational arithmetic.

Each region is an ``autograd.Function``, so under a gradient its
backward is counted too, from a ``torch.func.vjp`` of the same plain
code.  A region is priced as one kernel: its outputs are live memory,
its own intermediates are not.  Measurements are cached per shape, so
a model's layers after the first cost one lookup each.
"""
from __future__ import annotations

import contextvars
import weakref
from fractions import Fraction
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensor
from torch.distributed.tensor import DTensor, Replicate
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

from repro_torch.sharding.api import REGION_LAYOUTS, beneath

_ACTIVE: contextvars.ContextVar = contextvars.ContextVar("op_cost_counter",
                                                         default=None)

TAGS = ("attention", "wkv", "ssm")

_ELEMENTWISE = frozenset("""
    abs acos add addcdiv addcmul asin atan atan2 bitwise_and bitwise_left_shift
    bitwise_not bitwise_or bitwise_right_shift bitwise_xor ceil clamp clamp_max
    clamp_min copysign cos cosh div elu eq erf erfinv exp exp2 expm1 floor fmod
    gelu gelu_backward ge gt hardtanh isinf isnan le leaky_relu lerp log log10
    log1p log2 logaddexp logical_and logical_not logical_or logical_xor lt
    masked_fill maximum minimum mul nan_to_num ne neg pow reciprocal relu
    remainder round rsqrt rsub sigmoid sigmoid_backward sign silu silu_backward
    sin sinh softplus sqrt sub tan tanh tanh_backward threshold_backward trunc
    where xlogy __and__ __or__ __xor__ __lshift__ __rshift__
    _softmax_backward_data _log_softmax_backward_data
""".split())
_REDUCTIONS = frozenset("""
    all amax amin any argmax argmin cumprod cumsum logsumexp max mean min
    norm linalg_vector_norm prod std sum var _softmax _log_softmax sort topk
""".split())
# allocations whose contents are undefined: nothing is read or written
_NO_BYTES = frozenset("""
    empty empty_like empty_strided new_empty new_empty_strided
""".split())


def active() -> Optional["OpCounter"]:
    """The running count, or None: what a dispatcher checks."""
    return _ACTIVE.get()


def _name(func) -> str:
    name = func.overloadpacket.__name__
    return name[:-1] if name.endswith("_") and not name.endswith("__") \
        else name


def tensors(tree):
    return [x for x in tree_flatten(tree)[0] if isinstance(x, torch.Tensor)]


def local(t: torch.Tensor) -> torch.Tensor:
    """Rank 0's shard of a DTensor; any other tensor as it is."""
    return t._local_tensor if isinstance(t, DTensor) else t


def storage_key(t: torch.Tensor) -> int:
    return local(t).untyped_storage()._cdata


# The collectives DTensor issues (``torch.ops._c10d_functional`` and its
# autograd twins, DTensor's own all-to-all), by the reference's HLO kinds.
COLLECTIVES = {
    "all_reduce": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "shard_dim_alltoall": "all-to-all",
}
# bookkeeping around a collective: no work of its own
_NO_COST = frozenset(("wait_tensor", "_wrap_tensor_autograd"))


def _wire_bytes(kind: str, result_bytes: float, group: int) -> float:
    """Bytes one device puts on the wire for a ring collective whose
    local result is `result_bytes`, over `group` devices: the reference's
    ``hlo_cost._wire_bytes``, carried over as it is."""
    g = max(group, 2)
    if kind == "all-reduce":
        return 2.0 * result_bytes * (g - 1) / g
    if kind == "all-gather":
        return result_bytes * (g - 1) / g
    if kind == "reduce-scatter":
        return result_bytes * (g - 1)
    if kind == "all-to-all":
        return result_bytes * (g - 1) / g
    return result_bytes


def _group_ranks(args) -> Tuple[int, ...]:
    """The global ranks of the group a functional collective names (its
    last string argument)."""
    from torch.distributed.distributed_c10d import _resolve_process_group
    name = [a for a in args if isinstance(a, str)][-1]
    return tuple(dist.get_process_group_ranks(_resolve_process_group(name)))


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class _Tally:
    """One accumulator: the step's, or a region measurement's."""

    KEYS = ("flops", "matmul_flops", "bytes", "n_ops")

    def __init__(self, track_memory: bool, external: Sequence[int] = ()):
        self.flops = 0.0
        self.matmul_flops = 0.0
        self.bytes = 0.0
        self.n_ops = 0
        self.bytes_by_tag: Dict[str, float] = {}
        self.collectives: Dict[str, Dict[str, float]] = {}
        self.track_memory = track_memory
        self.external = set(external)
        self.live: Dict[int, list] = {}
        self.live_bytes = 0
        self.peak = 0

    def add_collective(self, kind: str, result_bytes: float, ranks) -> None:
        """One collective over the group of global `ranks`, priced as a
        ring over `analysis.link_of(ranks)`; a 1-rank group moves nothing."""
        if len(ranks) < 2:
            return
        from repro_torch.launch.analysis import link_of
        wire = _wire_bytes(kind, result_bytes, len(ranks))
        ent = self.collectives.setdefault(
            kind, {"bytes": 0.0, "count": 0.0, "nvlink": 0.0,
                   "network": 0.0})
        ent["bytes"] += wire
        ent["count"] += 1
        ent[link_of(ranks)] += wire

    def add_op(self, func, args, kwargs, out) -> None:
        name = _name(func)
        if name in _NO_COST:
            return
        outs = tensors(out)
        if name in COLLECTIVES:
            self.add_collective(COLLECTIVES[name],
                                float(sum(_nbytes(o) for o in outs)),
                                _group_ranks(args))
            if self.track_memory:
                # a collective's result is its own buffer on the card; the
                # meta version of DTensor's all-to-all returns a view of
                # a group-sized staging tensor, so its size is the view's
                for o in outs:
                    self._hold(o, _nbytes(o))
            return
        self.n_ops += 1
        packet = func.overloadpacket
        if packet in flop_registry:
            f = float(flop_registry[packet](*args, **(kwargs or {}),
                                            out_val=out))
            self.matmul_flops += f
            self.flops += f
        elif name in _ELEMENTWISE:
            self.flops += float(sum(o.numel() for o in outs))
        elif name in _REDUCTIONS:
            ins = tensors(args)
            if ins:
                self.flops += float(ins[0].numel())
        if not func.is_view and name not in _NO_BYTES:
            self.bytes += float(sum(_nbytes(t) for t in tensors(args))
                                + sum(_nbytes(t) for t in tensors(kwargs))
                                + sum(_nbytes(o) for o in outs))
        if self.track_memory:
            for o in outs:
                self._hold(o)

    def _hold(self, t: torch.Tensor, nbytes: Optional[int] = None) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self.external:
            return
        ent = self.live.get(key)
        if ent is None:
            n = st.nbytes() if nbytes is None else nbytes
            self.live[key] = [n, 1]
            self.live_bytes += n
            self.peak = max(self.peak, self.live_bytes)
        else:
            ent[1] += 1
        weakref.finalize(t, self._release, key)

    def _release(self, key: int) -> None:
        ent = self.live.get(key)
        if ent is None:
            return
        ent[1] -= 1
        if ent[1] == 0:
            self.live_bytes -= ent[0]
            del self.live[key]

    def cost(self) -> Dict[str, float]:
        return {k: float(getattr(self, k)) for k in self.KEYS}

    def add_cost(self, cost: Dict[str, float], tag: Optional[str],
                 mult: int = 1) -> None:
        cost = {k: mult * v for k, v in cost.items()}
        for k in self.KEYS:
            setattr(self, k, getattr(self, k) + cost[k])
        if tag is not None and cost["bytes"]:
            self.bytes_by_tag[tag] = self.bytes_by_tag.get(tag, 0.0) \
                + cost["bytes"]


def _extrapolate(points, n: int):
    """The quadratic through `points` [(n_i, value_i)] (a constant or a
    line through fewer), evaluated exactly at `n`: a recurrence's cost is
    a polynomial of degree <= 2 in its length, since each step's slice
    of a time-major input puts a full-length zero gradient into the
    backward pass."""
    total = Fraction(0)
    for i, (ni, vi) in enumerate(points):
        w = Fraction(1)
        for j, (nj, _) in enumerate(points):
            if j != i:
                w *= Fraction(n - nj, ni - nj)
        total += w * Fraction(vi)
    return total


class _Region(torch.autograd.Function):
    """A counted region: ``torch.empty`` outputs forward, ``torch.empty``
    input gradients backward, each priced by its measurement."""

    @staticmethod
    def forward(info, *inputs):
        info["counter"]._charge(info, "fwd")
        outs = tuple(torch.empty(s, dtype=d, device="meta")
                     for s, d in info["out_specs"])
        return outs if len(outs) > 1 else outs[0]

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.info = inputs[0]
        ctx.set_materialize_grads(False)

    @staticmethod
    def backward(ctx, *cotangents):
        info = ctx.info
        # only the outputs the step used carry a cotangent, and the
        # backward of the others is never run
        used = tuple(c is not None for c in cotangents)
        info["counter"]._charge(info, ("bwd", used))
        return (None,) + tuple(
            torch.empty(s, dtype=d, device="meta") if g else None
            for (s, d), g in zip(info["in_specs"], info["grad_mask"]))


class _RegionCall:
    """One region call on a mesh, and what its forward learned (the
    measurement, the inputs' layouts) for its backward."""

    def __init__(self, counter, tag, fn, kw, time_args, unit, layout,
                 grad_mask):
        self.counter, self.tag, self.fn, self.kw = counter, tag, fn, kw
        self.time_args, self.unit, self.layout = time_args, unit, layout
        self.grad_mask = grad_mask


def contiguous_stride(shape) -> Tuple[int, ...]:
    stride, acc = [], 1
    for n in reversed(shape):
        stride.append(acc)
        acc *= n
    return tuple(reversed(stride))


def _empty_dtensor(local_shape, dtype, mesh, placements, shape):
    return DTensor.from_local(
        torch.empty(local_shape, dtype=dtype, device="meta"), mesh,
        placements, run_check=False, shape=torch.Size(shape),
        stride=contiguous_stride(shape))


def _batch_front(args, in_dims, size):
    """Each arg with its vmapped dim first; an unbatched tensor
    expanded to the batch."""
    out = []
    for a, d in zip(args, in_dims):
        if a is None or not isinstance(a, torch.Tensor):
            out.append(a)
        elif d is None:
            out.append(a.unsqueeze(0).expand(size, *a.shape))
        else:
            out.append(a.movedim(d, 0))
    return out


class _ShardedRegion(torch.autograd.Function):
    """A region on rank 0's shards: the args (DTensors; a plain tensor is
    taken as replicated) redistributed to the call's layout, the region
    charged at the shards' per-example shapes times the local count of
    the `lead` vmapped dims, and ``meta`` DTensors out.  The ``vmap``
    rule moves the batched dim first and counts it among `lead`, so
    the region reaches the DTensors under ``vmap(grad(...))``."""

    @staticmethod
    def forward(call, lead, *args):
        mesh = next(a.device_mesh for a in args if isinstance(a, DTensor))
        ins = [a if isinstance(a, DTensor) else DTensor.from_local(
            a, mesh, (Replicate(),) * mesh.ndim, run_check=False)
            for a in args]
        in_pl, outs = call.layout(ins, lead)
        moved = [a.redistribute(mesh, pl) for a, pl in zip(ins, in_pl)]
        locs = [a.to_local() for a in moved]
        lead_shape = tuple(locs[0].shape[:lead])
        mult = 1
        for n in lead_shape:
            mult *= n
        info = call.counter._info(
            call.tag, call.fn, [(tuple(t.shape[lead:]), t.dtype)
                                for t in locs],
            call.grad_mask, call.kw, call.time_args, call.unit)
        call.counter._charge(info, "fwd", mult)
        call.info, call.mult, call.mesh = info, mult, mesh
        call.inputs = [(a.placements, pl, tuple(a.shape), tuple(t.shape),
                        t.dtype) for a, pl, t in zip(ins, in_pl, locs)]
        res = tuple(_empty_dtensor(lead_shape + tuple(shape), dtype, mesh,
                                   pl, gshape)
                    for (shape, dtype), (pl, gshape)
                    in zip(info["out_specs"], outs))
        return res if len(res) > 1 else res[0]

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.call, ctx.lead = inputs[0], inputs[1]
        ctx.set_materialize_grads(False)

    @staticmethod
    def backward(ctx, *cotangents):
        call = ctx.call
        grads = iter(_RegionGrads.apply(call, ctx.lead, *cotangents))
        return (None, None) + tuple(next(grads) if g else None
                                    for g in call.grad_mask)

    @staticmethod
    def vmap(info, in_dims, call, lead, *args):
        out = _ShardedRegion.apply(
            call, lead + 1, *_batch_front(args, in_dims[2:],
                                          info.batch_size))
        return out, (0,) * len(out) if isinstance(out, tuple) else 0


class _RegionGrads(torch.autograd.Function):
    """A sharded region's backward: charged at its measurement, and the
    input gradients as ``meta`` DTensors in the region's layout,
    redistributed back to each input's own (the collectives counted)."""

    @staticmethod
    def forward(call, lead, *cotangents):
        used = tuple(c is not None for c in cotangents)
        call.counter._charge(call.info, ("bwd", used), call.mult)
        out = []
        for g, (orig, pl, gshape, lshape, dtype) in zip(call.grad_mask,
                                                          call.inputs):
            if g:
                d = _empty_dtensor(lshape, dtype, call.mesh, pl, gshape)
                out.append(d.redistribute(call.mesh, orig))
        return tuple(out)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, *grads):
        raise RuntimeError("a counted region has no second derivative")

    @staticmethod
    def vmap(info, in_dims, call, lead, *cotangents):
        out = _RegionGrads.apply(
            call, lead + 1, *_batch_front(cotangents, in_dims[2:],
                                          info.batch_size))
        return out, (0,) * len(out)


class OpCounter(TorchDispatchMode):
    """Counts every aten op dispatched while it is entered.  ``external``
    are tensors that exist before the count (params, optimizer state,
    batch, cache): views of them allocate nothing."""

    def __init__(self, external: Sequence[torch.Tensor] = ()):
        super().__init__()
        keys = [storage_key(t) for t in external]
        self._stack = [_Tally(track_memory=True, external=keys)]
        self._cache: Dict[Any, Dict] = {}
        self._token = None
        self.dispatched = 0      # aten ops this count ran, measurements too

    @property
    def tally(self) -> _Tally:
        return self._stack[0]

    def __enter__(self):
        self._token = _ACTIVE.set(self)
        return super().__enter__()

    def __exit__(self, *exc):
        _ACTIVE.reset(self._token)
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        flat = tree_flatten((args, kwargs))[0]
        if any(isinstance(x, DTensor) for x in flat):
            # DTensor's own dispatch runs beneath this mode: the ops it
            # runs on rank 0's shards, and the collectives of the
            # redistributions it inserts, come back here as plain tensors
            return NotImplemented
        out = func(*args, **(kwargs or {}))
        if any(isinstance(x, FakeTensor)
               for x in flat + tree_flatten(out)[0]):
            return out      # DTensor's sharding propagation: no step work
        self.dispatched += 1
        self._stack[-1].add_op(func, args, kwargs, out)
        return out

    # -- regions ---------------------------------------------------------
    def region(self, tag: str, fn: Callable, args: Sequence[torch.Tensor],
               kw: Optional[Dict] = None, *, time_args: Sequence[int] = (),
               unit: int = 1, layout: Optional[str] = None):
        """`fn(*args, **kw)` counted under `tag`.  `time_args` index the
        args whose dim 1 is time, of length T = n·`unit` (`unit`
        divides T): the count is fitted through short n
        (`_measure_phase`).  `kw` must be hashable.

        On a mesh (an arg is a DTensor beneath any ``torch.func``
        levels), `layout` names the region's layout in
        `sharding.api.REGION_LAYOUTS`: a function of (args, `lead` leading
        vmapped dims) giving each arg's placements and each output's
        (placements, global shape).  The args are redistributed to
        it (the collectives counted), the region is measured on rank 0's
        shards and returns DTensors: `_ShardedRegion`."""
        kw = dict(kw or {})
        grad_mask = tuple(bool(a.requires_grad) for a in args)
        if layout is not None and any(isinstance(beneath(a), DTensor)
                                      for a in args):
            call = _RegionCall(self, tag, fn, kw, tuple(time_args), unit,
                               REGION_LAYOUTS[layout], grad_mask)
            return _ShardedRegion.apply(call, 0, *args)
        info = self._info(tag, fn, [(tuple(a.shape), a.dtype) for a in args],
                          grad_mask, kw, tuple(time_args), unit)
        return _Region.apply(info, *args)

    def _info(self, tag, fn, specs, grad_mask, kw, time_args, unit):
        """A region's cached measurement at the input `specs`."""
        key = (tag, fn, tuple(specs), grad_mask, tuple(sorted(kw.items())),
               time_args, unit)
        info = self._cache.get(key)
        if info is None:
            n = specs[time_args[0]][0][1] // unit if time_args else 1
            info = {"counter": self, "tag": tag, "fn": fn, "kw": kw,
                    "grad_mask": grad_mask, "time_args": time_args,
                    "unit": unit, "n": n, "in_specs": list(specs)}
            info["fwd"] = self._measure_phase(info, "fwd")
            self._cache[key] = info
        return info

    def _charge(self, info, phase, mult: int = 1) -> None:
        if info.get(phase) is None:
            info[phase] = self._measure_phase(info, phase)
        self._stack[-1].add_cost(info[phase], info["tag"], mult)

    @staticmethod
    def _inputs(info, n: int):
        """Fresh inputs of the region with time length n·unit."""
        out = []
        for i, (shape, dtype) in enumerate(info["in_specs"]):
            if i in info["time_args"]:
                shape = (shape[0], n * info["unit"]) + tuple(shape[2:])
            out.append(torch.empty(shape, dtype=dtype, device="meta"))
        return out

    def _run(self, fn: Callable) -> Tuple[Dict[str, float], Any]:
        self._stack.append(_Tally(track_memory=False))
        try:
            out = fn()
        finally:
            tally = self._stack.pop()
        return tally.cost(), out

    def _one_run(self, info, n: int, phase):
        """(cost, output specs) of the region at length n: its forward
        alone, or the backward of a ``torch.func.vjp`` of the outputs
        ``phase = ("bwd", used)`` marks."""
        fn, kw = info["fn"], info["kw"]
        _, ins = self._run(lambda: self._inputs(info, n))
        if phase == "fwd":
            with torch.no_grad():
                cost, out = self._run(lambda: fn(*ins, **kw))
            outs = out if isinstance(out, tuple) else (out,)
            return cost, [(tuple(o.shape), o.dtype) for o in outs]
        idx = [i for i, g in enumerate(info["grad_mask"]) if g]
        used = phase[1]

        def primal(*wrt):
            full = list(ins)
            for i, t in zip(idx, wrt):
                full[i] = t
            out = fn(*full, **kw)
            out = out if isinstance(out, tuple) else (out,)
            return tuple(o for o, u in zip(out, used) if u)

        with torch.enable_grad():
            _, (out, vjp_fn) = self._run(
                lambda: torch.func.vjp(primal, *[ins[i] for i in idx]))
            cost, _ = self._run(lambda: vjp_fn(tuple(
                torch.empty(o.shape, dtype=o.dtype, device="meta")
                for o in out)))
        return cost, None

    def _measure_phase(self, info, phase) -> Dict[str, float]:
        """A phase's cost at the full length: measured there when the
        length is short or there is no time axis, else fitted through
        n = 2, 3, 4 (1 could meet an edge case of the loop).  Sets the
        output specs on the forward phase."""
        n = info["n"]
        lengths = (2, 3, 4) if info["time_args"] and n > 4 else (n,)
        runs = [(m,) + self._one_run(info, m, phase) for m in lengths]
        cost = {k: float(_extrapolate([(m, c[k]) for m, c, _ in runs], n))
                for k in _Tally.KEYS}
        if phase == "fwd":
            info["out_specs"] = [
                (tuple(int(_extrapolate(
                    [(m, specs[j][0][d]) for m, _, specs in runs], n))
                       for d in range(len(shape))), dtype)
                for j, (shape, dtype) in enumerate(runs[0][2])]
        return cost


def analyze_ops(fn: Callable, *args) -> Dict:
    """Count ``fn(*args)`` on ``meta`` tensors, per device: on a mesh
    (DTensor args) as rank 0 runs it, every size from rank 0's shards.
    Returns the keys of the reference's ``analyze_hlo`` (``flops``,
    ``bytes``, ``collectives``: {kind: {bytes, count, nvlink, network}}
    in wire bytes, ``collective_bytes``, ``bytes_by_tag``) and
    ``matmul_flops``, ``n_ops``, ``peak_bytes`` (the largest live total
    of the storages the step created) and ``out`` (what `fn` returned);
    ``n_ops`` counts the ops of the plain path, each region's at its full
    length, and ``dispatched`` the ops the count itself ran.  The tensors
    among `args` exist before the count: views of them allocate
    nothing."""
    with OpCounter(external=tensors(args)) as counter:
        out = fn(*args)
    t = counter.tally
    return {"flops": t.flops, "bytes": t.bytes,
            "collectives": {k: dict(v) for k, v in t.collectives.items()},
            "collective_bytes": sum(v["bytes"]
                                    for v in t.collectives.values()),
            "bytes_by_tag": dict(t.bytes_by_tag),
            "matmul_flops": t.matmul_flops, "n_ops": t.n_ops,
            "peak_bytes": float(t.peak), "dispatched": counter.dispatched,
            "out": out}
