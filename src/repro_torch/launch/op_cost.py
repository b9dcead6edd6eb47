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
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

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
        self.track_memory = track_memory
        self.external = set(external)
        self.live: Dict[int, list] = {}
        self.live_bytes = 0
        self.peak = 0

    def add_op(self, func, args, kwargs, out) -> None:
        self.n_ops += 1
        name = _name(func)
        outs = tensors(out)
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

    def _hold(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self.external:
            return
        ent = self.live.get(key)
        if ent is None:
            n = st.nbytes()
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

    def add_cost(self, cost: Dict[str, float], tag: Optional[str]) -> None:
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


class OpCounter(TorchDispatchMode):
    """Counts every aten op dispatched while it is entered.  ``external``
    are tensors that exist before the count (params, optimizer state,
    batch, cache): views of them allocate nothing."""

    def __init__(self, external: Sequence[torch.Tensor] = ()):
        super().__init__()
        keys = [t.untyped_storage()._cdata for t in external]
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
        out = func(*args, **(kwargs or {}))
        self.dispatched += 1
        self._stack[-1].add_op(func, args, kwargs, out)
        return out

    # -- regions ---------------------------------------------------------
    def region(self, tag: str, fn: Callable, args: Sequence[torch.Tensor],
               kw: Optional[Dict] = None, *, time_args: Sequence[int] = (),
               unit: int = 1):
        """`fn(*args, **kw)` counted under `tag`.  `time_args` index the
        args whose dim 1 is time, of length T = n·`unit` (`unit`
        divides T): the count is fitted through short n
        (`_measure_phase`).  `kw` must be hashable."""
        kw = dict(kw or {})
        grad_mask = tuple(bool(a.requires_grad) for a in args)
        key = (tag, fn, tuple((tuple(a.shape), a.dtype) for a in args),
               grad_mask, tuple(sorted(kw.items())), tuple(time_args), unit)
        info = self._cache.get(key)
        if info is None:
            n = args[time_args[0]].shape[1] // unit if time_args else 1
            info = {"counter": self, "tag": tag, "fn": fn, "kw": kw,
                    "grad_mask": grad_mask, "time_args": tuple(time_args),
                    "unit": unit, "n": n,
                    "in_specs": [(tuple(a.shape), a.dtype) for a in args]}
            info["fwd"] = self._measure_phase(info, "fwd")
            self._cache[key] = info
        return _Region.apply(info, *args)

    def _charge(self, info, phase) -> None:
        if info.get(phase) is None:
            info[phase] = self._measure_phase(info, phase)
        self._stack[-1].add_cost(info[phase], info["tag"])

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
    """Count ``fn(*args)`` on ``meta`` tensors.  Returns the keys of the
    reference's ``analyze_hlo`` (``flops``, ``bytes``, ``collectives``,
    ``collective_bytes``, ``bytes_by_tag``; one card, so no
    collectives) and ``matmul_flops``, ``n_ops``, ``peak_bytes`` (the
    largest live total of the storages the step created) and ``out``
    (what `fn` returned); ``n_ops`` counts the ops of the plain path,
    each region's at its full length, and ``dispatched`` the ops the count
    itself ran.  The tensors among `args` exist before the count: views
    of them allocate nothing."""
    with OpCounter(external=tensors(args)) as counter:
        out = fn(*args)
    t = counter.tally
    return {"flops": t.flops, "bytes": t.bytes, "collectives": {},
            "collective_bytes": 0.0, "bytes_by_tag": dict(t.bytes_by_tag),
            "matmul_flops": t.matmul_flops, "n_ops": t.n_ops,
            "peak_bytes": float(t.peak), "dispatched": counter.dispatched,
            "out": out}
