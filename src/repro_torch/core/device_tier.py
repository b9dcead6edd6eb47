"""Two-tier continuum federation: the DEVICE axis under each institution.

The paper's leaf unit is the institution (P <= 64 hospitals); its vision is
personal medical devices feeding the hospitals' EHRs across the continuum.
This module adds that tier: every institution fronts a sub-federation of
``n_devices`` simulated devices whose local updates aggregate FedAvg-style
(weighted by each device's sample count) into the institution's round
update, which then enters the consensus, merge and DLT pipeline unchanged
through the registered ``hierarchical_device`` merge
(`core.merges.strategies`), whose institution-level mean is weighted by
each institution's device-weight total (`MergeContext.device_weights`).

Memory: O(chunk), never O(D)
----------------------------
The sweep is a Python loop over fixed-size chunks of the device axis.  A
device's shard and fault draws are counter-PRG functions of (seed, sweep,
institution, device) (`data.pipeline`, `chaos.schedule.DeviceSchedule`),
drawn on the device inside the chunk, so no (D, ...) tensor ever exists
and peak memory is bounded by the chunk size.  No chunk syncs with the
host (no ``.item()``, no Python branch on a tensor): the whole sweep runs
under the overlay's `torch.func.vmap` over institutions.

Exact aggregation: no chunk size changes a bit
----------------------------------------------
A float running mean depends on the summation order, so the sweep
aggregates in integers, as the JAX package does:

  1. each device's float32 update is clipped to +-clip and encoded at
     ``frac_bits`` fractional bits (round half to even, int32), then
     scaled by its integer sample weight (the config keeps the product
     inside int32);
  2. a chunk's contributions sum exactly in int64: |w*e| < 2^31 and at
     most 65,536 addends, so a chunk's sum stays under 2^47;
  3. chunk sums fold into an int64 accumulator that wraps mod 2^64.  The
     JAX package carries the same mod-2^64 sums as two uint32 limbs (XLA
     reduces uint32, not int64): its limbs are ``acc & 0xFFFFFFFF`` and
     ``(acc >> 32) & 0xFFFFFFFF`` of this accumulator.  Addition mod 2^64
     is associative and commutative, so every chunk partition of the
     device axis, the one-device loop of `device_sweep_reference`
     included, gives the same sums;
  4. one decode (`_decode_mean`) maps the sums to the float32 weighted
     mean: the high limb read as int32, times 2^32 (exact), plus the low
     limb rounded to float32, over max(w, 1) * 2^frac_bits, the JAX
     package's IEEE operations in its order.

Bounded staleness
-----------------
Late devices (past the deadline, `DeviceSchedule`) are not dropped: their
integer contributions accumulate in an institution-local stale buffer
carried between rounds and admitted into the NEXT round's aggregation
(``staleness_bound=1``; ``0`` drops them).  The buffer lives in the
overlay state dict beside ``"params"``; ``merge_subtree`` keeps it
institution-local, like optimizer state.

dtypes
------
The state keeps the JAX package's dtypes: uint32 limbs and weights, int32
institution ids, so a JAX device state carries across
(`convert.params_from_jax`) and a snapshot writes uint32.  On CUDA torch
has few uint32 operations (conversions, views, copies), so the sweep
widens every uint32 leaf to int64 on entry and narrows on exit.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from repro_torch.pytree import tree_flatten, tree_map, tree_unflatten

Pytree = Any

DEVICE_FRAC_BITS = 16   # fixed-point fraction, the secure-agg budget
_M32 = 0xFFFFFFFF


@dataclasses.dataclass(frozen=True)
class DeviceTierConfig:
    """Static configuration of one institution's device sub-federation.

    n_devices        devices per institution (D); the benchmark headline is
                     P=64 x D=16384 = 2^20 devices per federation round
    chunk_size       devices processed per chunk, the memory knob.  At
                     most 65536 (the JAX package's 16-bit limb sums hold
                     exactly that many addends)
    clip             update clip: the fixed-point window is [-clip, clip]
    max_weight       max per-device sample count (FedAvg weight)
    staleness_bound  rounds a late device's update may age before
                     admission: 1 = fold into the next round's carry
                     (default), 0 = drop late updates
    faults           optional `chaos.schedule.DeviceSchedule`: per-device
                     dropout and straggler draws
    frac_bits        fixed-point fractional bits of the encoding
    """
    n_devices: int
    chunk_size: int = 1024
    clip: float = 4.0
    max_weight: int = 64
    staleness_bound: int = 1
    faults: Optional[Any] = None
    frac_bits: int = DEVICE_FRAC_BITS

    def __post_init__(self):
        if self.n_devices < 1:
            raise ValueError(f"n_devices must be >= 1; got {self.n_devices}")
        if not 1 <= self.chunk_size <= 65536:
            raise ValueError(
                f"chunk_size must be in [1, 65536] (16-bit limb sums wrap "
                f"past 65536 addends); got {self.chunk_size}")
        if self.staleness_bound not in (0, 1):
            raise ValueError(
                f"staleness_bound must be 0 (drop late) or 1 (admit next "
                f"round); got {self.staleness_bound}")
        if self.max_weight < 1:
            raise ValueError(f"max_weight must be >= 1; got "
                             f"{self.max_weight}")
        enc_max = self.clip * 2.0 ** self.frac_bits
        if enc_max * self.max_weight >= 2 ** 31:
            raise ValueError(
                f"clip * 2^frac_bits * max_weight = "
                f"{enc_max * self.max_weight:.3g} overflows int32; shrink "
                f"clip, frac_bits, or max_weight")
        # weight totals (the uint32 survivor-weight sum) must stay exact
        if self.n_devices * self.max_weight >= 2 ** 31:
            raise ValueError(
                f"n_devices * max_weight = "
                f"{self.n_devices * self.max_weight} overflows the weight "
                f"accumulator")

    @property
    def n_chunks(self) -> int:
        return -(-self.n_devices // self.chunk_size)


# ----------------------------------------------------------------------
# exact integer machinery (the chunked sweep, the stacked baseline and the
# per-device loop reference share it)

def encode_update(u: torch.Tensor, cfg: DeviceTierConfig) -> torch.Tensor:
    """float32 update -> int32 fixed point: the clipped value at
    cfg.frac_bits, rounded half to even.  Elementwise, hence layout
    invariant."""
    c = float(np.float32(cfg.clip))
    return torch.round(torch.clamp(u, -c, c)
                       * float(2.0 ** cfg.frac_bits)).to(torch.int32)


def _chunk_sum64(c: torch.Tensor) -> torch.Tensor:
    """Exact sum of int32 contributions over the leading (chunk) axis, in
    int64: the JAX package's two-limb sum mod 2^64 as one int64."""
    return c.sum(dim=0, dtype=torch.int64)


def _from_limbs(lo, hi) -> torch.Tensor:
    """uint32 limbs (any integer dtype holding uint32 values) -> the int64
    that holds ``lo + hi * 2^32`` mod 2^64."""
    return lo.to(torch.int64) | (hi.to(torch.int64) << 32)


def _to_limbs(acc: torch.Tensor):
    """int64 -> its (lo, hi) uint32 limbs, as int64 values in [0, 2^32)."""
    return acc & _M32, (acc >> 32) & _M32


def _decode64(acc: torch.Tensor, wsum, frac_bits: int) -> torch.Tensor:
    """`_decode_mean` of an int64 sum: ``acc >> 32`` is the high limb read
    as int32, ``acc & 0xFFFFFFFF`` the low limb."""
    val = ((acc >> 32).to(torch.float32) * float(2.0 ** 32)
           + (acc & _M32).to(torch.float32))
    wsafe = torch.clamp(torch.as_tensor(wsum).to(torch.int64),
                        min=1).to(torch.float32)
    return val / (wsafe * float(2.0 ** frac_bits))


def _decode_mean(lo, hi, wsum, frac_bits: int) -> torch.Tensor:
    """Deterministic decode: the (lo, hi) limbs of a sum of weight-scaled
    fixed-point updates -> the float32 weighted mean update.  hi is read
    as int32 and scaled by 2^32 (exact in float32), lo is rounded to
    float32, and the one add and the division round as the JAX package's
    do."""
    return _decode64(_from_limbs(lo, hi), wsum, frac_bits)


def zero_stale(params: Pytree) -> Dict[str, Any]:
    """Empty stale buffer for one institution: uint32 limb trees shaped
    like the params and a scalar weight, on the params' device."""
    def z(p):
        return torch.zeros(tuple(p.shape), dtype=torch.uint32,
                           device=p.device)
    device = tree_flatten(params)[0][0].device
    return {"lo": tree_map(z, params), "hi": tree_map(z, params),
            "w": torch.zeros((), dtype=torch.uint32, device=device)}


# ----------------------------------------------------------------------
# the chunked sweep and its per-device loop reference

def device_sweep(params: Pytree, sweep_id, inst_id, stale: Dict[str, Any],
                 cfg: DeviceTierConfig,
                 data_fn: Callable, update_fn: Callable):
    """One institution's device sweep, chunk by chunk.

    data_fn(sweep, inst, ids) -> (per-device batch pytree with a leading
    chunk axis, (chunk,) integer sample weights); update_fn(params, batch
    row) -> an update pytree shaped like params (vmapped over the chunk).

    Returns ``(mean_update, new_stale, stats)``: mean_update is the
    float32 weighted mean over this sweep's ON-TIME devices plus the
    admitted stale buffer, new_stale (uint32 limbs and weight) holds this
    sweep's LATE contributions, and stats carries uint32 on-time and late
    counts and the admitted weight total.  The loop has no host sync, so
    the sweep runs under `torch.func.vmap` over institutions."""
    C, D = cfg.chunk_size, cfg.n_devices
    leaves, spec = tree_flatten(params)
    device = leaves[0].device
    acc = [torch.zeros_like(l, dtype=torch.int64) for l in leaves]
    sacc = list(acc)
    zero = torch.zeros((), dtype=torch.int64, device=device)
    w_on, sw, n_on, n_late = zero, zero, zero, zero
    ar = torch.arange(C, dtype=torch.int32, device=device)
    per_device = torch.func.vmap(update_fn, in_dims=(None, 0))

    def fold(sel, w, enc, accs):
        selw = torch.where(sel, w, 0).to(torch.int32)
        return [a + _chunk_sum64(e * selw.reshape((C,) + (1,) * (e.dim() - 1)))
                for e, a in zip(enc, accs)]

    for k in range(cfg.n_chunks):
        ids = ar + k * C
        valid = ids < D
        batch, w = data_fn(sweep_id, inst_id, ids)
        w = w.to(torch.int64)
        upd = per_device(params, batch)
        if cfg.faults is not None:
            on_time, late = cfg.faults.draw(sweep_id, inst_id, ids)
            on_time, late = on_time & valid, late & valid
        else:
            on_time, late = valid, torch.zeros_like(valid)
        enc = [encode_update(l, cfg) for l in tree_flatten(upd)[0]]
        acc = fold(on_time, w, enc, acc)
        w_on = w_on + torch.where(on_time, w, 0).sum()
        n_on = n_on + on_time.sum()
        n_late = n_late + late.sum()
        if cfg.staleness_bound >= 1:
            sacc = fold(late, w, enc, sacc)
            sw = sw + torch.where(late, w, 0).sum()

    # bounded-staleness admission: last round's late devices join this
    # round's aggregation, by exact adds mod 2^64
    if cfg.staleness_bound >= 1:
        acc = [a + _from_limbs(lo, hi) for a, lo, hi
               in zip(acc, tree_flatten(stale["lo"])[0],
                      tree_flatten(stale["hi"])[0])]
        wtot = (w_on + stale["w"].to(torch.int64)) & _M32
    else:
        wtot = w_on
    mean = [_decode64(a, wtot, cfg.frac_bits) for a in acc]

    def u32(x):
        return x.to(torch.uint32)
    limbs = [_to_limbs(s) for s in sacc]
    new_stale = {"lo": tree_unflatten(spec, [u32(lo) for lo, _ in limbs]),
                 "hi": tree_unflatten(spec, [u32(hi) for _, hi in limbs]),
                 "w": u32(sw)}
    stats = {"on_time": u32(n_on), "late": u32(n_late), "weight": u32(wtot)}
    return tree_unflatten(spec, mean), new_stale, stats


def device_sweep_reference(params: Pytree, sweep_id: int, inst_id: int,
                           stale: Dict[str, Any], cfg: DeviceTierConfig,
                           data_fn: Callable, update_fn: Callable):
    """Plain per-device loop oracle on the host: visits every device one at
    a time, accumulates the weight-scaled fixed-point contributions in
    exact numpy int64 (|w*e| < 2^31, exact far past any test D), and
    decodes through the same `_decode_mean`.  `device_sweep` must match it
    bit for bit at every chunk size.  A test oracle, never on a path."""
    params = tree_map(lambda x: x.detach().cpu(), params)
    leaves, spec = tree_flatten(params)
    tot = [np.zeros(tuple(l.shape), np.int64) for l in leaves]
    stl = [np.zeros(tuple(l.shape), np.int64) for l in leaves]
    w_on = w_late = n_on = n_late = 0
    for d in range(cfg.n_devices):
        ids = torch.tensor([d], dtype=torch.int32)
        batch, w = data_fn(sweep_id, inst_id, ids)
        if cfg.faults is not None:
            on_time, late = cfg.faults.draw_host(sweep_id, inst_id,
                                                 np.asarray([d]))
            on_time, late = bool(on_time[0]), bool(late[0])
        else:
            on_time, late = True, False
        if not (on_time or (late and cfg.staleness_bound >= 1)):
            n_late += int(late)
            continue
        row = tree_map(lambda b: b[0], batch)
        upd = update_fn(params, row)
        wd = int(w[0])
        enc = [encode_update(l, cfg).numpy().astype(np.int64)
               for l in tree_flatten(upd)[0]]
        dst = tot if on_time else stl
        for t, e in zip(dst, enc):
            t += wd * e
        if on_time:
            w_on += wd
            n_on += 1
        else:
            w_late += wd
            n_late += 1

    if cfg.staleness_bound >= 1:
        tot = [t + _from_limbs(lo.cpu(), hi.cpu()).numpy() for t, lo, hi
               in zip(tot, tree_flatten(stale["lo"])[0],
                      tree_flatten(stale["hi"])[0])]
        wtot = w_on + int(stale["w"])
    else:
        wtot = w_on
    mean = [_decode64(torch.from_numpy(t), wtot, cfg.frac_bits) for t in tot]

    def limb(t, k):
        return _to_limbs(torch.from_numpy(t))[k].to(torch.uint32)

    def u32(v):
        return torch.tensor(v, dtype=torch.int64).to(torch.uint32)
    new_stale = {"lo": tree_unflatten(spec, [limb(t, 0) for t in stl]),
                 "hi": tree_unflatten(spec, [limb(t, 1) for t in stl]),
                 "w": u32(w_late)}
    stats = {"on_time": u32(n_on), "late": u32(n_late), "weight": u32(wtot)}
    return tree_unflatten(spec, mean), new_stale, stats


def device_sweep_stacked(params: Pytree, sweep_id, inst_id,
                         stale: Dict[str, Any], cfg: DeviceTierConfig,
                         data_fn: Callable, update_fn: Callable):
    """The naive baseline: every device's batch and update as (D, ...)
    tensors in one vmap, then aggregated.  Identical to `device_sweep` (the
    same integer math over the whole axis, one chunk of size D), but its
    peak memory is O(D): the peak-memory counterfactual, not a path."""
    naive = dataclasses.replace(cfg, chunk_size=min(cfg.n_devices, 65536))
    if naive.n_chunks != 1:
        raise ValueError("stacked baseline needs n_devices <= 65536")
    return device_sweep(params, sweep_id, inst_id, stale, naive,
                        data_fn, update_fn)


# ----------------------------------------------------------------------
# overlay integration: the device tier as a local step over a state dict

def device_sweep_ids(n_rounds: int, local_steps: int, n_institutions: int,
                     start_round: int = 0, device=None) -> torch.Tensor:
    """(R, local_steps, P) int32 sweep ids, the device tier's ``batches``
    for `DecentralizedOverlay.run_rounds`: sweep (r, s) is the global step
    index (start_round + r) * local_steps + s, broadcast over institutions
    (each institution's devices draw from their own streams through the
    institution id).  On `device` (the CPU by default, like torch's
    factories): pass the state's device."""
    steps = (torch.arange(n_rounds, dtype=torch.int32)[:, None]
             + start_round) * local_steps \
        + torch.arange(local_steps, dtype=torch.int32)[None, :]
    return steps[:, :, None].expand(
        n_rounds, local_steps, n_institutions).contiguous().to(device)


def make_device_state(base_params: Pytree, n_institutions: int,
                      generator: Optional[torch.Generator] = None,
                      jitter: float = 0.0) -> Dict[str, Any]:
    """Stacked overlay state of a device-tier federation, on the base
    params' device: replicated params, empty uint32 stale buffers, uint32
    device weights and int32 institution ids.  Use with
    ``OverlayConfig(merge_subtree="params")`` (the default), so only the
    model is federated: stale limbs and device weights stay
    institution-local, like optimizer state."""
    # imported here: the overlay imports core, which exports this module
    from repro_torch.core.overlay import replicate_params
    stacked = replicate_params(base_params, n_institutions,
                               generator=generator, jitter=jitter)
    device = tree_flatten(stacked)[0][0].device

    def zeros(p):
        return torch.zeros(tuple(p.shape), dtype=torch.uint32, device=device)
    return {"params": stacked,
            "stale_lo": tree_map(zeros, stacked),
            "stale_hi": tree_map(zeros, stacked),
            "stale_w": torch.zeros((n_institutions,), dtype=torch.uint32,
                                   device=device),
            "device_w": torch.zeros((n_institutions,), dtype=torch.uint32,
                                    device=device),
            "inst": torch.arange(n_institutions, dtype=torch.int32,
                                 device=device)}


def make_device_local_step(cfg: DeviceTierConfig, data_fn: Callable,
                           update_fn: Callable):
    """Local step running one device sweep per step, ``local_step(state,
    sweep_id) -> (state, metrics)``.  The overlay vmaps it over
    institutions, so the P device sub-federations run side by side; the
    per-step ``batch`` is the scalar sweep id (`device_sweep_ids`).  The
    round's device-weight total lands in ``state["device_w"]``, which the
    overlay hands to `MergeContext.device_weights` for the
    ``hierarchical_device`` merge.  Metrics: ``device_on_time``,
    ``device_late`` and ``device_weight`` as float32."""
    def local_step(state, sweep_id):
        stale = {"lo": state["stale_lo"], "hi": state["stale_hi"],
                 "w": state["stale_w"]}
        upd, new_stale, stats = device_sweep(
            state["params"], sweep_id, state["inst"], stale, cfg,
            data_fn, update_fn)
        params = tree_map(lambda p, u: p + u, state["params"], upd)
        new_state = {"params": params,
                     "stale_lo": new_stale["lo"],
                     "stale_hi": new_stale["hi"],
                     "stale_w": new_stale["w"],
                     "device_w": stats["weight"],
                     "inst": state["inst"]}
        metrics = {"device_on_time": stats["on_time"].to(torch.float32),
                   "device_late": stats["late"].to(torch.float32),
                   "device_weight": stats["weight"].to(torch.float32)}
        return new_state, metrics
    return local_step
