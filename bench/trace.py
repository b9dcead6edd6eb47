"""The traced window: torch.profiler over part of a run, reduced to the
device's activity intervals, the card's busy time (the union of those
intervals), and the breakdown of the longest device operations and idle
gaps.

`prime_trace` and `device_events` are frozen copies of
``chip_smoke.py``'s.  A late trace can miss its first launches; the spin
kernels that open each trace stand in their place and are left out.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

import torch

PRIME_SPINS = 64    # short spin kernels that open each trace
TOP = 10            # entries of each breakdown list


def prime_trace():
    """Opens a trace with PRIME_SPINS short spin kernels and a 5 ms
    pause."""
    for _ in range(PRIME_SPINS):
        torch.cuda._sleep(100)
    torch.cuda.synchronize()
    time.sleep(0.005)


def device_events(prof):
    """(name, start us, device us) of each CUDA activity in a finished
    trace, in start order, without `prime_trace`'s spins and without the
    device-side copies of the benchmark's own host annotations
    (``bench.*``), which span the work and are none of it."""
    return sorted(((e.name, e.time_range.start, e.time_range.elapsed_us())
                   for e in prof.events()
                   if str(e.device_type).endswith("CUDA")
                   and "spin_kernel" not in e.name
                   and not e.name.startswith("bench.")),
                  key=lambda e: e[1])


def host_events(prof):
    """(name, start us, end us) of each host operation and annotation."""
    return [(e.name, e.time_range.start, e.time_range.end)
            for e in prof.events()
            if str(e.device_type).endswith("CPU")]


class Window:
    """A traced stretch of a run: ``with Window(on) as w: ...``, its
    length counted from `w.t0`, once the profiler runs.  When `on` is
    false it traces nothing.  The events are read by `read()`, after the
    measured window, so that reading them takes no window time."""

    def __init__(self, on: bool):
        self.on = on
        self.result: Optional[Dict] = None

    def __enter__(self):
        if self.on:
            acts = [torch.profiler.ProfilerActivity.CPU,
                    torch.profiler.ProfilerActivity.CUDA]
            self.prof = torch.profiler.profile(activities=acts)
            self.prof.__enter__()
            prime_trace()
            self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if not self.on:
            return False
        torch.cuda.synchronize()
        self.seconds = time.perf_counter() - self.t0
        self.prof.__exit__(*exc)
        return False

    def read(self) -> Optional[Dict]:
        """{"window_s", "device", "host"} of the traced stretch, or None."""
        if self.on and self.result is None:
            self.result = {"window_s": self.seconds,
                           "device": device_events(self.prof),
                           "host": host_events(self.prof)}
            del self.prof
        return self.result


def union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """The union of (start, end) intervals, merged, in order."""
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def busy_s(trace: Dict) -> float:
    """Seconds in which some operation ran on the device: the length of
    the union of the trace's device intervals."""
    merged = union([(s, s + d) for _, s, d in trace["device"]])
    return sum(e - s for s, e in merged) * 1e-6


def _innermost(host, t):
    """The shortest host event running at time `t`, and the outermost
    benchmark annotation (``bench.*``) around it."""
    inner, outer = None, None
    for name, s, e in host:
        if s <= t <= e:
            if inner is None or e - s < inner[2] - inner[1]:
                inner = (name, s, e)
            if name.startswith("bench.") and (
                    outer is None or e - s > outer[2] - outer[1]):
                outer = (name, s, e)
    parts = [p[0] for p in (outer, inner) if p is not None]
    return " / ".join(dict.fromkeys(parts)) or "no host operation"


def breakdown(trace: Dict) -> Dict:
    """The device operations that took most time (summed by name) and the
    longest idle gaps between device activity, each named by what the host
    was doing in the middle of it."""
    by_name: Dict[str, float] = {}
    for name, _, d in trace["device"]:
        by_name[name] = by_name.get(name, 0.0) + d * 1e-6
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    merged = union([(s, s + d) for _, s, d in trace["device"]])
    gaps = sorted(((b[0] - a[1], (a[1] + b[0]) / 2)
                   for a, b in zip(merged, merged[1:])), reverse=True)[:TOP]
    idle = [[_innermost(trace["host"], mid)[:200], g * 1e-6]
            for g, mid in gaps]
    return {"device_ops": [[n[:200], s] for n, s in ops], "idle_gaps": idle}


def kernel_launches(trace: Dict, names) -> List[Tuple[str, float]]:
    """(kernel, device us) of each launch whose function name is one of
    `names`, in start order.  A demangled name reads ``void name<...>(...)``
    or ``name(...)``, possibly in a namespace."""
    out = []
    for name, _, d in trace["device"]:
        if kernel_name(name) in names:
            out.append((kernel_name(name), d))
    return out


def kernel_name(name: str) -> str:
    """The bare function name of a demangled kernel: no return type,
    namespace, template arguments or parameters."""
    base = name.replace("(anonymous namespace)::", "")
    base = base[5:] if base.startswith("void ") else base
    base = base.split("(")[0].split("<")[0].strip()
    return base.split("::")[-1]
