"""What the harness, the drivers and the metric readers share: a run's
context and outcome, the checks that decide `correct`, and the
statistics of a window."""
from __future__ import annotations

import dataclasses
import importlib
import math
import statistics
import sys
from typing import Any, Dict, List, Optional, Sequence

import torch


@dataclasses.dataclass
class Context:
    name: str                 # the cell
    cell: Dict                # bench/workloads/<cell>.json
    config: Dict              # the configuration's file
    seed: int
    seconds: float
    trace: bool
    device: Any
    t_start: float            # process start, host clock (time.time)


@dataclasses.dataclass
class Check:
    """One number that decides `correct`: it holds when value <= limit."""
    name: str
    value: float
    limit: float

    @property
    def holds(self) -> bool:
        return math.isfinite(self.value) and self.value <= self.limit


@dataclasses.dataclass
class Outcome:
    metrics: Dict[str, float]          # end-to-end metrics by name
    attempted: int
    failed: int
    checks: List[Check]
    memory_peak: int
    counters: Dict[str, Any]           # what the per-layer readers read
    trace: Optional[Dict] = None       # bench.trace.Window's result

    @property
    def correct(self) -> bool:
        return bool(self.checks) and all(c.holds for c in self.checks)


def reference(config: Dict):
    """The plain reference that a configuration's file names
    (`bench/reference/<reference>.py`): its model, its seeded weights and
    its operation counts."""
    return importlib.import_module(f"bench.reference.{config['reference']}")


def sync(device) -> None:
    """Wait for the card (nothing to wait for on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def peak_bytes(device) -> int:
    """The allocator's peak on the card so far (0 on the CPU)."""
    if device.type == "cuda":
        return int(torch.cuda.max_memory_allocated(device))
    return 0


def checks_from(numbers: Dict[str, float], limits: Dict[str, float]
                ) -> List[Check]:
    """A Check for each limit of the cell; a number the run could not
    produce reads as infinite, so it fails."""
    return [Check(k, float(numbers.get(k, math.inf)), float(v))
            for k, v in limits.items()]


def p90(values: Sequence[float]) -> Optional[float]:
    """The 90th percentile (`statistics.quantiles`, exclusive method);
    None for fewer than two values."""
    if len(values) < 2:
        return None
    return statistics.quantiles(values, n=10)[8]


def spread(what: str, seconds: Sequence[float]) -> None:
    """A line on standard error with the quantiles of a window's call
    times, in ms: whether a slow run is slow all through or in a few
    calls."""
    if len(seconds) < 2:
        return
    ms = [1e3 * s for s in seconds]
    q = statistics.quantiles(ms, n=10)
    print(f"{what}: ms p10 {q[0]:.2f} p50 {statistics.median(ms):.2f} "
          f"p90 {q[8]:.2f} max {max(ms):.2f}, {sum(seconds):.3f} s in all",
          file=sys.stderr)


def norm_gap(prog: Sequence, ref: Sequence) -> float:
    """Worst leaf: | ||prog_leaf|| - ||ref_leaf|| | over the larger of
    ||ref_leaf|| and the median leaf's ||ref||."""
    pn = [float(p.double().norm()) for p in prog]
    rn = [float(r.double().norm()) for r in ref]
    med = statistics.median(rn)
    return max(abs(a - b) / max(b, med, 1e-30) for a, b in zip(pn, rn))
