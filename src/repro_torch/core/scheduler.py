"""Continuum-aware placement and the accuracy<->time knob (paper Gap 3,
Figs 3a/3b).

"the STIGMA EHR system assesses the complexity of the ML algorithms and the
training data structure to select suitable resources in the computing
continuum ... Then, based on the available hospital computational
infrastructure, a decision is taken where to conduct the training and
identify the accuracy level."

Host float64 arithmetic over the cost model (`continuum.costmodel`) and
the CNN's analytic FLOP count, equal to the JAX package's.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np

from repro_torch.configs.stigma_cnn import CNNConfig, STIGMA_CNN
from repro_torch.continuum.costmodel import training_time
from repro_torch.continuum.resources import C3_TESTBED, Resource
from repro_torch.models import stigma_cnn as cnn

# Paper Fig 3b anchor points: accuracy -> fraction of full training time.
ACCURACY_TIME_ANCHORS = {0.97: 1.00, 0.85: 0.38, 0.70: 0.10}


def width_for_time_fraction(cfg: CNNConfig, frac: float) -> float:
    """Invert flops_per_image(width)/flops_per_image(1.0) = frac (bisection)."""
    full = cnn.flops_per_image(cfg, 1.0)
    lo, hi = 0.02, 1.0
    for _ in range(60):
        mid = 0.5 * (lo + hi)
        if cnn.flops_per_image(cfg, mid) / full > frac:
            hi = mid
        else:
            lo = mid
    return 0.5 * (lo + hi)


def accuracy_to_width(target_accuracy: float,
                      cfg: CNNConfig = STIGMA_CNN) -> float:
    """Monotone interpolation through the paper's (accuracy, time) anchors."""
    accs = sorted(ACCURACY_TIME_ANCHORS)              # [0.70, 0.85, 0.97]
    fracs = [ACCURACY_TIME_ANCHORS[a] for a in accs]
    a = float(np.clip(target_accuracy, accs[0], accs[-1]))
    frac = float(np.interp(a, accs, fracs))
    return width_for_time_fraction(cfg, frac)


def time_fraction_for_accuracy(target_accuracy: float,
                               cfg: CNNConfig = STIGMA_CNN) -> float:
    w = accuracy_to_width(target_accuracy, cfg)
    return cnn.flops_per_image(cfg, w) / cnn.flops_per_image(cfg, 1.0)


@dataclass(frozen=True)
class Workload:
    flops_per_sample: float
    n_samples: int
    epochs: int
    model_size_mb: float


def cnn_workload(cfg: CNNConfig = STIGMA_CNN, epochs: int = 30,
                 width_scale: float = 1.0) -> Workload:
    n_params = sum(9 * cin * cout for cin, cout in zip(
        (cfg.in_channels,) + cnn.scaled_channels(cfg, width_scale)[:-1],
        cnn.scaled_channels(cfg, width_scale)))
    return Workload(
        flops_per_sample=cnn.flops_per_image(cfg, width_scale),
        n_samples=cfg.n_samples,
        epochs=epochs,
        model_size_mb=n_params * 4 / 1e6 + 0.5,
    )


@dataclass(frozen=True)
class Placement:
    resource: str
    est_time_s: float
    width_scale: float
    target_accuracy: float
    per_resource_times: Dict[str, float]


class ContinuumScheduler:
    """Greedy earliest-finish placement over the C3 tiers (paper §4.3)."""

    def __init__(self, resources: Optional[Dict[str, Resource]] = None,
                 inference_resource: str = "njn"):
        self.resources = dict(resources or C3_TESTBED)
        self.inference_resource = inference_resource

    def estimate_all(self, workload: Workload) -> Dict[str, float]:
        inf = self.resources[self.inference_resource]
        return {name: training_time(r, workload.flops_per_sample,
                                    workload.n_samples, workload.epochs,
                                    workload.model_size_mb, inf)
                for name, r in self.resources.items()}

    def place(self, target_accuracy: float = 0.97, epochs: int = 30,
              available: Optional[set] = None) -> Placement:
        width = accuracy_to_width(target_accuracy)
        wl = cnn_workload(epochs=epochs, width_scale=width)
        times = self.estimate_all(wl)
        pool = {k: v for k, v in times.items()
                if available is None or k in available}
        best = min(pool, key=pool.get)
        return Placement(resource=best, est_time_s=pool[best],
                         width_scale=width, target_accuracy=target_accuracy,
                         per_resource_times=times)
