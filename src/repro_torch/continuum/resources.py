"""Computing-continuum resource tiers: Table 1 of the paper (Carinthian
Computing Continuum), the tiers whose latencies the consensus simulation
draws from and the cost model prices, copied from the JAX package's
``continuum/resources.py``; and the roofline constants of the card the
port runs on (`H100_SXM`; the JAX package's TPU constants stay there).

Bandwidth figures are the paper's measured Mb/s; sustained GFLOP/s are
calibrated so that the cost model reproduces the paper's Fig 3a ordering
(EGS about 60% faster than the cloud instances, NJN competitive, RPi4
slowest)."""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class Resource:
    name: str
    tier: str                  # cci | fog | edge
    gflops: float              # sustained train-throughput GFLOP/s (calibrated)
    memory_gb: float
    bandwidth_mbps: float      # paper Table 1 "BW [Mb/s]"
    latency_s: float           # one-way message latency to the C3 backbone


C3_TESTBED = {
    # Centralized Computing Infrastructure (AWS)
    "m5a.xlarge": Resource("m5a.xlarge", "cci", 120.0, 32, 27, 0.040),
    "c5.large":   Resource("c5.large",   "cci", 100.0, 8,  26, 0.040),
    # Fog Cluster (Exoscale, <=12 ms latency)
    "es.large":   Resource("es.large",   "fog", 140.0, 8,  65, 0.012),
    "es.medium":  Resource("es.medium",  "fog",  80.0, 4,  65, 0.012),
    # Edge Cluster
    "egs":        Resource("egs",        "edge", 300.0, 32, 813, 0.001),
    "njn":        Resource("njn",        "edge", 235.0, 4,  450, 0.001),
    "rpi4":       Resource("rpi4",       "edge",  12.0, 4,  800, 0.001),
}


@dataclass(frozen=True)
class Accelerator:
    name: str
    peak_flops_bf16: float     # FLOP/s per chip
    hbm_bandwidth: float       # bytes/s per chip
    ici_bandwidth: float       # bytes/s per link
    hbm_gb: float
    vmem_mb: float


# NVIDIA H100 SXM5 (80 GB HBM3): the bf16 tensor-core rate (dense) and
# the HBM rate of NVIDIA's data sheet, the rates chip_smoke.py's kernel
# bounds read.  ``ici_bandwidth`` is NVLink 4's rate in one direction (900 GB/s
# both ways over 18 links); ``vmem_mb`` holds the card's closest
# counterpart of a TPU core's vector memory, the 50 MB L2 cache.
H100_SXM = Accelerator(
    name="h100-sxm",
    peak_flops_bf16=989e12,
    hbm_bandwidth=3.35e12,
    ici_bandwidth=450e9,
    hbm_gb=80.0,
    vmem_mb=50.0,
)
