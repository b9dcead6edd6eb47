"""Computing-continuum resource tiers: Table 1 of the paper (Carinthian
Computing Continuum), the tiers whose latencies the consensus simulation
draws from.  A copy of the JAX package's ``continuum/resources.py``."""
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
