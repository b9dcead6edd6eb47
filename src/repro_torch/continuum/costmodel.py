"""Analytic cost model for the computing continuum (paper Figs 3a, 3b, 4),
copied from the JAX package's ``continuum/costmodel.py``: host arithmetic,
so every modeled time equals the JAX package's as a float.

All estimates are *modeled* (no WAN link or edge device is measured); the
paper's validation targets are ratios, not absolute seconds.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

from repro_torch.continuum.resources import C3_TESTBED, Resource

MB_BITS = 8e6
TRAIN_FLOP_FACTOR = 3.0        # fwd + bwd ≈ 3x fwd FLOPs


@dataclass(frozen=True)
class DeviceProfile:
    """Uplink of ONE personal medical device in the two-tier continuum
    the last-hop link from a wearable/phone/bedside monitor to
    the edge institution that fronts it.  Only the link is modeled — the
    device-local update is a few FLOPs and never dominates."""
    name: str
    bandwidth_mbps: float
    latency_s: float


# The device tier under the C3 testbed's edge institutions.  Bandwidths
# are conservative sustained-uplink figures (BLE-class wearable, LTE-class
# phone, wired bedside monitor), latencies one-way.
DEVICE_PROFILES: Dict[str, DeviceProfile] = {
    "wearable": DeviceProfile("wearable", bandwidth_mbps=2.0,
                              latency_s=0.050),
    "phone": DeviceProfile("phone", bandwidth_mbps=20.0, latency_s=0.030),
    "bedside_monitor": DeviceProfile("bedside_monitor", bandwidth_mbps=100.0,
                                     latency_s=0.005),
}


def device_upload_time_s(profile: DeviceProfile,
                         update_size_mb: float) -> float:
    """One device shipping its masked update up its own last-hop link."""
    return (profile.latency_s
            + update_size_mb * MB_BITS / (profile.bandwidth_mbps * 1e6))


def device_fanin_time_s(n_devices: int, profile: DeviceProfile,
                        edge: Resource, update_size_mb: float) -> float:
    """Modeled wall time for an edge institution to absorb its device
    sub-federation's round: every device uploads in parallel over its OWN
    link (slowest uplink bounds that phase — with one shared profile,
    that's just `device_upload_time_s`), then the institution ingests the
    n_devices updates serially through its single downlink.  The chunked
    `core.device_tier` sweep mirrors exactly this shape: per-device work is
    embarrassingly parallel, aggregation funnels through one accumulator."""
    if n_devices <= 0:
        return 0.0
    uplink = device_upload_time_s(profile, update_size_mb)
    ingest = (n_devices * update_size_mb * MB_BITS
              / (edge.bandwidth_mbps * 1e6))
    return uplink + ingest


def transfer_time_mb(size_mb: float, src: Resource, dst: Resource) -> float:
    """One-way transfer: src->backbone->dst, bottleneck link + both latencies."""
    bw = min(src.bandwidth_mbps, dst.bandwidth_mbps)
    return src.latency_s + dst.latency_s + size_mb * MB_BITS / (bw * 1e6)


def transfer_matrix_1mb() -> Dict[str, Dict[str, float]]:
    """Fig 4: effective time to move 1 MB between every resource pair."""
    out: Dict[str, Dict[str, float]] = {}
    for sname, src in C3_TESTBED.items():
        out[sname] = {dname: transfer_time_mb(1.0, src, dst)
                      for dname, dst in C3_TESTBED.items()}
    return out


def training_time(resource: Resource, flops_per_sample: float,
                  n_samples: int, epochs: int,
                  model_size_mb: float = 0.0,
                  inference_resource: Resource | None = None) -> float:
    """Fig 3a: train on `resource`, then ship the model to the inference
    device (the paper includes that transfer in the reported time)."""
    compute = (TRAIN_FLOP_FACTOR * flops_per_sample * n_samples * epochs
               / (resource.gflops * 1e9))
    ship = 0.0
    if inference_resource is not None and inference_resource is not resource:
        ship = transfer_time_mb(model_size_mb, resource, inference_resource)
    return compute + ship
