"""The computing continuum: resource tiers, the analytic cost model, and
the cost-model placement of a federation's institutions on cloud, fog and
edge.

  resources.py  the paper's C3 testbed (Table 1) and the H100's roofline
                constants
  costmodel.py  transfer, training and device fan-in times (Figs 3-4)
  placement.py  assign_institutions, straggler weights, participation
                masks and PlacementSchedule (the cost model as a fault
                schedule)
"""
from repro_torch.continuum.resources import (
    C3_TESTBED, H100_SXM, Accelerator, Resource,
)
from repro_torch.continuum.costmodel import (
    DEVICE_PROFILES, DeviceProfile, device_fanin_time_s,
    device_upload_time_s, training_time, transfer_time_mb,
    transfer_matrix_1mb,
)
from repro_torch.continuum.placement import (
    DeviceFleet, FederationWorkload, InstitutionPlacement,
    PlacementSchedule, assign_institutions, participation_mask,
    round_time_s, straggler_weights,
)

__all__ = [
    "Accelerator", "C3_TESTBED", "DEVICE_PROFILES", "DeviceFleet",
    "DeviceProfile", "FederationWorkload", "H100_SXM",
    "InstitutionPlacement", "PlacementSchedule", "Resource",
    "assign_institutions", "device_fanin_time_s", "device_upload_time_s",
    "participation_mask", "round_time_s", "straggler_weights",
    "training_time", "transfer_matrix_1mb", "transfer_time_mb",
]
