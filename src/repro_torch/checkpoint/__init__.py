"""Verified checkpoints and crash-recovery snapshots, in the JAX package's
on-disk format (each package reads the other's).

  store.py     save_checkpoint / load_checkpoint: an npz payload and a JSON
               manifest, restore verified against the ledger fingerprint
  snapshot.py  federation snapshots: the stacked carry, the serialized
               ledger, stats and round index, committed by a COMMIT marker
               and verified in five layers on restore
"""
from repro_torch.checkpoint.store import (
    CheckpointError, load_checkpoint, save_checkpoint,
)
from repro_torch.checkpoint.snapshot import (
    SnapshotError, SnapshotState, latest_verified_snapshot, list_snapshots,
    load_snapshot, overlay_cfg_summary, save_snapshot, snapshot_path,
)

__all__ = [
    "CheckpointError", "SnapshotError", "SnapshotState",
    "latest_verified_snapshot", "list_snapshots", "load_checkpoint",
    "load_snapshot", "overlay_cfg_summary", "save_checkpoint",
    "save_snapshot", "snapshot_path",
]
