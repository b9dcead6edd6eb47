"""Verified federation snapshots: crash-recoverable `run_rounds`.

A snapshot is one directory holding everything a resumed run needs to be
bit-identical to an uninterrupted one:

  arrays.npz / manifest.json   the stacked (P, ...) carry, through the
                               verified `checkpoint.store` round trip;
  federation.json              the overlay's host-side state: the round
                               index (every deterministic schedule, of
                               data, faults, attacks, consensus and DP
                               noise, keys off it), the per-round stats,
                               the RDP accountant's step count, the whole
                               serialized ledger (`ModelRegistry.to_dict`),
                               the ledger's Merkle root, and a summary of
                               the overlay config it was taken under;
  COMMIT                       written last, holding the snapshot
                               fingerprint: its absence marks a snapshot
                               whose save died mid-way.

The format is the JAX package's, byte for byte in ``federation.json``
(the same canonical JSON and the same ``b"repro-snapshot-v1"`` domain
tag), so each package restores the other's snapshots and the same overlay
state gives the same snapshot fingerprint in both.

`load_snapshot` verifies in five layers, so a corrupt or torn snapshot is
refused, never half-adopted:

  1. the COMMIT marker must exist and match federation.json's recorded
     fingerprint (a crash during the save, or a tampered marker);
  2. the snapshot fingerprint is recomputed over the canonical
     federation.json bytes (any single-bit state tamper);
  3. the params payload round-trips through the verified
     `load_checkpoint` and its fingerprint must equal the one
     federation.json recorded;
  4. the restored ledger must pass `verify_log()` and its recomputed
     Merkle root must equal the snapshot's recorded ``ledger_root``;
  5. the restoring overlay's config summary must match the snapshot's.

`latest_verified_snapshot` walks a snapshot directory newest-first and
falls back across corrupt snapshots to the newest one that verifies.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import re
import zipfile
from typing import Any, Callable, List, Optional, Tuple

from repro_torch.checkpoint.store import (
    CheckpointError, load_checkpoint, save_checkpoint,
)
from repro_torch.core.registry import ModelRegistry

Pytree = Any

SNAPSHOT_FORMAT = 1
_DIR_RE = re.compile(r"^round_(\d{6})$")


class SnapshotError(RuntimeError):
    """A snapshot failed verification (corrupt, torn, mismatched against
    the ledger, or taken under a different federation config)."""


@dataclasses.dataclass(frozen=True)
class SnapshotState:
    """The verified host-side state `load_snapshot` hands back; feed it to
    `DecentralizedOverlay.restore` (the stacked carry travels separately)."""
    round_index: int
    params_fingerprint: str
    ledger_root: str
    registry: ModelRegistry
    stats: List[dict]
    accountant_steps: int
    cfg: dict
    metadata: dict


def _schedule_repr(s) -> Optional[str]:
    """Deterministic, address-free description of a fault/attack schedule
    (dataclass reprs are stable; composed schedules recurse; anything else
    degrades to its class name so cfg matching stays possible)."""
    if s is None:
        return None
    if dataclasses.is_dataclass(s):
        return repr(s)
    parts = getattr(s, "parts", None)
    if parts is not None:
        return "compose(%s)" % ", ".join(
            str(_schedule_repr(p)) for p in parts)
    return type(s).__name__


def overlay_cfg_summary(cfg) -> dict:
    """The OverlayConfig fields a resumed run MUST share with the run that
    took the snapshot — anything here differing would silently fork the
    data/consensus/fault/attack schedules off the snapshotted trajectory.

    The same fields as the JAX package's summary, and no more, so that
    both packages write the same federation.json bytes: like the
    reference's, it leaves out `secure_domain`, `consensus_params` and the
    partial merge's `block_spec`, `merge_blocks`, `block_schedule` and
    `inner_merge`, so a snapshot restores into an overlay that differs in
    any of them without complaint."""
    dp = getattr(cfg, "dp", None)
    return {
        "n_institutions": cfg.n_institutions,
        "local_steps": cfg.local_steps,
        "merge": cfg.merge,
        "alpha": cfg.alpha,
        "group_size": cfg.group_size,
        "consensus_seed": cfg.consensus_seed,
        "arch_family": cfg.arch_family,
        "trim_fraction": cfg.trim_fraction,
        "norm_gate_factor": cfg.norm_gate_factor,
        "merge_subtree": cfg.merge_subtree,
        "fault_schedule": _schedule_repr(cfg.fault_schedule),
        "attack_schedule": _schedule_repr(cfg.attack_schedule),
        "dp": None if dp is None else {
            "clip_norm": dp.clip_norm, "noise_multiplier": dp.noise_multiplier,
            "delta": dp.delta, "seed": dp.seed},
    }


def _canonical(payload: dict) -> bytes:
    return json.dumps(payload, sort_keys=True,
                      separators=(",", ":")).encode()


def _snapshot_fingerprint(payload: dict) -> str:
    body = {k: v for k, v in payload.items() if k != "snapshot_fingerprint"}
    return hashlib.sha256(b"repro-snapshot-v1" + _canonical(body)).hexdigest()


def snapshot_path(snapshot_dir: str, round_index: int) -> str:
    return os.path.join(snapshot_dir, f"round_{round_index:06d}")


def list_snapshots(snapshot_dir: str) -> List[Tuple[int, str]]:
    """(round_index, path) pairs, ascending — COMMIT-less (torn) directories
    included so callers can report them; verification happens at load."""
    if not os.path.isdir(snapshot_dir):
        return []
    out = []
    for name in os.listdir(snapshot_dir):
        m = _DIR_RE.match(name)
        if m:
            out.append((int(m.group(1)), os.path.join(snapshot_dir, name)))
    return sorted(out)


# ----------------------------------------------------------------------
def save_snapshot(path: str, stacked: Pytree, overlay, *,
                  metadata: Optional[dict] = None) -> str:
    """Persist one verified snapshot of `overlay` + its stacked carry at
    the overlay's current round; returns the snapshot fingerprint.  The
    COMMIT marker is written last, so a crash mid-save leaves a directory
    that `load_snapshot` refuses instead of a silently-wrong restore."""
    params_fp = save_checkpoint(path, stacked, step=overlay.round_index,
                                metadata={"kind": "federation_snapshot"})
    acct = getattr(overlay, "accountant", None)
    payload = {
        "format": SNAPSHOT_FORMAT,
        "round_index": overlay.round_index,
        "params_fingerprint": params_fp,
        "ledger_root": overlay.registry.merkle_root(),
        "n_transactions": len(overlay.registry.chain),
        "registry": overlay.registry.to_dict(),
        "stats": overlay.stats,
        "accountant_steps": 0 if acct is None else acct.steps,
        "cfg": overlay_cfg_summary(overlay.cfg),
        "metadata": metadata or {},
    }
    payload["snapshot_fingerprint"] = _snapshot_fingerprint(payload)
    with open(os.path.join(path, "federation.json"), "w") as f:
        json.dump(payload, f, indent=2, sort_keys=True)
    with open(os.path.join(path, "COMMIT"), "w") as f:
        f.write(payload["snapshot_fingerprint"])
    return payload["snapshot_fingerprint"]


def load_snapshot(path: str, like: Pytree,
                  cfg=None) -> Tuple[Pytree, SnapshotState]:
    """Restore + VERIFY one snapshot directory (see module docstring for
    the verification layers).  `like` gives the stacked carry's structure;
    `cfg` (an OverlayConfig) additionally pins the federation config.
    Raises `SnapshotError` on any failure — the caller falls back to an
    older snapshot, never to unverified state."""
    commit_path = os.path.join(path, "COMMIT")
    if not os.path.exists(commit_path):
        raise SnapshotError(f"{path}: no COMMIT marker (save died mid-way?)")
    try:
        with open(commit_path) as f:
            committed_fp = f.read().strip()
        with open(os.path.join(path, "federation.json")) as f:
            payload = json.load(f)
    except (OSError, json.JSONDecodeError) as e:
        raise SnapshotError(f"{path}: unreadable federation state: {e}")
    if payload.get("format") != SNAPSHOT_FORMAT:
        raise SnapshotError(f"{path}: unknown snapshot format "
                            f"{payload.get('format')!r}")
    recorded = payload.get("snapshot_fingerprint")
    if committed_fp != recorded:
        raise SnapshotError(f"{path}: COMMIT marker disagrees with "
                            f"federation.json")
    if _snapshot_fingerprint(payload) != recorded:
        raise SnapshotError(f"{path}: snapshot fingerprint mismatch — "
                            f"federation.json was modified after commit")
    try:
        stacked, manifest = load_checkpoint(path, like)
    except (CheckpointError, OSError, KeyError, ValueError,
            zipfile.BadZipFile, json.JSONDecodeError) as e:
        raise SnapshotError(f"{path}: params payload failed verification: "
                            f"{e}")
    if manifest["fingerprint"] != payload["params_fingerprint"]:
        raise SnapshotError(f"{path}: params manifest fingerprint does not "
                            f"match the federation state's record")
    registry = ModelRegistry.from_dict(payload["registry"])
    if not registry.verify_log():
        raise SnapshotError(f"{path}: restored ledger failed verify_log()")
    if registry.merkle_root() != payload["ledger_root"]:
        raise SnapshotError(f"{path}: ledger Merkle root "
                            f"{registry.merkle_root()[:16]}… does not match "
                            f"the snapshot's recorded root "
                            f"{payload['ledger_root'][:16]}…")
    if cfg is not None:
        want, got = overlay_cfg_summary(cfg), payload["cfg"]
        if want != got:
            diff = {k: (got.get(k), want.get(k))
                    for k in set(want) | set(got) if got.get(k) != want.get(k)}
            raise SnapshotError(f"{path}: snapshot was taken under a "
                                f"different federation config: {diff}")
    state = SnapshotState(
        round_index=int(payload["round_index"]),
        params_fingerprint=payload["params_fingerprint"],
        ledger_root=payload["ledger_root"],
        registry=registry,
        stats=list(payload["stats"]),
        accountant_steps=int(payload["accountant_steps"]),
        cfg=payload["cfg"],
        metadata=payload.get("metadata", {}),
    )
    return stacked, state


def latest_verified_snapshot(
        snapshot_dir: str, like: Pytree, cfg=None,
        on_skip: Optional[Callable[[str, str], None]] = None,
) -> Tuple[Pytree, SnapshotState, str, List[Tuple[str, str]]]:
    """Newest verified snapshot under `snapshot_dir`, falling back across
    corrupt/torn ones (each skip is recorded and reported via `on_skip`).
    Returns ``(stacked, state, path, skipped)``; raises `SnapshotError`
    when NO snapshot verifies — the caller restarts from round 0 rather
    than adopting unverified state."""
    skipped: List[Tuple[str, str]] = []
    for _, path in reversed(list_snapshots(snapshot_dir)):
        try:
            stacked, state = load_snapshot(path, like, cfg=cfg)
        except SnapshotError as e:
            skipped.append((path, str(e)))
            if on_skip is not None:
                on_skip(path, str(e))
            continue
        return stacked, state, path, skipped
    raise SnapshotError(
        f"no verified snapshot under {snapshot_dir!r} "
        f"({len(skipped)} candidate(s) failed verification)")
