"""Kill/recover chaos scenarios: snapshot-based failover.

The fault schedules of `chaos.schedule` inject faults a run survives
(dropouts, stragglers, partitions, leader re-election).  This module
injects the one it cannot survive, the death of the coordinating process
mid-run, and exercises the recovery contract:

  * `fatal_crash_rounds` reads a (composed) fault schedule and returns the
    rounds where a ``CoordinatorCrash(fatal=True)`` fires: the simulated
    kill points, deterministic like every other chaos decision;
  * `simulate_crash_run` runs a federation to its crash round with
    periodic verified snapshots, throws the process state away (whatever
    ran after the last snapshot is lost work), builds a fresh same-seed
    federation, fails it over through `CNNFederation.resume_from` (the
    newest verified snapshot; corrupt or torn ones are skipped, never
    adopted) and runs it to the end;
  * `corrupt_snapshot` damages a snapshot directory in four ways (payload
    bit flip, torn ``arrays.npz``, state bit flip, missing COMMIT marker),
    so that tests and the smoke run can show that each is detected and
    that failover falls back to the newest snapshot that still verifies.

The bar: the recovered run's final params fingerprint and chain digest
are bit-identical to an uninterrupted run's.  Crash recovery is a pure
replay, not an approximation.
"""
from __future__ import annotations

import dataclasses
import os
from typing import TYPE_CHECKING, Callable, List, Optional, Tuple

from repro_torch.chaos.schedule import ComposedSchedule, CoordinatorCrash

if TYPE_CHECKING:           # the harness imports repro_torch.core, which
    from repro_torch.chaos.harness import CNNFederation  # imports chaos

CORRUPTION_MODES = ("flip_arrays", "torn_arrays", "flip_state",
                    "drop_commit")


def corrupt_snapshot(path: str, mode: str) -> None:
    """Damage one snapshot directory in place.

    flip_arrays   flip one bit in the middle of `arrays.npz` (payload
                  tamper; the zip may still parse — the fingerprint
                  recomputation must catch it)
    torn_arrays   truncate `arrays.npz` to half (crash mid-write)
    flip_state    flip one bit in `federation.json` (ledger/state tamper)
    drop_commit   delete the COMMIT marker (crash between payload and
                  commit — the save never completed)
    """
    if mode not in CORRUPTION_MODES:
        raise ValueError(f"unknown corruption mode {mode!r}; "
                         f"have {CORRUPTION_MODES}")
    if mode == "drop_commit":
        os.remove(os.path.join(path, "COMMIT"))
        return
    fname = "federation.json" if mode == "flip_state" else "arrays.npz"
    fpath = os.path.join(path, fname)
    with open(fpath, "rb") as f:
        blob = bytearray(f.read())
    if mode == "torn_arrays":
        blob = blob[:len(blob) // 2]
    else:
        blob[len(blob) // 2] ^= 0x01
    with open(fpath, "wb") as f:
        f.write(bytes(blob))


def fatal_crash_rounds(schedule, n_rounds: int) -> List[int]:
    """Rounds in [0, n_rounds) where a ``CoordinatorCrash(fatal=True)``
    anywhere in the (possibly composed) schedule fires — the deterministic
    kill points of a chaos run."""
    def leaves(s):
        if s is None:
            return []
        if isinstance(s, ComposedSchedule):
            return [q for p in s.parts for q in leaves(p)]
        return [s]

    fatal = [s for s in leaves(schedule)
             if isinstance(s, CoordinatorCrash) and s.fatal]
    out = []
    for r in range(n_rounds):
        if any(s.faults(r, 1).coordinator_crash for s in fatal):
            out.append(r)
    return out


@dataclasses.dataclass(frozen=True)
class RecoveryReport:
    """What one kill/recover cycle did: the recovery's lost work, the
    snapshots it refused, and the bit-identity evidence."""
    total_rounds: int
    snapshot_every: int
    crash_round: int             # rounds [0, crash_round) ran before death
    restored_round: int          # the verified snapshot failed over to
    rounds_replayed: int         # crash-to-recovery lost work re-run
    snapshots_skipped: Tuple[str, ...]   # corrupt/torn paths refused
    chain_digest: str
    params_fingerprint: str


def simulate_crash_run(
        make_federation: Callable[[], CNNFederation],
        total_rounds: int, crash_round: int, snapshot_dir: str, *,
        snapshot_every: int = 2,
        corrupt: Optional[Callable[[str], None]] = None) -> RecoveryReport:
    """One full kill -> failover -> recover cycle.

    Phase 1 (the doomed run): a fresh federation executes rounds
    [0, crash_round), snapshotting every `snapshot_every` rounds.  Work
    past the last completed snapshot chunk is executed WITHOUT
    snapshotting — it exists only in process memory, which dies with the
    process (the federation object is simply discarded).

    Phase 2 (optional sabotage): `corrupt` receives the snapshot
    directory and may damage any snapshot in it (`corrupt_snapshot`).

    Phase 3 (failover): a FRESH same-config federation resumes from the
    newest snapshot that VERIFIES — corrupt ones are skipped and
    recorded — then replays the lost rounds and runs to `total_rounds`.

    The returned report's digest/fingerprint must equal an uninterrupted
    run's: every schedule (data, consensus, faults, attacks, DP noise) is
    a pure function of the round index the snapshot restored.
    """
    if not 0 <= crash_round <= total_rounds:
        raise ValueError(f"crash_round {crash_round} outside "
                         f"[0, {total_rounds}]")
    K = int(snapshot_every)
    if K <= 0:
        raise ValueError("snapshot_every must be positive")

    # Phase 1: the doomed run. Snapshotted chunks first, then the lost tail.
    doomed = make_federation()
    snapped = (crash_round // K) * K
    if snapped:
        doomed.run_rounds(snapped, snapshot_every=K,
                          snapshot_dir=snapshot_dir)
    if crash_round - snapped:
        doomed.run_rounds(crash_round - snapped)   # dies unsnapshotted
    del doomed                                     # the process is gone

    # Phase 2: sabotage (callers corrupt specific snapshots here).
    if corrupt is not None:
        corrupt(snapshot_dir)

    # Phase 3: failover onto a fresh process.  (Imported here: checkpoint
    # imports repro_torch.core, which imports this package.)
    from repro_torch.checkpoint.snapshot import SnapshotError, list_snapshots
    fed = make_federation()
    if crash_round == 0 or snapped == 0:
        # Nothing was ever snapshotted: recovery IS a restart from round 0.
        restored, skipped = 0, []
    else:
        try:
            restored, skipped = fed.resume_from(snapshot_dir)
        except SnapshotError:
            # EVERY snapshot failed verification — the last line of the
            # degradation ladder is a restart from round 0 on a fresh
            # federation, never adopting unverified state.
            restored = 0
            skipped = [(p, "failed verification")
                       for _, p in list_snapshots(snapshot_dir)]
    if total_rounds - restored:
        fed.run_rounds(total_rounds - restored)
    return RecoveryReport(
        total_rounds=total_rounds,
        snapshot_every=K,
        crash_round=crash_round,
        restored_round=restored,
        rounds_replayed=crash_round - restored,
        snapshots_skipped=tuple(p for p, _ in skipped),
        chain_digest=fed.chain_digest(),
        params_fingerprint=fed.params_fingerprint())


def golden_run(make_federation: Callable[[], CNNFederation],
               total_rounds: int) -> Tuple[str, str]:
    """The uninterrupted reference: ``(chain_digest, params_fingerprint)``
    every crash/recover cycle must reproduce bit-for-bit."""
    fed = make_federation()
    fed.run_rounds(total_rounds)
    return fed.chain_digest(), fed.params_fingerprint()
