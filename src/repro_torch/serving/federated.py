"""Verified train->registry->serve path.

The ledger stores only model *fingerprints* (paper §4.1.1) while the
weights live in the hospitals' own infrastructure.  A serving replica
therefore has to close a trust gap before it puts a model in front of
patients: the bytes it fetched from a weight store must be provably the
bytes the federation committed.  `pull_latest_model` is that gate:

  1. the replica's ledger copy passes the full `verify_log` audit (hash
     chain links + incremental-Merkle consistency + every committed
     ``ledger_root``), else `TamperedLedgerError`;
  2. when the caller pins a `trusted_root` (obtained out of band), the
     ledger's current Merkle root must equal it: a truncated or forked
     replica is self-consistent after a rebuild, so only an external root
     catches rollback (`LedgerRootMismatchError`);
  3. the newest committed round (`rolling_update`, optionally filtered by
     arch family) is located, else `NoCommittedModelError`;
  4. its transaction carries an O(log n) inclusion proof against the
     (trusted) root, and each parent registration is proven against the
     ``ledger_root`` the round itself committed (`LedgerRootMismatchError`);
  5. the weight store must hold the fingerprint (`ModelUnavailableError`)
     and the fingerprint is RE-DERIVED from the fetched bytes
     (`FingerprintMismatchError` on any bit flip).

Any failure raises; params are never handed to an engine unverified.
`pull_from_snapshot` runs the same gate against a crash-recovery snapshot
(`checkpoint.snapshot`), so a rebooted serving tier refuses corrupt or
torn state (`SnapshotError`) as a rebooted coordinator does.

`FederatedServer` wires the gate to the engine: construct = verified pull
+ `ServingEngine` on the committed params; `refresh()` re-pulls
mid-traffic and hot-swaps when a newer round committed.

`serving_workload` and `plan_serving` price an engine tick in the
continuum cost model and place serving replicas on cloud, fog and edge
with the training placement's greedy assignment.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, List, Optional

from repro_torch.checkpoint.snapshot import latest_verified_snapshot
from repro_torch.configs.base import ModelConfig
from repro_torch.continuum.costmodel import TRAIN_FLOP_FACTOR
from repro_torch.continuum.placement import (
    FederationWorkload, InstitutionPlacement, assign_institutions,
)
from repro_torch.core.merkle import verify_inclusion
from repro_torch.core.registry import (
    ModelRegistry, Transaction, fingerprint_pytree,
)
from repro_torch.pytree import tree_map
from repro_torch.serving.engine import ServeConfig, ServingEngine

Pytree = Any

__all__ = [
    "FederatedServer", "FingerprintMismatchError", "LedgerRootMismatchError",
    "ModelStore", "ModelUnavailableError", "NoCommittedModelError",
    "ServingVerificationError", "TamperedLedgerError", "VerifiedModel",
    "latest_committed", "plan_serving", "pull_from_snapshot",
    "pull_latest_model", "serving_workload",
]


# ----------------------------------------------------------------------
# Named failure taxonomy: the tamper battery asserts on these EXACT types,
# so a verification layer can never silently degrade into a different one.
class ServingVerificationError(RuntimeError):
    """Base: the train→registry→serve gate refused to serve."""


class TamperedLedgerError(ServingVerificationError):
    """The registry failed its own audit (broken hash chain, inconsistent
    Merkle state, or a committed ``ledger_root`` that disagrees with the
    chain prefix it claims to cover)."""


class LedgerRootMismatchError(ServingVerificationError):
    """A Merkle root check failed: the replica's root differs from the
    caller's trusted root (truncation/rollback/fork), or an inclusion
    proof did not verify against the root it was anchored to."""


class NoCommittedModelError(ServingVerificationError):
    """The ledger holds no committed round (``rolling_update``) to serve —
    e.g. a fresh federation, or none matching the requested arch family."""


class ModelUnavailableError(ServingVerificationError):
    """The ledger names a fingerprint the weight store cannot produce."""


class FingerprintMismatchError(ServingVerificationError):
    """The fetched weight bytes do not hash to the committed fingerprint."""


# ----------------------------------------------------------------------
class ModelStore:
    """Content-addressed weight store: fingerprint → params pytree.

    Stands in for the hospital-side weight storage the paper keeps OFF the
    ledger; `pull_latest_model` treats it as untrusted — whatever it
    returns is re-fingerprinted against the committed transaction."""

    def __init__(self):
        self._by_fp: Dict[str, Pytree] = {}

    def put(self, params: Pytree) -> str:
        fp = fingerprint_pytree(params)
        self._by_fp[fp] = params
        return fp

    def get(self, fp: str) -> Pytree:
        return self._by_fp[fp]

    def __contains__(self, fp: str) -> bool:
        return fp in self._by_fp

    def __len__(self) -> int:
        return len(self._by_fp)


@dataclasses.dataclass(frozen=True)
class VerifiedModel:
    """What the gate hands to the engine: params plus the provenance that
    justified serving them.  `version` (the transaction index) is the
    monotone model version the hot-swap log records."""
    params: Pytree
    tx: Transaction
    fingerprint: str
    ledger_root: str            # root the pull verified against
    version: int
    parents_verified: int       # survivor registrations proven at commit root


# ----------------------------------------------------------------------
def latest_committed(registry: ModelRegistry,
                     arch_family: Optional[str] = None
                     ) -> Optional[Transaction]:
    """Newest ``rolling_update`` transaction (optionally same-arch), or
    None — location only, NO verification (that is `pull_latest_model`)."""
    for tx in reversed(registry.chain):
        if tx.kind != "rolling_update":
            continue
        if arch_family is not None and tx.arch_family != arch_family:
            continue
        return tx
    return None


def pull_latest_model(registry: ModelRegistry, store: ModelStore, *,
                      trusted_root: Optional[str] = None,
                      arch_family: Optional[str] = None) -> VerifiedModel:
    """Fetch + VERIFY the newest committed federated model (see module
    docstring for the layered gate).  Raises a `ServingVerificationError`
    subclass on any failure — params never reach an engine unverified."""
    # 1. full ledger self-audit (chain links, Merkle consistency, every
    #    committed ledger_root vs the prefix it covers)
    if not registry.verify_chain():
        raise TamperedLedgerError(
            "registry hash chain broken: a transaction was mutated, "
            "reordered, or deleted")
    if not registry.verify_log():
        raise TamperedLedgerError(
            "registry Merkle audit failed: incremental root or a committed "
            "ledger_root disagrees with the chain")
    # 2. rollback/fork detection needs an EXTERNAL anchor: a truncated
    #    replica re-derives a self-consistent root, so only the caller's
    #    trusted_root can catch it
    root = registry.merkle_root()
    if trusted_root is not None and root != trusted_root:
        raise LedgerRootMismatchError(
            f"registry root {root[:16]}… does not match the trusted root "
            f"{trusted_root[:16]}… (truncated, forked, or stale replica)")
    # 3. newest committed round
    tx = latest_committed(registry, arch_family)
    if tx is None:
        raise NoCommittedModelError(
            "no committed rolling_update in the ledger"
            + (f" for arch family {arch_family!r}" if arch_family else ""))
    # 4a. the transaction itself is in the tree the root covers
    proof = registry.inclusion_proof(tx.index)
    if not verify_inclusion(tx.hash(), proof, root):
        raise LedgerRootMismatchError(
            f"inclusion proof for round transaction #{tx.index} failed "
            f"against root {root[:16]}…")
    # 4b. provenance: every parent registration is proven against the
    #     ledger_root the round COMMITTED (the chain prefix of length
    #     tx.index), not against today's root
    committed_root = json.loads(tx.metadata).get("ledger_root")
    parents_verified = 0
    if committed_root is not None:
        if registry.root_at(tx.index) != committed_root:
            raise LedgerRootMismatchError(
                f"round #{tx.index} committed ledger_root "
                f"{committed_root[:16]}… but the chain prefix hashes to "
                f"{registry.root_at(tx.index)[:16]}…")
        by_fp = {t.model_fingerprint: t for t in registry.chain[:tx.index]
                 if t.kind == "register"}
        for parent_fp in tx.parents:
            parent = by_fp.get(parent_fp)
            if parent is None:
                raise LedgerRootMismatchError(
                    f"round #{tx.index} names parent {parent_fp[:16]}… "
                    f"with no registration before it")
            pproof = registry.inclusion_proof_at(parent.index, tx.index)
            if not verify_inclusion(parent.hash(), pproof, committed_root):
                raise LedgerRootMismatchError(
                    f"parent registration #{parent.index} failed its "
                    f"inclusion proof against round #{tx.index}'s "
                    f"committed ledger_root")
            parents_verified += 1
    # 5. fetch the weights and re-derive the fingerprint from the bytes
    if tx.model_fingerprint not in store:
        raise ModelUnavailableError(
            f"weight store has no params for committed fingerprint "
            f"{tx.model_fingerprint[:16]}…")
    params = store.get(tx.model_fingerprint)
    fp = fingerprint_pytree(params)
    if fp != tx.model_fingerprint:
        raise FingerprintMismatchError(
            f"fetched params hash to {fp[:16]}… but round #{tx.index} "
            f"committed {tx.model_fingerprint[:16]}…")
    return VerifiedModel(params=params, tx=tx, fingerprint=fp,
                         ledger_root=root, version=tx.index,
                         parents_verified=parents_verified)


def pull_from_snapshot(snapshot_dir: str, like: Pytree, *,
                       cfg=None, trusted_root: Optional[str] = None,
                       arch_family: Optional[str] = None,
                       merged_row: int = 0) -> VerifiedModel:
    """The verified pull of a rebooted serving tier: restore the newest
    verified federation snapshot (`checkpoint.snapshot` refuses corrupt,
    torn or config-mismatched state with `SnapshotError`), take the merged
    params from row `merged_row` of the stacked carry (after a committed
    alpha = 1.0 merge every row holds the merged model) to the host, and
    run the `pull_latest_model` gate against the restored ledger.  The
    newest round must have committed: an aborted last round leaves the
    carry on per-institution params, which the fingerprint gate refuses."""
    stacked, state, _, _ = latest_verified_snapshot(snapshot_dir, like,
                                                    cfg=cfg)
    merged = tree_map(lambda a: a[merged_row].cpu(), stacked)
    store = ModelStore()
    store.put(merged)
    return pull_latest_model(state.registry, store,
                             trusted_root=trusted_root,
                             arch_family=arch_family)


# ----------------------------------------------------------------------
class FederatedServer:
    """A serving replica bound to a federation's ledger: construct =
    verified pull + engine on the committed params; `refresh()` re-pulls
    and hot-swaps mid-traffic when a newer round has committed.

    The engine's `params_version` is the ledger transaction index, so a
    finished request's `params_version` names the exact committed round
    that generated it — inference provenance for free."""

    def __init__(self, cfg: ModelConfig, registry: ModelRegistry,
                 store: ModelStore, scfg: ServeConfig, *,
                 trusted_root: Optional[str] = None,
                 arch_family: Optional[str] = None,
                 seed: int = 0, use_prefill: bool = True, device=None):
        self.cfg = cfg
        self.registry = registry
        self.store = store
        self.arch_family = arch_family
        self.model = pull_latest_model(registry, store,
                                       trusted_root=trusted_root,
                                       arch_family=arch_family)
        self.engine = ServingEngine(cfg, self.model.params, scfg,
                                    seed=seed, use_prefill=use_prefill,
                                    device=device)
        self.engine.params_version = self.model.version

    def refresh(self, trusted_root: Optional[str] = None
                ) -> Optional[VerifiedModel]:
        """Re-run the verified pull; if a NEWER round committed, stage a
        hot-swap (in-flight traffic drains on the old params, the swap
        applies at a tick boundary, zero requests dropped).  Returns the
        new `VerifiedModel`, or None when already serving the newest."""
        model = pull_latest_model(self.registry, self.store,
                                  trusted_root=trusted_root,
                                  arch_family=self.arch_family)
        if model.version <= self.engine.params_version:
            return None
        self.model = model
        self.engine.swap_params(model.params, version=model.version)
        return model


# ----------------------------------------------------------------------
def serving_workload(cfg: ModelConfig, scfg: ServeConfig
                     ) -> FederationWorkload:
    """One engine TICK as a cost-model workload: `batch_size` tokens of
    forward-only decode.  `round_time_s` prices training (forward and
    backward) through `TRAIN_FLOP_FACTOR`, so the factor is divided back
    out here; the exchange term then models the hot-swap model fetch, not
    a gradient publish."""
    flops_per_token = 2.0 * cfg.active_param_count()   # fwd matmuls: 2N/token
    return FederationWorkload(
        flops_per_sample=flops_per_token / TRAIN_FLOP_FACTOR,
        samples_per_round=scfg.batch_size,
        model_size_mb=4.0 * cfg.param_count() / 1e6,   # fp32 weight bytes
    )


def plan_serving(n_replicas: int, cfg: ModelConfig, scfg: ServeConfig,
                 resources: Optional[Dict[str, Any]] = None
                 ) -> List[InstitutionPlacement]:
    """Place `n_replicas` serving replicas on the continuum with the greedy
    marginal-cost assignment the training placement uses (the Fig 3/4
    cost model): each replica lands on the cloud, fog or edge resource
    that minimizes its modeled tick time given the load already placed
    there.  `placement.tier_latency_summary(placements,
    serving_workload(cfg, scfg))` rolls the result up per tier."""
    return assign_institutions(n_replicas, serving_workload(cfg, scfg),
                               resources)
