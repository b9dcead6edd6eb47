"""Permissioned-DLT model registry (paper §4.1.1-4.1.2).

The ledger stores only fingerprints of model updates (SHA-256 over the
weight bytes), never weights or data: an append-only hash chain with an
incremental Merkle log over it, and provenance links from every merged
model to the fingerprints it was merged from.  `to_dict` / `from_dict`
serialize the whole ledger for crash-recovery snapshots
(`checkpoint.snapshot`): a restored replica re-derives its Merkle state
from the chain.  `suitable_models` answers the paper's "other suitable
registered models" query without revealing weights.

Fingerprints equal the JAX package's for the same bytes: the hash covers
``str(treedef)`` of the JAX pytree (reproduced by `treedef_str`), then
each leaf's shape, dtype and bytes in JAX leaf order.
"""
from __future__ import annotations

import hashlib
import json
import time
from dataclasses import asdict, dataclass
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.merkle import MerkleLog, MerkleProof
from repro_torch.pytree import tree_flatten, treedef_str

GENESIS = "0" * 64

__all__ = ["GENESIS", "ModelRegistry", "RoundRecord", "Transaction",
           "fingerprint_pytree"]


def _host(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def fingerprint_pytree(params) -> str:
    """SHA-256 over the canonical byte stream of a weight pytree."""
    h = hashlib.sha256()
    leaves, spec = tree_flatten(params)
    h.update(treedef_str(spec).encode())
    for leaf in leaves:
        arr = _host(leaf)
        h.update(str(arr.shape).encode())
        h.update(str(arr.dtype).encode())
        h.update(arr.tobytes())
    return h.hexdigest()


@dataclass(frozen=True)
class Transaction:
    index: int
    prev_hash: str
    kind: str                       # register | rolling_update
    institution: str
    model_fingerprint: str
    arch_family: str
    parents: tuple                  # parent fingerprints (provenance)
    metadata: str                   # JSON: consensus round, DP trace, ...
    timestamp: float

    def hash(self) -> str:
        payload = json.dumps(asdict(self), sort_keys=True).encode()
        return hashlib.sha256(payload).hexdigest()


@dataclass(frozen=True)
class RoundRecord:
    """One overlay round's DLT writes for `register_round_batch`: the
    survivors' registrations (institution order), then the merged model's
    rolling_update whose parents are exactly those fingerprints.

    `blocks`: a partial merge's attestation, e.g. ``{"inner": "mean",
    "shared": ["backbone"], "merged": ["backbone"]}``, written into the
    merged transaction's metadata as ``"blocks"``; the params are then
    shared views, so no personal block reaches a fingerprint.  None: the
    round federated the whole tree and nothing extra is written."""
    arch_family: str
    registrations: Sequence[tuple]        # (institution, params, metadata)
    merged_institution: str
    merged_params: Any
    merged_metadata: Dict[str, Any]
    blocks: Optional[Dict[str, Any]] = None


class ModelRegistry:
    """One logical DLT.  `logical_clock=True` stamps transactions with a
    monotone counter instead of `time.time()`, so two same-seed runs
    produce byte-identical chains."""

    def __init__(self, logical_clock: bool = False):
        self.chain: List[Transaction] = []
        self.logical_clock = logical_clock
        self._merkle = MerkleLog()

    def register(self, *, kind: str, institution: str, params,
                 arch_family: str, parents: Sequence[str] = (),
                 metadata: Optional[Dict[str, Any]] = None,
                 timestamp: Optional[float] = None) -> Transaction:
        if timestamp is None:
            timestamp = (float(len(self.chain)) if self.logical_clock
                         else time.time())
        tx = Transaction(
            index=len(self.chain),
            prev_hash=self.chain[-1].hash() if self.chain else GENESIS,
            kind=kind,
            institution=institution,
            model_fingerprint=fingerprint_pytree(params),
            arch_family=arch_family,
            parents=tuple(parents),
            metadata=json.dumps(metadata or {}, sort_keys=True),
            timestamp=timestamp,
        )
        self.chain.append(tx)
        self._merkle.append(tx.hash())
        return tx

    def register_round_batch(self, rounds: Sequence[RoundRecord]
                             ) -> List[Transaction]:
        """Flush many rounds' DLT effects in one call, in the order the
        eager per-round path writes them.  Each merged transaction commits
        the Merkle root over everything before it as ``ledger_root``."""
        merged_txs = []
        for rec in rounds:
            parents = []
            for institution, params, meta in rec.registrations:
                tx = self.register(kind="register", institution=institution,
                                   params=params,
                                   arch_family=rec.arch_family,
                                   metadata=meta)
                parents.append(tx.model_fingerprint)
            merged_meta = dict(rec.merged_metadata)
            if rec.blocks is not None:
                merged_meta["blocks"] = rec.blocks
            merged_meta["ledger_root"] = self.merkle_root()
            merged_txs.append(self.register(
                kind="rolling_update", institution=rec.merged_institution,
                params=rec.merged_params, arch_family=rec.arch_family,
                parents=parents, metadata=merged_meta))
        return merged_txs

    def verify_chain(self) -> bool:
        prev = GENESIS
        for i, tx in enumerate(self.chain):
            if tx.index != i or tx.prev_hash != prev:
                return False
            prev = tx.hash()
        return True

    def merkle_root(self) -> str:
        return self._merkle.root()

    def inclusion_proof(self, index: int) -> MerkleProof:
        """O(log n) audit path proving ``chain[index]`` is in the ledger
        whose root is `merkle_root()`; verify with
        ``merkle.verify_inclusion(tx.hash(), proof, root)``."""
        return self._merkle.proof(index)

    def root_at(self, n: int) -> str:
        """Root of the n-transaction chain prefix: what a round's merged
        transaction committed as ``ledger_root`` when the chain was n
        long.  Rebuilds the prefix tree, O(n)."""
        return self._prefix_log(n).root()

    def inclusion_proof_at(self, index: int, n: int) -> MerkleProof:
        """Audit path for ``chain[index]`` against the n-leaf prefix root
        ``root_at(n)``: proves a merged round's parent registrations
        against the ``ledger_root`` that round itself committed."""
        if not 0 <= index < n <= len(self.chain):
            raise IndexError(
                f"prefix proof needs 0 <= index < n <= len(chain); got "
                f"index={index}, n={n}, len={len(self.chain)}")
        return self._prefix_log(n).proof(index)

    def _prefix_log(self, n: int) -> MerkleLog:
        if not 0 <= n <= len(self.chain):
            raise IndexError(f"prefix length {n} out of range "
                             f"[0, {len(self.chain)}]")
        log = MerkleLog()
        for tx in self.chain[:n]:
            log.append(tx.hash())
        return log

    def suitable_models(self, arch_family: str,
                        exclude_institution: Optional[str] = None
                        ) -> List[Transaction]:
        """Paper step 5: 'checks for other suitable registered models'."""
        return [tx for tx in self.chain
                if tx.arch_family == arch_family
                and tx.kind in ("register", "rolling_update")
                and tx.institution != exclude_institution]

    def lineage(self, fp: str) -> List[str]:
        """Provenance chain of a fingerprint (depth-first over parents)."""
        by_fp = {tx.model_fingerprint: tx for tx in self.chain}
        out, stack, seen = [], [fp], set()
        while stack:
            cur = stack.pop()
            if cur in seen or cur not in by_fp:
                continue
            seen.add(cur)
            out.append(cur)
            stack.extend(by_fp[cur].parents)
        return out

    def clone(self) -> "ModelRegistry":
        replica = ModelRegistry(logical_clock=self.logical_clock)
        replica.chain = list(self.chain)
        replica._rebuild_merkle()
        return replica

    def _rebuild_merkle(self) -> None:
        self._merkle = MerkleLog()
        for tx in self.chain:
            self._merkle.append(tx.hash())

    def verify_log(self) -> bool:
        """Chain links, Merkle state and every committed ``ledger_root``."""
        if not self.verify_chain():
            return False
        rebuilt = MerkleLog()
        for tx in self.chain:
            if tx.kind == "rolling_update":
                claimed = json.loads(tx.metadata).get("ledger_root")
                if claimed is not None and claimed != rebuilt.root():
                    return False
            rebuilt.append(tx.hash())
        return rebuilt.root() == self._merkle.root()

    def to_dict(self) -> Dict[str, Any]:
        """JSON-serializable image of the whole ledger (a snapshot's
        payload).  The Merkle state is derived, not stored: `from_dict`
        re-appends every transaction, so a tampered snapshot cannot bring
        in a root that disagrees with its own chain."""
        return {"logical_clock": self.logical_clock,
                "chain": [asdict(tx) for tx in self.chain]}

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "ModelRegistry":
        reg = cls(logical_clock=bool(d.get("logical_clock", False)))
        for row in d["chain"]:
            row = dict(row)
            row["parents"] = tuple(row["parents"])
            reg.chain.append(Transaction(**row))
        reg._rebuild_merkle()
        return reg
