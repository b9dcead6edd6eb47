"""The federation's ledger, checked from its definition: SHA-256 over a
model row's canonical bytes (the tree's structure string, then each
leaf's shape, dtype and bytes in leaf order), and the hash chain, each
transaction's hash over its fields as sorted JSON."""
from __future__ import annotations

import dataclasses
import hashlib
import json
from typing import List, Sequence

import numpy as np

GENESIS = "0" * 64


def fingerprint(leaves: Sequence[np.ndarray], treedef: str) -> str:
    h = hashlib.sha256()
    h.update(treedef.encode())
    for arr in leaves:
        arr = np.ascontiguousarray(arr)
        h.update(str(arr.shape).encode())
        h.update(str(arr.dtype).encode())
        h.update(arr.tobytes())
    return h.hexdigest()


def tx_hash(tx) -> str:
    """A transaction's hash over its fields (tuples as JSON lists)."""
    fields = dataclasses.asdict(tx)
    return hashlib.sha256(
        json.dumps(fields, sort_keys=True).encode()).hexdigest()


def broken_links(chain: List) -> int:
    """Transactions whose index or previous hash does not follow."""
    bad, prev = 0, GENESIS
    for i, tx in enumerate(chain):
        if tx.index != i or tx.prev_hash != prev:
            bad += 1
        prev = tx_hash(tx)
    return bad
