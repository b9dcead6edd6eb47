"""Incremental Merkle log over the DLT transaction chain, a hashlib copy
of the JAX package's ``core/merkle.py`` (roots are identical for identical
transaction hashes).

The hash chain in `core.registry` gives append-only integrity, but proving
that ONE transaction belongs to it means replaying every predecessor.  This
module maintains a Merkle tree over the transaction hashes incrementally:

  * `append` folds a new leaf into the running root in O(log n),
  * `proof(i)` returns the O(log n) audit path for leaf i,
  * `verify_inclusion(leaf, proof, root)` recomputes the root from the leaf
    and the path — any single-bit tamper of leaf, proof, or root fails.

Tree shape: the "promotion" scheme — leaves are paired level by level and an
unpaired last node is promoted unchanged to the next level (no duplicate
padding, so the root of n leaves never equals the root of n+k copies).
Leaves and interior nodes are domain-separated (0x00 / 0x01 prefixes, the
RFC 6962 discipline) so an interior node can never be replayed as a leaf.

The verifier derives each step's sibling SIDE and the promotion skips from
``(leaf_index, n_leaves)`` alone — the proof carries only the sibling
hashes, so the index and size are load-bearing.  The index changes a
sibling side at its lowest set bit, so tampering it breaks the walk; the
SIZE alone would not (a leaf away from the right edge walks identically in
an n- and an (n+1)-leaf tree — promotion paths only differ near the edge),
so the published root additionally BINDS the leaf count:
``root = H(0x03 || n_leaves || tree_top)``, the signed-tree-head
discipline.  Any single-bit tamper of leaf, index, size, path, or root now
fails verification.
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass
from typing import List, Tuple

# Root of the empty log — a fixed domain-separated constant, NOT sha256(b"")
# (which collides with the empty-*input* hash any attacker can name).
EMPTY_ROOT = hashlib.sha256(b"\x02repro-merkle-empty").hexdigest()


def _leaf_hash(leaf_hex: str) -> bytes:
    return hashlib.sha256(b"\x00" + bytes.fromhex(leaf_hex)).digest()


def _node_hash(left: bytes, right: bytes) -> bytes:
    return hashlib.sha256(b"\x01" + left + right).digest()


def _bound_root(n_leaves: int, top: bytes) -> str:
    """The published root: tree top bound to the leaf count, so a proof's
    claimed size is authenticated by the root itself."""
    return hashlib.sha256(
        b"\x03" + n_leaves.to_bytes(8, "big") + top).hexdigest()


@dataclass(frozen=True)
class MerkleProof:
    """Audit path for one leaf: bottom-up sibling hashes (hex).  Promotion
    levels (odd last node, no sibling) contribute no entry — the verifier
    reconstructs which levels those are from `n_leaves`."""
    leaf_index: int
    n_leaves: int
    path: Tuple[str, ...]


class MerkleLog:
    """Append-only Merkle tree over hex-encoded 32-byte leaf values.

    `self._levels[0]` holds the leaf hashes; `self._levels[k]` the k-th
    interior level.  An append touches one node per level (the rightmost
    path), so the running root is maintained in O(log n) per transaction.
    """

    def __init__(self):
        self._levels: List[List[bytes]] = [[]]

    def __len__(self) -> int:
        return len(self._levels[0])

    # -- write path ----------------------------------------------------
    def append(self, leaf_hex: str) -> str:
        """Fold one leaf into the tree; returns the new root (hex)."""
        self._levels[0].append(_leaf_hash(leaf_hex))
        i, lvl = len(self._levels[0]) - 1, 0
        while len(self._levels[lvl]) > 1:
            parent = i // 2
            left = self._levels[lvl][2 * parent]
            if 2 * parent + 1 < len(self._levels[lvl]):
                node = _node_hash(left, self._levels[lvl][2 * parent + 1])
            else:
                node = left                      # odd last node: promoted
            if lvl + 1 == len(self._levels):
                self._levels.append([])
            nxt = self._levels[lvl + 1]
            if parent == len(nxt):
                nxt.append(node)
            else:
                nxt[parent] = node
            i, lvl = parent, lvl + 1
        return self.root()

    # -- read path -----------------------------------------------------
    def root(self) -> str:
        if not self._levels[0]:
            return EMPTY_ROOT
        return _bound_root(len(self._levels[0]), self._levels[-1][0])

    def proof(self, index: int) -> MerkleProof:
        """O(log n)-size audit path for leaf `index` against the CURRENT
        root (the tree is append-only: a proof is valid for exactly one
        (root, n_leaves) snapshot)."""
        n = len(self._levels[0])
        if not 0 <= index < n:
            raise IndexError(f"leaf index {index} out of range [0, {n})")
        path, i = [], index
        for lvl in range(len(self._levels) - 1):
            size = len(self._levels[lvl])
            sib = i ^ 1
            if sib < size:
                path.append(self._levels[lvl][sib].hex())
            i //= 2
        return MerkleProof(leaf_index=index, n_leaves=n, path=tuple(path))


def verify_inclusion(leaf_hex: str, proof: MerkleProof, root: str) -> bool:
    """Does `leaf_hex` sit at `proof.leaf_index` of the `proof.n_leaves`-leaf
    tree whose root is `root`?  Pure function of its arguments — any
    institution can audit a model's provenance from (transaction hash,
    proof, committed root) without replaying the chain.  Returns False on
    ANY inconsistency (bad index/size, wrong path length, tampered bits)
    rather than raising: a proof is evidence, not trusted input."""
    try:
        n = int(proof.n_leaves)
        i = int(proof.leaf_index)
        if not 0 <= i < n:
            return False
        h = _leaf_hash(leaf_hex)
        used, size = 0, n
        while size > 1:
            sib = i ^ 1
            if sib < size:
                if used >= len(proof.path):
                    return False
                s = bytes.fromhex(proof.path[used])
                if len(s) != 32:
                    return False
                used += 1
                h = _node_hash(s, h) if sib < i else _node_hash(h, s)
            # else: odd last node, promoted — consumes no path entry
            i //= 2
            size = (size + 1) // 2
        if used != len(proof.path):
            return False                         # trailing garbage in proof
        return _bound_root(n, h) == root
    except (ValueError, TypeError, OverflowError):
        return False
