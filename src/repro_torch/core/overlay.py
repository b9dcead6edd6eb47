"""The STIGMA decentralized-ML overlay (paper §4): P institutions federate a
model WITHOUT a central aggregation server.

Each round:
  1. every institution trains its own replica on its own data for
     `local_steps` steps: `torch.func.vmap` of the caller's per-institution
     step over the stacked (P, ...) param tree;
  2. (optional, ``OverlayConfig.dp``) each institution's round update is
     L2-clipped and Gaussian-noised by the DP kernel before anything sees
     it; the RDP accountant's eps(delta) rides into the ledger;
  3. (optional, ``OverlayConfig.attack_schedule``) compromised surviving
     institutions publish poisoned rows (`chaos.attacks`);
  4. a Paxos 3-phase instance (`ConsensusGate`) decides whether the round
     commits;
  5. the registered merge strategy (``secure_mean``: the fused MPC kernel;
     or mean, ring, hierarchical, quantized, the robust merges, or
     ``partial`` over any of them) merges the published rows, gated by
     the commit bit;
  6. the DLT registers every survivor's published fingerprint and the
     merged model with its provenance (a partial merge's ledger attests
     only the shared blocks).

Fault tolerance: with ``OverlayConfig.fault_schedule`` every round derives
a deterministic `chaos.RoundFaults` record for its index.  The consensus
instance sees the faults (crashed acceptors, coordinator failover,
quorum); the merge sees the survivors as a (P,) participation mask (masked
mean, survivor-pair secure aggregation); the DLT records the survivor set:
only survivors register fingerprints, and the merged model's provenance
lists survivor parents alone.  A round every institution survived merges
with mask=None, the fault-free code path.

Two engines, bit-identical on the same seed:

  * EAGER: `round()` / `merge_phase()`, one consensus instance, merge and
    DLT flush per call;
  * BATCHED: `run_rounds()`: every consensus transcript is computed up
    front (it depends only on seed x round x schedule), the R rounds of
    training and merging run as a Python loop on the device with no host
    round trip, and all DLT writes happen in one flush at the end.

Crash recovery: `snapshot()` persists a verified federation snapshot
(`checkpoint.snapshot`), `run_rounds(..., snapshot_every=K,
snapshot_dir=...)` takes one after every K rounds, and `restore()` makes a
fresh overlay adopt a verified snapshot's state, so that the run it
resumes is bit-identical to the uninterrupted one.

A stacked state may be a dict: with ``OverlayConfig.merge_subtree`` (by
default ``"params"``) only that subtree federates, and the rest (optimizer
state, the device tier's stale buffers and device weights) stays with its
institution.

Mesh-parallel federations: ``run_rounds(mesh=...)`` takes a
`DeviceMesh` with an ``"inst"`` axis (`sharding.make_institution_mesh`,
`launch.mesh.make_overlay_mesh`), and the institution axis spans the
ranks: each trains its own block of hospitals, one ``all_gather`` a round
brings every hospital's trained rows to every rank, and every rank runs
the same publish-and-merge on them, the kernels included.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import random as prng
from repro_torch.chaos.attacks import ATTACK_KINDS, apply_attack
from repro_torch.core.consensus import (
    ConsensusGate, ProtocolParams, Transcript,
)
from repro_torch.core.merges import MergeContext, get_merge, gossip_shift
from repro_torch.core.merges.toolkit import gate as _commit_gate
from repro_torch.core.registry import ModelRegistry, RoundRecord
from repro_torch.core.secure_agg import seed_from_key
from repro_torch.pytree import tree_flatten, tree_map
from repro_torch.kernels.dp import ops as _dp_ops
from repro_torch.sharding.api import (
    all_gather_rows, institution_rows, mesh_axis_sizes, mesh_barrier,
)
from repro_torch.privacy.accountant import RDPAccountant

Pytree = Any
LocalStepFn = Callable[[Pytree, Pytree], Tuple[Pytree, Dict]]


@dataclasses.dataclass
class OverlayConfig:
    n_institutions: int
    local_steps: int = 10          # steps between gossip rounds
    merge: str = "secure_mean"     # any name in core.merges.available_merges()
    alpha: float = 1.0             # rolling-update blend
    group_size: int = 2            # hierarchical merge group
    consensus_seed: int = 0
    arch_family: str = "cnn"
    consensus_params: Optional[ProtocolParams] = None
    # ProtocolParams.for_fleet(P) lets federations of P >= 16 commit
    fault_schedule: Optional[Any] = None    # repro_torch.chaos.FaultSchedule
    dp: Optional[Any] = None                # repro_torch.privacy.DPConfig
    attack_schedule: Optional[Any] = None   # chaos.ByzantineSchedule
    trim_fraction: float = 0.25             # trimmed_mean per-side trim
    norm_gate_factor: Optional[float] = 3.0  # norm_gated_mean threshold
    secure_domain: str = "float"   # secure_mean arithmetic: "float" fp32
                                   # pads, or "int" exact Z_2^32 pads
    block_spec: Optional[Any] = None
    # merges.partial.BlockSpec: the named partition of the param tree for
    # merge="partial"; None makes "partial" delegate to `inner_merge`.
    merge_blocks: Optional[Tuple[str, ...]] = None
    # The shared blocks the partial merge federates; every other block is
    # personal: it never merges and never enters a ledger fingerprint.
    # None = all of the spec's blocks.
    block_schedule: Optional[Any] = None
    # merges.partial.BlockSchedule: a per-round rotation over the shared
    # blocks.
    inner_merge: str = "mean"      # what "partial" runs on the shared blocks
    merge_subtree: Optional[str] = "params"
    # Only the MODEL is federated: when the stacked state is a dict holding
    # this key, that subtree alone is merged, published, DP-noised and
    # fingerprinted, and every other leaf (optimizer state, the device
    # tier's stale buffers) stays institution-local.  A state that is not
    # such a dict (a bare param tree) is merged whole.  The device tier
    # (core.device_tier) runs in the local step; its round's weight totals
    # travel in the state: a "device_w" leaf feeds
    # `MergeContext.device_weights` each round.


def stack_params(param_list: List[Pytree]) -> Pytree:
    """P param trees -> one tree of (P, ...) leaves."""
    return tree_map(lambda *xs: torch.stack(xs), *param_list)


def unstack_params(stacked: Pytree, n: int) -> List[Pytree]:
    """The first `n` institutions' param trees of a stacked tree."""
    return [tree_map(lambda x: x[i], stacked) for i in range(n)]


def replicate_params(params: Pytree, n: int,
                     generator: Optional[torch.Generator] = None,
                     jitter: float = 0.0) -> Pytree:
    """P identical (or jittered) replicas: the institutions start from a
    common registered architecture.  Jitter is drawn from `generator` on
    the generator's device, leaf by leaf in JAX leaf order."""
    def rep(x):
        out = x[None].expand((n,) + tuple(x.shape)).clone()
        if jitter and generator is not None and out.is_floating_point():
            noise = torch.randn(out.shape, generator=generator,
                                dtype=out.dtype, device=generator.device)
            out = out + jitter * noise.to(out.device)
        return out
    return tree_map(rep, params)


_MODEL_ATTACKS = ("sign_flip", "scaled_grad")


def _rows_mask(mask: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return mask.reshape(mask.shape + (1,) * (x.dim() - 1))


def _publish_merge(strategy, dp, attack_kind, stacked: Pytree,
                   ctx: MergeContext, att_mask, att_scale,
                   ref: Optional[Pytree] = None) -> Tuple[Pytree, Pytree]:
    """ONE round's publication pipeline + merge, shared by both engines.

      1. DP (cfg.dp): every surviving row's round update (its delta from
         `ref`, the round-start params; ref=None clips the raw row) is
         clipped and noised by the DP kernel and re-added to `ref`.  The
         noise seed is the round's MPC seed XOR the DP config seed.  Dead
         rows are restored bit for bit ((x - ref) + ref is not an
         identity in floating point).
      2. Attack (cfg.attack_schedule): compromised SURVIVING rows are
         replaced by what they publish (a dead attacker publishes
         nothing).
      3. The merge strategy runs on the published rows.
      4. With DP or a model-space attack, the commit gate is applied again
         on the original rows: a rejected round leaves the real params
         untouched.

    `att_mask` ((P,) bool) and `att_scale` are read only for a
    model-space attack; other rounds pass None.  Returns ``(merged,
    published)``: the ledger fingerprints what each institution published,
    never its raw private rows."""
    pub = stacked
    if dp is not None:
        seed = seed_from_key(ctx.key) ^ np.uint32(dp.seed)
        if ref is None:
            pub = _dp_ops.dp_clip_noise_tree(pub, seed, dp.clip_norm,
                                             dp.noise_multiplier,
                                             mask=ctx.mask)
        else:
            delta = tree_map(lambda a, b: a - b, pub, ref)
            noised = _dp_ops.dp_clip_noise_tree(delta, seed, dp.clip_norm,
                                                dp.noise_multiplier,
                                                mask=ctx.mask)
            pub = tree_map(lambda b, d: b + d, ref, noised)
        if ctx.mask is not None:
            pub = tree_map(lambda p, o: torch.where(_rows_mask(ctx.mask, o),
                                                    p, o), pub, stacked)
    if attack_kind in _MODEL_ATTACKS:
        am = att_mask if ctx.mask is None else att_mask & ctx.mask
        pub = apply_attack(attack_kind, pub, am, att_scale)
    merged = strategy.merge(pub, ctx)
    if dp is not None or attack_kind in _MODEL_ATTACKS:
        merged = _commit_gate(merged, stacked, ctx.commit)
    return merged, pub


def _host(tree: Pytree) -> Pytree:
    return tree_map(lambda x: x.detach().cpu().numpy(), tree)


class DecentralizedOverlay:
    def __init__(self, cfg: OverlayConfig,
                 registry: Optional[ModelRegistry] = None):
        get_merge(cfg.merge)   # fail fast on unknown strategy names
        if cfg.merge == "partial":
            if cfg.inner_merge == "partial":
                raise ValueError("inner_merge cannot be 'partial' (the "
                                 "partial meta-merge does not nest)")
            get_merge(cfg.inner_merge)
            if cfg.block_spec is None:
                if cfg.merge_blocks is not None or \
                        cfg.block_schedule is not None:
                    raise ValueError(
                        "merge_blocks/block_schedule need a block_spec "
                        "naming the blocks they select")
            else:
                selected = (cfg.block_spec.block_names
                            if cfg.merge_blocks is None
                            else cfg.block_spec.validate_blocks(
                                cfg.merge_blocks))
                if cfg.block_schedule is not None:
                    stray = [b for g in cfg.block_schedule.groups
                             for b in g if b not in selected]
                    if stray:
                        raise ValueError(
                            f"block_schedule names blocks {stray} outside "
                            f"the merged selection {tuple(selected)}")
        elif (cfg.block_spec is not None or cfg.merge_blocks is not None
              or cfg.block_schedule is not None):
            raise ValueError(
                f"block_spec/merge_blocks/block_schedule require "
                f"merge='partial'; got merge={cfg.merge!r}")
        if cfg.secure_domain not in ("float", "int"):
            raise ValueError(f"unknown secure_domain "
                             f"{cfg.secure_domain!r}; valid domains: "
                             f"('float', 'int')")
        if cfg.attack_schedule is not None and \
                cfg.attack_schedule.kind not in ATTACK_KINDS:
            raise ValueError(f"unknown attack kind "
                             f"{cfg.attack_schedule.kind!r}")
        self.cfg = cfg
        self.registry = registry or ModelRegistry()
        self.gate = ConsensusGate(cfg.n_institutions, seed=cfg.consensus_seed,
                                  params=cfg.consensus_params)
        self.accountant = (RDPAccountant(cfg.dp.noise_multiplier)
                           if cfg.dp is not None else None)
        self.round_index = 0
        self.stats: List[Dict] = []

    # ------------------------------------------------------------------
    def local_phase(self, stacked: Pytree, batches: Pytree,
                    local_step: LocalStepFn):
        """`local_steps` institution-local updates, `local_step` vmapped
        over the institution axis.  batches leaves: (local_steps, P, ...);
        data never crosses the institution axis.  Returns the last step's
        metrics."""
        step = torch.func.vmap(local_step)
        metrics = None
        for s in range(self.cfg.local_steps):
            stacked, metrics = step(stacked,
                                    tree_map(lambda x: x[s], batches))
        return stacked, metrics

    # ------------------------------------------------------------------
    def _faults(self, round_index: int):
        """The configured schedule's RoundFaults for a round, or None."""
        sched = self.cfg.fault_schedule
        if sched is None:
            return None
        return sched.faults(round_index, self.cfg.n_institutions)

    def _survivors(self, tr: Transcript, faults) -> Tuple[List[int], Any]:
        """(survivor list, (P,) bool participation or None).  The consensus
        transcript is authoritative (a coordinator that crashed
        mid-instance is excluded though the schedule listed it as up); a
        round every institution survived has mask None, the fault-free
        code path."""
        P = self.cfg.n_institutions
        if faults is None or tr.survivors == tuple(range(P)):
            return list(range(P)), None
        part = np.zeros(P, bool)
        part[list(tr.survivors)] = True
        return [int(i) for i in tr.survivors], part

    @property
    def _attack_kind(self) -> Optional[str]:
        sched = self.cfg.attack_schedule
        return None if sched is None else sched.kind

    def _attack_arrays(self, round_index: int):
        """Host-side attack decision for one round: ((P,) bool attacker
        mask, f32 scale, scheduled attacker list or None)."""
        P = self.cfg.n_institutions
        sched = self.cfg.attack_schedule
        if sched is None:
            return np.zeros(P, bool), np.float32(1.0), None
        att = sched.attacker_mask(round_index, P)
        return (att, np.float32(getattr(sched, "scale", 1.0)),
                [int(i) for i in np.flatnonzero(att)])

    @property
    def _merge_blocks(self) -> Optional[Tuple[str, ...]]:
        mb = self.cfg.merge_blocks
        return None if mb is None else tuple(mb)

    def _block_mask_row(self, round_index: int):
        """The round's (n_blocks,) bool block-schedule row, or None when
        no schedule is attached; both engines take it from here."""
        sched = self.cfg.block_schedule
        if sched is None or self.cfg.block_spec is None:
            return None
        return sched.mask_row(self.cfg.block_spec, round_index)

    def _attestation(self, round_index: int, tree):
        """How a round's DLT writes see the param tree: ``(view_fn,
        merge_label, blocks_meta)``.  Personal blocks never enter a
        fingerprint, so a partial federation registers `select_tree`
        views.  A selection that covers the whole tree with no schedule
        behaves exactly like its inner merge and attests exactly like it
        (its label, whole-tree fingerprints, no "blocks"), so its chain
        digest equals the inner merge's."""
        cfg = self.cfg
        if cfg.merge != "partial":
            return (lambda t: t), cfg.merge, None
        if cfg.block_spec is None:
            return (lambda t: t), cfg.inner_merge, None
        spec = cfg.block_spec
        selected = self._merge_blocks or spec.block_names
        if cfg.block_schedule is None:
            if spec.covers(tree, selected):
                return (lambda t: t), cfg.inner_merge, None
            merged_now = tuple(selected)
        else:
            merged_now = tuple(b for b in cfg.block_schedule
                               .active(round_index) if b in selected)
        blocks_meta = {"inner": cfg.inner_merge,
                       "shared": list(selected),
                       "merged": list(merged_now)}
        return (lambda t: spec.select_tree(t, selected)), "partial", \
            blocks_meta

    def _merge_context(self, round_index: int, commit, key,
                       mask=None, device_weights=None) -> MergeContext:
        cfg = self.cfg
        return MergeContext(
            commit=commit, mask=mask, alpha=cfg.alpha,
            round_index=round_index, key=key, group_size=cfg.group_size,
            shift=gossip_shift(round_index, cfg.n_institutions),
            n_institutions=cfg.n_institutions,
            trim_fraction=cfg.trim_fraction,
            norm_gate_factor=cfg.norm_gate_factor,
            domain=cfg.secure_domain, device_weights=device_weights,
            block_spec=cfg.block_spec,
            blocks=self._merge_blocks, inner_merge=cfg.inner_merge,
            block_mask=self._block_mask_row(round_index))

    def _merge(self, stacked: Pytree, key, committed: bool,
               ref: Optional[Pytree], round_index: int, part,
               survivors: List[int]):
        """Publish + merge one round under participation `part` ((P,) bool
        or None): returns (merged state, published rows, merged row of the
        first survivor); the last two feed the ledger.

        Subtree mode (``cfg.merge_subtree`` names a key of a dict state):
        only that subtree is published, DP-noised (against the same
        subtree of `ref`), merged and fingerprinted; the merged state is
        ``{**state, sub: merged}``.  A state's ``"device_w"`` leaf, as the
        local phase left it, is the merge's device weights."""
        sub = self.cfg.merge_subtree
        full_state = None
        dw = stacked.get("device_w") if isinstance(stacked, dict) else None
        if sub is not None and isinstance(stacked, dict) and sub in stacked:
            full_state, stacked = stacked, stacked[sub]
            if ref is not None:
                ref = ref[sub]
        device = tree_flatten(stacked)[0][0].device
        mask = None if part is None else torch.from_numpy(part).to(device)
        att, scale = None, None
        if self._attack_kind in _MODEL_ATTACKS:
            att, scale, _ = self._attack_arrays(round_index)
            att = torch.from_numpy(att).to(device)
        merged, published = _publish_merge(
            get_merge(self.cfg.merge), self.cfg.dp, self._attack_kind,
            stacked, self._merge_context(round_index, committed, key, mask,
                                         device_weights=dw),
            att, scale, ref)
        row = survivors[0] if survivors else 0
        merged_row = tree_map(lambda x: x[row], merged)
        if full_state is not None:
            merged = {**full_state, sub: merged}
        return merged, published, merged_row

    def _round_record(self, round_index: int, tr: Transcript,
                      survivors: List[int], host_stacked,
                      host_merged_row) -> RoundRecord:
        """The round's DLT writes: every survivor's registration, then the
        merged model's provenance.  The privacy accountant advances once
        per publishing round (any round with survivors: rows are
        registered before the vote, so even an aborted round released
        them), here, in round order."""
        view, merge_label, blocks_meta = self._attestation(round_index,
                                                           host_stacked)
        regs = [(f"hospital-{i}",
                 view(tree_map(lambda x: x[i], host_stacked)),
                 {"round": round_index, "consensus_s": tr.elapsed_s})
                for i in survivors]
        merged_metadata = {"round": round_index, "merge": merge_label,
                           "committed": bool(tr.committed),
                           "survivors": survivors,
                           "leader": tr.leader,
                           "leader_elections": tr.leader_elections}
        attackers = self._attack_arrays(round_index)[2]
        if attackers is not None:
            # scheduled attackers that actually published this round
            merged_metadata["attackers"] = [i for i in attackers
                                            if i in survivors]
        if self.cfg.dp is not None:
            if survivors:
                self.accountant.step()
            merged_metadata["dp"] = {
                "clip_norm": self.cfg.dp.clip_norm,
                "noise_multiplier": self.cfg.dp.noise_multiplier,
                "delta": self.cfg.dp.delta,
                "steps": self.accountant.steps,
                "eps": round(self.accountant.epsilon(self.cfg.dp.delta), 6),
            }
        return RoundRecord(arch_family=self.cfg.arch_family,
                           registrations=regs,
                           merged_institution="overlay",
                           merged_params=view(host_merged_row),
                           merged_metadata=merged_metadata,
                           blocks=blocks_meta)

    def _flush(self, rounds, ledger: bool = True) -> None:
        """One DLT flush for (transcript, survivors, published rows, merged
        row) rounds, in round order.  ``ledger=False`` (a mesh rank other
        than 0) writes no ledger record but keeps the stats, the round
        index and the privacy accountant in step."""
        if ledger:
            records = []
            for r, (tr, survivors, published, row) in enumerate(rounds):
                records.append(self._round_record(
                    self.round_index + r, tr, survivors, _host(published),
                    _host(row)))
            self.registry.register_round_batch(records)
        elif self.accountant is not None:
            for _, survivors, _, _ in rounds:
                if survivors:
                    self.accountant.step()
        for tr, survivors, _, _ in rounds:
            self.round_index += 1
            self.stats.append({"round": self.round_index,
                               "consensus_s": tr.elapsed_s,
                               "consensus_rounds": tr.rounds_total,
                               "committed": bool(tr.committed),
                               "n_survivors": len(survivors),
                               "leader_elections": tr.leader_elections,
                               "aborted_no_quorum": bool(tr.aborted_no_quorum),
                               "straggler_wait_s": tr.straggler_wait_s})

    def merge_phase(self, stacked: Pytree, key, faults=None,
                    ref: Optional[Pytree] = None):
        """Consensus -> gated, survivor-masked merge -> DLT registration.

        `faults` (a `chaos.RoundFaults`) overrides the configured fault
        schedule for this round; by default it is derived from
        ``cfg.fault_schedule`` at the current round index.  `ref` (DP
        runs) is the round-start state, so the DP mechanism clips the round
        update; without it the raw published row is clipped."""
        if faults is None:
            faults = self._faults(self.round_index)
        tr = self.gate.next_round(faults=faults)
        survivors, part = self._survivors(tr, faults)
        merged, published, row = self._merge(stacked, key, tr.committed, ref,
                                             self.round_index, part,
                                             survivors)
        self._flush([(tr, survivors, published, row)])
        return merged, tr

    def round(self, stacked: Pytree, batches: Pytree, local_step: LocalStepFn,
              key):
        """One full overlay round: local training + consensus-gated merge."""
        _, k2 = prng.split(key)
        ref = stacked if self.cfg.dp is not None else None
        stacked, metrics = self.local_phase(stacked, batches, local_step)
        stacked, tr = self.merge_phase(stacked, k2, ref=ref)
        return stacked, metrics, tr

    # ------------------------------------------------------------------
    def restore(self, snap) -> None:
        """Adopt a verified `checkpoint.snapshot.SnapshotState`: the
        ledger, stats, round index and privacy accountant come from the
        snapshot, and the consensus gate is fast-forwarded through the
        instances already run (each is a pure function of seed x index x
        schedule), so the next round this overlay runs (its data, fault
        and attack draws, consensus transcript and merge keys) is the one
        the uninterrupted run would have run.  Only a fresh overlay may
        restore: resuming over live state would fork the schedules."""
        if self.round_index != 0 or self.stats or self.gate.history:
            raise ValueError("restore() requires a fresh overlay "
                             "(round 0, no consensus history)")
        self.registry = snap.registry
        self.stats = [dict(s) for s in snap.stats]
        self.round_index = int(snap.round_index)
        if self.accountant is not None:
            self.accountant.steps = int(snap.accountant_steps)
        sched, P = self.cfg.fault_schedule, self.cfg.n_institutions
        self.gate.fast_forward(
            self.round_index,
            None if sched is None else (lambda r: sched.faults(r, P)))

    @staticmethod
    def _keeps_ledger(mesh) -> bool:
        """Whether this process keeps the DLT and writes the snapshots:
        always without a mesh, global rank 0 alone under one."""
        return mesh is None or dist.get_rank() == 0

    def snapshot(self, snapshot_dir: str, stacked: Pytree,
                 metadata: Optional[Dict] = None, *, mesh=None) -> str:
        """Persist a verified snapshot of the current state at
        ``snapshot_dir/round_<index>``; returns its path.  Under `mesh`,
        every rank of it calls this: rank 0 writes, and every rank waits
        at a barrier until it has."""
        # imported here: checkpoint imports core.registry, and with it
        # this package
        from repro_torch.checkpoint.snapshot import (
            save_snapshot, snapshot_path,
        )
        path = snapshot_path(snapshot_dir, self.round_index)
        if self._keeps_ledger(mesh):
            save_snapshot(path, stacked, self, metadata=metadata)
        if mesh is not None:
            mesh_barrier(mesh)
        return path

    # ------------------------------------------------------------------
    def run_rounds(self, stacked: Pytree, batches: Pytree,
                   local_step: LocalStepFn, key, n_rounds: int, *,
                   mesh=None, snapshot_every: Optional[int] = None,
                   snapshot_dir: Optional[str] = None):
        """R overlay rounds with one DLT flush, bit-identical to R `round`
        calls.

        batches leaves: (n_rounds, local_steps, P, ...).  `key` is one key
        (split into R round keys) or an (R, 2) stack used verbatim.  All R
        consensus instances, with the fault schedule's survivor masks, run
        first on the host; the R rounds of training and merging then run
        on the device without a host round trip, each faulty round through
        the masked merge and each healthy one through the unmasked path;
        the ledger is written once at the end.

        Returns ``(stacked, metrics, transcripts)``; metrics leaves gain a
        leading (R,) round axis.

        With `snapshot_dir` (and a cadence ``snapshot_every=K``, default
        R) the R rounds run as ceil(R/K) chunks of this same round loop,
        each followed by a verified snapshot, so snapshotting changes no
        bit.  A crashed run resumes by restoring the newest verified
        snapshot into a fresh overlay (`checkpoint.snapshot
        .latest_verified_snapshot`, then `restore`) and running the
        remaining rounds.

        Mesh-parallel federations: `mesh` is a `DeviceMesh` with an
        ``"inst"`` axis of W ranks (a mesh without one raises ValueError
        before anything runs), and every rank of the mesh makes the same
        call with the same full (P, ...) `stacked` and `batches`.  Where P
        divides W, rank r of the axis trains rows ``[r*P/W, (r+1)*P/W)``
        (``Shard(0)``; `batches` sliced on dim 2), then one
        `sharding.all_gather_rows` of its trained rows and metrics hands
        every rank the full (P, ...) state, and every rank runs the
        unchanged publish-and-merge on it, the kernels included: the merge
        reads the rows it reads on one device, so only the local
        training's batching under `vmap` differs across layouts.  Where P
        does not divide W, every rank trains all P rows (the divisibility
        guard: replicated, never padded).  On a 1-rank mesh the gather is
        the identity, so the result is bit-identical to ``mesh=None``.
        Every rank returns the full merged state and the metrics of all P.
        Every rank runs the same host consensus, so the transcripts and
        stats agree; global rank 0 alone keeps the DLT (the other ranks
        register nothing) and writes the snapshots, and every rank waits
        at a barrier after each snapshot."""
        if mesh is not None and "inst" not in mesh_axis_sizes(mesh):
            raise ValueError(
                f"mesh must carry an 'inst' institution axis; got axes "
                f"{tuple(mesh_axis_sizes(mesh))}")
        R = int(n_rounds)
        if R <= 0:
            raise ValueError("n_rounds must be positive")
        first = tree_flatten(batches)[0][0]
        if first.shape[0] != R or first.shape[1] != self.cfg.local_steps:
            raise ValueError(
                f"batches leaves must be (n_rounds={R}, "
                f"local_steps={self.cfg.local_steps}, P, ...); got leading "
                f"dims {tuple(first.shape[:2])}")
        key = np.asarray(key, np.uint32)
        if key.ndim == 2:
            if key.shape[0] != R:
                raise ValueError(f"got {key.shape[0]} stacked keys for "
                                 f"{R} rounds")
            round_keys = key
        else:
            round_keys = prng.split(key, R)
        # everything that can raise is checked before phase 1, which
        # advances the gate: an error after it would leave the overlay out
        # of step with its own round index
        if snapshot_every is not None:
            if snapshot_dir is None:
                raise ValueError("snapshot_every requires snapshot_dir")
            if int(snapshot_every) <= 0:
                raise ValueError("snapshot_every must be positive")

        if snapshot_dir is not None:
            K = R if snapshot_every is None else int(snapshot_every)
            all_metrics, all_trs = [], []
            for lo in range(0, R, K):
                hi = min(lo + K, R)
                stacked, metrics, trs = self.run_rounds(
                    stacked, tree_map(lambda x: x[lo:hi], batches),
                    local_step, round_keys[lo:hi], hi - lo, mesh=mesh)
                self.snapshot(snapshot_dir, stacked, mesh=mesh)
                all_metrics.append(metrics)
                all_trs.extend(trs)
            metrics = {k: torch.cat([m[k] for m in all_metrics])
                       for k in all_metrics[0]}
            return stacked, metrics, all_trs

        # phase 1 (host): every consensus instance of the R rounds, with
        # its faults, survivor list and participation mask (None for a
        # round every institution survived: the fault-free path)
        transcripts, participation = [], []
        for r in range(R):
            faults = self._faults(self.round_index + r)
            tr = self.gate.next_round(faults=faults)
            transcripts.append(tr)
            participation.append(self._survivors(tr, faults))

        # phase 2 (device): local training + gated merge, no host sync
        # (under a mesh, each rank trains its block and one all_gather a
        # round brings back the full rows)
        block = None if mesh is None else institution_rows(
            mesh, self.cfg.n_institutions)
        rounds, all_metrics = [], []
        for r, tr in enumerate(transcripts):
            _, k2 = prng.split(round_keys[r])
            ref = stacked if self.cfg.dp is not None else None
            batch = tree_map(lambda x: x[r], batches)
            if block is None:
                stacked, metrics = self.local_phase(stacked, batch,
                                                    local_step)
            else:
                group, lo, hi = block
                trained = self.local_phase(
                    tree_map(lambda x: x[lo:hi], stacked),
                    tree_map(lambda x: x[:, lo:hi], batch), local_step)
                stacked, metrics = self._gather_rows(trained, group)
            survivors, part = participation[r]
            stacked, published, row = self._merge(
                stacked, k2, tr.committed, ref, self.round_index + r, part,
                survivors)
            rounds.append((tr, survivors, published, row))
            all_metrics.append(metrics)

        # phase 3 (host): ONE flush of all R rounds' DLT effects
        self._flush(rounds, ledger=self._keeps_ledger(mesh))
        metrics = {k: torch.stack([m[k] for m in all_metrics])
                   for k in all_metrics[0]}
        return stacked, metrics, transcripts

    @staticmethod
    def _gather_rows(tree, group):
        """Every rank's trained block -> the full rows on every rank (one
        collective; a method so that a caller can time it)."""
        return all_gather_rows(tree, group)

    # ------------------------------------------------------------------
    def divergence(self, stacked: Pytree) -> float:
        """Max L2 distance of any institution from the federation mean."""
        def leaf_div(x):
            d = (x - x.mean(dim=0, keepdim=True)) ** 2
            if x.dim() > 1:
                d = d.sum(dim=tuple(range(1, x.dim())))
            return torch.sqrt(d).max()
        return float(max(leaf_div(x) for x in tree_flatten(stacked)[0]))
