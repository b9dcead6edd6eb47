"""The STIGMA decentralized-ML overlay (paper §4): P institutions federate a
model WITHOUT a central aggregation server.

Each round:
  1. every institution trains its own replica on its own data for
     `local_steps` steps: `torch.func.vmap` of the caller's per-institution
     step over the stacked (P, ...) param tree;
  2. (optional, ``OverlayConfig.dp``) each institution's round update is
     L2-clipped and Gaussian-noised by the DP kernel before anything sees
     it; the RDP accountant's eps(delta) rides into the ledger;
  3. a Paxos 3-phase instance (`ConsensusGate`) decides whether the round
     commits;
  4. the registered merge strategy (``secure_mean``: the fused MPC kernel)
     merges the published rows, gated by the commit bit;
  5. the DLT registers every institution's published fingerprint and the
     merged model with its provenance.

Two engines, bit-identical on the same seed:

  * EAGER: `round()` / `merge_phase()`, one consensus instance, merge and
    DLT flush per call;
  * BATCHED: `run_rounds()`: every consensus transcript is computed up
    front (it depends only on seed x round), the R rounds of training and
    merging run as a Python loop on the device with no host round trip,
    and all DLT writes happen in one flush at the end.

Fault schedules, attack schedules and meshes are not ported yet and raise
`NotImplementedError`.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import random as prng
from repro_torch.core.consensus import ConsensusGate, Transcript
from repro_torch.core.merges import MergeContext, get_merge
from repro_torch.core.merges.toolkit import gate as _commit_gate
from repro_torch.core.registry import ModelRegistry, RoundRecord
from repro_torch.core.secure_agg import seed_from_key
from repro_torch.pytree import tree_flatten, tree_map
from repro_torch.kernels.dp import ops as _dp_ops
from repro_torch.privacy.accountant import RDPAccountant

Pytree = Any
LocalStepFn = Callable[[Pytree, Pytree], Tuple[Pytree, Dict]]


@dataclasses.dataclass
class OverlayConfig:
    n_institutions: int
    local_steps: int = 10          # steps between gossip rounds
    merge: str = "secure_mean"     # any name in core.merges.available_merges()
    alpha: float = 1.0             # rolling-update blend
    consensus_seed: int = 0
    arch_family: str = "cnn"
    fault_schedule: Optional[Any] = None    # not ported yet: must be None
    dp: Optional[Any] = None                # repro_torch.privacy.DPConfig
    attack_schedule: Optional[Any] = None   # not ported yet: must be None
    secure_domain: str = "float"   # secure_mean arithmetic: "float" fp32
                                   # pads, or "int" exact Z_2^32 pads
    merge_subtree: Optional[str] = "params"
    # Only the MODEL is federated: when the stacked tree is a dict holding
    # this key, the reference merges that subtree alone.  That mode (model
    # plus optimizer state) is not ported yet and raises; bare param trees
    # (this key absent, or None) are merged whole.


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


def _publish_merge(strategy, dp, stacked: Pytree, ctx: MergeContext,
                   ref: Optional[Pytree] = None) -> Tuple[Pytree, Pytree]:
    """ONE round's publication pipeline + merge, shared by both engines.

      1. DP (cfg.dp): every surviving row's round update (its delta from
         `ref`, the round-start params; ref=None clips the raw row) is
         clipped and noised by the DP kernel and re-added to `ref`.  The
         noise seed is the round's MPC seed XOR the DP config seed.
      2. The merge strategy runs on the published rows.
      3. With DP, the commit gate is applied again on the original rows: a
         rejected round leaves the real params untouched.

    Returns ``(merged, published)``: the ledger fingerprints what each
    institution published, never its raw private rows."""
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
    merged = strategy.merge(pub, ctx)
    if dp is not None:
        merged = _commit_gate(merged, stacked, ctx.commit)
    return merged, pub


def _host(tree: Pytree) -> Pytree:
    return tree_map(lambda x: x.detach().cpu().numpy(), tree)


class DecentralizedOverlay:
    def __init__(self, cfg: OverlayConfig,
                 registry: Optional[ModelRegistry] = None):
        get_merge(cfg.merge)   # fail fast on unknown strategy names
        if cfg.secure_domain not in ("float", "int"):
            raise ValueError(f"unknown secure_domain "
                             f"{cfg.secure_domain!r}; valid domains: "
                             f"('float', 'int')")
        if cfg.fault_schedule is not None or cfg.attack_schedule is not None:
            raise NotImplementedError(
                "fault and attack schedules are not ported to the PyTorch "
                "overlay yet")
        self.cfg = cfg
        self.registry = registry or ModelRegistry()
        self.gate = ConsensusGate(cfg.n_institutions, seed=cfg.consensus_seed)
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
    def _merge_context(self, round_index: int, commit, key) -> MergeContext:
        return MergeContext(commit=commit, mask=None, alpha=self.cfg.alpha,
                            round_index=round_index, key=key,
                            n_institutions=self.cfg.n_institutions,
                            domain=self.cfg.secure_domain)

    def _merge(self, stacked: Pytree, key, committed: bool,
               ref: Optional[Pytree], round_index: int):
        """Publish + merge one round: returns (merged, published rows,
        merged row 0); the last two feed the ledger."""
        sub = self.cfg.merge_subtree
        if sub is not None and isinstance(stacked, dict) and sub in stacked:
            raise NotImplementedError(
                f"merging only the {sub!r} subtree of a stacked state is not "
                f"ported to the PyTorch overlay yet")
        merged, published = _publish_merge(
            get_merge(self.cfg.merge), self.cfg.dp, stacked,
            self._merge_context(round_index, committed, key), ref)
        return merged, published, tree_map(lambda x: x[0], merged)

    def _round_record(self, round_index: int, tr: Transcript,
                      host_stacked, host_merged_row) -> RoundRecord:
        """The round's DLT writes: every institution's registration, then
        the merged model's provenance.  The privacy accountant advances
        once per publishing round, here, in round order."""
        survivors = list(range(self.cfg.n_institutions))
        regs = [(f"hospital-{i}", tree_map(lambda x: x[i], host_stacked),
                 {"round": round_index, "consensus_s": tr.elapsed_s})
                for i in survivors]
        merged_metadata = {"round": round_index, "merge": self.cfg.merge,
                           "committed": bool(tr.committed),
                           "survivors": survivors,
                           "leader": tr.leader,
                           "leader_elections": tr.leader_elections}
        if self.cfg.dp is not None:
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
                           merged_params=host_merged_row,
                           merged_metadata=merged_metadata)

    def _flush(self, rounds) -> None:
        """One DLT flush for (transcript, published rows, merged row)
        rounds, in round order."""
        records = []
        for r, (tr, published, row) in enumerate(rounds):
            records.append(self._round_record(self.round_index + r, tr,
                                              _host(published), _host(row)))
        self.registry.register_round_batch(records)
        for tr, _, _ in rounds:
            self.round_index += 1
            self.stats.append({"round": self.round_index,
                               "consensus_s": tr.elapsed_s,
                               "consensus_rounds": tr.rounds_total,
                               "committed": bool(tr.committed),
                               "n_survivors": self.cfg.n_institutions,
                               "leader_elections": tr.leader_elections,
                               "aborted_no_quorum": bool(tr.aborted_no_quorum),
                               "straggler_wait_s": tr.straggler_wait_s})

    def merge_phase(self, stacked: Pytree, key, ref: Optional[Pytree] = None):
        """Consensus -> gated merge -> DLT registration.  `ref` (DP runs)
        is the round-start state, so the DP mechanism clips the round
        update; without it the raw published row is clipped."""
        tr = self.gate.next_round()
        merged, published, row = self._merge(stacked, key, tr.committed, ref,
                                             self.round_index)
        self._flush([(tr, published, row)])
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
    def run_rounds(self, stacked: Pytree, batches: Pytree,
                   local_step: LocalStepFn, key, n_rounds: int, *,
                   mesh=None):
        """R overlay rounds with one DLT flush, bit-identical to R `round`
        calls.

        batches leaves: (n_rounds, local_steps, P, ...).  `key` is one key
        (split into R round keys) or an (R, 2) stack used verbatim.  All R
        consensus instances run first on the host; the R rounds of
        training and merging then run on the device without a host round
        trip; the ledger is written once at the end.

        Returns ``(stacked, metrics, transcripts)``; metrics leaves gain a
        leading (R,) round axis."""
        if mesh is not None:
            raise NotImplementedError("mesh-parallel federations are not "
                                      "ported to the PyTorch overlay yet")
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

        # phase 1 (host): every consensus instance of the R rounds
        transcripts = [self.gate.next_round() for _ in range(R)]

        # phase 2 (device): local training + gated merge, no host sync
        rounds, all_metrics = [], []
        for r, tr in enumerate(transcripts):
            _, k2 = prng.split(round_keys[r])
            ref = stacked if self.cfg.dp is not None else None
            stacked, metrics = self.local_phase(
                stacked, tree_map(lambda x: x[r], batches), local_step)
            stacked, published, row = self._merge(
                stacked, k2, tr.committed, ref, self.round_index + r)
            rounds.append((tr, published, row))
            all_metrics.append(metrics)

        # phase 3 (host): ONE flush of all R rounds' DLT effects
        self._flush(rounds)
        metrics = {k: torch.stack([m[k] for m in all_metrics])
                   for k in all_metrics[0]}
        return stacked, metrics, transcripts

    # ------------------------------------------------------------------
    def divergence(self, stacked: Pytree) -> float:
        """Max L2 distance of any institution from the federation mean."""
        def leaf_div(x):
            d = (x - x.mean(dim=0, keepdim=True)) ** 2
            if x.dim() > 1:
                d = d.sum(dim=tuple(range(1, x.dim())))
            return torch.sqrt(d).max()
        return float(max(leaf_div(x) for x in tree_flatten(stacked)[0]))
