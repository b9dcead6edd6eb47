"""The federation harness: P hospitals training the (width-scaled) paper CNN
through the overlay under a fault schedule and an attack schedule: the
paper's federation, as ``chip_smoke.py`` runs it.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch import random as prng
from repro_torch import resolve_device
from repro_torch.checkpoint.snapshot import latest_verified_snapshot
from repro_torch.configs.stigma_cnn import STIGMA_CNN
from repro_torch.core.overlay import (
    DecentralizedOverlay, OverlayConfig, replicate_params,
)
from repro_torch.core.registry import ModelRegistry, fingerprint_pytree
from repro_torch.pytree import tree_map
from repro_torch.data.pipeline import DirichletPartitioner, SyntheticGlendaDataset
from repro_torch.models import stigma_cnn as cnn


class CNNFederation:
    """P institutions training the paper CNN under a fault schedule.
    `run_round(rnd)` executes one overlay round (local SGD on
    institution-private synthetic GLENDA frames, then the consensus-gated,
    survivor-masked secure merge) and returns (metrics, transcript);
    `run_rounds(n)` executes n rounds through the batched engine,
    bit-identical to n `run_round` calls.  `snapshot` and `resume_from`
    are its crash recovery (`chaos.recovery` drives them).

    The local SGD step is vmapped over the institution axis
    (`torch.func.vmap` of `torch.func.grad_and_value`), in IEEE float32
    whatever the process's TF32 settings (`cnn.full_fp32`).  The DLT runs with
    a logical clock, so two same-seed runs produce byte-identical chains.

    `stacked`: the starting (P, ...) params, e.g. the JAX package's through
    `repro_torch.convert.params_from_jax`; None draws them from
    ``torch.Generator`` seeds `seed` (weights) and `seed + 1` (jitter).
    `device`: None means ``cuda`` and raises without a CUDA device.
    `secure_domain`: "float" or "int" secure_mean arithmetic.
    `schedule`: a `chaos.FaultSchedule` (None: every institution survives
    every round).  `consensus_params`: a `ProtocolParams`; federations of
    P >= 16 pass ``ProtocolParams.for_fleet(P)``, under which their rounds
    can commit.  `merge`: any registered strategy; `trim_fraction` and
    `norm_gate_factor` tune the robust ones.  `dp`: a `privacy.DPConfig`.
    `attack_schedule`: a `chaos.ByzantineSchedule`; model poisoning runs
    inside the overlay, and a ``label_flip`` schedule poisons the attacker
    institutions' dataset labels here instead (statically, so it takes no
    start/stop window).  With ``merge="partial"``, `block_spec`,
    `merge_blocks`, `block_schedule` and `inner_merge` go to the overlay:
    ``block_spec=BlockSpec.by_prefix(backbone="conv", head="head")`` with
    ``merge_blocks=("backbone",)`` federates the conv stack while each
    hospital keeps a personal head.  `mesh`: a `DeviceMesh` with an
    "inst" axis (`sharding.make_institution_mesh`), which `run_rounds`
    passes to the overlay: every rank of the mesh builds the same
    federation, trains its block of hospitals and holds the full merged
    state after each round, so `divergence`, `snapshot` and `resume_from`
    work on the full state (rank 0 alone writes a snapshot; see
    `DecentralizedOverlay.run_rounds`).  `run_round` stays unsharded."""

    def __init__(self, schedule=None, seed: int = 0, *,
                 n_institutions: int = 5, local_steps: int = 2,
                 batch: int = 8, image_size: int = 16,
                 width_scale: float = 0.25, lr: float = 0.05,
                 mesh=None, dirichlet_alpha: Optional[float] = None,
                 consensus_params=None, merge: str = "secure_mean",
                 dp=None, attack_schedule=None,
                 trim_fraction: float = 0.25,
                 norm_gate_factor: Optional[float] = 3.0,
                 block_spec=None, merge_blocks=None, block_schedule=None,
                 inner_merge: str = "mean",
                 secure_domain: str = "float", stacked=None,
                 device=None):
        self.mesh = mesh
        self.device = resolve_device(device)
        P = n_institutions
        self.P, self.local_steps, self.batch = P, local_steps, batch
        self.seed = seed
        self.cfg = dataclasses.replace(STIGMA_CNN, image_size=image_size)
        part = (None if dirichlet_alpha is None else
                DirichletPartitioner(P, alpha=dirichlet_alpha, seed=seed))
        flipped = ()
        if attack_schedule is not None and \
                attack_schedule.kind == "label_flip":
            # the poisoning is baked into the dataset at construction: a
            # round window cannot be honoured (the ledger's attacker
            # metadata would contradict the actual poisoning)
            if attack_schedule.start != 0 or attack_schedule.stop is not None:
                raise ValueError(
                    "label_flip poisons the dataset statically; "
                    "start/stop round windows are not supported")
            flipped = attack_schedule.attacker_set(P)
        self.ds = SyntheticGlendaDataset(image_size=image_size,
                                         n_samples=40 * P,
                                         n_institutions=P, seed=seed,
                                         partitioner=part,
                                         label_flip_institutions=flipped)
        cfg, self.lr = self.cfg, lr

        def local_step(params, batch_):
            imgs, labels = batch_
            with cnn.full_fp32():
                g, (loss, acc) = torch.func.grad_and_value(
                    lambda p: cnn.loss_fn(cfg, p, imgs, labels),
                    has_aux=True)(params)
            return tree_map(lambda a, b: a - lr * b, params, g), {
                "loss": loss, "acc": acc}

        self.local_step = local_step
        if stacked is None:
            params = cnn.init_params(cfg, torch.Generator().manual_seed(seed),
                                     width_scale=width_scale)
            stacked = replicate_params(
                params, P, generator=torch.Generator().manual_seed(seed + 1),
                jitter=0.01)
        self.stacked = tree_map(lambda x: x.to(self.device), stacked)
        self.overlay = DecentralizedOverlay(OverlayConfig(
            n_institutions=P, local_steps=local_steps, merge=merge,
            alpha=1.0, consensus_seed=seed, fault_schedule=schedule,
            consensus_params=consensus_params, dp=dp,
            attack_schedule=attack_schedule, trim_fraction=trim_fraction,
            norm_gate_factor=norm_gate_factor, secure_domain=secure_domain,
            block_spec=block_spec, merge_blocks=merge_blocks,
            block_schedule=block_schedule, inner_merge=inner_merge,
            merge_subtree=None, arch_family="cnn"),
            registry=ModelRegistry(logical_clock=True))

    def _round_batches(self, rnd: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """(local_steps, P, B, ...) image/label stacks on the device, one
        `ds.batch` call per (step, institution)."""
        per_step = [[self.ds.batch(rnd * self.local_steps + s, self.batch, i)
                     for i in range(self.P)] for s in range(self.local_steps)]
        imgs = np.stack([np.stack([b[0] for b in row]) for row in per_step])
        labels = np.stack([np.stack([b[1] for b in row]) for row in per_step])
        return (torch.from_numpy(imgs).to(self.device),
                torch.from_numpy(labels).to(self.device))

    def round_key(self, rnd: int) -> np.ndarray:
        return prng.PRNGKey(self.seed * 1000 + rnd)

    def run_round(self, rnd: int) -> Tuple[Dict, object]:
        self.stacked, metrics, tr = self.overlay.round(
            self.stacked, self._round_batches(rnd), self.local_step,
            self.round_key(rnd))
        return metrics, tr

    def run_rounds(self, n_rounds: int, *,
                   snapshot_every: Optional[int] = None,
                   snapshot_dir: Optional[str] = None) -> Tuple[Dict, list]:
        """The next n rounds through the batched engine, starting at the
        overlay's current round index (the data and key schedules follow
        the consensus schedule), so repeated calls chunk training exactly
        like repeated `run_round` calls.  `snapshot_every` /
        `snapshot_dir`: a verified snapshot every K rounds (see
        `DecentralizedOverlay.run_rounds`), which changes no bit."""
        start = self.overlay.round_index
        per_round = [self._round_batches(start + r) for r in range(n_rounds)]
        imgs = torch.stack([b[0] for b in per_round])
        labels = torch.stack([b[1] for b in per_round])
        keys = np.stack([self.round_key(start + r) for r in range(n_rounds)])
        self.stacked, metrics, trs = self.overlay.run_rounds(
            self.stacked, (imgs, labels), self.local_step, keys, n_rounds,
            mesh=self.mesh, snapshot_every=snapshot_every,
            snapshot_dir=snapshot_dir)
        return metrics, trs

    # -- crash recovery -------------------------------------------------
    def snapshot(self, snapshot_dir: str) -> str:
        """Persist a verified snapshot at the current round (what the
        eager `run_round` loop calls between rounds); returns its path.
        Under a mesh, rank 0 writes it and every rank waits for it."""
        return self.overlay.snapshot(snapshot_dir, self.stacked,
                                     mesh=self.mesh)

    def resume_from(self, snapshot_dir: str, on_skip=None
                    ) -> Tuple[int, list]:
        """Fail over from the newest verified snapshot under
        `snapshot_dir`: corrupt or torn snapshots are skipped (each
        reported through `on_skip(path, reason)`), the overlay adopts the
        ledger, stats and accountant and fast-forwards its consensus gate,
        and `self.stacked` becomes the verified carry, on `self.device`.
        Call it on a fresh federation built with the crashed run's seed
        and config: the data and key schedules are pure functions of the
        round index, so the resumed run is bit-identical to an
        uninterrupted one.  Returns ``(restored_round, skipped)``."""
        stacked, state, _, skipped = latest_verified_snapshot(
            snapshot_dir, self.stacked, cfg=self.overlay.cfg,
            on_skip=on_skip)
        self.overlay.restore(state)
        self.stacked = stacked
        return state.round_index, skipped

    def per_institution_eval(self, batch: int = 64, seed: int = 0) -> Dict:
        """Each institution's own replica on its own held-aside batch: row
        i of the stacked params on institution i's `eval_batch` draw, the
        quantity a personal head should improve.  ``{"loss": (P,), "acc":
        (P,)}`` numpy arrays."""
        imgs, labels = self.ds.eval_batches(batch, seed=seed)
        cfg = self.cfg
        with torch.no_grad(), cnn.full_fp32():
            loss, acc = torch.func.vmap(
                lambda p, x, y: cnn.loss_fn(cfg, p, x, y))(
                self.stacked, torch.from_numpy(imgs).to(self.device),
                torch.from_numpy(labels).to(self.device))
        return {"loss": loss.cpu().numpy(), "acc": acc.cpu().numpy()}

    def chain_digest(self) -> str:
        """Digest of the ledger head."""
        return self.overlay.registry.chain[-1].hash()

    def params_fingerprint(self) -> str:
        return fingerprint_pytree(self.stacked)

    def divergence(self) -> float:
        return self.overlay.divergence(self.stacked)
