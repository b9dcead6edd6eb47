"""The federation harness: P hospitals training the (width-scaled) paper CNN
through the overlay, the slice of the system ``chip_smoke.py`` drives.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch import random as prng
from repro_torch import resolve_device
from repro_torch.configs.stigma_cnn import STIGMA_CNN
from repro_torch.core.overlay import (
    DecentralizedOverlay, OverlayConfig, replicate_params,
)
from repro_torch.core.registry import ModelRegistry, fingerprint_pytree
from repro_torch.pytree import tree_map
from repro_torch.data.pipeline import DirichletPartitioner, SyntheticGlendaDataset
from repro_torch.models import stigma_cnn as cnn


class CNNFederation:
    """P institutions training the paper CNN.  `run_round(rnd)` executes
    one overlay round (local SGD on institution-private synthetic GLENDA
    frames, then the consensus-gated secure merge) and returns (metrics,
    transcript); `run_rounds(n)` executes n rounds through the batched
    engine, bit-identical to n `run_round` calls.

    The local SGD step is vmapped over the institution axis
    (`torch.func.vmap` of `torch.func.grad_and_value`), in IEEE float32
    whatever the process's TF32 settings (`cnn.full_fp32`).  The DLT runs with
    a logical clock, so two same-seed runs produce byte-identical chains.

    `stacked`: the starting (P, ...) params, e.g. the JAX package's through
    `repro_torch.convert.params_from_jax`; None draws them from
    ``torch.Generator`` seeds `seed` (weights) and `seed + 1` (jitter).
    `device`: None means ``cuda`` and raises without a CUDA device.
    `secure_domain`: "float" or "int" secure_mean arithmetic.
    `schedule` (faults) and `mesh` are not ported yet and must be None."""

    def __init__(self, schedule=None, seed: int = 0, *,
                 n_institutions: int = 5, local_steps: int = 2,
                 batch: int = 8, image_size: int = 16,
                 width_scale: float = 0.25, lr: float = 0.05,
                 mesh=None, dirichlet_alpha: Optional[float] = None,
                 merge: str = "secure_mean",
                 dp=None, secure_domain: str = "float", stacked=None,
                 device=None):
        if schedule is not None or mesh is not None:
            raise NotImplementedError("fault schedules and meshes are not "
                                      "ported to the PyTorch overlay yet")
        self.device = resolve_device(device)
        P = n_institutions
        self.P, self.local_steps, self.batch = P, local_steps, batch
        self.seed = seed
        self.cfg = dataclasses.replace(STIGMA_CNN, image_size=image_size)
        part = (None if dirichlet_alpha is None else
                DirichletPartitioner(P, alpha=dirichlet_alpha, seed=seed))
        self.ds = SyntheticGlendaDataset(image_size=image_size,
                                         n_samples=40 * P,
                                         n_institutions=P, seed=seed,
                                         partitioner=part)
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
            alpha=1.0, consensus_seed=seed, dp=dp,
            secure_domain=secure_domain, arch_family="cnn"),
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

    def run_rounds(self, n_rounds: int) -> Tuple[Dict, list]:
        """The next n rounds through the batched engine, starting at the
        overlay's current round index (the data and key schedules follow
        the consensus schedule), so repeated calls chunk training exactly
        like repeated `run_round` calls."""
        start = self.overlay.round_index
        per_round = [self._round_batches(start + r) for r in range(n_rounds)]
        imgs = torch.stack([b[0] for b in per_round])
        labels = torch.stack([b[1] for b in per_round])
        keys = np.stack([self.round_key(start + r) for r in range(n_rounds)])
        self.stacked, metrics, trs = self.overlay.run_rounds(
            self.stacked, (imgs, labels), self.local_step, keys, n_rounds)
        return metrics, trs

    def chain_digest(self) -> str:
        """Digest of the ledger head."""
        return self.overlay.registry.chain[-1].hash()

    def params_fingerprint(self) -> str:
        return fingerprint_pytree(self.stacked)

    def divergence(self) -> float:
        return self.overlay.divergence(self.stacked)
