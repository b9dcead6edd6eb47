"""LM-federation harness for the serve path.

`LMFederation` is the language-model sibling of
`chaos.harness.CNNFederation`: P institutions train a causal LM on
institution-private synthetic token streams through the same
`DecentralizedOverlay` (consensus gate, merge, logical-clock DLT), and
`publish` puts the merged model where a serving replica's verified pull
(`serving.federated`) can fetch it.

`TINY_SERVE` and `TINY_SERVE_SSM` are the reference's two small configs
of the serve-path tests, of two families (dense attention and the rwkv6
recurrence), so that the prefill-vs-token-wise A/B and the hot-swap
battery cover both a cache-shaped and a constant-size decode state.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch import models, resolve_device
from repro_torch import random as prng
from repro_torch.configs.base import ModelConfig
from repro_torch.core.overlay import (
    DecentralizedOverlay, OverlayConfig, replicate_params,
)
from repro_torch.core.registry import ModelRegistry, fingerprint_pytree
from repro_torch.pytree import tree_map
from repro_torch.serving.federated import ModelStore

TINY_SERVE = ModelConfig(
    name="tiny-serve", family="dense", n_layers=2, d_model=64,
    n_heads=2, n_kv_heads=1, d_ff=128, vocab_size=128,
    citation="tier-1 serve-path smoke config")

TINY_SERVE_SSM = ModelConfig(
    name="tiny-serve-ssm", family="ssm", n_layers=2, d_model=64,
    n_heads=0, n_kv_heads=0, d_ff=128, vocab_size=128, wkv_head_dim=32,
    citation="tier-1 serve-path smoke config, rwkv6 family")


class LMFederation:
    """P institutions training a causal LM under the decentralized
    overlay; `run_rounds(n)` executes n rounds through the batched engine
    and `publish(store)` puts the merged model into a weight store.

    The local step is one SGD step on the next-token cross-entropy,
    `torch.func.vmap`-ed over the institution axis, with attention and
    the recurrences on the plain path (``impl="ref"``, as the reference
    trains: no kernel has a backward pass yet).  The DLT runs
    with a logical clock, so two same-seed runs produce byte-identical
    chains.

    `stacked`: the starting (P, ...) params, e.g. the JAX package's
    through `repro_torch.convert.params_from_jax`; None draws them from
    ``torch.Generator`` seeds `seed` (weights) and `seed + 1` (jitter) on
    the device.  `device`: None means ``cuda`` and raises without one."""

    def __init__(self, cfg: ModelConfig = TINY_SERVE, seed: int = 0, *,
                 n_institutions: int = 3, local_steps: int = 2,
                 batch: int = 4, seq_len: int = 16, lr: float = 0.1,
                 merge: str = "mean", stacked=None, device=None):
        self.device = resolve_device(device)
        P = n_institutions
        self.cfg = cfg
        self.P, self.local_steps, self.batch = P, local_steps, batch
        self.seq_len, self.seed = seq_len, seed

        def local_step(params, toks):
            def loss_fn(p):
                logits, _ = models.forward(cfg, p, {"tokens": toks},
                                           impl="ref")
                lg, lab = logits[:, :-1], toks[:, 1:].long()
                lse = torch.logsumexp(lg, dim=-1)
                gold = torch.gather(lg, -1, lab[..., None])[..., 0]
                return (lse - gold).mean()
            g, loss = torch.func.grad_and_value(loss_fn)(params)
            return tree_map(lambda a, b: a - lr * b, params, g), {
                "loss": loss}

        self.local_step = local_step
        if stacked is None:
            gen = torch.Generator(self.device)
            params = models.init_params(cfg, gen.manual_seed(seed))
            stacked = replicate_params(
                params, P, generator=gen.manual_seed(seed + 1), jitter=0.01)
        self.stacked = tree_map(lambda x: x.to(self.device), stacked)
        self.overlay = DecentralizedOverlay(OverlayConfig(
            n_institutions=P, local_steps=local_steps, merge=merge,
            alpha=1.0, consensus_seed=seed, merge_subtree=None,
            arch_family=cfg.name),
            registry=ModelRegistry(logical_clock=True))

    # -- data / key schedules (pure functions of the round index) -------
    def _round_batches(self, rnd: int) -> torch.Tensor:
        """(local_steps, P, B, S) int32 token stacks on the device:
        institution i's stream is a deterministic function of (seed,
        round, step, i), byte-identical to the reference's."""
        toks = np.stack([
            np.stack([
                np.random.default_rng(
                    (self.seed, rnd, s, i)).integers(
                        1, self.cfg.vocab_size, (self.batch, self.seq_len))
                for i in range(self.P)])
            for s in range(self.local_steps)]).astype(np.int32)
        return torch.from_numpy(toks).to(self.device)

    def round_key(self, rnd: int) -> np.ndarray:
        return prng.PRNGKey(self.seed * 1000 + rnd)

    # -- training -------------------------------------------------------
    def run_rounds(self, n_rounds: int, *,
                   snapshot_every: Optional[int] = None,
                   snapshot_dir: Optional[str] = None) -> Tuple[Dict, list]:
        """The next n rounds through the batched engine, one DLT flush;
        repeated calls chunk exactly like the chaos harness, and
        `snapshot_every` / `snapshot_dir` snapshot as its do."""
        start = self.overlay.round_index
        toks = torch.stack([self._round_batches(start + r)
                            for r in range(n_rounds)])
        keys = np.stack([self.round_key(start + r) for r in range(n_rounds)])
        self.stacked, metrics, trs = self.overlay.run_rounds(
            self.stacked, toks, self.local_step, keys, n_rounds,
            snapshot_every=snapshot_every, snapshot_dir=snapshot_dir)
        return metrics, trs

    # -- serve-path handoff ----------------------------------------------
    def merged_params(self):
        """Row 0 of the stacked carry, on the host: after a committed
        alpha=1.0 merge every institution holds the merged model, so row 0
        is the params whose fingerprint the round's rolling_update
        committed."""
        return tree_map(lambda a: a[0].cpu(), self.stacked)

    def publish(self, store: ModelStore) -> str:
        """Put the merged model into a weight store for a serving
        replica's verified pull; returns its fingerprint."""
        return store.put(self.merged_params())

    def snapshot(self, snapshot_dir: str) -> str:
        """Persist a verified snapshot at the current round, which a
        rebooted serving tier pulls from (`federated.pull_from_snapshot`);
        returns its path."""
        return self.overlay.snapshot(snapshot_dir, self.stacked)

    def chain_digest(self) -> str:
        return self.overlay.registry.chain[-1].hash()

    def params_fingerprint(self) -> str:
        return fingerprint_pytree(self.stacked)
