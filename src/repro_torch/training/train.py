"""Training step factory: loss, grads, microbatching, remat, optimizer.

`make_train_step` builds the update used by both the centralized baseline
and the decentralized overlay, where `make_local_step` makes it the
institution-local step that the overlay `torch.func.vmap`s over the
stacked institution axis.

Kernels: ``TrainConfig.impl = "auto"`` resolves to ``"plain"`` on every
device, the plain paths the reference's ``"auto"`` picks off the TPU
(attention ``"chunked"`` above S = 1,024, else ``"ref"``; WKV6 ``"ref"``;
the selective scan ``"chunked"``).  None of the hand-written kernels has
a backward pass, and every trainer of the reference trains on these
paths; an explicit ``"pallas"`` or ``"fused"`` reaches a kernel, which
raises on a CUDA tensor that a gradient would flow through.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Tuple

import torch

from repro_torch import models
from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.optim import (
    AdamWConfig, adamw_init, adamw_update, linear_warmup_cosine,
)
from repro_torch.pytree import tree_map

Pytree = Any


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    optimizer: AdamWConfig = AdamWConfig()
    total_steps: int = 1000
    warmup_steps: int = 100
    microbatches: int = 1         # gradient accumulation splits
    remat: bool = True
    impl: str = "auto"            # attention / recurrence implementation
    z_loss_weight: float = 1e-4
    # token-chunked fused cross-entropy: the (B, S, V) logits are never
    # materialized, lse and gold come per token chunk.  0 disables; it
    # applies when vocab_size >= fused_xent_min_vocab.
    fused_xent_chunk: int = 2048
    fused_xent_min_vocab: int = 16_384


@dataclasses.dataclass
class TrainState:
    params: Pytree
    opt_state: Pytree
    step: torch.Tensor

    @classmethod
    def create(cls, cfg: ModelConfig,
               generator: torch.Generator) -> "TrainState":
        params = models.init_params(cfg, generator)
        return cls(params=params, opt_state=adamw_init(params),
                   step=torch.zeros((), dtype=torch.int32,
                                    device=generator.device))


def resolve_impl(impl: str) -> str:
    """The implementation the models train through: ``"auto"`` is
    ``"plain"`` (see the module docstring); anything else passes."""
    return "plain" if impl == "auto" else impl


def _labels_and_logits(cfg: ModelConfig, logits, batch):
    """Align logits with next-token (or frame-label) targets per modality."""
    if cfg.modality == "audio":                     # per-frame classification
        labels = batch["labels"]
        return logits, labels, torch.ones(labels.shape, dtype=torch.bool,
                                          device=labels.device)
    tokens = batch["tokens"]
    if cfg.modality == "vlm":                       # text follows patches
        P = logits.shape[1] - tokens.shape[1]
        logits = logits[:, P:]
    labels = tokens[:, 1:]
    return logits[:, :-1], labels, torch.ones(labels.shape, dtype=torch.bool,
                                               device=labels.device)


def _chunk_nll(x_c, head, lab_c):
    logits = (x_c @ head).float()                         # (B, c, V)
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, lab_c[..., None].long())[..., 0]
    return lse - gold


def _fused_nll(features, head, labels, mask, chunk: int):
    """Sequence-chunked cross-entropy: lse + gold per (B, chunk, V) tile.

    features: (B, S, d); head: (d, V); labels / mask: (B, S).  The logits
    peak at chunk x V a batch row instead of S x V; each chunk is
    recomputed on the backward pass (`layers.recompute`), so its tile
    stays transient under grad."""
    S = features.shape[1]
    c = L._fit_chunk(S, chunk)
    head = head.to(features.dtype)
    nll = torch.cat([L.recompute(_chunk_nll, features[:, i:i + c], head,
                                 labels[:, i:i + c])
                     for i in range(0, S, c)], dim=1)
    return nll * mask


def make_loss_fn(cfg: ModelConfig, tcfg: TrainConfig
                 ) -> Callable[[Pytree, Dict], Tuple[torch.Tensor, Dict]]:
    use_fused = (tcfg.fused_xent_chunk > 0
                 and cfg.vocab_size >= tcfg.fused_xent_min_vocab)
    impl = resolve_impl(tcfg.impl)

    def loss_fn(params, batch):
        if use_fused:
            feats, aux, head = models.forward_features(
                cfg, params, batch, impl=impl, remat=tcfg.remat)
            feats, labels, mask = _labels_and_logits(cfg, feats, batch)
            nll = _fused_nll(feats, head, labels, mask,
                             tcfg.fused_xent_chunk)
        else:
            logits, aux = models.forward(cfg, params, batch, impl=impl,
                                         remat=tcfg.remat)
            logits, labels, mask = _labels_and_logits(cfg, logits, batch)
            logits = logits.float()
            logz = torch.logsumexp(logits, dim=-1)
            gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
            nll = (logz - gold) * mask
        denom = torch.clamp(mask.sum(), min=1)
        loss = nll.sum() / denom
        loss = loss + cfg.router_aux_weight * aux["load_balance"]
        loss = loss + tcfg.z_loss_weight * aux["router_z"]
        metrics = {"loss": loss, "nll": nll.sum() / denom,
                   "load_balance": aux["load_balance"],
                   "dropped_frac": aux["dropped_frac"]}
        return loss, metrics
    return loss_fn


def make_train_step(cfg: ModelConfig, tcfg: TrainConfig):
    """Returns train_step(params, opt_state, step, batch) -> (params,
    opt_state, metrics): pure, over `torch.func.grad_and_value`, so the
    overlay can `vmap` it.  With ``microbatches`` > 1 the batch splits
    along its first axis and the gradients and metrics accumulate in fp32
    in microbatch order, then divide by their count."""
    loss_fn = make_loss_fn(cfg, tcfg)
    grad_fn = torch.func.grad_and_value(loss_fn, has_aux=True)

    def train_step(params, opt_state, step, batch):
        if tcfg.microbatches > 1:
            n = tcfg.microbatches
            split = tree_map(lambda x: x.reshape(n, x.shape[0] // n,
                                                 *x.shape[1:]), batch)
            grads = tree_map(lambda p: torch.zeros(
                p.shape, dtype=torch.float32, device=p.device), params)
            metrics = None
            for i in range(n):
                g, (_, m) = grad_fn(params, tree_map(lambda x: x[i], split))
                grads = tree_map(torch.add, grads, g)
                if metrics is None:
                    metrics = {k: torch.zeros((), dtype=torch.float32,
                                              device=v.device)
                               for k, v in m.items()}
                metrics = {k: metrics[k] + m[k] for k in metrics}
            grads = tree_map(lambda g: g / n, grads)
            metrics = {k: v / n for k, v in metrics.items()}
        else:
            grads, (_, metrics) = grad_fn(params, batch)

        lr_scale = linear_warmup_cosine(step, tcfg.warmup_steps,
                                        tcfg.total_steps)
        params, opt_state, opt_metrics = adamw_update(
            tcfg.optimizer, params, grads, opt_state, lr_scale)
        metrics = dict(metrics)
        metrics.update(opt_metrics)
        return params, opt_state, metrics

    return train_step


def make_local_step(cfg: ModelConfig, tcfg: TrainConfig):
    """The overlay's local step: (state, batch) -> (state, metrics), with
    state = {"params", "opt", "step"}, one institution's whole training
    state; the overlay vmaps it over the stacked institution axis and
    federates the "params" subtree alone (``merge_subtree``)."""
    step_fn = make_train_step(cfg, tcfg)

    def local_step(state, batch):
        params, opt, metrics = step_fn(state["params"], state["opt"],
                                       state["step"], batch)
        return {"params": params, "opt": opt,
                "step": state["step"] + 1}, metrics

    return local_step
