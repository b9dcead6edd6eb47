"""Training launcher: centralized baseline or STIGMA decentralized overlay.

  python -m repro_torch.launch.train --arch smollm-360m \
      --steps 50 --seq-len 128 --batch 8 --reduced
  python -m repro_torch.launch.train --arch qwen3-0.6b --reduced \
      --overlay --institutions 4 --local-steps 5 --rounds 6 --merge secure_mean

Runs on ``cuda`` unless ``--device cpu`` is given; without a CUDA device
the default raises.  The overlay's state is ``{"params", "opt", "step"}``
per institution, and only "params" federates (``merge_subtree``): the
AdamW moments stay with their institution.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch import models, resolve_device
from repro_torch import random as prng
from repro_torch.configs import ARCHS, get_config, reduced as make_reduced
from repro_torch.core import (
    DecentralizedOverlay, OverlayConfig, replicate_params,
)
from repro_torch.data import (
    DataConfig, SyntheticTokenDataset, institution_batches,
)
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.training import (
    TrainConfig, make_local_step, make_train_step,
)

MERGES = ["mean", "ring", "hierarchical", "quantized", "secure_mean"]


def initial_params(cfg, device):
    """The launchers' starting weights: drawn from seed 0 on `device`."""
    return models.init_params(cfg, torch.Generator(device).manual_seed(0))


def run_centralized(cfg, tcfg, data_cfg, steps, log_every=10, *,
                    device=None):
    """`steps` steps of one model on the whole corpus; returns (params,
    the loss of each step)."""
    dev = resolve_device(device)
    ds = SyntheticTokenDataset(cfg, data_cfg)
    params = initial_params(cfg, dev)
    opt = adamw_init(params)
    step_fn = make_train_step(cfg, tcfg)
    history = []
    for s in range(steps):
        batch = {k: torch.from_numpy(v).to(dev)
                 for k, v in ds.batch(s).items()}
        t0 = time.time()
        params, opt, metrics = step_fn(
            params, opt, torch.tensor(s, dtype=torch.int32, device=dev),
            batch)
        loss = float(metrics["loss"])
        history.append(loss)
        if s % log_every == 0 or s == steps - 1:
            print(f"step {s:5d} loss {loss:.4f} "
                  f"grad_norm {float(metrics['grad_norm']):.3f} "
                  f"({time.time() - t0:.2f}s)")
    return params, history


def make_overlay_state(params, n_inst: int):
    """Every institution starts from the same registered model, with fresh
    AdamW moments and step 0: ``{"params", "opt", "step"}`` stacked."""
    opt = adamw_init(params)
    return {"params": replicate_params(params, n_inst),
            "opt": replicate_params(opt, n_inst),
            "step": torch.zeros((n_inst,), dtype=torch.int32,
                                device=opt["count"].device)}


def setup_overlay(cfg, tcfg, data_cfg, *, n_inst, local_steps, merge,
                  alpha, device=None, params=None, **overlay_kw):
    """The overlay run's parts: (stacked state, local step, overlay,
    dataset).  `params`: the starting weights (by default
    `initial_params` on the device); `overlay_kw` goes to `OverlayConfig`
    (``secure_domain``, ``dp``)."""
    dev = resolve_device(device)
    if params is None:
        params = initial_params(cfg, dev)
    overlay = DecentralizedOverlay(OverlayConfig(
        n_institutions=n_inst, local_steps=local_steps, merge=merge,
        alpha=alpha, arch_family=cfg.family, **overlay_kw))
    return (make_overlay_state(params, n_inst), make_local_step(cfg, tcfg),
            overlay, SyntheticTokenDataset(cfg, data_cfg))


def overlay_round(overlay, ds, state, local_step, r, key_base=100):
    """Round r: each institution's `local_steps` batches of the corpus,
    trained and merged under ``PRNGKey(key_base + r)``; returns (state,
    metrics, transcript)."""
    toks = institution_batches(ds, overlay.cfg.n_institutions,
                               overlay.cfg.local_steps, r)
    dev = state["step"].device
    return overlay.round(state, {"tokens": torch.from_numpy(toks).to(dev)},
                         local_step, prng.PRNGKey(key_base + r))


def run_overlay(cfg, tcfg, data_cfg, *, n_inst, local_steps, rounds, merge,
                alpha, device=None, params=None, key_base=100,
                **overlay_kw):
    """`rounds` overlay rounds of `n_inst` institutions, each training
    `local_steps` steps on its own rows of the corpus between merges;
    returns (stacked state, the mean loss of each round, the overlay).
    `params`, `overlay_kw`: as `setup_overlay` takes them; `key_base`:
    as `overlay_round` takes it."""
    state, local_step, overlay, ds = setup_overlay(
        cfg, tcfg, data_cfg, n_inst=n_inst, local_steps=local_steps,
        merge=merge, alpha=alpha, device=device, params=params,
        **overlay_kw)
    history = []
    for r in range(rounds):
        t0 = time.time()
        state, metrics, tr = overlay_round(overlay, ds, state, local_step, r,
                                           key_base)
        loss = float(metrics["loss"].mean())
        div = overlay.divergence(state["params"])
        history.append(loss)
        print(f"round {r:3d} loss {loss:.4f} divergence {div:.4f} "
              f"consensus {tr.elapsed_s:.2f}s wall {time.time() - t0:.1f}s "
              f"(total DLT time {overlay.gate.total_consensus_time_s:.1f}s, "
              f"chain len {len(overlay.registry.chain)}, "
              f"verified={overlay.registry.verify_chain()})")
    return state, history, overlay


def main(argv=None):
    """Returns the loss history (a step's loss, or a round's mean)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-360m", choices=sorted(ARCHS))
    ap.add_argument("--reduced", action="store_true",
                    help="2-layer CPU-scale variant")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--impl", default="ref")
    # overlay
    ap.add_argument("--overlay", action="store_true")
    ap.add_argument("--institutions", type=int, default=4)
    ap.add_argument("--local-steps", type=int, default=5)
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--merge", default="secure_mean", choices=MERGES)
    ap.add_argument("--alpha", type=float, default=1.0)
    ap.add_argument("--device", default=None,
                    help="cuda (the default; raises without a card) or cpu")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = make_reduced(cfg)
    tcfg = TrainConfig(optimizer=AdamWConfig(learning_rate=args.lr),
                       total_steps=max(args.steps,
                                       args.rounds * args.local_steps),
                       warmup_steps=5, remat=False, impl=args.impl)
    data_cfg = DataConfig(seq_len=args.seq_len, global_batch=args.batch)

    if args.overlay:
        _, history, _ = run_overlay(
            cfg, tcfg, data_cfg, n_inst=args.institutions,
            local_steps=args.local_steps, rounds=args.rounds,
            merge=args.merge, alpha=args.alpha, device=dev)
    else:
        _, history = run_centralized(cfg, tcfg, data_cfg, args.steps,
                                     device=dev)
    return history


if __name__ == "__main__":
    main()
