"""End-to-end EHR training driver: decentralized training of a smollm-
family transformer across hospitals, with consensus-gated secure merges
(``secure_mean``), DLT registration, the continuum scheduler's placement
and a checkpoint of the merged model.

    python -m repro_torch.launch.ehr_train [--rounds 20] \
        [--local-steps 10] [--full-100m] [--ckpt-dir DIR] [--device cpu]

The default trains a reduced model (2 layers); ``--full-100m`` trains the
smollm-360m family at its published width cut to 8 layers (~100M
parameters).  With ``--ckpt-dir`` the merged model (institution 0's row)
is saved there by `checkpoint.save_checkpoint`; its fingerprint equals
the ledger's last merged one.  Runs on ``cuda`` unless ``--device cpu``
is given; without a CUDA device the default raises.
"""
from __future__ import annotations

import argparse
import dataclasses

from repro_torch import models, resolve_device
from repro_torch.checkpoint import save_checkpoint
from repro_torch.configs import ARCHS, reduced
from repro_torch.core.scheduler import ContinuumScheduler
from repro_torch.data import DataConfig
from repro_torch.launch.train import run_overlay
from repro_torch.optim import AdamWConfig
from repro_torch.pytree import tree_map
from repro_torch.training import TrainConfig


def build_cfg(full: bool):
    base = ARCHS["smollm-360m"]
    if not full:
        return reduced(base)
    # ~100M params: 8 layers of the smollm-360m family
    return dataclasses.replace(base, name="smollm-100m", n_layers=8)


def main(argv=None):
    """Returns (the overlay, the stacked state, the checkpoint's
    fingerprint or None)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=20)
    ap.add_argument("--local-steps", type=int, default=10)
    ap.add_argument("--institutions", type=int, default=4)
    ap.add_argument("--full-100m", action="store_true")
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--ckpt-dir", default=None,
                    help="directory for the merged model's checkpoint")
    ap.add_argument("--device", default=None,
                    help="cuda (the default; raises without a card) or cpu")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = build_cfg(args.full_100m)
    P = args.institutions
    n_params = models.param_count(cfg)
    print(f"arch={cfg.name} params={n_params / 1e6:.1f}M institutions={P}")

    tcfg = TrainConfig(
        optimizer=AdamWConfig(learning_rate=3e-4),
        total_steps=args.rounds * args.local_steps,
        warmup_steps=10, remat=False, impl="ref")
    # the continuum scheduler decides where the institutions train
    placement = ContinuumScheduler().place(target_accuracy=0.97)
    print(f"scheduler placed training on '{placement.resource}' "
          f"(modeled {placement.est_time_s:.1f}s/round at full accuracy)")

    state, _, overlay = run_overlay(
        cfg, tcfg, DataConfig(seq_len=args.seq_len, global_batch=args.batch),
        n_inst=P, local_steps=args.local_steps, rounds=args.rounds,
        merge="secure_mean", alpha=1.0, device=dev, key_base=1000)

    fp = None
    if args.ckpt_dir is None:
        print("\nno --ckpt-dir: the merged model is not checkpointed")
    else:
        fp = save_checkpoint(args.ckpt_dir,
                             tree_map(lambda x: x[0], state["params"]),
                             step=args.rounds * args.local_steps,
                             metadata={"arch": cfg.name, "overlay": True})
        print(f"\ncheckpoint fingerprint {fp[:16]}… in {args.ckpt_dir} "
              f"(also registered on the DLT: "
              f"{overlay.registry.chain[-1].model_fingerprint[:16]}…)")
    print(f"DLT transactions: {len(overlay.registry.chain)}, "
          f"verified={overlay.registry.verify_chain()}, "
          f"total consensus time {overlay.gate.total_consensus_time_s:.1f}s")
    return overlay, state, fp


if __name__ == "__main__":
    main()
