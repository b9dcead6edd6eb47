"""Scaling the institution axis on the PyTorch port: a P = 16 federation,
mesh-parallel over ranks, with label-skewed hospital data and
cost-model-driven placement, as `examples/scale_institutions.py` does on
JAX.

    PYTHONPATH=src python examples/torch_scale_institutions.py
    PYTHONPATH=src python examples/torch_scale_institutions.py \
        --world-size 4 --backend gloo --device cpu

Walks the whole loop:
  1. `DirichletPartitioner(alpha=0.2)` deals each pathology class to a few
     hospitals only (non-IID data);
  2. `continuum.assign_institutions` places the 16 hospitals on the cloud,
     fog and edge tiers by the paper's cost model, and `PlacementSchedule`
     feeds the modelled straggler delays into every consensus round;
  3. `run_rounds(mesh=...)` spreads the institution axis over W ranks
     (`sharding.make_institution_mesh`): each rank trains its block of
     hospitals and every rank merges the gathered rows, with the same
     numerics as one process (fp32 tolerance; bit-identical at W = 1).

W = 1 runs in this process; W > 1 spawns W ranks (`torch.multiprocessing`,
start method spawn, a `FileStore` in a temporary directory), and rank 0
prints.  The backend is the caller's: NCCL needs a card for each rank,
gloo runs on the CPU and for several ranks on one card.  Runs on
``cuda`` unless ``--device cpu`` is given.
"""
import argparse
import os
import sys
import tempfile

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.chaos.harness import CNNFederation
from repro_torch.configs.stigma_cnn import STIGMA_CNN
from repro_torch.continuum import (
    FederationWorkload, PlacementSchedule, assign_institutions,
    straggler_weights,
)
from repro_torch.core.consensus import ProtocolParams
from repro_torch.launch.mesh import process_group, spawn_ranks
from repro_torch.models import stigma_cnn as cnn
from repro_torch.sharding import make_institution_mesh, rank_device


def run(say, args, rank, world_size):
    """The federation on this rank; `say` prints on rank 0 only."""
    P = args.institutions
    device = rank_device(args.device)
    mesh = make_institution_mesh(device=device)
    say(f"ranks: {world_size} ({args.backend}, {device.type}); "
        f"{P} institutions, {P // world_size if P % world_size == 0 else P}"
        f" trained a rank")

    # cost-model placement: the full-width CNN on a 500-frame local epoch,
    # heavy enough that the placement spreads past the fastest edge box
    wl = FederationWorkload(
        flops_per_sample=cnn.flops_per_image(STIGMA_CNN, 1.0),
        samples_per_round=500, model_size_mb=5.0)
    placements = assign_institutions(P, wl)
    tiers = {}
    for p in placements:
        key = f"{p.resource} ({p.tier})"
        tiers[key] = tiers.get(key, 0) + 1
    say("placement: " + ", ".join(f"{k} x{v}" for k, v in tiers.items()))
    w = straggler_weights(placements)
    say(f"straggler weights: min={w.min():.3f} max={w.max():.3f}")

    fed = CNNFederation(PlacementSchedule(placements), seed=0,
                        n_institutions=P, image_size=args.image_size,
                        local_steps=args.local_steps, batch=args.batch,
                        mesh=mesh,
                        dirichlet_alpha=0.2,
                        consensus_params=ProtocolParams.for_fleet(P),
                        device=device)
    sizes = np.bincount(fed.ds.institution, minlength=P)
    say(f"hospital sample counts (alpha=0.2): min={sizes.min()} "
        f"max={sizes.max()} (round-robin would be {sizes.sum() // P})")

    metrics, transcripts = fed.run_rounds(args.rounds)
    for r, tr in enumerate(transcripts):
        say(f"round {r}: loss={float(metrics['loss'][r].mean()):.3f} "
            f"committed={tr.committed} "
            f"straggler_wait={tr.straggler_wait_s:.2f}s")
    reg = fed.overlay.registry
    if rank == 0:       # rank 0 keeps the ledger
        say(f"divergence={fed.divergence():.2e}  "
            f"chain verified={reg.verify_chain()} "
            f"({len(reg.chain)} transactions)")


def _rank_main(rank, world_size, args, out_path):
    torch.set_num_threads(max(1, torch.get_num_threads() // world_size))
    lines = []

    def say(line=""):
        if rank == 0:
            print(line, flush=True)
            lines.append(line)
    run(say, args, rank, world_size)
    if rank == 0:
        with open(out_path, "w") as f:
            f.write("\n".join(lines))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--world-size", type=int, default=1,
                    help="ranks the institution axis spans (default 1)")
    ap.add_argument("--backend", choices=("nccl", "gloo"), default=None,
                    help="nccl (the default on the card: one card a rank) "
                    "or gloo (the default with --device cpu)")
    ap.add_argument("--institutions", type=int, default=16)
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--image-size", type=int, default=16)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--local-steps", type=int, default=2)
    ap.add_argument("--device", default=None,
                    help="cuda (the default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    args.device = device.type
    if args.backend is None:
        args.backend = "gloo" if device.type == "cpu" else "nccl"
    W = args.world_size
    if args.backend == "nccl" and (device.type != "cuda"
                                   or W > torch.cuda.device_count()):
        raise ValueError(f"nccl needs a card for each of the {W} ranks; "
                         f"pass --backend gloo")
    if W == 1:
        lines = []

        def say(line=""):
            print(line)
            lines.append(line)
        with process_group(args.backend):
            run(say, args, 0, 1)
        return "\n".join(lines)
    if device.type == "cuda":
        from repro_torch.kernels import _cuda
        _cuda.build("secure_agg")         # the ranks only load it
    # the spawned ranks import this file by its name
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    try:
        with tempfile.TemporaryDirectory() as tmp:
            out_path = os.path.join(tmp, "rank0.txt")
            spawn_ranks(_rank_main, W, backend=args.backend,
                        args=(args, out_path))
            with open(out_path) as f:
                return f.read()
    finally:
        sys.path.remove(here)


if __name__ == "__main__":
    main()
