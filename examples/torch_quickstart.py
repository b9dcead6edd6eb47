"""Quickstart on the PyTorch port: the STIGMA overlay federating three
hospitals, as `examples/quickstart.py` does on JAX.

    PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]

Runs on ``cuda`` unless ``--device cpu`` is given, and raises without a
card.  The secure merge goes through the hand-written masked rolling
update kernel on the card.
"""
import argparse
import dataclasses

import numpy as np
import torch

from repro_torch import random as prng
from repro_torch import resolve_device
from repro_torch.configs.stigma_cnn import STIGMA_CNN
from repro_torch.core import (
    DecentralizedOverlay, OverlayConfig, replicate_params,
)
from repro_torch.data import SyntheticGlendaDataset
from repro_torch.models import stigma_cnn as cnn
from repro_torch.pytree import tree_map

P, ROUNDS, STEPS = 3, 5, 6            # three institutions, 5 rounds of 6 steps
CFG = dataclasses.replace(STIGMA_CNN, image_size=32)


def round_batches(ds):
    """(R, S, P, 16, ...) images and labels, the reference's stacking."""
    def stack(k):
        return np.stack([np.stack([np.stack(
            [ds.batch(r * STEPS + s, 16, i)[k] for i in range(P)])
            for s in range(STEPS)]) for r in range(ROUNDS)])
    return stack(0), stack(1)


def run(device, stacked=None):
    """(overlay, stacked, metrics, transcripts) of the ROUNDS rounds.
    `stacked`: the starting (P, ...) params; None draws them from
    ``torch.Generator`` seeds 0 (weights) and 1 (jitter)."""
    ds = SyntheticGlendaDataset(image_size=32, n_samples=240,
                                n_institutions=P, seed=0)

    def local_step(params, batch):              # institution-local SGD
        imgs, labels = batch
        with cnn.full_fp32():
            g, (loss, acc) = torch.func.grad_and_value(
                lambda p: cnn.loss_fn(CFG, p, imgs, labels),
                has_aux=True)(params)
        return tree_map(lambda a, b: a - 0.05 * b, params, g), {
            "loss": loss, "acc": acc}

    if stacked is None:
        params = cnn.init_params(CFG, torch.Generator().manual_seed(0))
        stacked = replicate_params(params, P,
                                   generator=torch.Generator().manual_seed(1),
                                   jitter=0.01)
    stacked = tree_map(lambda x: x.to(device), stacked)
    overlay = DecentralizedOverlay(OverlayConfig(
        n_institutions=P, local_steps=STEPS, merge="secure_mean",
        arch_family="cnn"))
    # all rounds in one call: consensus on the host first, then training
    # and the consensus-gated MPC merges on the device, one DLT flush
    imgs, labels = round_batches(ds)
    keys = np.stack([prng.PRNGKey(r) for r in range(ROUNDS)])
    stacked, metrics, transcripts = overlay.run_rounds(
        stacked, (torch.from_numpy(imgs).to(device),
                  torch.from_numpy(labels).to(device)),
        local_step, keys, ROUNDS)
    return overlay, stacked, metrics, transcripts


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="cuda (the default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    overlay, stacked, metrics, transcripts = run(resolve_device(args.device))
    lines = []
    for rnd, tr in enumerate(transcripts):
        lines.append(f"round {rnd}: "
                     f"loss={float(metrics['loss'][rnd].mean()):.3f} "
                     f"acc={float(metrics['acc'][rnd].mean()):.2f} "
                     f"consensus={tr.elapsed_s:.2f}s")
    lines.append(f"final divergence={overlay.divergence(stacked):.2e}")
    lines.append(f"\nDLT: {len(overlay.registry.chain)} transactions, "
                 f"chain verified={overlay.registry.verify_chain()}")
    lines.append("No raw data ever left an institution; merges used MPC "
                 "masked shares gated by Paxos consensus.")
    text = "\n".join(lines)
    print(text)
    return text


if __name__ == "__main__":
    main()
