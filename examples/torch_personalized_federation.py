"""Personalized partial merges on the PyTorch port: a federated backbone
with hospital-personal heads under Dirichlet-0.1 label skew, as
`examples/personalized_federation.py` does on JAX.

    PYTHONPATH=src python examples/torch_personalized_federation.py
    PYTHONPATH=src python examples/torch_personalized_federation.py --bcd

A `BlockSpec` names the param blocks; ``merge="partial"`` runs the inner
merge over the selected blocks only, and every other leaf (each
hospital's head) passes through untouched.  ``--bcd`` rotates the three
conv layers one a round (`BlockSchedule.round_robin`).  Runs on ``cuda``
unless ``--device cpu`` is given.
"""
import argparse
import json

from repro_torch import resolve_device
from repro_torch.chaos.harness import CNNFederation
from repro_torch.core import BlockSchedule, BlockSpec


def build(variant: str, seed: int, device=None) -> CNNFederation:
    common = dict(seed=seed, dirichlet_alpha=0.1, device=device)
    if variant == "full":
        return CNNFederation(None, merge="mean", **common)
    if variant == "backbone":
        return CNNFederation(
            None, merge="partial",
            block_spec=BlockSpec.by_prefix(backbone="conv", head="head"),
            merge_blocks=("backbone",), inner_merge="mean", **common)
    blocks = ("conv0", "conv1", "conv2")      # BCD: one conv layer a round
    return CNNFederation(
        None, merge="partial",
        block_spec=BlockSpec.by_prefix(conv0="conv/0", conv1="conv/1",
                                       conv2="conv/2", head="head"),
        merge_blocks=blocks, inner_merge="mean",
        block_schedule=BlockSchedule.round_robin(blocks), **common)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=6)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--bcd", action="store_true",
                    help="rotate conv blocks round-robin instead of "
                         "merging the whole backbone every round")
    ap.add_argument("--device", default=None,
                    help="cuda (the default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    personalized = "bcd" if args.bcd else "backbone"
    lines = []

    def say(line=""):
        print(line)
        lines.append(line)

    results = {}
    for variant in ("full", personalized):
        fed = build(variant, args.seed, device)
        fed.run_rounds(args.rounds)
        ev = fed.per_institution_eval(batch=64, seed=args.seed)
        results[variant] = ev
        say(f"\n=== {variant} merge, {args.rounds} rounds, "
            f"Dirichlet(0.1) hospitals ===")
        for i, (l, a) in enumerate(zip(ev["loss"], ev["acc"])):
            say(f"  hospital-{i}: own-data loss={float(l):.4f} "
                f"acc={float(a):.3f}")
        say(f"  mean loss={float(ev['loss'].mean()):.4f} "
            f"acc={float(ev['acc'].mean()):.3f}")
        last = fed.overlay.registry.chain[-1]
        blocks = json.loads(last.metadata).get("blocks")
        say(f"  DLT digest {last.hash()[:16]}… "
            + (f"attests blocks {blocks}" if blocks
               else "attests the full tree (no personal blocks)"))

    gain = (float(results["full"]["loss"].mean())
            - float(results[personalized]["loss"].mean()))
    say(f"\n-> personalization gain (mean per-hospital loss, "
        f"full - {personalized}): {gain:+.4f} "
        f"({'personalized wins' if gain > 0 else 'full merge wins'})")
    return "\n".join(lines)


if __name__ == "__main__":
    main()
