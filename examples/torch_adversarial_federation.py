"""Adversarial federation on the PyTorch port: DP-noised updates,
poisoned hospitals and Byzantine-robust merges, as
`examples/adversarial_federation.py` does on JAX.

    PYTHONPATH=src python examples/torch_adversarial_federation.py     # all
    PYTHONPATH=src python examples/torch_adversarial_federation.py \
        --attack sign_flip_30
    PYTHONPATH=src python examples/torch_adversarial_federation.py --list

Part 1 trains the paper's CNN across 5 institutions while a
`ByzantineSchedule` makes compromised hospitals publish poisoned updates,
once under the plain mean and once under the trimmed mean.  Part 2 runs
the federation with `DPConfig`-noised updates (the hand-written clip and
noise kernel on the card) and prints the RDP accountant's eps trace as
the ledger records it.  Runs on ``cuda`` unless ``--device cpu`` is given.
"""
import argparse
import json

from repro_torch import resolve_device
from repro_torch.chaos import attack_scenarios
from repro_torch.chaos.harness import CNNFederation
from repro_torch.privacy.accountant import DPConfig


def run_attack(say, name, schedule, *, seed=0, rounds=4, device=None):
    say(f"\n=== attack: {name} ===")
    if schedule is not None:
        say(f"    compromised hospitals: "
            f"{list(schedule.attacker_set(5))} (kind={schedule.kind})")
    for merge in ("mean", "trimmed_mean"):
        fed = CNNFederation(None, seed, merge=merge,
                            attack_schedule=schedule, trim_fraction=0.34,
                            device=device)
        metrics, _ = fed.run_rounds(rounds)
        loss = float(metrics["loss"][-1].mean())
        say(f"  merge={merge:<13} final loss={loss:10.3f} "
            f"div={fed.divergence():.2e} "
            f"digest={fed.overlay.registry.chain[-1].hash()[:16]}…")


def run_dp(say, *, seed=0, rounds=4, device=None):
    say("\n=== differential privacy: eps(delta) vs utility ===")
    for sigma in (None, 0.5, 1.0):
        dp = (None if sigma is None else
              DPConfig(clip_norm=0.5, noise_multiplier=sigma, delta=1e-5))
        fed = CNNFederation(None, seed, merge="mean", dp=dp, device=device)
        metrics, _ = fed.run_rounds(rounds)
        loss = float(metrics["loss"][-1].mean())
        if dp is None:
            say(f"  sigma=off  loss={loss:8.3f}  eps=0 (no DP)")
            continue
        eps_trace = [json.loads(t.metadata)["dp"]["eps"]
                     for t in fed.overlay.registry.chain
                     if t.kind == "rolling_update"]
        say(f"  sigma={sigma:<4} loss={loss:8.3f}  "
            f"eps trace (per publishing round): {eps_trace}")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--attack", default=None,
                    help="one attack scenario (default: run all)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--list", action="store_true")
    ap.add_argument("--device", default=None,
                    help="cuda (the default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    lines = []

    def say(line=""):
        print(line)
        lines.append(line)

    scen = attack_scenarios(args.seed)
    if args.list:
        for k in scen:
            say(k)
        return "\n".join(lines)
    device = resolve_device(args.device)
    names = [args.attack] if args.attack else list(scen)
    for name in names:
        run_attack(say, name, scen[name], seed=args.seed, rounds=args.rounds,
                   device=device)
    run_dp(say, seed=args.seed, rounds=args.rounds, device=device)
    return "\n".join(lines)


if __name__ == "__main__":
    main()
