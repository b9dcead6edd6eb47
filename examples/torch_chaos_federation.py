"""Fault-tolerant federation on the PyTorch port: the STIGMA overlay
surviving churn, stragglers, partitions, flapping rejoin and coordinator
crashes, as `examples/chaos_federation.py` does on JAX.

    PYTHONPATH=src python examples/torch_chaos_federation.py          # all
    PYTHONPATH=src python examples/torch_chaos_federation.py --scenario churn
    PYTHONPATH=src python examples/torch_chaos_federation.py --list

Each scenario trains the paper's CNN across 5 institutions (the shared
`chaos.harness.CNNFederation`, secure_mean merges) while a deterministic
`FaultSchedule` injects failures into the Paxos simulation and the merge.
The ledger runs on a logical clock, so a same-seed run prints the same
chain digest.  Runs on ``cuda`` unless ``--device cpu`` is given.
"""
import argparse

from repro_torch import resolve_device
from repro_torch.chaos import standard_scenarios
from repro_torch.chaos.harness import CNNFederation


def run_scenario(say, name, schedule, *, seed=0, rounds=6, device=None):
    fed = CNNFederation(schedule, seed, device=device)
    ov, P = fed.overlay, fed.P

    say(f"\n=== scenario: {name} ===")
    for rnd in range(rounds):
        metrics, tr = fed.run_round(rnd)
        down = sorted(set(range(P)) - set(tr.survivors))
        status = "committed" if tr.committed else (
            "ABORTED (no quorum)" if tr.aborted_no_quorum else "ABORTED")
        notes = []
        if down:
            notes.append(f"down={down}")
        if tr.leader_elections:
            notes.append(f"re-elected leader -> hospital-{tr.leader}")
        if tr.straggler_wait_s > 0:
            notes.append(f"waited {tr.straggler_wait_s:.1f}s on stragglers")
        say(f"round {rnd}: {status:<19} consensus={tr.elapsed_s:6.2f}s "
            f"loss={float(metrics['loss'].mean()):.3f} "
            f"div={fed.divergence():.2e}"
            + ("  [" + ", ".join(notes) + "]" if notes else ""))
    commits = sum(s["committed"] for s in ov.stats)
    say(f"-> {commits}/{rounds} rounds committed, "
        f"{ov.gate.total_leader_elections} leader re-elections, "
        f"DLT verified={ov.registry.verify_chain()} "
        f"({len(ov.registry.chain)} txs, survivor sets recorded)")
    say(f"   chain digest: {ov.registry.chain[-1].hash()[:16]}…")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--scenario", default=None,
                    help="one scenario name (default: run all)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--rounds", type=int, default=6)
    ap.add_argument("--list", action="store_true")
    ap.add_argument("--device", default=None,
                    help="cuda (the default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    lines = []

    def say(line=""):
        print(line)
        lines.append(line)

    scen = standard_scenarios(args.seed)
    if args.list:
        for k in scen:
            say(k)
        return "\n".join(lines)
    device = resolve_device(args.device)
    names = [args.scenario] if args.scenario else list(scen)
    for name in names:
        run_scenario(say, name, scen[name], seed=args.seed,
                     rounds=args.rounds, device=device)
    return "\n".join(lines)


if __name__ == "__main__":
    main()
