"""Serve a federated model across the continuum on the PyTorch port, end
to end, as `examples/continuum_serve.py` does on JAX: train a federation
for three rounds, pull the newest committed model through the verified
provenance gate, place serving replicas with the cost model, serve a
batched request queue, then commit a fourth round mid-traffic and watch
the engine hot-swap to it at a tick boundary with no request dropped.

    PYTHONPATH=src python examples/torch_continuum_serve.py [--requests 12]

Runs on ``cuda`` unless ``--device cpu`` is given; on the card the
prompts' prefill goes through the hand-written flash attention kernel.
"""
import argparse
import time

from repro_torch import resolve_device
from repro_torch.continuum.placement import tier_latency_summary
from repro_torch.serving import (
    FederatedServer, ModelStore, Request, ServeConfig, plan_serving,
    serving_workload,
)
from repro_torch.serving.harness import LMFederation, TINY_SERVE


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cuda (the default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    lines = []

    def say(line=""):
        print(line)
        lines.append(line)

    # 1. train: P hospitals, 3 overlay rounds, every commit on the DLT
    fed = LMFederation(TINY_SERVE, seed=args.seed, device=device)
    fed.run_rounds(3)
    store = ModelStore()
    fed.publish(store)
    say(f"trained 3 rounds: chain length "
        f"{len(fed.overlay.registry.chain)}, "
        f"head {fed.chain_digest()[:16]}…")

    # 2. verified pull + engine: any tamper raises, never serves
    scfg = ServeConfig(max_seq_len=64, batch_size=4)
    srv = FederatedServer(TINY_SERVE, fed.overlay.registry, store, scfg,
                          device=device)
    m = srv.model
    say(f"verified pull: round tx #{m.version}, "
        f"fingerprint {m.fingerprint[:16]}…, "
        f"{m.parents_verified} parent registrations proven against the "
        f"committed ledger_root")

    # 3. continuum placement: where would N replicas of this model serve?
    placements = plan_serving(6, TINY_SERVE, scfg)
    tiers = tier_latency_summary(placements,
                                 serving_workload(TINY_SERVE, scfg))
    for tier, s in tiers.items():
        say(f"  tier {tier}: {s['replicas']} replicas, modeled tick "
            f"{s['compute_s'] * 1e6:.1f}us, "
            f"{s['samples_per_s']:.0f} tok/s")

    # 4. serve half the traffic
    half = args.requests // 2
    for i in range(half):
        prompt = [3 + (i % 7), 11, 5 + (i % 5)]
        srv.engine.submit(Request(uid=i, prompt=prompt,
                                  max_new_tokens=args.max_new))
    t0 = time.time()
    while srv.engine.tick < 3:          # keep requests in flight
        srv.engine.step()

    # 5. the federation moves on: commit round 4, hot-swap mid-traffic
    fed.run_rounds(1)
    fed.publish(store)
    new = srv.refresh()                 # verified pull + staged swap
    say(f"round 4 committed; hot-swap staged to tx #{new.version} "
        f"(in-flight requests drain on tx #{m.version})")
    for i in range(half, args.requests):
        prompt = [3 + (i % 7), 11, 5 + (i % 5)]
        srv.engine.submit(Request(uid=i, prompt=prompt,
                                  max_new_tokens=args.max_new))
    done = srv.engine.run()
    dt = time.time() - t0
    toks = sum(len(r.generated) for r in done)
    entry = srv.engine.swap_log[-1]
    say(f"served {len(done)}/{srv.engine.submitted} requests / {toks} "
        f"tokens in {dt:.1f}s ({toks / dt:.1f} tok/s on {device.type}); "
        f"swap paused admission {entry['pause_ticks']} ticks, 0 dropped")
    by_version = {}
    for r in done:
        by_version.setdefault(r.params_version, []).append(r.uid)
    for v, uids in sorted(by_version.items()):
        say(f"  tx #{v} served uids {sorted(uids)}")

    # 6. paper step 8: the DLT records "inference performance data"
    fed.overlay.registry.register(
        kind="inference_report", institution="hospital-0",
        params=new.params, arch_family=TINY_SERVE.name,
        parents=[new.fingerprint],
        metadata={"requests": len(done), "tokens": toks,
                  "tok_per_s": round(toks / dt, 1),
                  "swap_pause_ticks": entry["pause_ticks"]})
    assert fed.overlay.registry.verify_log()
    say(f"inference report registered on DLT "
        f"(chain length {len(fed.overlay.registry.chain)}, verified)")
    return "\n".join(lines)


if __name__ == "__main__":
    main()
