"""Two-tier continuum federation on the PyTorch port: personal medical
devices under every hospital, as `examples/device_tier_federation.py`
does on JAX.

    PYTHONPATH=src python examples/torch_device_tier_federation.py
    PYTHONPATH=src python examples/torch_device_tier_federation.py \
        --devices 4096 --institutions 16 --rounds 3

Every simulated device gets its own tiny non-IID shard; each
institution's D-device FedAvg sweep runs chunk by chunk under a
`DeviceSchedule` that drops and delays devices; the institution tier is
the unchanged overlay (consensus gate, ``hierarchical_device`` merge,
DLT); and the continuum cost model prices the device fan-in.  Runs on
``cuda`` unless ``--device cpu`` is given.
"""
import argparse

import numpy as np
import torch

from repro_torch import random as prng
from repro_torch import resolve_device
from repro_torch.chaos.schedule import DeviceSchedule
from repro_torch.continuum import (
    C3_TESTBED, DEVICE_PROFILES, DeviceFleet, FederationWorkload,
    assign_institutions,
)
from repro_torch.core import DecentralizedOverlay, OverlayConfig
from repro_torch.core.consensus import ProtocolParams
from repro_torch.core.device_tier import (
    DeviceTierConfig, device_sweep_ids, make_device_local_step,
    make_device_state,
)
from repro_torch.data.pipeline import (
    DeviceShardSpec, DirichletPartitioner, institution_class_mixes,
    make_centroid_pull_update, make_device_data_fn,
)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--institutions", type=int, default=8)
    ap.add_argument("--devices", type=int, default=1024,
                    help="devices per institution")
    ap.add_argument("--chunk", type=int, default=256)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cuda (the default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    P, D, R = args.institutions, args.devices, args.rounds
    lines = []

    def say(line=""):
        print(line)
        lines.append(line)

    say(f"=== two-tier federation: {P} institutions x {D} devices "
        f"= {P * D} devices/round (chunk={args.chunk}) ===")

    # tier 0: per-device synthetic shards
    spec = DeviceShardSpec(n_classes=4, n_features=32, min_samples=1,
                           max_samples=16, seed=args.seed)
    mixes = institution_class_mixes(
        DirichletPartitioner(alpha=0.5, n_institutions=P, seed=args.seed),
        spec.n_classes)
    data_fn = make_device_data_fn(spec, mixes)
    update_fn = make_centroid_pull_update(spec)

    # tier 0 -> 1: the chunked device sweep under each institution
    sched = DeviceSchedule(dropout_rate=0.1, straggler_rate=0.15,
                           max_delay_s=2.0, deadline_s=1.5, seed=args.seed)
    cfg_dev = DeviceTierConfig(n_devices=D, chunk_size=args.chunk,
                               max_weight=16, staleness_bound=1,
                               faults=sched)
    local_step = make_device_local_step(cfg_dev, data_fn, update_fn)

    # tier 1: the unchanged institution overlay; the round's device
    # weights reach the merge through the state's "device_w" leaf
    ov = DecentralizedOverlay(OverlayConfig(
        n_institutions=P, local_steps=1, merge="hierarchical_device",
        merge_subtree="params",
        consensus_params=ProtocolParams.for_fleet(P)))
    base = {"w": torch.linspace(-1.0, 1.0, spec.n_features,
                                dtype=torch.float32, device=device)}
    state = make_device_state(base, P)
    ids = device_sweep_ids(R, 1, P, device=device)
    state, metrics, trs = ov.run_rounds(state, ids, local_step,
                                        prng.PRNGKey(args.seed), R)

    on_t = metrics["device_on_time"].cpu().numpy()   # (R, [steps,] P)
    on_time = on_t.reshape(on_t.shape[0], -1).sum(axis=1)
    late = metrics["device_late"].cpu().numpy()
    late = late.reshape(late.shape[0], -1).sum(axis=1)
    for r, tr in enumerate(trs):
        say(f"  round {r}: committed={bool(tr.committed)} "
            f"on_time={int(on_time[r])} late={int(late[r])}")
    say(f"  final device-weight totals per institution: "
        f"{state['device_w'].cpu().tolist()}")
    say(f"  staleness bank (folds into next round): "
        f"{state['stale_w'].cpu().tolist()}")
    w = state["params"]["w"].cpu().numpy()
    say(f"  institutions synchronized: max drift "
        f"{np.abs(w - w[0]).max():.1e}")

    # the cost model sees the device fan-in too
    say("\n=== placement with device fan-in priced in ===")
    wl = FederationWorkload(flops_per_sample=1.3e8, samples_per_round=500,
                            model_size_mb=5.0)
    for profile in ("wearable", "phone", "bedside_monitor"):
        fleet = DeviceFleet(n_devices=D, profile=profile,
                            update_size_mb=0.01)
        pl = assign_institutions(min(P, 5), wl, fleet=fleet)
        fanin = fleet.fanin_time_s(C3_TESTBED[pl[0].resource])
        bw = DEVICE_PROFILES[profile].bandwidth_mbps
        say(f"  {profile:<16} ({bw:5.1f} Mb/s uplink): "
            f"fan-in {fanin:6.2f}s, round {pl[0].round_time_s:6.2f}s "
            f"on {pl[0].resource}")
    return "\n".join(lines)


if __name__ == "__main__":
    main()
