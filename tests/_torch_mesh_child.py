"""W-rank half of the port's mesh parity suite (tests/test_torch_mesh.py).

Run as a script, it spawns W = 4 ranks over gloo on the CPU
(`launch.mesh.spawn_ranks`), each on the ("inst",) mesh of all four, and
prints ONE json object on stdout: each rank's report.  Every rank runs
each case twice, on the mesh and with mesh=None (the port's
single-process run), and reports:

  cases      `run_rounds` at P in {5, 8, 16} x {healthy, dropout30} under
             "mean", every other merge at P = 8, and int secure_mean at
             P in {5, 8, 16}: allclose at RTOL 2e-5, ATOL 1e-6, bit
             equality, commits, transcripts and stats; rank 0 adds the
             mesh run's leaves, which the test holds against the JAX
             package's single-device run
  partial    the personalization config (backbone/head BlockSpec,
             backbone-only selection, a block schedule) at P = 8: the
             head must be bit-identical
  gather     `all_gather_rows` of f32, uint32 and bool blocks: the full
             rows in rank order, bit for bit
  toolkit    `survivor_count` / `masked_mean` / `masked_abs_max` with
             ``group=``, each rank passing its block, against the
             single-block helpers
  recovery   snapshot every 2 rounds, a kill at round 5, failover from
             the newest verified snapshot, run to round 6: params
             fingerprint (and on rank 0 the chain digest) against the
             uninterrupted mesh run and the single-process run
  device     the two-tier federation (8 institutions, 48 devices each)
             merged by hierarchical_device: the uint32 device totals bit
             for bit, the params at fp32 tolerance

P = 5 does not divide W = 4, so it runs replicated (the guard).
"""
import json
import os
import shutil
import sys
import tempfile

import numpy as np
import torch

from repro_torch import random as prng
from repro_torch.chaos import Dropout
from repro_torch.core import DecentralizedOverlay, OverlayConfig
from repro_torch.core.consensus import ProtocolParams
from repro_torch.core.merges import available_merges, toolkit
from repro_torch.core.registry import ModelRegistry, fingerprint_pytree
from repro_torch.launch.mesh import spawn_ranks
from repro_torch.pytree import tree_flatten, tree_map
from repro_torch.sharding import all_gather_rows, make_institution_mesh

W = 4
R, LOCAL_STEPS = 2, 1
RTOL, ATOL = 2e-5, 1e-6
KEY = 42


def start_arrays(P, seed=0):
    """The (P, ...) start params as numpy, leaves in tree order (b/c, w):
    zeros jittered by 0.3 x a standard normal."""
    rng = np.random.default_rng([seed, P])
    return {"b": {"c": (0.3 * rng.standard_normal((P, 3, 2))
                        ).astype(np.float32)},
            "w": (0.3 * rng.standard_normal((P, 7))).astype(np.float32)}


def batch_arrays(P, n_rounds=R, seed=5):
    """(x, y) of shape (n_rounds, LOCAL_STEPS, P, 8, 7) and (..., 8):
    y = x @ arange(7)."""
    rng = np.random.default_rng([seed, P, n_rounds])
    x = rng.standard_normal((n_rounds, LOCAL_STEPS, P, 8, 7)).astype(
        np.float32)
    return x, np.einsum("rspbd,d->rspb", x,
                        np.arange(7, dtype=np.float32)).astype(np.float32)


def local_step(p, batch):
    """The reference child's linear step: one SGD step of lr 0.1 on the
    mean squared error of x @ w against y."""
    x, y = batch

    def loss(q):
        return torch.mean((x @ q["w"] - y) ** 2)
    g = torch.func.grad(loss)(p)
    return tree_map(lambda a, b: a - 0.1 * b, p, g), {"loss": loss(p)}


def schedules():
    return {"healthy": None, "dropout30": Dropout(rate=0.30, seed=0)}


def overlay(P, merge, schedule, domain="float", **cfg_kw):
    # fleet consensus, so that rounds commit at every P
    return DecentralizedOverlay(OverlayConfig(
        n_institutions=P, local_steps=LOCAL_STEPS, merge=merge, alpha=0.7,
        group_size=2, consensus_seed=0, fault_schedule=schedule,
        consensus_params=ProtocolParams.for_fleet(P), secure_domain=domain,
        merge_subtree=None, **cfg_kw),
        registry=ModelRegistry(logical_clock=True))


def tensors(tree, device="cpu"):
    return tree_map(lambda a: torch.from_numpy(a).to(device), tree)


def run(P, merge, schedule, mesh, domain="float", device="cpu", **cfg_kw):
    ov = overlay(P, merge, schedule, domain, **cfg_kw)
    x, y = tensors(batch_arrays(P), device)
    stacked, metrics, trs = ov.run_rounds(
        tensors(start_arrays(P), device), (x, y), local_step,
        prng.PRNGKey(KEY), R, mesh=mesh)
    return ov, [a.cpu().numpy() for a in tree_flatten((stacked, metrics))[0]
                ], trs


def verdict(ref, got):
    ov_r, a, trs_r = ref
    ov_m, b, trs_m = got
    return {"allclose": all(np.allclose(u, v, rtol=RTOL, atol=ATOL)
                            for u, v in zip(a, b)),
            "bit_equal": all(np.array_equal(u, v) for u, v in zip(a, b)),
            "max_abs_err": max(float(np.abs(u - v).max()) for u, v in
                               zip(a, b)),
            "transcripts_equal": [(t.committed, t.survivors) for t in trs_r]
            == [(t.committed, t.survivors) for t in trs_m],
            "stats_equal": ov_r.stats == ov_m.stats,
            "committed": sum(s["committed"] for s in ov_r.stats),
            "committed_mesh": sum(s["committed"] for s in ov_m.stats),
            "fingerprint": fingerprint_pytree(b)}


def run_cases(mesh, rank):
    scheds = schedules()
    cases = [(P, "mean", s, "float") for P in (5, 8, 16) for s in scheds]
    cases += [(8, m, s, "float") for m in sorted(available_merges())
              if m != "mean" for s in scheds]
    cases += [(P, "secure_mean", s, "int") for P in (5, 8, 16)
              for s in scheds]
    out = []
    for P, merge, name, domain in cases:
        ref = run(P, merge, schedules()[name], None, domain)
        got = run(P, merge, schedules()[name], mesh, domain)
        case = {"P": P, "merge": merge, "schedule": name, "domain": domain,
                **verdict(ref, got)}
        if rank == 0:
            case["leaves"] = [a.tolist() for a in got[1]]
        out.append(case)
    return out


def run_partial(mesh):
    from repro_torch.core import BlockSchedule, BlockSpec
    kw = dict(block_spec=BlockSpec.by_prefix(backbone="w", head="b"),
              merge_blocks=("backbone",),
              block_schedule=BlockSchedule(
                  groups=(("backbone",), ("backbone",))),
              inner_merge="mean")
    out = []
    for name, sched in schedules().items():
        ref = run(8, "partial", sched, None, **kw)
        got = run(8, "partial", sched, mesh, **kw)
        v = verdict(ref, got)
        # leaves: b/c (the head), w (the backbone), then the loss
        v.update(schedule=name,
                 head_bit_equal=bool(np.array_equal(ref[1][0], got[1][0])),
                 head_untouched=bool(np.array_equal(
                     got[1][0], _trained_head(8))),
                 backbone_moved=bool(np.abs(got[1][1]).max() > 0))
        out.append(v)
    return out


def _trained_head(P):
    """The head after R rounds of local steps alone: the linear step
    leaves b/c where it starts, and a personal block never merges."""
    return start_arrays(P)["b"]["c"]


def run_gather(mesh):
    P = 8
    full = {"a": torch.arange(P * 3, dtype=torch.float32).reshape(P, 3) / 7,
            "u": (torch.arange(P, dtype=torch.int64) * 0x9E3779B1
                  % 2 ** 32).to(torch.uint32),
            "m": torch.arange(P) % 3 == 0}
    group = mesh.get_group("inst")
    per = P // W
    r = torch.distributed.get_rank(group)
    back = all_gather_rows({k: v[r * per:(r + 1) * per]
                            for k, v in full.items()}, group)
    return all(back[k].dtype == full[k].dtype
               and torch.equal(back[k].view(torch.uint8),
                               full[k].view(torch.uint8)) for k in full)


def run_toolkit(mesh):
    P, F = 16, 12
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((P, F)).astype(np.float32))
    mask = torch.from_numpy(np.arange(P) % 3 != 0)
    count_ref = toolkit.survivor_count(mask)
    mb = toolkit.mask_nd(mask, x).to(torch.bool)
    mean_ref = toolkit.masked_mean(x, mb, count_ref)
    amax_ref = toolkit.masked_abs_max(x, mb)
    group = mesh.get_group("inst")
    per = P // W
    r = torch.distributed.get_rank(group)
    xb, mkb = x[r * per:(r + 1) * per], mask[r * per:(r + 1) * per]
    mbb = toolkit.mask_nd(mkb, xb).to(torch.bool)
    count = toolkit.survivor_count(mkb, group=group)
    mean = toolkit.masked_mean(xb, mbb, count, group=group)
    amax = toolkit.masked_abs_max(xb, mbb, group=group)
    return {"count_equal": bool(torch.equal(count, count_ref)),
            "mean_allclose": bool(torch.allclose(mean, mean_ref, rtol=RTOL,
                                                 atol=ATOL)),
            "absmax_equal": bool(torch.equal(amax, amax_ref))}


def run_recovery(mesh, snap_dir, rank):
    from repro_torch.checkpoint import latest_verified_snapshot
    P, R6 = 8, 6
    x, y = (torch.from_numpy(a) for a in batch_arrays(P, R6))
    keys = prng.split(prng.PRNGKey(KEY), R6)

    def mk():
        return (overlay(P, "mean", Dropout(rate=0.30, seed=0)),
                tensors(start_arrays(P)))

    def result(ov, s):
        chain = ov.registry.chain
        return fingerprint_pytree(s), chain[-1].hash() if chain else None

    ov, s = mk()
    s, _, _ = ov.run_rounds(s, (x, y), local_step, keys, R6)
    single = result(ov, s)
    ov, s = mk()
    s, _, _ = ov.run_rounds(s, (x, y), local_step, keys, R6, mesh=mesh)
    golden = result(ov, s)

    # the doomed run: snapshots at rounds 2 and 4, dies in round 5
    ov2, s2 = mk()
    s2, _, _ = ov2.run_rounds(s2, (x[:4], y[:4]), local_step, keys[:4], 4,
                              mesh=mesh, snapshot_every=2,
                              snapshot_dir=snap_dir)
    ov2.run_rounds(s2, (x[4:5], y[4:5]), local_step, keys[4:5], 1,
                   mesh=mesh)
    # failover: a fresh overlay, the newest verified snapshot, on to 6
    ov3, like = mk()
    s3, state, _, skipped = latest_verified_snapshot(snap_dir, like,
                                                     cfg=ov3.cfg)
    ov3.restore(state)
    r0 = state.round_index
    s3, _, _ = ov3.run_rounds(s3, (x[r0:], y[r0:]), local_step, keys[r0:],
                              R6 - r0, mesh=mesh)
    got = result(ov3, s3)
    out = {"restored_round": int(r0), "snapshots_skipped": len(skipped),
           "params_equal": got[0] == golden[0],
           "params_equal_single": got[0] == single[0]}
    if rank == 0:
        out.update(digest_equal=got[1] == golden[1],
                   digest_equal_single=got[1] == single[1],
                   chain_verified=ov3.registry.verify_chain())
    return out


def run_device_tier(mesh):
    from repro_torch.chaos.schedule import DeviceSchedule
    from repro_torch.core.device_tier import (
        DeviceTierConfig, device_sweep_ids, make_device_local_step,
        make_device_state,
    )
    from repro_torch.data.pipeline import (
        DeviceShardSpec, DirichletPartitioner, institution_class_mixes,
        make_centroid_pull_update, make_device_data_fn,
    )
    P8, R2, LS = 8, 2, 1
    spec = DeviceShardSpec(n_classes=4, n_features=7, min_samples=1,
                           max_samples=9, seed=3)
    mixes = institution_class_mixes(
        DirichletPartitioner(alpha=0.5, n_institutions=P8, seed=1),
        spec.n_classes)
    cfg_dev = DeviceTierConfig(
        n_devices=48, chunk_size=16, max_weight=16, staleness_bound=1,
        faults=DeviceSchedule(dropout_rate=0.2, straggler_rate=0.3,
                              max_delay_s=2.0, deadline_s=1.2, seed=9))
    step = make_device_local_step(cfg_dev, make_device_data_fn(spec, mixes),
                                  make_centroid_pull_update(spec))
    base = {"w": torch.linspace(-1.0, 1.0, 7)}

    def go(m):
        ov = DecentralizedOverlay(OverlayConfig(
            n_institutions=P8, local_steps=LS, merge="hierarchical_device",
            merge_subtree="params",
            consensus_params=ProtocolParams.for_fleet(P8)))
        st, _, _ = ov.run_rounds(make_device_state(base, P8),
                                 device_sweep_ids(R2, LS, P8), step,
                                 prng.PRNGKey(KEY), R2, mesh=m)
        return st, sum(s["committed"] for s in ov.stats)

    ref, c0 = go(None)
    got, c1 = go(mesh)
    ints = [k for k in sorted(ref) if k != "params"]
    return {"params_allclose": bool(np.allclose(
                ref["params"]["w"].numpy(), got["params"]["w"].numpy(),
                rtol=RTOL, atol=ATOL)),
            "params_bit_equal": bool(torch.equal(ref["params"]["w"],
                                                 got["params"]["w"])),
            "uint32_leaves": [k for k in ints
                              if tree_flatten(got[k])[0][0].dtype
                              == torch.uint32],
            "device_aggregates_bit_equal": all(
                np.array_equal(a.numpy(), b.numpy())
                for k in ints for a, b in zip(tree_flatten(ref[k])[0],
                                              tree_flatten(got[k])[0])),
            "committed": c0, "committed_mesh": c1}


def rank_main(rank, world_size, out_dir):
    torch.set_num_threads(1)
    mesh = make_institution_mesh(device="cpu")
    report = {"rank": rank, "world": world_size,
              "cases": run_cases(mesh, rank),
              "partial": run_partial(mesh),
              "gather": run_gather(mesh),
              "toolkit": run_toolkit(mesh),
              "recovery": run_recovery(mesh, os.path.join(out_dir, "snap"),
                                       rank),
              "device": run_device_tier(mesh)}
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(report, f)


if __name__ == "__main__":
    out = tempfile.mkdtemp(prefix="mesh_child_")
    try:
        spawn_ranks(rank_main, W, backend="gloo", args=(out,))
        reports = []
        for r in range(W):
            with open(os.path.join(out, f"rank{r}.json")) as f:
                reports.append(json.load(f))
    finally:
        shutil.rmtree(out, ignore_errors=True)
    print(json.dumps({"world": W, "ranks": reports}))
    sys.stdout.flush()
