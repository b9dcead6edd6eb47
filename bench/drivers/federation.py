"""Driver of the federation cells: P hospitals training the paper's CNN
through ``DecentralizedOverlay.run_rounds`` (local SGD under vmap, the
consensus gate, the ``secure_mean`` kernels, optional DP and dropout, the
ledger), rounds back to back in calls of `rounds_per_call`.

Set-up makes the frames and the stacked params on the card from the seed,
builds the federation (``chaos.harness.CNNFederation``, its overlay and
local step) on them, drives its first three rounds through the window's
own call and feed one round a call, and warms up.  The window then runs
calls until `--seconds` have passed.  After it, the plain reference
that the configuration's file names (`reference`: `bench/reference/
cnn.py`, which also holds the model's leaves and seeded weights)
follows the first three rounds from the same
params, frames and keys, with the survivor sets and commits the program
reported, and the run is judged on:

  loss_gap       each of the three rounds' last-step loss, every hospital:
                 the largest |program - reference| over the larger of
                 |reference| and the median |reference|; loss_gap_r1,
                 _r2, _r3 the same for one round
  update_gap     round 1's update (params after it minus before), the
                 worst leaf's gap of norms (`common.norm_gap`)
  change_gap     the same for the change over the three rounds
  ledger_faults  rounds whose committed fingerprint is not the SHA-256
                 of the program's merged row, whose parents are not its
                 survivors, whose survivors include a hospital the fault
                 schedule had down, and transactions off the hash chain
  round_faults   rounds of the whole run, set-up and window, whose outcome
                 breaks the protocol (`round_faults`)

A round that the protocol rightly aborts (fewer than a majority of the
hospitals up, or a phase that ran out of its votes) is an answer, not a
failure: `failed` counts the window's rounds whose outcome breaks the
protocol, and `round_ms` the window over the rounds that committed.
"""
from __future__ import annotations

import json
import math
import sys
import time

import numpy as np
import torch

from bench.common import (Outcome, checks_from, norm_gap, peak_bytes,
                          reference, spread, sync)
from bench.reference import ledger, prg
from bench.trace import Window

MERGE_KERNELS = ("masked_rolling_update_kernel",
                 "masked_rolling_update_wide_kernel")
DP_KERNELS = ("clip_noise_kernel", "clip_noise_wide_kernel")
FOLLOWED = 3
MAX_VOTES = 64      # voting rounds a consensus phase runs before it aborts


def make_frames(model, P, F, g, dev):
    """GLENDA-like frames (P, F, H, W, 3) and labels (P, F), with the
    statistics of the repository's synthetic GLENDA set: tissue texture
    N(0, 0.3^2), a camera bias per hospital (uniform in [0, 0.3] a
    channel), and for label 1 a reddish lesion, a Gaussian blob of
    amplitude 2 with its centre in the middle half of the frame and a
    radius from H/16 to H/6."""
    H = model["image_size"]
    labels = torch.randint(0, 2, (P, F), generator=g, device=dev)
    img = 0.3 * torch.randn((P, F, H, H, 3), generator=g, device=dev)
    img += 0.3 * torch.rand((P, 1, 1, 1, 3), generator=g, device=dev)
    geo = torch.rand((P, F, 3), generator=g, device=dev)
    cy, cx = H / 4 + geo[..., 0] * H / 2, H / 4 + geo[..., 1] * H / 2
    rad = H / 16 + geo[..., 2] * (H / 6 - H / 16)
    ax = torch.arange(H, device=dev, dtype=torch.float32)
    d2 = ((ax[:, None] - cy[..., None, None]) ** 2
          + (ax[None, :] - cx[..., None, None]) ** 2)
    blob = torch.exp(-d2 / (2 * rad[..., None, None] ** 2))
    img[..., 0] += 2.0 * labels[..., None, None].float() * blob
    return img.contiguous(), labels.to(torch.int32)


class Feed:
    """Each call's batches and round keys, from the seed: every round a
    fresh order of each hospital's frames, cut into local_steps batches."""

    def __init__(self, frames, labels, steps, batch, g, seed):
        self.frames, self.labels = frames, labels
        self.steps, self.batch, self.g = steps, batch, g
        self.rng = np.random.default_rng(seed)

    def __call__(self, R):
        P, F = self.labels.shape
        dev = self.frames.device
        order = torch.argsort(torch.rand((R, P, F), generator=self.g,
                                         device=dev), dim=-1)
        idx = order[..., :self.steps * self.batch].reshape(
            R, P, self.steps, self.batch).permute(0, 2, 1, 3)
        rows = torch.arange(P, device=dev)[None, None, :, None]
        keys = self.rng.integers(0, 2 ** 32, size=(R, 2), dtype=np.uint32)
        return self.frames[rows, idx], self.labels[rows, idx], keys


def build(ctx):
    """(federation, feed, first params) of the cell, on ctx.device."""
    from repro_torch.chaos.harness import CNNFederation
    from repro_torch.chaos.schedule import Dropout
    from repro_torch.core.consensus import ProtocolParams
    from repro_torch.privacy.accountant import DPConfig

    model, tr = ctx.config["model"], ctx.cell["traffic_params"]
    dev, P = ctx.device, tr["institutions"]
    g = torch.Generator(device=dev).manual_seed(ctx.seed)
    frames, labels = make_frames(model, P, tr["frames_per_institution"], g,
                                 dev)
    ref = reference(ctx.config)
    leaves = ref.make_params(model, P, g, dev)
    small = ctx.seed & 0x7FFFFFFF
    dp = tr.get("dp")
    fed = CNNFederation(
        Dropout(tr["dropout"], seed=small) if tr.get("dropout") else None,
        seed=small, n_institutions=P, local_steps=tr["local_steps"],
        batch=tr["batch"], image_size=model["image_size"], width_scale=1.0,
        lr=tr["lr"],
        consensus_params=(ProtocolParams.for_fleet(P)
                          if tr.get("fleet_consensus") else None),
        dp=(DPConfig(dp["clip_norm"], dp["noise_multiplier"],
                     seed=dp["seed"]) if dp else None),
        secure_domain=tr["secure_domain"], stacked=ref.from_leaves(leaves),
        device=dev)
    feed = Feed(frames, labels, tr["local_steps"], tr["batch"], g,
                ctx.seed)
    return fed, feed, [t.clone() for t in leaves]


def call(fed, feed, R, log):
    """One `run_rounds(R)` call on the next feed; appends (host start,
    host end, alive rows of each round, commits, outcomes) to `log`, an
    outcome (round index, survivors, committed, a phase out of votes)."""
    imgs, labels, keys = feed(R)
    first = fed.overlay.round_index
    t0 = time.perf_counter()
    with torch.profiler.record_function("bench.run_rounds"):
        fed.stacked, metrics, trs = fed.overlay.run_rounds(
            fed.stacked, (imgs, labels), fed.local_step, keys, R)
    sync(fed.device)
    log.append((t0, time.perf_counter(),
                [len(t.survivors) for t in trs],
                [bool(t.committed) for t in trs],
                [(first + i, tuple(int(j) for j in t.survivors),
                  bool(t.committed),
                  any(ph["rounds"] >= MAX_VOTES for ph in t.phases))
                 for i, t in enumerate(trs)]))
    return (imgs, labels, keys), metrics, trs


def up_rows(dropout, r, P):
    """The hospitals up in round r: those the plain dropout schedule
    (rate, seed) keeps, or all without one."""
    if dropout is None:
        return tuple(range(P))
    return tuple(int(i) for i in np.flatnonzero(
        prg.dropout_up(dropout[1], dropout[0], r, P)))


def round_faults(outcomes, P, dropout):
    """Rounds whose outcome breaks the protocol: survivors other than the
    hospitals up, a commit without a majority of the P up (Paxos safety),
    or an abort with a majority up and no phase out of its votes."""
    bad = 0
    for r, surv, committed, exhausted in outcomes:
        up = up_rows(dropout, r, P)
        if surv != up or committed != (len(up) >= P // 2 + 1
                                       and not exhausted):
            bad += 1
    return bad


def ledger_faults(ref, fed, after, trs, dropout, P):
    faults = ledger.broken_links(fed.overlay.registry.chain)
    merged = [tx for tx in fed.overlay.registry.chain
              if tx.kind == "rolling_update"]
    for r in range(FOLLOWED):
        surv = list(trs[r].survivors)
        row = surv[0] if surv else 0
        fp = ledger.fingerprint([t[row].detach().cpu().numpy()
                                 for t in after[r]], ref.TREEDEF)
        tx = merged[r] if r < len(merged) else None
        if tx is None or tx.model_fingerprint != fp:
            faults += 1
        elif len(tx.parents) != len(surv) or \
                json.loads(tx.metadata).get("round") != r:
            faults += 1
        up = up_rows(dropout, r, P)
        if any(i not in up for i in surv):
            faults += 1
    return faults


def judge(prog_after, prog_losses, ref_after, ref_losses, first):
    """The training numbers of a run against the reference's (a number
    is compared only where the cell gives it a limit)."""
    scale = np.maximum(np.abs(ref_losses), np.median(np.abs(ref_losses)))
    gaps = np.abs(prog_losses - ref_losses) / np.maximum(scale, 1e-30)
    out = {"loss_gap": float(gaps.max())}
    for r in range(FOLLOWED):
        out[f"loss_gap_r{r + 1}"] = float(gaps[r].max())
    for name, r in (("update_gap", 0), ("change_gap", FOLLOWED - 1)):
        out[name] = norm_gap([a - b for a, b in zip(prog_after[r], first)],
                             [a - b for a, b in zip(ref_after[r], first)])
    return out


def reference_follow(ctx, feeds, trs, first, tf32=False, lr=None):
    tr = ctx.cell["traffic_params"]
    ref = reference(ctx.config)
    images = torch.cat([f[0] for f in feeds])
    labels = torch.cat([f[1] for f in feeds])
    keys = np.concatenate([f[2] for f in feeds])
    return ref.follow(first, images, labels, keys,
                      [t.survivors for t in trs],
                      [bool(t.committed) for t in trs],
                      tr["lr"] if lr is None else lr,
                      dp=tr.get("dp"), tf32=tf32)


def run(ctx, control: bool = False) -> Outcome:
    """One run of the cell; `control` also reads the control's numbers
    (`bench/readings.py`), into counters['control']."""
    tr = ctx.cell["traffic_params"]
    model = ctx.config["model"]
    P, R = tr["institutions"], tr["rounds_per_call"]
    dropout = ((tr["dropout"], ctx.seed & 0x7FFFFFFF)
               if tr.get("dropout") else None)
    ref = reference(ctx.config)
    fed, feed, first = build(ctx)
    print(f"setup build: {time.time() - ctx.t_start:.1f} s", file=sys.stderr)
    log = []
    feeds, prog_after, prog_losses, first_trs = [], [], [], []
    for _ in range(FOLLOWED):
        f, metrics, trs = call(fed, feed, 1, log)
        feeds.append(f)
        first_trs += trs
        prog_after.append([t.detach().clone()
                           for t in ref.leaves(fed.stacked)])
        prog_losses.append(metrics["loss"][0].double().cpu().numpy())
    warm_until = time.perf_counter() + tr["warm_seconds"]
    call(fed, feed, R, log)
    while time.perf_counter() < warm_until:
        call(fed, feed, R, log)

    t_open = time.perf_counter()
    setup_s = time.time() - ctx.t_start
    n_setup = len(log)
    traced_s = min(tr["trace_seconds"], ctx.seconds / 2)
    with Window(ctx.trace) as win:
        while ctx.trace and time.perf_counter() - win.t0 < traced_s:
            call(fed, feed, R, log)
    n_traced = len(log)
    rest = ctx.seconds - traced_s if ctx.trace else ctx.seconds
    t_rest = time.perf_counter()
    while time.perf_counter() - t_rest < rest:
        call(fed, feed, R, log)
    t_close = log[-1][1]
    memory_peak = peak_bytes(ctx.device)

    window = log[n_setup:]
    spread(f"window: {len(window)} calls of {R} rounds",
           [c[1] - c[0] for c in window])
    rounds = sum(len(c[3]) for c in window)
    committed = sum(sum(c[3]) for c in window)
    counted = log[n_traced:] if ctx.trace else window
    span = (counted[-1][1] - counted[0][0]) if counted else 0.0
    counters = {
        "model": model, "P": P, "N": sum(math.prod(s)
                                         for s in ref.leaf_shapes(model)),
        "dp": bool(tr.get("dp")),
        "train_flops": ref.train_flops(
            model, sum(len(c[3]) for c in counted) * P * tr["local_steps"]
            * tr["batch"]),
        "span_s": span,
        "traced_alive": [a for c in log[n_setup:n_traced] for a in c[2]],
        "merge_kernels": MERGE_KERNELS, "dp_kernels": DP_KERNELS,
    }

    ref_after, ref_losses = reference_follow(ctx, feeds, first_trs, first)
    numbers = judge(prog_after, np.stack(prog_losses), ref_after,
                    ref_losses, first)
    numbers["ledger_faults"] = float(ledger_faults(
        ref, fed, prog_after, first_trs, dropout, P))
    numbers["round_faults"] = float(round_faults(
        [o for c in log for o in c[4]], P, dropout))
    counters["numbers"] = numbers
    if control:
        low_after, low_losses = reference_follow(ctx, feeds, first_trs,
                                                 first, tf32=True)
        counters["control"] = judge(low_after, low_losses, ref_after,
                                    ref_losses, first)
        # the fault "half of each batch left out", planted in the
        # reference put in the program's place
        half = [(i[:, :, :, :i.shape[3] // 2], y[:, :, :, :y.shape[3] // 2],
                 k) for i, y, k in feeds]
        h_after, h_losses = reference_follow(ctx, half, first_trs, first)
        counters["half_batch"] = judge(h_after, h_losses, ref_after,
                                       ref_losses, first)
        # the fault "a step that returns its state unchanged": local
        # training that does not move the params
        u_after, u_losses = reference_follow(ctx, feeds, first_trs, first,
                                             lr=0.0)
        counters["unchanged"] = judge(u_after, u_losses, ref_after,
                                      ref_losses, first)
    return Outcome(
        metrics={"round_ms": (t_close - t_open) * 1e3 / committed
                 if committed else None, "setup_s": setup_s},
        attempted=rounds,
        failed=round_faults([o for c in window for o in c[4]], P, dropout),
        checks=checks_from(numbers, ctx.cell["limits"]),
        memory_peak=memory_peak, counters=counters, trace=win.read())
