#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from this checkout (each
``src/repro_torch/csrc/*.cu`` into its own library for sm_90a, one nvcc
per source, all started together), holds each kernel against its plain
PyTorch version on the card, then drives the port's two paths at full
width, each with every launch count set to 0 just before it and read just
after:

* the paper's federation round (``CNNFederation.run_rounds``): P = 10
  hospitals, the STIGMA CNN at width 1.0 on 64x64 frames (N = 109,634
  parameters per hospital), 3 rounds of secure_mean in the float domain,
  the int domain and the float domain with DP;
* the federated LM serving path (train -> registry -> verified pull ->
  serve): an ``LMFederation`` of qwen3-0.6b at its published width (28
  layers, 596,049,920 parameters, random weights from a seed) runs one
  round and publishes, a ``FederatedServer`` pulls the committed model
  through the ledger's provenance gate and serves 16 greedy requests of
  64-1024 prompt tokens (prefill through the flash-attention kernel, then
  decode).

Before the full-width paths, small runs on the card are held against the
same runs on the CPU, and a mid-traffic hot-swap is checked for identity
with a fresh engine.  Prints each kernel's time beside its bound, its
plain version's time and a PyTorch library call's time where one exists,
then a JSON line of kernels, the card's name and power limit, and as the
last line ``{"ok": true, "device": {...}}``.  Exits non-zero, printing no
result, without a CUDA device or outside the repository.

The script leaves PyTorch's TF32 settings at their defaults, as a user
has them: the CNN's local step computes in IEEE float32 by itself, and the
LM computes in bf16.
"""
import json
import math
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent

# H100 SXM rates.  HBM bytes/s, float32 ops/s (an add or a multiply is
# one op) and the bf16 tensor-core rate from NVIDIA's data sheet.
# Per-pipe rates from the CUDA C++ Programming Guide's throughput table
# for compute capability 9.0, in results per clock per SM, x 132 SMs x the
# 1,980 MHz boost clock: int32 shifts and logic run on the INT32 pipe
# (64), int32 multiplies on the FMA pipe (64), int32 adds on either;
# conversions (16) and the special functions log / sqrt / cos (16) are
# counted against their own rate.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
BF16_TC_FLOPS = 989e12
PER_CLOCK = 132 * 1.98e9
ALU_OPS_PER_S = IMAD_OPS_PER_S = 64 * PER_CLOCK
CVT_OPS_PER_S = SFU_OPS_PER_S = 16 * PER_CLOCK

P_FULL, N_FULL, N_RAGGED = 10, 109_634, 4_097
ROUNDS = 3
MODES = ("float", "int", "dp")

# flash attention on the card vs its plain version:
# (B, S, Hq, Hkv, hd, dtype, causal, window)
FLASH_CASES = [
    (1, 1000, 16, 8, 128, torch.bfloat16, True, 0),   # qwen3, ragged S
    (2, 192, 6, 3, 32, torch.bfloat16, True, 0),
    (2, 192, 6, 3, 32, torch.float32, True, 0),
    (1, 512, 4, 1, 80, torch.bfloat16, True, 0),
    (2, 256, 15, 5, 64, torch.bfloat16, True, 0),     # group 3
    (2, 256, 4, 2, 64, torch.float32, True, 16),
    (2, 256, 4, 2, 64, torch.float32, True, 64),
    (2, 256, 4, 2, 64, torch.float32, True, 100),
    (1, 200, 4, 2, 64, torch.float32, False, 0),      # non-causal ragged
]
FLASH_TOL = {torch.bfloat16: 2e-2, torch.float32: 2e-5}
FLASH_TIMED = (1, 1024, 16, 8, 128)       # qwen3's prefill at S = 1024
# the LM main path: qwen3-0.6b, harness defaults, 16 greedy requests
LM_ARCH, N_REQUESTS, MAX_NEW, PROMPT_LO, PROMPT_HI = (
    "qwen3-0.6b", 16, 32, 64, 1024)


def op_counts(kind, P, N, alive_rows):
    """Operations per class the kernel's function needs for these inputs
    (only surviving pairs exchange pads).  One pad word, mask_bits, is
    key ^ (column * golden) then mix32: 7 shifts and logic ops and 2
    multiplies per (pair, column), and 1 multiply per column for the
    counter, which no pair changes.  The float pad adds a shift, a
    conversion, 3 float ops and 2 float accumulations; the int pad 2
    wrapping adds.  DP: two words per (row, column) plus 2 shifts, an
    add, 2 conversions, log / sqrt / cos and 11 float ops."""
    K = alive_rows * (alive_rows - 1) // 2
    A = alive_rows
    if kind == "masked_rolling_update":
        return dict(alu=N * K * 8, imad=N * (2 * K + 1), iadd=0,
                    fp=N * (5 * K + 6 * A + 1), cvt=N * K, sfu=0)
    if kind == "masked_field_wsum":   # encode: scale, clamp (2), 2 cvt
        return dict(alu=N * (7 * K + 2 * P), imad=N * (2 * K + 1),
                    iadd=N * (2 * K + A), fp=N * P, cvt=N * 2 * P, sfu=0)
    return dict(alu=N * A * 16, imad=N * (4 * A + 1), iadd=N * A,
                fp=N * A * 11, cvt=N * A * 2, sfu=N * A * 3)


def bound(kind, P, N, alive_rows):
    """(bytes_ms, ops_ms): bytes / HBM rate (each input read once, each
    output written once), and the slowest class of operations over its
    pipe's rate; int32 adds may fill either integer pipe."""
    nbytes = {"masked_rolling_update": 2 * P * N * 4,
              "masked_field_wsum": P * N * 4 + N * 4,
              "clip_noise": 2 * P * N * 4 + P * 4}[kind]
    c = op_counts(kind, P, N, alive_rows)
    t_ops = max(c["alu"] / ALU_OPS_PER_S, c["imad"] / IMAD_OPS_PER_S,
                (c["alu"] + c["imad"] + c["iadd"])
                / (ALU_OPS_PER_S + IMAD_OPS_PER_S),
                c["fp"] / FP32_OPS_PER_S, c["cvt"] / CVT_OPS_PER_S,
                c["sfu"] / SFU_OPS_PER_S)
    return nbytes / HBM_BYTES_PER_S * 1e3, t_ops * 1e3


def flash_bound(B, S, Hq, Hkv, hd, itemsize=2):
    """(bytes_ms, ops_ms) of causal attention: q, k, v and o moved once;
    4 * hd flops per unmasked (q, k) pair and head (QK^T and PV, a
    multiply-add each), S(S+1)/2 pairs, at the bf16 tensor-core rate."""
    nbytes = B * S * hd * (2 * Hq + 2 * Hkv) * itemsize
    flops = 4 * hd * B * Hq * S * (S + 1) / 2
    return nbytes / HBM_BYTES_PER_S * 1e3, flops / BF16_TC_FLOPS * 1e3


def cuda_ms(fn, inputs, iters):
    """Mean ms of `fn` over `iters` calls cycling through `inputs` (more
    than the 50 MB L2 in total, so each call reads from HBM), by CUDA
    events after a warm-up."""
    for x in inputs[:4]:
        fn(x)
    torch.cuda.synchronize()
    start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for i in range(iters):
        fn(inputs[i % len(inputs)])
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def device_us(fn, iters, host=True):
    """{kernel name: [device us of each launch]} over `iters` calls of
    fn(i), from torch.profiler's CUDA activity: the kernels' own time on
    the card, without the host's launch gaps.  `host=False` traces the
    card alone, which costs the host far less per operation."""
    acts = [torch.profiler.ProfilerActivity.CUDA]
    if host:
        acts.append(torch.profiler.ProfilerActivity.CPU)
    with torch.profiler.profile(activities=acts) as prof:
        for i in range(iters):
            fn(i)
        torch.cuda.synchronize()
    out = {}
    for e in prof.events():
        if str(e.device_type).endswith("CUDA"):
            out.setdefault(e.name, []).append(e.time_range.elapsed_us())
    return out


def print_resource_usage(lib_path, tag):
    """Registers and spills of the kernels whose mangled name holds
    `tag`, from cuobjdump."""
    from repro_torch.kernels import _cuda
    cuobjdump = shutil.which("cuobjdump") or str(
        Path(_cuda._nvcc()).with_name("cuobjdump"))
    if not Path(cuobjdump).exists():
        return
    usage = subprocess.run([cuobjdump, "--dump-resource-usage",
                            str(lib_path)], capture_output=True, text=True)
    lines = usage.stdout.splitlines()
    for name, counts in zip(lines, lines[1:]):   # "Function f:", "REG:"
        if "Function" in name and tag in name:
            print(f"  {name.strip()} {counts.strip()}")


class Stopwatch:
    """Wraps fn so that each call is timed on the host clock between two
    synchronizes (`calls`: seconds of each), and its result handed to
    `check`, which returns False to fail the run."""

    def __init__(self, fn, check=None):
        self.fn, self.check, self.calls = fn, check, []

    def __call__(self, *args, **kwargs):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = self.fn(*args, **kwargs)
        torch.cuda.synchronize()
        self.calls.append(time.perf_counter() - t)
        if self.check is not None:
            assert self.check(out), f"{self.fn.__name__}: check failed"
        return out

    @property
    def seconds(self):
        return sum(self.calls)


# ----------------------------------------------------------------------
# the secure-aggregation and DP kernels (slice 1)

def secure_agg_kernels(dev):
    from repro_torch.kernels.dp import kernel as dp_kernel
    from repro_torch.kernels.dp import ref as dp_ref
    from repro_torch.kernels.secure_agg import kernel as agg_kernel
    from repro_torch.kernels.secure_agg import ref as agg_ref
    return {
        "masked_rolling_update": dict(
            wrapper=agg_kernel.masked_rolling_update_flat,
            source="src/repro_torch/csrc/secure_agg.cu",
            replaces="src/repro/kernels/secure_agg/kernel.py:209",
            run=lambda u, m: agg_kernel.masked_rolling_update_flat(
                u, 0xC0FFEE, 0.7, m),
            plain=lambda u, m: agg_ref.masked_rolling_update_reference(
                u, 0xC0FFEE, 0.7, m)),
        "masked_field_wsum": dict(
            wrapper=agg_kernel.masked_field_wsum_flat,
            source="src/repro_torch/csrc/secure_agg.cu",
            replaces="src/repro/kernels/secure_agg/kernel.py:177",
            run=lambda u, m: agg_kernel.masked_field_wsum_flat(
                u, 0xC0FFEE, m),
            plain=lambda u, m: agg_ref.masked_field_wsum_reference(
                u, 0xC0FFEE, m)),
        "clip_noise": dict(
            wrapper=dp_kernel.clip_noise_flat,
            source="src/repro_torch/csrc/secure_agg.cu",
            replaces="src/repro/kernels/dp/kernel.py:69",
            run=lambda u, m: dp_kernel.clip_noise_flat(
                u, dp_ref._row_norms(u), 0xC0FFEE, 0.5, 1.0, m),
            plain=lambda u, m: dp_ref.clip_noise_reference(
                u, 0xC0FFEE, 0.5, 1.0, m, dp_ref._row_norms(u))),
    }


def check_secure_agg(kernels, dev):
    rng = np.random.default_rng(0)
    for name, k in kernels.items():
        k["max_abs_err"] = 0.0
        for N in (N_FULL, N_RAGGED):
            for dead in ((), (0, 4)):
                u = torch.from_numpy(rng.standard_normal(
                    (P_FULL, N)).astype(np.float32)).to(dev)
                m = None
                if dead:
                    mask = np.ones(P_FULL, np.float32)
                    mask[list(dead)] = 0.0
                    u[dead[0]] = float("inf")
                    u[dead[1]] = float("nan")
                    m = torch.from_numpy(mask).to(dev)
                got, want = k["run"](u, m), k["plain"](u, m)
                torch.cuda.synchronize()
                if name == "masked_field_wsum":
                    assert torch.equal(got, want), (name, N, dead)
                    continue
                tol = (dict(atol=P_FULL * 1e-6, rtol=0)
                       if name == "masked_rolling_update"
                       else dict(atol=1e-6, rtol=1e-5))
                torch.testing.assert_close(got, want, equal_nan=True, **tol)
                alive = [p for p in range(P_FULL) if p not in dead]
                err = float((got[alive] - want[alive]).abs().max())
                k["max_abs_err"] = max(k["max_abs_err"], err)
                if dead:
                    assert torch.equal(got[dead[0]], u[dead[0]])
        print(f"check {name}: kernel == plain at N={N_FULL},{N_RAGGED} "
              f"(all alive, 2 dead rows); max |err| {k['max_abs_err']:.3g}")


def check_flash(dev):
    """The flash kernel against its plain version on every listed shape;
    returns the largest |err| over the bf16 cases."""
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention import ref as fa_ref
    worst = 0.0
    for i, (B, S, Hq, Hkv, hd, dtype, causal, window) in enumerate(
            FLASH_CASES):
        g = torch.Generator(dev).manual_seed(i)
        q, k, v = (torch.randn((B, S, h, hd), generator=g, device=dev)
                   .to(dtype) for h in (Hq, Hkv, Hkv))
        before = fa_kernel.flash_attention_bhsd.launches
        got = fa_ops.flash_attention(q, k, v, causal=causal, window=window)
        want = fa_ref.attention_reference(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            causal=causal, window=window).transpose(1, 2)
        torch.cuda.synchronize()
        assert fa_kernel.flash_attention_bhsd.launches == before + 1
        tol = FLASH_TOL[dtype]
        torch.testing.assert_close(got.float(), want.float(), atol=tol,
                                   rtol=tol)
        err = float((got.float() - want.float()).abs().max())
        worst = max(worst, err)
        print(f"check flash_attention_bhsd (B,S,Hq,Hkv,hd)="
              f"{(B, S, Hq, Hkv, hd)} {str(dtype)[6:]} causal={causal} "
              f"window={window}: max |err| {err:.3g} (tol {tol})")
    return worst


# ----------------------------------------------------------------------
# the card against the CPU, small

def cnn_card_vs_cpu(dev, fed_kwargs):
    from repro_torch.chaos.harness import CNNFederation
    from repro_torch.pytree import tree_flatten
    for mode in MODES:
        small = dict(n_institutions=3, image_size=16, width_scale=0.25,
                     **fed_kwargs(mode))
        g_fed = CNNFederation(None, 0, device=dev, **small)
        gm, _ = g_fed.run_rounds(2)
        c_fed = CNNFederation(None, 0, device="cpu", **small)
        cm, _ = c_fed.run_rounds(2)
        np.testing.assert_allclose(gm["loss"].cpu().numpy(),
                                   cm["loss"].numpy(), rtol=1e-4)
        for a, b in zip(tree_flatten(g_fed.stacked)[0],
                        tree_flatten(c_fed.stacked)[0]):
            np.testing.assert_allclose(a.cpu().numpy(), b.numpy(),
                                       atol=1e-4)
        print(f"reference {mode}: card == CPU on P=3, width 0.25, 16x16, "
              f"2 rounds")


def bf16_atol(want, ulps):
    """`ulps` bf16 ulps of the largest magnitude in `want`."""
    return ulps * 2.0 ** (math.floor(math.log2(float(want.abs().max()))) - 7)


def lm_card_vs_cpu(dev):
    """Reduced qwen3 prefill and 4 decode steps, card (flash kernel,
    cuBLAS) against CPU (plain path); then a TINY_SERVE federation served
    on the card with a mid-traffic hot-swap, whose post-swap admissions
    must be token-identical to a fresh engine on the new params."""
    from repro_torch import models
    from repro_torch.configs import ARCHS, reduced
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.pytree import tree_map
    from repro_torch.serving import (
        FederatedServer, ModelStore, Request, ServeConfig, ServingEngine,
    )
    from repro_torch.serving.harness import LMFederation, TINY_SERVE

    cfg = reduced(ARCHS[LM_ARCH])
    params = models.init_params(cfg, torch.Generator().manual_seed(0))
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        1, cfg.vocab_size, (2, 77)).astype(np.int32))
    nxt = torch.from_numpy(np.random.default_rng(1).integers(
        1, cfg.vocab_size, (2, 4)).astype(np.int32))
    out = {}
    for where in ("cpu", dev):
        p = tree_map(lambda x: x.to(where), params)
        before = fa_kernel.flash_attention_bhsd.launches
        lg, st, _ = models.prefill(cfg, p, {"tokens": toks.to(where)}, 128)
        logits = [lg[:, -1]]
        for t in range(4):
            pos = torch.full((2,), 77 + t, dtype=torch.int32, device=where)
            d, st = models.decode_step(cfg, p, st, nxt[:, t].to(where), pos)
            logits.append(d)
        launched = fa_kernel.flash_attention_bhsd.launches - before
        assert launched == (0 if where == "cpu" else cfg.n_layers), launched
        out[str(where)] = [x.float().cpu() for x in logits]
    worst = 0.0
    for a, b in zip(out["cpu"], out[str(dev)]):
        # bf16 matmuls round in other places on cuBLAS than on the CPU:
        # held to 8 bf16 ulps of the largest logit
        atol = bf16_atol(a, 8)
        torch.testing.assert_close(b, a, atol=atol, rtol=0)
        worst = max(worst, float((a - b).abs().max()) / atol * 8)
    print(f"reference {LM_ARCH}-reduced: card == CPU on prefill (B=2, "
          f"S=77) + 4 decode steps, max |err| {worst:.2f} bf16 ulps of the "
          f"largest logit (bound 8)")

    fed = LMFederation(TINY_SERVE, 0, device=dev)
    fed.run_rounds(1)
    store = ModelStore()
    fed.publish(store)
    scfg = ServeConfig(max_seq_len=64, batch_size=2)
    srv = FederatedServer(TINY_SERVE, fed.overlay.registry, store, scfg,
                          device=dev)

    def submit(eng, uids):
        for i in uids:
            eng.submit(Request(uid=i, prompt=[3 + i, 5, 9 + (i % 3), 4],
                               max_new_tokens=6))
    submit(srv.engine, range(4))
    while srv.engine.tick < 3:
        srv.engine.step()
    fed.run_rounds(1)
    fed.publish(store)
    model = srv.refresh()
    assert model is not None
    submit(srv.engine, range(4, 7))
    done = {r.uid: r for r in srv.engine.run()}
    assert len(done) == 7 and srv.engine.swap_log[0]["applied_tick"] > 0
    after = sorted(u for u, r in done.items()
                   if r.params_version == model.version)
    fresh = ServingEngine(TINY_SERVE, model.params, scfg, device=dev)
    submit(fresh, after)
    want = {r.uid: r.generated for r in fresh.run()}
    assert all(done[u].generated == want[u] for u in after), (done, want)
    print(f"hot-swap on the card: {len(after)} post-swap requests "
          f"(uids {after}) token-identical to a fresh engine on round "
          f"#{model.version}; swap log {srv.engine.swap_log}")


# ----------------------------------------------------------------------
# the main paths at full width

def cnn_main_path(dev, kernels, fed_kwargs, totals):
    from repro_torch.chaos.harness import CNNFederation
    from repro_torch.pytree import tree_flatten
    for mode in MODES:
        fed = CNNFederation(None, 0, n_institutions=P_FULL, local_steps=2,
                            batch=8, image_size=64, width_scale=1.0,
                            device=dev, **fed_kwargs(mode))
        n_params = sum(x[0].numel() for x in tree_flatten(fed.stacked)[0])
        assert n_params == N_FULL, n_params
        fed.run_rounds(1)                     # warm-up (cuDNN plans)
        torch.cuda.synchronize()
        flush = Stopwatch(fed.overlay._flush)  # host time of the DLT flush
        fed.overlay._flush = flush
        for k in kernels.values():
            k["wrapper"].launches = 0
        t0 = time.perf_counter()
        metrics, trs = fed.run_rounds(ROUNDS)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / ROUNDS
        counts = {name: k["wrapper"].launches for name, k in kernels.items()}
        for name in counts:
            totals[name] += counts[name]
        loss = metrics["loss"]
        assert loss.shape == (ROUNDS, P_FULL), loss.shape
        assert bool(torch.isfinite(loss).all()), loss
        for x in tree_flatten(fed.stacked)[0]:
            assert bool(torch.isfinite(x).all())
        div = fed.divergence()
        if trs[-1].committed:
            assert div < 1e-3, div
        assert fed.overlay.registry.verify_log()
        want = {"float": ("masked_rolling_update",),
                "int": ("masked_field_wsum",),
                "dp": ("masked_rolling_update", "clip_noise")}[mode]
        for name in want:
            assert counts[name] == ROUNDS, (mode, counts)
        print(f"main path {mode}: {ms:.2f} ms/round "
              f"({flush.seconds * 1e3 / ROUNDS:.2f} of it the DLT flush on "
              f"the host) | loss "
              f"{[round(float(v), 4) for v in loss.mean(dim=1)]} | "
              f"committed {[t.committed for t in trs]} | divergence "
              f"{div:.3g} | launches {counts}")
        # where one round's time goes on the card (a profiled extra round)
        prof = {k: sum(v) / 1e3 for k, v in
                device_us(lambda i: fed.run_rounds(1), 1).items()}
        busy = sum(prof.values())
        top = sorted(prof.items(), key=lambda kv: -kv[1])[:5]
        print(f"  device busy {busy:.2f} ms of {ms:.2f} ms/round (idle "
              f"{1 - busy / ms:.1%}); top kernels: "
              + "; ".join(f"{key[:50]} {t:.3f} ms" for key, t in top))


def lm_requests(vocab):
    """N_REQUESTS greedy requests: prompt lengths uniform in [PROMPT_LO,
    PROMPT_HI], tokens uniform in [1, vocab), from a seeded numpy RNG."""
    from repro_torch.serving import Request
    rng = np.random.default_rng(0)
    lens = rng.integers(PROMPT_LO, PROMPT_HI + 1, N_REQUESTS)
    return [Request(uid=i, prompt=rng.integers(1, vocab, n).tolist(),
                    max_new_tokens=MAX_NEW) for i, n in enumerate(lens)]


def lm_main_path(dev, all_wrappers):
    """qwen3-0.6b at full width through the entry points a user calls:
    `LMFederation` (P = 3, 2 local steps, batch 4, seq 16, lr 0.1: the
    harness's defaults) runs one round and publishes; `FederatedServer`
    pulls the committed model through the provenance gate and serves 16
    greedy requests.  Every launch count is 0 at the start.  Returns the
    flash kernel's launches on this path."""
    from repro_torch import models
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.pytree import tree_flatten
    from repro_torch.serving import (
        FederatedServer, ModelStore, Request, ServeConfig, pull_latest_model,
    )
    from repro_torch.serving.harness import LMFederation

    cfg = get_config(LM_ARCH)
    scfg = ServeConfig(max_seq_len=2048, batch_size=8)
    for w in all_wrappers:
        w.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    fed = LMFederation(cfg, 0, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(x[0].numel() for x in tree_flatten(fed.stacked)[0])
    assert n_params == models.param_count(cfg), n_params
    flush = Stopwatch(fed.overlay._flush)
    fed.overlay._flush = flush
    t0 = time.perf_counter()
    metrics, trs = fed.run_rounds(1)
    torch.cuda.synchronize()
    round_ms = (time.perf_counter() - t0) * 1e3
    loss = metrics["loss"].float()
    assert bool(torch.isfinite(loss).all()), loss
    for x in tree_flatten(fed.stacked)[0]:
        assert bool(torch.isfinite(x).all())
    assert trs[0].committed and fed.overlay.registry.verify_log()
    train_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    store = ModelStore()
    t0 = time.perf_counter()
    fed.publish(store)
    publish_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    model = pull_latest_model(fed.overlay.registry, store,
                              arch_family=cfg.name)
    pull_ms = (time.perf_counter() - t0) * 1e3
    print(f"main path {LM_ARCH} train: init {init_s:.2f} s | 1 round "
          f"{round_ms:.2f} ms ({flush.seconds * 1e3:.2f} of it the DLT "
          f"flush: 4 fingerprints of 2.38 GB each on the host) | loss "
          f"{[round(float(x), 4) for x in loss[0]]} | publish "
          f"{publish_ms:.2f} ms | verified pull {pull_ms:.2f} ms (SHA-256 "
          f"over 2.38 GB, {model.parents_verified} parent proofs) | peak "
          f"device memory {train_peak:.2f} GiB")
    registry = fed.overlay.registry
    del fed, model
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()

    prefill = Stopwatch(models.prefill, check=lambda out: bool(
        torch.isfinite(out[0][:, -1]).all()))
    models.prefill = prefill        # the engine calls models.prefill
    try:
        t0 = time.perf_counter()
        srv = FederatedServer(cfg, registry, store, scfg,
                              arch_family=cfg.name, device=dev)
        torch.cuda.synchronize()
        server_ms = (time.perf_counter() - t0) * 1e3
        step = Stopwatch(srv.engine.step_fn,
                         check=lambda out: bool(torch.isfinite(out[0]).all()))
        srv.engine.step_fn = step
        reqs = lm_requests(cfg.vocab_size)
        for r in reqs:
            srv.engine.submit(r)
        t0 = time.perf_counter()
        done = srv.engine.run()
        torch.cuda.synchronize()
        serve_s = time.perf_counter() - t0
        launches = fa_kernel.flash_attention_bhsd.launches
        n_prefill = len(prefill.calls)
        assert len(done) == N_REQUESTS == n_prefill, (len(done), n_prefill)
        assert launches == cfg.n_layers * n_prefill, launches
        assert all(r.params_version == srv.model.version for r in done)
        prompt_toks = sum(len(r.prompt) for r in reqs)
        decode_toks = sum(len(r.generated) for r in done) - n_prefill
        ticks = len(step.calls)
        serve_peak = torch.cuda.max_memory_allocated() / 2 ** 30
        print(f"main path {LM_ARCH} serve: FederatedServer (verified pull "
              f"+ engine) {server_ms:.2f} ms | {N_REQUESTS} requests, "
              f"{prompt_toks} prompt tokens, {decode_toks} decoded tokens "
              f"in {serve_s:.2f} s | prefill {prompt_toks / prefill.seconds:.0f}"
              f" tokens/s ({prefill.seconds * 1e3:.1f} ms for {n_prefill} "
              f"prefills) | decode {step.seconds * 1e3 / ticks:.2f} ms per "
              f"tick of 8 slots, {decode_toks / step.seconds:.1f} tokens/s "
              f"({ticks} ticks) | flash launches {launches} = "
              f"{cfg.n_layers} x {n_prefill} prefills | peak device memory "
              f"{serve_peak:.2f} GiB")

    finally:
        models.prefill = prefill.fn
    srv.engine.step_fn = step.fn

    # where the serving time goes on the card: one batch of the same
    # requests (8 prefills, then 8 tokens each) served twice, once timed
    # on the host clock, once under the profiler tracing the card alone
    def serve_batch(i=0):
        for r in reqs[:scfg.batch_size]:
            srv.engine.submit(Request(uid=r.uid, prompt=r.prompt,
                                      max_new_tokens=8))
        srv.engine.run()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    serve_batch()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    prof = device_us(serve_batch, 1, host=False)
    per_kernel = {k: (sum(v) / 1e3, len(v)) for k, v in prof.items()}
    busy = sum(t for t, _ in per_kernel.values())
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1][0])[:8]
    print(f"  one batch again ({scfg.batch_size} prefills + 8 tokens "
          f"each): {wall_ms:.1f} ms on the host clock, device busy "
          f"{busy:.1f} ms (idle {1 - busy / wall_ms:.1%}), "
          f"{sum(n for _, n in per_kernel.values())} device activities; top:"
          + "; ".join(f" {key[:44]} {t:.1f} ms/{n}" for key, (t, n) in top))
    return launches


def time_flash(dev):
    """The flash kernel at qwen3's prefill shape (S = 1024, bf16, causal):
    profiler median over 101 launches cycling 8 input sets (67 MB, more
    than the L2), the plain version's and SDPA's time on the same sets."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention import ref as fa_ref
    B, S, Hq, Hkv, hd = FLASH_TIMED
    g = torch.Generator(dev).manual_seed(7)
    sets = [[torch.randn((B, S, h, hd), generator=g, device=dev).to(
        torch.bfloat16) for h in (Hq, Hkv, Hkv)] for _ in range(8)]
    bhsd = [[x.transpose(1, 2).contiguous() for x in st] for st in sets]

    def run(x):
        return fa_ops.flash_attention(*x, causal=True)

    def plain(x):
        return fa_ref.attention_reference(*(t.transpose(1, 2) for t in x),
                                          causal=True)

    def library(x):
        return F.scaled_dot_product_attention(*x, is_causal=True,
                                              enable_gqa=True)
    launch_ms = cuda_ms(run, sets, 100)
    p_ms = cuda_ms(plain, sets, 10)
    prof = device_us(lambda i: run(sets[i % 8]), 101)
    mine = [us for key, v in prof.items() if "flash_attention_kernel" in key
            for us in v]
    assert len(mine) == 101, (len(mine), list(prof))
    k_ms = float(np.median(mine)) / 1e3
    library(bhsd[0])
    torch.cuda.synchronize()
    lib = device_us(lambda i: library(bhsd[i % 8]), 101)
    lib_ms = sum(sum(v) for v in lib.values()) / 101 / 1e3
    bytes_ms, ops_ms = flash_bound(B, S, Hq, Hkv, hd)
    b_ms = max(bytes_ms, ops_ms)
    b_by = "bytes" if bytes_ms >= ops_ms else "operations"
    flops = 4 * hd * B * Hq * S * (S + 1) / 2
    print(f"time flash_attention_bhsd {FLASH_TIMED} bf16 causal: kernel "
          f"median {k_ms * 1e3:.1f} us on the card ({flops / k_ms / 1e9:.1f}"
          f" TFLOP/s; {launch_ms * 1e3:.1f} us per call back to back, host "
          f"launch included) | plain {p_ms * 1e3:.1f} us | SDPA "
          f"{lib_ms * 1e3:.1f} us ({', '.join(k[:40] for k in lib)}) | "
          f"bound {b_ms * 1e3:.2f} us by {b_by} (bytes {bytes_ms * 1e3:.2f} "
          f"us, operations {ops_ms * 1e3:.2f} us); kernel at "
          f"{b_ms / k_ms:.2%} of bound")
    return k_ms, p_ms, b_ms, b_by, lib_ms


def time_secure_agg(dev, kernels, totals):
    from repro_torch.kernels.dp import kernel as dp_kernel
    from repro_torch.kernels.dp import ref as dp_ref
    n_buf = 12        # 12 x (10, 109634) f32 = 53 MB of inputs
    bufs = [torch.randn((P_FULL, N_FULL), device=dev) for _ in range(n_buf)]
    rows = []
    for name, k in kernels.items():
        if name == "clip_noise":
            norms = {id(b): dp_ref._row_norms(b) for b in bufs}
            run = lambda u: dp_kernel.clip_noise_flat(   # noqa: E731
                u, norms[id(u)], 7, 0.5, 1.0)
            plain = lambda u: dp_ref.clip_noise_reference(   # noqa: E731
                u, 7, 0.5, 1.0, None, norms[id(u)])
        else:
            run = lambda u, k=k: k["run"](u, None)          # noqa: E731
            plain = lambda u, k=k: k["plain"](u, None)      # noqa: E731
        launch_ms = cuda_ms(run, bufs, 300)
        p_ms = cuda_ms(plain, bufs, 12)
        prof = device_us(lambda i: run(bufs[i % n_buf]), 101)
        mine = [us for key, v in prof.items() if f"{name}_kernel" in key
                for us in v]
        assert len(mine) == 101, (len(mine), list(prof))
        k_ms = float(np.median(mine)) / 1e3
        bytes_ms, ops_ms = bound(name, P_FULL, N_FULL, P_FULL)
        b_ms = max(bytes_ms, ops_ms)
        b_by = "bytes" if bytes_ms >= ops_ms else "operations"
        print(f"time {name}: kernel median {k_ms * 1e3:.2f} us on the card "
              f"({launch_ms * 1e3:.2f} us per call back to back, host "
              f"launch included) | plain {p_ms * 1e3:.1f} us | bound "
              f"{b_ms * 1e3:.2f} us by {b_by} (bytes {bytes_ms * 1e3:.2f} "
              f"us, operations {ops_ms * 1e3:.2f} us); kernel at "
              f"{b_ms / k_ms:.1%} of bound")
        rows.append({"name": name, "route": "cuda", "source": k["source"],
                     "replaces": k["replaces"], "launches": totals[name],
                     "max_abs_err": k["max_abs_err"], "ms": k_ms,
                     "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by,
                     "library_ms": None})
    return rows


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _cuda
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.privacy.accountant import DPConfig

    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"torch {torch.__version__} cuda {torch.version.cuda} | {smi}")
    print(f"tf32 as the process has it: cudnn.allow_tf32="
          f"{torch.backends.cudnn.allow_tf32} matmul.allow_tf32="
          f"{torch.backends.cuda.matmul.allow_tf32} (left as they are; "
          f"the federation's local step turns both off inside itself)")
    t_start = time.perf_counter()

    # ---- build: one nvcc per source, all started together -------------
    built = _cuda.build_all()
    for name, (path, secs) in built.items():
        _cuda.library(name)
        print(f"build {name}.cu: {path.name} in {secs:.1f} s")
    print_resource_usage(built["secure_agg"][0], "Li10E")    # P = 10
    print_resource_usage(built["flash_attention"][0], "Li128E")  # hd 128

    # ---- each kernel against its plain version -----------------------
    kernels = secure_agg_kernels(dev)
    check_secure_agg(kernels, dev)
    flash_err = check_flash(dev)

    # ---- the card against the CPU, small -----------------------------
    def fed_kwargs(mode):
        return dict(secure_domain="int" if mode == "int" else "float",
                    dp=DPConfig(clip_norm=0.5, noise_multiplier=1.0)
                    if mode == "dp" else None)
    cnn_card_vs_cpu(dev, fed_kwargs)
    lm_card_vs_cpu(dev)

    # ---- the main paths: full width, counts from 0 -------------------
    wrappers = [k["wrapper"] for k in kernels.values()] + [
        fa_kernel.flash_attention_bhsd]
    totals = {name: 0 for name in kernels}
    cnn_main_path(dev, kernels, fed_kwargs, totals)
    for name, n in totals.items():
        assert n > 0, f"{name} never launched on the main path"

    # ---- timing at the main paths' shapes ----------------------------
    rows = time_secure_agg(dev, kernels, totals)
    k_ms, p_ms, b_ms, b_by, lib_ms = time_flash(dev)

    flash_launches = lm_main_path(dev, wrappers)
    assert flash_launches > 0, "flash_attention_bhsd never launched"
    rows.append({"name": "flash_attention_bhsd", "route": "cuda",
                 "source": "src/repro_torch/csrc/flash_attention.cu",
                 "replaces": "src/repro/kernels/flash_attention/kernel.py:75",
                 "launches": flash_launches, "max_abs_err": flash_err,
                 "ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms,
                 "bound_by": b_by, "library_ms": lib_ms})
    assert all(math.isfinite(r["ms"]) and r["ms"] > 0 for r in rows)
    print(f"smoke took {time.perf_counter() - t_start:.1f} s after start-up")

    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
