#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels (``src/repro_torch/csrc/secure_agg.cu``,
for sm_90a) from this checkout, holds each kernel against its plain
PyTorch version on the card, then drives the paper's federation round
(``repro_torch.chaos.harness.CNNFederation.run_rounds``) at full width:
P = 10 hospitals, the STIGMA CNN at width 1.0 on 64x64 frames (N = 109,634
parameters per hospital), 3 rounds of secure_mean in the float domain, the
int domain and the float domain with DP.  Every kernel's launch count must
rise during that run, and a small federation on the card must agree with
the same federation on the CPU.  Prints each kernel's time beside its
bound and its plain version's time, then a JSON line of kernels, the
card's name and power limit, and as the last line
``{"ok": true, "device": {...}}``.  Exits non-zero, printing no result,
without a CUDA device or outside the repository.

The script leaves PyTorch's TF32 settings at their defaults, as a user
has them: the port's local step computes in IEEE float32 by itself.
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

# H100 SXM rates.  HBM bytes/s and float32 ops/s (an add or a multiply is
# one op) from NVIDIA's data sheet.  Per-pipe rates from the CUDA C++
# Programming Guide's throughput table for compute capability 9.0, in
# results per clock per SM, x 132 SMs x the 1,980 MHz boost clock: int32
# shifts and logic run on the INT32 pipe (64), int32 multiplies on the
# FMA pipe (64), int32 adds on either; conversions (16) and the special
# functions log / sqrt / cos (16) are counted against their own rate.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
PER_CLOCK = 132 * 1.98e9
ALU_OPS_PER_S = IMAD_OPS_PER_S = 64 * PER_CLOCK
CVT_OPS_PER_S = SFU_OPS_PER_S = 16 * PER_CLOCK

P_FULL, N_FULL, N_RAGGED = 10, 109_634, 4_097
ROUNDS = 3
MODES = ("float", "int", "dp")


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


def device_us(fn, iters):
    """{kernel name: [device us of each launch]} over `iters` calls of
    fn(i), from torch.profiler's CUDA activity: the kernels' own time on
    the card, without the host's launch gaps."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for i in range(iters):
            fn(i)
        torch.cuda.synchronize()
    out = {}
    for e in prof.events():
        if str(e.device_type).endswith("CUDA"):
            out.setdefault(e.name, []).append(e.time_range.elapsed_us())
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.chaos.harness import CNNFederation
    from repro_torch.pytree import tree_flatten
    from repro_torch.kernels import _cuda
    from repro_torch.kernels.dp import kernel as dp_kernel
    from repro_torch.kernels.dp import ref as dp_ref
    from repro_torch.kernels.secure_agg import kernel as agg_kernel
    from repro_torch.kernels.secure_agg import ref as agg_ref
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

    # ---- build -------------------------------------------------------
    t0 = time.perf_counter()
    lib_path = _cuda.build()
    _cuda.library()
    print(f"build: {lib_path.name} in {time.perf_counter() - t0:.1f} s")
    cuobjdump = shutil.which("cuobjdump") or str(
        Path(_cuda._nvcc()).with_name("cuobjdump"))
    if Path(cuobjdump).exists():   # registers, spills: the P = 10 kernels
        usage = subprocess.run([cuobjdump, "--dump-resource-usage",
                                str(lib_path)], capture_output=True,
                               text=True)
        lines = usage.stdout.splitlines()
        for name, counts in zip(lines, lines[1:]):   # "Function f:", "REG:"
            if "Function" in name and "Li10E" in name:
                print(f"  {name.strip()} {counts.strip()}")

    # ---- each kernel against its plain version -----------------------
    kernels = {
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

    # ---- the card against the CPU on a small federation --------------
    def fed_kwargs(mode):
        return dict(secure_domain="int" if mode == "int" else "float",
                    dp=DPConfig(clip_norm=0.5, noise_multiplier=1.0)
                    if mode == "dp" else None)

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

    # ---- the main path: full width, 3 rounds per mode ----------------
    totals = {name: 0 for name in kernels}
    for mode in MODES:
        fed = CNNFederation(None, 0, n_institutions=P_FULL, local_steps=2,
                            batch=8, image_size=64, width_scale=1.0,
                            device=dev, **fed_kwargs(mode))
        n_params = sum(x[0].numel() for x in tree_flatten(fed.stacked)[0])
        assert n_params == N_FULL, n_params
        fed.run_rounds(1)                     # warm-up (cuDNN plans)
        torch.cuda.synchronize()
        flush_s = []                          # host time of the DLT flush
        flush = fed.overlay._flush

        def timed_flush(rounds, flush=flush, flush_s=flush_s):
            t = time.perf_counter()
            flush(rounds)
            flush_s.append(time.perf_counter() - t)
        fed.overlay._flush = timed_flush
        for k in kernels.values():
            k["wrapper"].launches = 0
        t0 = time.perf_counter()
        metrics, trs = fed.run_rounds(ROUNDS)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / ROUNDS
        flush_ms = sum(flush_s) * 1e3 / ROUNDS
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
        print(f"main path {mode}: {ms:.2f} ms/round ({flush_ms:.2f} of it "
              f"the DLT flush on the host) | loss "
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
    for name, n in totals.items():
        assert n > 0, f"{name} never launched on the main path"

    # ---- timing at the main path's shape ------------------------------
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
        assert len(mine) == 101, list(prof)
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
    assert all(math.isfinite(r["ms"]) and r["ms"] > 0 for r in rows)

    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
