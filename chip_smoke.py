#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py                 # the smoke run
    python3 chip_smoke.py --depth-probe   # the recurrent paths' depth cut

Builds the port's CUDA kernels from this checkout (each
``src/repro_torch/csrc/*.cu`` into its own library for sm_90a, one nvcc
per source, all started together), holds each kernel against its plain
PyTorch version on the card, then drives the port's paths at full width,
each with every launch count set to 0 just before it and read just
after:

* the paper's federation round (``CNNFederation.run_rounds``): P = 10
  hospitals, the STIGMA CNN at width 1.0 on 64x64 frames (N = 109,634
  parameters per hospital), 3 rounds of secure_mean in the float domain,
  the int domain and the float domain with DP;
* the same federation for 6 rounds under fault and attack schedules
  (churn, quorum loss and partition in the float and int domains, 30%
  dropout with DP, 30% sign-flip and label-flip attackers): the survivor
  masks reach the masked kernels, and a round that did not commit leaves
  every institution's params bit-untouched;
* the legacy two-stage MPC round (``core.secure_agg
  .secure_rolling_update``: masks drawn on the card, shares materialized,
  one aggregate kernel) in both domains, at P = 10 on the CNN's N and at
  P = 3 on qwen3-0.6b's 596,049,920 parameters, timed beside the fused
  round on the same (P, N);
* the federated LM serving path (train -> registry -> verified pull ->
  serve) for three families, each at its published width with random
  weights from a seed: an ``LMFederation`` runs one round and publishes,
  a ``FederatedServer`` pulls the committed model through the ledger's
  provenance gate and serves 16 greedy requests of 64-1024 prompt tokens:
  - qwen3-0.6b (28 layers, 596,049,920 parameters): prefill attention
    through the flash-attention kernel;
  - rwkv6-3b, cut from 32 to 12 layers: prefill and decode through the
    WKV6 kernel;
  - hymba-1.5b, cut from 32 to 17 layers: prefill attention through the
    flash kernel, the mamba branch's scan through the selective-scan
    kernel in prefill and decode.
  The recurrent families' depth is the largest whose training round
  peaks below 70 GiB on the 80 GB card; ``--depth-probe`` measures the
  round's peak depth by depth up to the first that reaches it.

Before the full-width paths, small runs on the card are held against the
same runs on the CPU, and a mid-traffic hot-swap is checked for identity
with a fresh engine (dense and rwkv6).  Prints each kernel's time beside
its bound, its plain version's time and a PyTorch library call's time
where one exists, then a JSON line of kernels, the card's name and power
limit, and as the last line ``{"ok": true, "device": {...}}``.  Exits
non-zero, printing no result, without a CUDA device or outside the
repository.

The script leaves PyTorch's TF32 settings at their defaults, as a user
has them: the CNN's local step computes in IEEE float32 by itself, and the
LMs compute in bf16 (hymba's scan inputs in fp32).
"""
import gc
import json
import math
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

# the recurrent paths train within a few GiB of the card's capacity:
# segments that grow in place keep the allocator's fragmentation from
# adding gigabytes on top of the peak (set before CUDA starts)
os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")

import numpy as np  # noqa: E402
import torch  # noqa: E402

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
FLASH_CASES.append(
    (1, 1152, 25, 5, 64, torch.bfloat16, True, 1024))  # hymba's prefill
FLASH_TOL = {torch.bfloat16: 2e-2, torch.float32: 2e-5}
FLASH_TIMED = (1, 1024, 16, 8, 128)       # qwen3's prefill at S = 1024
# WKV6 on the card vs its plain version: (B, T, H, hd, r/k/v dtype,
# w dtype, nonzero s0, strided input)
WKV6_CASES = [
    (1, 1000, 40, 64, torch.bfloat16, torch.float32, False, False),  # rwkv6
    (8, 1, 40, 64, torch.bfloat16, torch.float32, True, False),  # decode
    (2, 77, 4, 32, torch.float32, torch.float32, True, False),
    (2, 40, 3, 16, torch.bfloat16, torch.bfloat16, True, False),
    (1, 33, 2, 128, torch.float32, torch.float32, True, False),
    (2, 50, 4, 64, torch.bfloat16, torch.float32, True, True),
]
WKV6_TIMED = (1, 1024, 40, 64)            # rwkv6-3b's prefill at T = 1024
# the selective scan on the card vs its plain version: (Bz, T, di, N,
# dtype, nonzero h0)
SSM_CASES = [
    (1, 1152, 3200, 16, torch.float32, False),    # hymba's prefill
    (8, 1, 3200, 16, torch.float32, True),        # decode
    (2, 100, 1001, 16, torch.float32, True),      # ragged di
    (2, 70, 515, 8, torch.bfloat16, True),
    (1, 37, 96, 5, torch.float32, True),
]
SSM_TIMED = (1, 1152, 3200, 16)           # hymba-1.5b's prefill, 1024 + 128
# kernel vs plain: bf16 y within the flash kernel's 2e-2 (atol = rtol);
# fp32 y and the fp32 states within 1e-4 of the largest magnitude (the
# kernels sum in another order than the plain versions)
REC_TOL_BF16, REC_TOL_F32 = 2e-2, 1e-4
# the LM main paths: harness defaults, 16 greedy requests each
N_REQUESTS, MAX_NEW, PROMPT_LO, PROMPT_HI = 16, 32, 64, 1024
# (arch, depth, lr): published widths; the recurrent families' depth is
# cut to the largest whose training round peaks below 70 GiB on one 80 GB
# card (`python3 chip_smoke.py --depth-probe` measures the round's peak
# depth by depth).  lr is the harness's 0.1 but for rwkv6, whose first
# token is ill-conditioned (its WKV output is a sum of products with the
# bonus u near 0, which the group norm scales up by up to 316x,
# compounded over the layers, in the reference as in the port): at 0.1
# one round leaves non-finite params at this depth, and at 1e-6 its
# largest step is the size of hymba's at 0.1 (`--depth-probe` prints
# both)
LM_PATHS = [("qwen3-0.6b", 28, 0.1), ("rwkv6-3b", 12, 1e-6),
            ("hymba-1.5b", 17, 0.1)]
TRAIN_PEAK_LIMIT_GIB = 70.0
# the LM kernels' sources and the TPU kernels they replace
# the legacy two-stage round (slice 4): kernel checks at every P and N
# here, params in f32 / bf16 / f16; one ulp of the output type as rtol
LEGACY_CHECK_P = (1, 2, 3, 10, 17)
LEGACY_CHECK_N = (1, 3, 1000, 4097, N_FULL)
LEGACY_ULP = {torch.float32: 0.0, torch.bfloat16: 2.0 ** -7,
              torch.float16: 2.0 ** -10}
# the legacy round's (P, N): the paper CNN's federation, and the LM
# federation's P = 3 at qwen3-0.6b's parameter count (the kernels' timed
# shape)
LEGACY_POINTS = [(P_FULL, N_FULL), (3, 596_049_920)]
# the fault and attack path at full width: (scenario, mode)
FAULT_ROUNDS = 6
FAULT_RUNS = [("churn", "float"), ("churn", "int"),
              ("quorum_loss", "float"), ("quorum_loss", "int"),
              ("quorum_loss_p10", "float"),
              ("partition", "float"), ("partition", "int"),
              ("dropout30", "dp"), ("sign_flip_30", "float"),
              ("label_flip_30", "float")]
LM_KERNEL_SOURCES = {
    "flash_attention_bhsd": ("src/repro_torch/csrc/flash_attention.cu",
                             "src/repro/kernels/flash_attention/kernel.py:75"),
    "wkv6_bthd": ("src/repro_torch/csrc/wkv6.cu",
                  "src/repro/kernels/rwkv6_scan/kernel.py:62"),
    "ssm_scan_btd": ("src/repro_torch/csrc/ssm_scan.cu",
                     "src/repro/kernels/ssm_scan/kernel.py:56"),
}


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


def wkv6_bound(B, T, H, hd, itemsize=2, w_itemsize=4):
    """(bytes_ms, ops_ms) of WKV6: r, k, v, w read and y written once, u
    and the two states moved once; 7 fp32 operations per state element
    and token (k·v, u·kv, S + u·kv, · r, the sum over i, w·S, + kv)."""
    n = B * T * H * hd
    nbytes = (n * (4 * itemsize + w_itemsize) + H * hd * 4
              + 2 * B * H * hd * hd * 4)
    return (nbytes / HBM_BYTES_PER_S * 1e3,
            7 * n * hd / FP32_OPS_PER_S * 1e3)


def ssm_bound(Bz, T, di, N, itemsize=4):
    """(bytes_ms, ops_ms) of the selective scan: a, bx, B, C read and y
    written once, h0 and h_last moved once; 5 operations per (t, c, n)
    (a·h, bx·B, their sum, ·C, the sum over n)."""
    nbytes = Bz * T * (3 * di + 2 * N) * itemsize + 2 * Bz * di * N * 4
    return (nbytes / HBM_BYTES_PER_S * 1e3,
            5 * Bz * T * di * N / FP32_OPS_PER_S * 1e3)


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


def kernel_median_ms(fn, iters, tag):
    """Median device ms of one launch of the kernel whose name holds
    `tag`: fn(i) is called iters + 1 times under torch.profiler's CUDA
    activity, the first call a lead-in, and the median is taken over the
    last `iters` launches the trace recorded, in start order.  Late in a
    long process the trace can miss the first launch of its window (seen
    on the card: one of 101); the lead-in absorbs it, and a trace that
    recorded fewer than `iters` launches fails the run."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for i in range(iters + 1):
            fn(i)
        torch.cuda.synchronize()
    mine = sorted((e.time_range.start, e.time_range.elapsed_us())
                  for e in prof.events()
                  if str(e.device_type).endswith("CUDA") and tag in e.name)
    assert len(mine) >= iters, (tag, len(mine), iters + 1)
    return float(np.median([us for _, us in mine[-iters:]])) / 1e3


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


def rel_err(got, want):
    """max |got - want| / max |want|, in fp32."""
    got, want = got.float(), want.float()
    return float((got - want).abs().max() / want.abs().max().clamp(
        min=1e-30))


def check_recurrent_y(name, got, want, dtype):
    """y in bf16 within 2e-2 (atol = rtol), y in fp32 within 1e-4 of the
    largest magnitude; returns max |err|."""
    if dtype == torch.bfloat16:
        torch.testing.assert_close(got.float(), want.float(),
                                   atol=REC_TOL_BF16, rtol=REC_TOL_BF16)
    else:
        assert rel_err(got, want) <= REC_TOL_F32, (name, rel_err(got, want))
    return float((got.float() - want.float()).abs().max())


def check_wkv6(dev):
    """The WKV6 kernel against its plain version on every listed shape;
    returns the largest |err| of y."""
    from repro_torch.kernels.rwkv6_scan import kernel as wkv_kernel
    from repro_torch.kernels.rwkv6_scan import ref as wkv_ref
    worst = 0.0
    for i, (B, T, H, hd, dtype, wdtype, s0_nz, strided) in enumerate(
            WKV6_CASES):
        g = torch.Generator(dev).manual_seed(100 + i)

        def randn(*shape):
            return torch.randn(shape, generator=g, device=dev)
        if strided:     # r through a (B, H, T, hd) layout, v every 2nd head
            r = randn(B, H, T, hd).to(dtype).transpose(1, 2)
            v = randn(B, T, 2 * H, hd).to(dtype)[:, :, ::2]
        else:
            r, v = randn(B, T, H, hd).to(dtype), randn(B, T, H, hd).to(dtype)
        k = randn(B, T, H, hd).to(dtype)
        w = torch.exp(-torch.exp(randn(B, T, H, hd) - 1.0)).to(wdtype)
        u = randn(H, hd) * 0.1
        s0 = randn(B, H, hd, hd) * 0.5 if s0_nz else torch.zeros(
            (B, H, hd, hd), device=dev)
        before = wkv_kernel.wkv6_bthd.launches
        y, s = wkv_kernel.wkv6_bthd(r, k, v, w, u, s0)
        torch.cuda.synchronize()
        assert wkv_kernel.wkv6_bthd.launches == before + 1
        y_ref, s_ref = wkv_ref.wkv6_reference(r, k, v, w, u, s0)
        assert y.dtype == dtype and s.dtype == torch.float32
        err = check_recurrent_y("wkv6", y, y_ref, dtype)
        assert rel_err(s, s_ref) <= REC_TOL_F32, rel_err(s, s_ref)
        worst = max(worst, err)
        print(f"check wkv6_bthd (B,T,H,hd)={(B, T, H, hd)} "
              f"{str(dtype)[6:]}/w {str(wdtype)[6:]} "
              f"s0={'randn' if s0_nz else 0}"
              f"{' strided' if strided else ''}: y max |err| {err:.3g} "
              f"(rel {rel_err(y, y_ref):.3g}), state rel err "
              f"{rel_err(s, s_ref):.3g}")
    return worst


def check_ssm(dev):
    """The selective-scan kernel against its plain version on every
    listed shape; returns the largest |err| of y."""
    from repro_torch.kernels.ssm_scan import kernel as ssm_kernel
    from repro_torch.kernels.ssm_scan import ref as ssm_ref
    worst = 0.0
    for i, (Bz, T, di, N, dtype, h0_nz) in enumerate(SSM_CASES):
        g = torch.Generator(dev).manual_seed(200 + i)

        def randn(*shape):
            return torch.randn(shape, generator=g, device=dev)
        a = torch.sigmoid(randn(Bz, T, di) + 2.0).to(dtype)
        bx = randn(Bz, T, di).to(dtype)
        Bm, Cm = randn(Bz, T, N).to(dtype), randn(Bz, T, N).to(dtype)
        h0 = randn(Bz, di, N) if h0_nz else torch.zeros((Bz, di, N),
                                                        device=dev)
        before = ssm_kernel.ssm_scan_btd.launches
        y, h = ssm_kernel.ssm_scan_btd(a, bx, Bm, Cm, h0)
        torch.cuda.synchronize()
        assert ssm_kernel.ssm_scan_btd.launches == before + 1
        y_ref, h_ref = ssm_ref.ssm_scan_reference(a, bx, Bm, Cm, h0)
        assert y.dtype == dtype and h.dtype == torch.float32
        err = check_recurrent_y("ssm_scan", y, y_ref, dtype)
        assert rel_err(h, h_ref) <= REC_TOL_F32, rel_err(h, h_ref)
        worst = max(worst, err)
        print(f"check ssm_scan_btd (Bz,T,di,N)={(Bz, T, di, N)} "
              f"{str(dtype)[6:]} h0={'randn' if h0_nz else 0}: y max |err| "
              f"{err:.3g} (rel {rel_err(y, y_ref):.3g}), state rel err "
              f"{rel_err(h, h_ref):.3g}")
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


def kernel_wrappers():
    """{name: wrapper} of the kernels the LM paths launch."""
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.kernels.rwkv6_scan import kernel as wkv_kernel
    from repro_torch.kernels.ssm_scan import kernel as ssm_kernel
    return {"flash_attention_bhsd": fa_kernel.flash_attention_bhsd,
            "wkv6_bthd": wkv_kernel.wkv6_bthd,
            "ssm_scan_btd": ssm_kernel.ssm_scan_btd}


def expected_launches(cfg, prefills, ticks):
    """The launches of each LM kernel that `prefills` prefills and
    `ticks` decode steps of `cfg` must make: prefill attention goes
    through the flash kernel, each recurrence through its kernel in
    prefill and decode alike; decode attention is plain code."""
    L = cfg.n_layers
    return {"flash_attention_bhsd": L * prefills if cfg.family != "ssm"
            else 0,
            "wkv6_bthd": L * (prefills + ticks) if cfg.family == "ssm"
            else 0,
            "ssm_scan_btd": L * (prefills + ticks)
            if cfg.family == "hybrid" else 0}


def lm_card_vs_cpu(dev, arch):
    """Reduced `arch` prefill and 4 decode steps, card (the kernels,
    cuBLAS) against CPU (plain path), with the same params and tokens."""
    from repro_torch import models
    from repro_torch.configs import ARCHS, reduced
    from repro_torch.pytree import tree_map

    cfg = reduced(ARCHS[arch])
    wrappers = kernel_wrappers()
    params = models.init_params(cfg, torch.Generator().manual_seed(0))
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        1, cfg.vocab_size, (2, 77)).astype(np.int32))
    nxt = torch.from_numpy(np.random.default_rng(1).integers(
        1, cfg.vocab_size, (2, 4)).astype(np.int32))
    out = {}
    for where in ("cpu", dev):
        p = tree_map(lambda x: x.to(where), params)
        before = {k: w.launches for k, w in wrappers.items()}
        lg, st, _ = models.prefill(cfg, p, {"tokens": toks.to(where)}, 128)
        logits = [lg[:, -1]]
        for t in range(4):
            pos = torch.full((2,), 77 + t, dtype=torch.int32, device=where)
            d, st = models.decode_step(cfg, p, st, nxt[:, t].to(where), pos)
            logits.append(d)
        launched = {k: w.launches - before[k] for k, w in wrappers.items()}
        want = (dict.fromkeys(wrappers, 0) if where == "cpu"
                else expected_launches(cfg, 1, 4))
        assert launched == want, (arch, where, launched, want)
        out[str(where)] = [x.float().cpu() for x in logits]
    worst = 0.0
    for a, b in zip(out["cpu"], out[str(dev)]):
        # bf16 matmuls round in other places on cuBLAS than on the CPU,
        # and the kernels sum in another order: held to 8 bf16 ulps of
        # the largest logit
        atol = bf16_atol(a, 8)
        torch.testing.assert_close(b, a, atol=atol, rtol=0)
        worst = max(worst, float((a - b).abs().max()) / atol * 8)
    print(f"reference {arch}-reduced: card == CPU on prefill (B=2, S=77) + "
          f"4 decode steps, max |err| {worst:.2f} bf16 ulps of the largest "
          f"logit (bound 8); card launches {expected_launches(cfg, 1, 4)}")


def hot_swap_on_card(dev, cfg):
    """A small federation of `cfg` served on the card with a mid-traffic
    hot-swap, whose post-swap admissions must be token-identical to a
    fresh engine on the new params."""
    from repro_torch.serving import (
        FederatedServer, ModelStore, Request, ServeConfig, ServingEngine,
    )
    from repro_torch.serving.harness import LMFederation

    fed = LMFederation(cfg, 0, device=dev)
    fed.run_rounds(1)
    store = ModelStore()
    fed.publish(store)
    scfg = ServeConfig(max_seq_len=64, batch_size=2)
    srv = FederatedServer(cfg, fed.overlay.registry, store, scfg,
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
    fresh = ServingEngine(cfg, model.params, scfg, device=dev)
    submit(fresh, after)
    want = {r.uid: r.generated for r in fresh.run()}
    assert all(done[u].generated == want[u] for u in after), (done, want)
    print(f"hot-swap on the card ({cfg.name}): {len(after)} post-swap "
          f"requests (uids {after}) token-identical to a fresh engine on "
          f"round #{model.version}; swap log {srv.engine.swap_log}")


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


def lm_main_path(dev, arch, n_layers, lr, all_wrappers):
    """`arch` at its published width, cut to `n_layers`, through the entry
    points a user calls: `LMFederation` (P = 3, 2 local steps, batch 4,
    seq 16: the harness's defaults; learning rate `lr`) runs one round
    and publishes;
    `FederatedServer` pulls the committed model through the provenance
    gate and serves 16 greedy requests.  Every launch count is 0 at the
    start.  Returns {LM kernel: its launches on this path}."""
    import dataclasses
    from repro_torch import models
    from repro_torch.configs import get_config
    from repro_torch.pytree import tree_flatten
    from repro_torch.serving import (
        FederatedServer, ModelStore, Request, ServeConfig, pull_latest_model,
    )
    from repro_torch.serving.harness import LMFederation

    full = get_config(arch)
    cfg = dataclasses.replace(full, n_layers=n_layers)
    cut = ("" if n_layers == full.n_layers else
           f", cut from {full.n_layers} layers (published widths)")
    scfg = ServeConfig(max_seq_len=2048, batch_size=8)
    wrappers = kernel_wrappers()
    for w in all_wrappers:
        w.launches = 0
    gc.collect()
    torch.cuda.empty_cache()
    assert torch.cuda.memory_allocated() < 2 ** 30, "memory left over"
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    fed = LMFederation(cfg, 0, lr=lr, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(x[0].numel() for x in tree_flatten(fed.stacked)[0])
    assert n_params == models.param_count(cfg), n_params
    gb = n_params * 4 / 1e9
    flush = Stopwatch(fed.overlay._flush)
    fed.overlay._flush = flush
    t0 = time.perf_counter()
    metrics, trs = fed.run_rounds(1)
    torch.cuda.synchronize()
    round_ms = (time.perf_counter() - t0) * 1e3
    loss = metrics["loss"].float()
    assert bool(torch.isfinite(loss).all()), loss
    assert all(bool(torch.isfinite(x).all())
               for x in tree_flatten(fed.stacked)[0])
    assert trs[0].committed and fed.overlay.registry.verify_log()
    train_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    assert train_peak < TRAIN_PEAK_LIMIT_GIB, train_peak
    store = ModelStore()
    t0 = time.perf_counter()
    fed.publish(store)
    publish_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    model = pull_latest_model(fed.overlay.registry, store,
                              arch_family=cfg.name)
    pull_ms = (time.perf_counter() - t0) * 1e3
    print(f"main path {arch} train: {n_layers} layers{cut}, {n_params:,} "
          f"parameters | init {init_s:.2f} s | 1 round (lr {lr:g}) "
          f"{round_ms:.2f} ms ({flush.seconds * 1e3:.2f} of it the DLT "
          f"flush: 4 fingerprints of {gb:.2f} GB each on the host) | loss "
          f"{[round(float(x), 4) for x in loss[0]]} | publish "
          f"{publish_ms:.2f} ms | verified pull {pull_ms:.2f} ms (SHA-256 "
          f"over {gb:.2f} GB, {model.parents_verified} parent proofs) | peak "
          f"device memory {train_peak:.2f} GiB")
    registry = fed.overlay.registry
    del fed, model
    gc.collect()
    torch.cuda.empty_cache()
    assert torch.cuda.memory_allocated() < 2 ** 30, "training left over"
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
        resident = torch.cuda.memory_allocated() / 2 ** 30
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
        launches = {k: w.launches for k, w in wrappers.items()}
        n_prefill, ticks = len(prefill.calls), len(step.calls)
        assert len(done) == N_REQUESTS == n_prefill, (len(done), n_prefill)
        want = expected_launches(cfg, n_prefill, ticks)
        assert launches == want, (arch, launches, want)
        assert all(r.params_version == srv.model.version for r in done)
        prompt_toks = sum(len(r.prompt) for r in reqs)
        decode_toks = sum(len(r.generated) for r in done) - n_prefill
        serve_peak = torch.cuda.max_memory_allocated() / 2 ** 30
        print(f"main path {arch} serve: FederatedServer (verified pull "
              f"+ engine) {server_ms:.2f} ms | {N_REQUESTS} requests, "
              f"{prompt_toks} prompt tokens, {decode_toks} decoded tokens "
              f"in {serve_s:.2f} s | prefill "
              f"{prompt_toks / prefill.seconds:.0f} tokens/s "
              f"({prefill.seconds * 1e3:.1f} ms for {n_prefill} "
              f"prefills) | decode {step.seconds * 1e3 / ticks:.2f} ms per "
              f"tick of 8 slots, {decode_toks / step.seconds:.1f} tokens/s "
              f"({ticks} ticks) | launches "
              + ", ".join(f"{k} {v}" for k, v in launches.items() if v)
              + f" ({n_layers} layers x {n_prefill} prefills"
              + (f" + {ticks} ticks" if cfg.family != "dense" else "")
              + f") | peak device memory {serve_peak:.2f} GiB ({resident:.2f} "
              f"GiB resident: params and decode state)")

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
    del srv
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def train_round(dev, cfg, lr, steps=False):
    """One `LMFederation` round of `cfg` (the harness's defaults but `lr`;
    the DLT flush left out, it runs on the host): its peak device memory
    in GiB and, with `steps`, whether every param stayed finite and the
    largest change of one param of institution 0."""
    from repro_torch.pytree import tree_flatten
    from repro_torch.serving.harness import LMFederation
    gc.collect()
    torch.cuda.empty_cache()
    assert torch.cuda.memory_allocated() < 2 ** 30
    torch.cuda.reset_peak_memory_stats()
    fed = LMFederation(cfg, 0, lr=lr, device=dev)
    fed.overlay._flush = lambda rounds: None
    before = [x[0].cpu() for x in tree_flatten(fed.stacked)[0]] if steps \
        else []
    fed.run_rounds(1)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    if not steps:
        return peak
    after = [x[0].cpu() for x in tree_flatten(fed.stacked)[0]]
    finite = all(bool(torch.isfinite(x).all()) for x in after)
    step = max(float((a - b).abs().max()) for a, b in zip(after, before))
    return peak, finite, step


def depth_probe(dev):
    """For each recurrent family at its published width: the training
    round's peak at 2 and 6 layers, the line through them, then the peak
    at each depth from two below that line's fit upward, until one
    reaches the limit: the depth before it is the cut.  At the cut, the
    round's largest param step at the harness's lr 0.1 and at the path's
    lr."""
    import dataclasses
    from repro_torch.configs import get_config
    for arch, cut, lr in LM_PATHS[1:]:
        full = get_config(arch)
        peak = {d: train_round(
            dev, dataclasses.replace(full, n_layers=d), lr) for d in (2, 6)}
        per_layer = (peak[6] - peak[2]) / 4
        base = peak[2] - 2 * per_layer
        depth = int((TRAIN_PEAK_LIMIT_GIB - base) // per_layer) - 2
        print(f"depth probe {arch}: {peak[2]:.2f} GiB at 2 layers, "
              f"{peak[6]:.2f} GiB at 6: {per_layer:.3f} GiB a layer over "
              f"{base:.2f} GiB")
        while depth < full.n_layers:
            peak[depth] = train_round(
                dev, dataclasses.replace(full, n_layers=depth), lr)
            print(f"depth probe {arch}: {peak[depth]:.2f} GiB at {depth} "
                  f"layers")
            if peak[depth] >= TRAIN_PEAK_LIMIT_GIB:
                break
            depth += 1
        print(f"depth probe {arch}: the largest depth below "
              f"{TRAIN_PEAK_LIMIT_GIB:.0f} GiB is {depth - 1}")
        for rate in sorted({0.1, lr}, reverse=True):
            _, finite, step = train_round(
                dev, dataclasses.replace(full, n_layers=cut), rate, True)
            print(f"lr probe {arch} at {cut} layers, lr {rate:g}: params "
                  f"finite after the round {finite}, largest step of one "
                  f"param {step:.4g}")


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
    k_ms = kernel_median_ms(lambda i: run(sets[i % 8]), 101,
                            "flash_attention_kernel")
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


def time_recurrent(dev, name):
    """The WKV6 or selective-scan kernel at its main path's prefill shape:
    profiler median over 101 launches cycling 4 input sets (more than the
    50 MB L2 together), the plain version's time on the same sets.
    Library: none (no single PyTorch call computes either recurrence).
    Returns (ms, plain_ms, bound_ms, bound_by)."""
    g = torch.Generator(dev).manual_seed(9)

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev)
    if name == "wkv6_bthd":
        from repro_torch.kernels.rwkv6_scan import kernel as mod
        from repro_torch.kernels.rwkv6_scan import ref
        B, T, H, hd = shape = WKV6_TIMED
        sets = [(randn(*shape).bfloat16(), randn(*shape).bfloat16(),
                 randn(*shape).bfloat16(),
                 torch.exp(-torch.exp(randn(*shape) - 1.0)),
                 randn(H, hd) * 0.1, torch.zeros((B, H, hd, hd), device=dev))
                for _ in range(4)]
        run, plain, tag = mod.wkv6_bthd, ref.wkv6_reference, "wkv6_kernel"
        bytes_ms, ops_ms = wkv6_bound(*shape)
    else:
        from repro_torch.kernels.ssm_scan import kernel as mod
        from repro_torch.kernels.ssm_scan import ref
        Bz, T, di, N = shape = SSM_TIMED
        sets = [(torch.sigmoid(randn(Bz, T, di) + 2.0), randn(Bz, T, di),
                 randn(Bz, T, N), randn(Bz, T, N),
                 torch.zeros((Bz, di, N), device=dev)) for _ in range(4)]
        run, plain = mod.ssm_scan_btd, ref.ssm_scan_reference
        tag = "ssm_scan_kernel"
        bytes_ms, ops_ms = ssm_bound(*shape)
    launch_ms = cuda_ms(lambda x: run(*x), sets, 100)
    p_ms = cuda_ms(lambda x: plain(*x), sets, 4)
    k_ms = kernel_median_ms(lambda i: run(*sets[i % 4]), 101, tag)
    b_ms = max(bytes_ms, ops_ms)
    b_by = "bytes" if bytes_ms >= ops_ms else "operations"
    print(f"time {name} {shape}: kernel median {k_ms * 1e3:.1f} us on the "
          f"card ({launch_ms * 1e3:.1f} us per call back to back, host "
          f"launch included) | plain {p_ms * 1e3:.1f} us | library: none | "
          f"bound {b_ms * 1e3:.2f} us by {b_by} (bytes {bytes_ms * 1e3:.2f} "
          f"us, operations {ops_ms * 1e3:.2f} us); kernel at "
          f"{b_ms / k_ms:.2%} of bound")
    return k_ms, p_ms, b_ms, b_by


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
        k_ms = kernel_median_ms(lambda i: run(bufs[i % n_buf]), 101,
                                f"{name}_kernel")
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


# ----------------------------------------------------------------------
# the legacy two-stage round and the fault and attack path (slice 4)

def legacy_kernels():
    from repro_torch.kernels.secure_agg import kernel as agg_kernel
    from repro_torch.kernels.secure_agg import ref as agg_ref
    return {
        "rolling_update": dict(
            wrapper=agg_kernel.rolling_update_flat,
            plain=agg_ref.rolling_update_reference,
            source="src/repro_torch/csrc/secure_agg.cu",
            replaces="src/repro/kernels/secure_agg/kernel.py:76",
            tag="::rolling_update_kernel<"),
        "field_wsum": dict(
            wrapper=agg_kernel.field_wsum_flat,
            plain=agg_ref.field_wsum_reference,
            source="src/repro_torch/csrc/secure_agg.cu",
            replaces="src/repro/kernels/secure_agg/kernel.py:56",
            tag="::field_wsum_kernel<"),
    }


def at_offset(t, k):
    """A contiguous copy of `t` that starts k elements into its storage."""
    buf = torch.empty(t.numel() + k, dtype=t.dtype, device=t.device)
    view = buf[k:].view(t.shape)
    view.copy_(t)
    return view


def check_legacy(dev, kernels):
    """Each legacy kernel against its plain version at every P in
    LEGACY_CHECK_P and N in LEGACY_CHECK_N (ragged, and below one block of
    1,024 columns), params in f32 / bf16 / f16, alpha 1 and 0.3: the
    float aggregate within atol = P * 1e-6 plus one ulp of the output type
    (rtol 2^-7 in bf16, 2^-10 in f16); the share-sum equal.  Then the
    same at operands that start one element off a 16-byte boundary."""
    ru, fw = kernels["rolling_update"], kernels["field_wsum"]
    ru["max_abs_err"], fw["max_abs_err"] = 0.0, 0.0
    worst = {dt: 0.0 for dt in LEGACY_ULP}
    for P in LEGACY_CHECK_P:
        for N in LEGACY_CHECK_N:
            g = torch.Generator(dev).manual_seed(P * 1_000_003 + N)
            shares = torch.randn((P, N), generator=g, device=dev)
            for dtype in LEGACY_ULP:
                params = torch.randn((N,), generator=g, device=dev).to(dtype)
                for alpha in (1.0, 0.3):
                    got = ru["wrapper"](shares, params, alpha)
                    want = ru["plain"](shares, params, alpha)
                    assert got.dtype == dtype and got.shape == (N,)
                    torch.testing.assert_close(
                        got.float(), want.float(), atol=P * 1e-6,
                        rtol=LEGACY_ULP[dtype])
                    err = float((got.float() - want.float()).abs().max())
                    worst[dtype] = max(worst[dtype], err)
            words = shares.view(torch.uint32)   # any 32 bits are field words
            got = fw["wrapper"](words)
            assert got.dtype == torch.int32 and got.shape == (N,)
            assert torch.equal(got, fw["plain"](words)), (P, N)
    # N % 4 == 0 with operands off a 16-byte boundary: the scalar path
    P, N = 3, 1000
    g = torch.Generator(dev).manual_seed(7)
    shares = at_offset(torch.randn((P, N), generator=g, device=dev), 1)
    for dtype in LEGACY_ULP:
        params = at_offset(
            torch.randn((N,), generator=g, device=dev).to(dtype), 1)
        got, want = ru["wrapper"](shares, params, 0.3), \
            ru["plain"](shares, params, 0.3)
        torch.testing.assert_close(got.float(), want.float(), atol=P * 1e-6,
                                   rtol=LEGACY_ULP[dtype])
        worst[dtype] = max(worst[dtype],
                           float((got.float() - want.float()).abs().max()))
    words = shares.view(torch.uint32)
    assert torch.equal(fw["wrapper"](words), fw["plain"](words))
    torch.cuda.synchronize()
    ru["max_abs_err"] = max(worst.values())
    print(f"check rolling_update: kernel == plain at P={LEGACY_CHECK_P} x "
          f"N={LEGACY_CHECK_N} (and P=3, N=1000 at a 4-byte offset) x "
          f"params f32/bf16/f16 x alpha 1, 0.3; max "
          f"|err| f32 {worst[torch.float32]:.3g}, bf16 "
          f"{worst[torch.bfloat16]:.3g}, f16 {worst[torch.float16]:.3g}")
    print(f"check field_wsum: kernel == plain bit for bit at the same "
          f"{len(LEGACY_CHECK_P) * len(LEGACY_CHECK_N)} shapes and the "
          f"offset view")


def legacy_main_path(dev, kernels, fused_wrappers):
    """The legacy MPC round through `secure_rolling_update` on the card,
    at each LEGACY_POINTS (P, N), in both domains, alpha 1: masks drawn on
    the card, shares materialized, one aggregate kernel launch (asserted).
    The result is held against the plain mean of the updates: within
    atol = P * 1e-5 in the float domain (the pads cancel to fp32
    rounding) and 2^-16 in the int domain (the fixed-point step).  The
    fused round on the same (P, N) and key is timed beside it.  Returns
    the launches of each legacy kernel."""
    from repro_torch import random as prng
    from repro_torch.core.secure_agg import (
        fused_secure_rolling_update, secure_rolling_update,
    )
    launches = dict.fromkeys(kernels, 0)
    key = prng.PRNGKey(2024)
    for P, N in LEGACY_POINTS:
        g = torch.Generator(dev).manual_seed(P)
        ups = [torch.randn((N,), generator=g, device=dev) for _ in range(P)]
        params = torch.randn((N,), generator=g, device=dev)
        mean = torch.zeros((N,), device=dev)
        for u in ups:
            mean += u
        mean /= P
        for domain in ("float", "int"):
            want = "rolling_update" if domain == "float" else "field_wsum"
            for k in kernels.values():
                k["wrapper"].launches = 0
            torch.cuda.reset_peak_memory_stats()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = secure_rolling_update(ups, params, 1.0, key, domain=domain)
            torch.cuda.synchronize()
            legacy_s = time.perf_counter() - t0
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            counts = {n: k["wrapper"].launches for n, k in kernels.items()}
            assert counts == {n: int(n == want) for n in kernels}, counts
            launches[want] += counts[want]
            assert out.shape == (N,) and out.dtype == torch.float32
            err = float((out - mean).abs().max())
            assert err <= (P * 1e-5 if domain == "float" else 2.0 ** -16), \
                (P, N, domain, err)
            del out
            rows = torch.stack(ups)
            before = {w: w.launches for w in fused_wrappers}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fused = fused_secure_rolling_update(rows, 1.0, key,
                                                domain=domain)
            torch.cuda.synchronize()
            fused_s = time.perf_counter() - t0
            assert sum(w.launches - before[w] for w in fused_wrappers) == 1
            ferr = float((fused[0] - mean).abs().max())
            assert ferr <= (P * 1e-5 if domain == "float" else 2.0 ** -16), \
                (P, N, domain, ferr)
            del rows, fused
            print(f"legacy round {domain} P={P} N={N:,}: "
                  f"{legacy_s * 1e3:.1f} ms (peak {peak:.2f} GiB) | fused "
                  f"round {fused_s * 1e3:.2f} ms, {legacy_s / fused_s:.0f}x "
                  f"faster | launches {counts} | max |result - plain mean| "
                  f"legacy {err:.3g}, fused {ferr:.3g}")
        del ups, params, mean
        gc.collect()
        torch.cuda.empty_cache()
    return launches


def time_legacy(dev, kernels, launches):
    """Each legacy kernel at the LM federation's legacy point (P = 3, N =
    qwen3-0.6b's 596,049,920, f32): profiler median of 21 launches, the
    plain version's time, one library call where one computes the same
    function.  The 7.15 GB of shares dwarf the 50 MB L2, so every launch
    reads from HBM.  Returns the kernels' JSON rows."""
    P, N = LEGACY_POINTS[-1]
    g = torch.Generator(dev).manual_seed(11)
    shares = torch.randn((P, N), generator=g, device=dev)
    params = torch.randn((N,), generator=g, device=dev)
    words = shares.view(torch.uint32)
    ru, fw = kernels["rolling_update"], kernels["field_wsum"]
    calls = {
        "rolling_update": (lambda _: ru["wrapper"](shares, params, 0.7),
                           lambda _: ru["plain"](shares, params, 0.7)),
        "field_wsum": (lambda _: fw["wrapper"](words),
                       lambda _: fw["plain"](words)),
    }
    got = ru["wrapper"](shares, params, 0.7)
    want = ru["plain"](shares, params, 0.7)
    torch.testing.assert_close(got, want, atol=P * 1e-6, rtol=0)
    ru["max_abs_err"] = max(ru["max_abs_err"],
                            float((got - want).abs().max()))
    del got, want
    wsum = fw["wrapper"](words)
    assert torch.equal(wsum, fw["plain"](words))
    # the library's candidate: an int32 sum cast back to int32 wraps?
    lib = words.view(torch.int32).sum(0, dtype=torch.int32)
    wraps = bool(torch.equal(lib, wsum))
    del lib, wsum
    two_ms = cuda_ms(lambda _: torch.lerp(params, shares.mean(0), 0.7),
                     [None], 5)
    lib_ms = {"rolling_update": None,
              "field_wsum": cuda_ms(lambda _: words.view(torch.int32).sum(
                  0, dtype=torch.int32), [None], 5) if wraps else None}
    rows = []
    for name, k in kernels.items():
        run, plain = calls[name]
        launch_ms = cuda_ms(run, [None], 20)
        p_ms = cuda_ms(plain, [None], 3)
        k_ms = kernel_median_ms(run, 21, k["tag"])
        nbytes = (P * N * 4 + 2 * N * 4 if name == "rolling_update"
                  else P * N * 4 + N * 4)
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = P * N / FP32_OPS_PER_S * 1e3   # P adds a column
        b_ms = max(bytes_ms, ops_ms)
        b_by = "bytes" if bytes_ms >= ops_ms else "operations"
        extra = (f"two calls (lerp of mean) {two_ms * 1e3:.1f} us"
                 if name == "rolling_update" else
                 f"int32 sum {'wraps, equal to the kernel' if wraps else 'does NOT wrap'}"
                 + (f": {lib_ms[name] * 1e3:.1f} us" if wraps else ""))
        print(f"time {name} P={P} N={N:,}: kernel median {k_ms * 1e3:.1f} "
              f"us on the card ({launch_ms * 1e3:.1f} us per call back to "
              f"back) | plain {p_ms * 1e3:.1f} us | library: {extra} | "
              f"bound {b_ms * 1e3:.1f} us by {b_by} ({nbytes / 1e9:.2f} GB); "
              f"kernel at {b_ms / k_ms:.1%} of bound")
        rows.append({"name": name, "route": "cuda", "source": k["source"],
                     "replaces": k["replaces"], "launches": launches[name],
                     "max_abs_err": k["max_abs_err"], "ms": k_ms,
                     "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by,
                     "library_ms": lib_ms[name]})
    del shares, params, words
    gc.collect()
    torch.cuda.empty_cache()
    return rows


def same_bits(a, b):
    """Bit-for-bit equality (NaN payloads included, which `torch.equal`
    calls unequal): a DP run at full width may carry non-finite rows."""
    ints = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
    return torch.equal(a.view(ints[a.element_size()]),
                       b.view(ints[b.element_size()]))


class MergeRecorder:
    """Wraps an overlay's `_merge` (stacked, key, committed, ref, round,
    participation, survivors) and checks on the card as each round runs:
    a round whose consensus did not commit hands back every row
    bit-untouched, and a dead institution's row passes through a
    committed round bit-untouched (DP and the attack step included).
    Counts the aborted rounds and the rows checked dead."""

    def __init__(self, overlay):
        self.inner, self.aborted, self.dead_rows = overlay._merge, 0, 0
        overlay._merge = self

    def __call__(self, stacked, key, committed, ref, rnd, part, survivors):
        from repro_torch.pytree import tree_flatten
        out = self.inner(stacked, key, committed, ref, rnd, part, survivors)
        pairs = list(zip(tree_flatten(stacked)[0], tree_flatten(out[0])[0]))
        if not committed:
            self.aborted += 1
            for a, b in pairs:
                assert same_bits(a, b), "an aborted round moved params"
        elif part is not None:
            dead = torch.from_numpy(~part).to(pairs[0][0].device)
            self.dead_rows += int(dead.sum())
            for a, b in pairs:
                assert same_bits(a[dead], b[dead]), "a dead row moved"
        return out


def schedules_for(name):
    """(fault schedule, attack schedule) of a FAULT_RUNS name."""
    from repro_torch.chaos import (
        Partition, attack_scenarios, standard_scenarios,
    )
    if name == "quorum_loss_p10":
        # the standard quorum_loss strands 3 of P = 5; at P = 10 that
        # leaves a quorum, so this one strands 5
        return Partition(start=2, stop=4, minority=tuple(range(5))), None
    faults = standard_scenarios(0)
    if name in faults:
        return faults[name], None
    return None, attack_scenarios(0)[name]


def fault_card_vs_cpu(dev):
    """A small federation (P = 5, width 0.25, 16x16, 6 rounds) under churn
    and quorum_loss on the card and on the CPU: equal survivor lists and
    commits, params within atol = 1e-4."""
    from repro_torch.chaos.harness import CNNFederation
    from repro_torch.pytree import tree_flatten
    for name in ("churn", "quorum_loss"):
        sched, _ = schedules_for(name)
        small = dict(n_institutions=5, image_size=16, width_scale=0.25)
        g_fed = CNNFederation(sched, 0, device=dev, **small)
        c_fed = CNNFederation(sched, 0, device="cpu", **small)
        _, gtrs = g_fed.run_rounds(FAULT_ROUNDS)
        _, ctrs = c_fed.run_rounds(FAULT_ROUNDS)
        assert [t.survivors for t in gtrs] == [t.survivors for t in ctrs]
        assert [t.committed for t in gtrs] == [t.committed for t in ctrs]
        for a, b in zip(tree_flatten(g_fed.stacked)[0],
                        tree_flatten(c_fed.stacked)[0]):
            np.testing.assert_allclose(a.cpu().numpy(), b.numpy(),
                                       atol=1e-4)
        print(f"reference faults {name}: card == CPU on P=5, width 0.25, "
              f"16x16, {FAULT_ROUNDS} rounds: survivors "
              f"{[len(t.survivors) for t in gtrs]}, committed "
              f"{[t.committed for t in gtrs]}")


def fault_main_path(dev, kernels, fed_kwargs, totals):
    """The paper's federation at full width (P = 10, width 1.0, 64x64)
    under each FAULT_RUNS schedule for FAULT_ROUNDS rounds: every launch
    count set to 0 before and read after; the round's masked kernels
    launched once a round (asserted); at least one round merged under a
    survivor mask in every fault scenario; every round that did not
    commit leaves params bit-untouched."""
    from repro_torch.chaos.harness import CNNFederation
    from repro_torch.pytree import tree_flatten
    for name, mode in FAULT_RUNS:
        sched, attack = schedules_for(name)
        fed = CNNFederation(sched, 0, n_institutions=P_FULL, local_steps=2,
                            batch=8, image_size=64, width_scale=1.0,
                            device=dev, attack_schedule=attack,
                            **fed_kwargs(mode))
        recorder = MergeRecorder(fed.overlay)
        for k in kernels.values():
            k["wrapper"].launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        metrics, trs = fed.run_rounds(FAULT_ROUNDS)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / FAULT_ROUNDS
        counts = {n: k["wrapper"].launches for n, k in kernels.items()}
        for n in counts:
            totals[n] += counts[n]
        want = {"float": ("masked_rolling_update",),
                "int": ("masked_field_wsum",),
                "dp": ("masked_rolling_update", "clip_noise")}[mode]
        for n in want:
            assert counts[n] == FAULT_ROUNDS, (name, mode, counts)
        survivors = [s["n_survivors"] for s in fed.overlay.stats]
        if attack is None:
            assert min(survivors) < P_FULL, (name, survivors)
        else:
            # the ledger names the attackers that published each round
            metas = [json.loads(tx.metadata)
                     for tx in fed.overlay.registry.chain
                     if tx.kind == "rolling_update"]
            bad = list(attack.attacker_set(P_FULL))
            assert bad and all(m["attackers"] == bad for m in metas), metas
        if mode != "dp" and (attack is None or attack.kind == "label_flip"):
            # DP at clip 0.5, sigma 1.0 destroys full-width training (as
            # in the JAX package), and a scaled sign flip of 3 of 10 makes
            # the plain mean's round map expansive (|10 - 3 - 8 x 3| / 10
            # = 1.7): either may overflow within 6 rounds
            assert bool(torch.isfinite(metrics["loss"]).all())
            for x in tree_flatten(fed.stacked)[0]:
                assert bool(torch.isfinite(x).all())
        if name == "quorum_loss_p10":
            assert recorder.aborted == 2, recorder.aborted
        assert recorder.aborted == sum(not t.committed for t in trs)
        assert fed.overlay.registry.verify_log()
        if attack is None:
            assert recorder.dead_rows + recorder.aborted > 0, name
        print(f"fault path {name} {mode}: {ms:.2f} ms/round | committed "
              f"{sum(t.committed for t in trs)}/{FAULT_ROUNDS} (aborted "
              f"rounds untouched: {recorder.aborted}; dead rows passed "
              f"through: {recorder.dead_rows}) | survivors "
              f"{survivors} | loss "
              f"{[round(float(v), 4) for v in metrics['loss'].mean(dim=1)]}"
              f" | launches {counts}")
        del fed, recorder


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _cuda
    from repro_torch.privacy.accountant import DPConfig
    from repro_torch.serving.harness import TINY_SERVE, TINY_SERVE_SSM

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
    if "--depth-probe" in sys.argv[1:]:
        depth_probe(dev)
        return 0

    # ---- build: one nvcc per source, all started together -------------
    built = _cuda.build_all()
    for name, (path, secs) in built.items():
        _cuda.library(name)
        print(f"build {name}.cu: {path.name} in {secs:.1f} s")
    print_resource_usage(built["secure_agg"][0], "Li10E")    # P = 10
    print_resource_usage(built["flash_attention"][0], "Li128E")  # hd 128
    print_resource_usage(built["wkv6"][0], "fLi64E")     # rwkv6: hd 64
    print_resource_usage(built["ssm_scan"][0], "IfLi16E")   # hymba: N 16
    print_resource_usage(built["secure_agg"][0], "21rolling_update_kernel")
    print_resource_usage(built["secure_agg"][0], "17field_wsum_kernel")

    # ---- each kernel against its plain version -----------------------
    kernels = secure_agg_kernels(dev)
    check_secure_agg(kernels, dev)
    legacy = legacy_kernels()
    check_legacy(dev, legacy)
    flash_err = check_flash(dev)
    wkv6_err = check_wkv6(dev)
    ssm_err = check_ssm(dev)

    # ---- the card against the CPU, small -----------------------------
    def fed_kwargs(mode):
        return dict(secure_domain="int" if mode == "int" else "float",
                    dp=DPConfig(clip_norm=0.5, noise_multiplier=1.0)
                    if mode == "dp" else None)
    cnn_card_vs_cpu(dev, fed_kwargs)
    fault_card_vs_cpu(dev)
    for arch, _, _ in LM_PATHS:
        lm_card_vs_cpu(dev, arch)
    for cfg in (TINY_SERVE, TINY_SERVE_SSM):
        hot_swap_on_card(dev, cfg)

    # ---- the main paths: full width, counts from 0 -------------------
    lm_kernels = kernel_wrappers()
    wrappers = [k["wrapper"] for k in kernels.values()] + list(
        lm_kernels.values())
    totals = {name: 0 for name in kernels}
    cnn_main_path(dev, kernels, fed_kwargs, totals)
    fault_main_path(dev, kernels, fed_kwargs, totals)
    for name, n in totals.items():
        assert n > 0, f"{name} never launched on the main path"
    legacy_launches = legacy_main_path(
        dev, legacy, [kernels[n]["wrapper"] for n in
                      ("masked_rolling_update", "masked_field_wsum")])
    for name, n in legacy_launches.items():
        assert n == len(LEGACY_POINTS), f"{name}: {n} launches"

    # ---- timing at the main paths' shapes ----------------------------
    rows = time_secure_agg(dev, kernels, totals)
    rows += time_legacy(dev, legacy, legacy_launches)
    timed = {"flash_attention_bhsd": time_flash(dev)}
    for name in ("wkv6_bthd", "ssm_scan_btd"):
        timed[name] = time_recurrent(dev, name) + (None,)

    lm_launches = dict.fromkeys(lm_kernels, 0)
    for arch, depth, lr in LM_PATHS:
        for name, n in lm_main_path(dev, arch, depth, lr, wrappers).items():
            lm_launches[name] += n
    errs = {"flash_attention_bhsd": flash_err, "wkv6_bthd": wkv6_err,
            "ssm_scan_btd": ssm_err}
    for name, (source, replaces) in LM_KERNEL_SOURCES.items():
        assert lm_launches[name] > 0, f"{name} never launched"
        k_ms, p_ms, b_ms, b_by, lib_ms = timed[name]
        rows.append({"name": name, "route": "cuda", "source": source,
                     "replaces": replaces, "launches": lm_launches[name],
                     "max_abs_err": errs[name], "ms": k_ms, "plain_ms": p_ms,
                     "bound_ms": b_ms, "bound_by": b_by,
                     "library_ms": lib_ms})
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
