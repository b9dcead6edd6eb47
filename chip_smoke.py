#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py                 # the smoke run
    python3 chip_smoke.py --depth-probe   # the recurrent paths' depth cut
    python3 chip_smoke.py --turns PARENT  # two kernels vs a parent tree's
    python3 chip_smoke.py --training      # the training path alone
    python3 chip_smoke.py --families      # the MoE, audio, VLM paths alone
    python3 chip_smoke.py --examples      # shim, examples, dry-runs alone
    python3 chip_smoke.py --mesh          # the mesh path alone

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
* the same federation (a warm-up round, then 3 timed ones) under the
  other merges: ring, hierarchical (groups of 2 and of 5), quantized; the
  robust merges (trimmed mean, coordinate median, norm-gated mean) for 6
  rounds under 30% sign-flip attackers; a partial merge of the conv
  backbone through secure_mean (float and int) with personal heads, and
  one whose backbone and head merge in turns;
* a fleet of P = 32 hospitals at full width with the fleet consensus
  parameters, 6 rounds in each secure_mean mode, through the fused
  kernels' P > 16 versions;
* crash recovery (``chaos.recovery``): two same-seed P = 10 federations
  in each mode must end bit-equal (and do so only with the local step's
  cuDNN held deterministic, whose cost in ms/round is timed in turns);
  then, under the reference's recovery schedule (30% dropout, a fatal
  coordinator crash at round 3), 6 rounds with a verified snapshot every
  2 into a temporary directory: the run killed at its crash round, a
  fresh federation failed over from the newest verified snapshot must
  end bit-equal to an uninterrupted run, also when the newest snapshot
  is corrupted in each of four ways and the failover falls back to the
  one before; the same for the P = 32 fleet, whose round 4 (half the
  fleet stranded, and the fatal crash) aborts with every row untouched;
* the same federation placed on the computing continuum by the cost model
  (``continuum.placement``): P = 16 hospitals at full width assigned to
  cloud, fog and edge resources, 3 rounds of secure_mean in each domain
  under the modelled straggler delays, once with no deadline (every round
  waits for the slowest tier) and once with a deadline that drops the
  slowest tier: the cost model's participation mask reaches the fused
  kernels, the ledger's survivors are the mask's, dropped rows come back
  untouched, and the same schedule at a small width gives the CPU's
  params;
* the same federation with its institution axis over ranks
  (``run_rounds(mesh=...)``): P = 16 hospitals at full width, 2 rounds
  in each secure_mean mode, healthy and under 30% dropout, on a 1-rank
  NCCL mesh in this process (bit-identical to no mesh), then on 2 and 4
  spawned ranks sharing the card over gloo (each rank bit-equal to one
  process training the same blocks of hospitals, and within rtol 2e-5,
  atol 1e-4 of the 1-rank run; its transcripts and stats equal, the
  fused kernels launched on every rank), and over NCCL across cards
  where there are several; each run's round ms and the gather's ms;
* the device tier (``core.device_tier``) at the repo's headline size: P =
  64 hospitals, each fronting D = 16,384 simulated personal devices (2^20
  device updates a round) in chunks of 1,024 with dropout and late
  devices admitted the next round, merged by ``hierarchical_device``: a
  warm-up and 4 rounds through ``run_rounds``, equal bit for bit to an
  eager loop; one hospital's sweep identical at chunks of 256 to 16,384;
  every round's device counts and weights equal to a numpy recount; the
  card equal to the CPU at P = 8 x D = 2,048;
* training (``launch.train``'s overlay in parts): smollm-360m at its
  published width and depth (32 layers, N = 361,821,120 a hospital),
  P = 4, 4 sequences of 512 tokens a hospital, 2 local steps of AdamW
  with remat and the fused cross-entropy, a warm-up and 3 rounds of
  secure_mean in the float domain, the int domain and the float domain
  with DP: the fused kernels at (4, 361,821,120), where only the params
  federate and the moments stay with their hospital; one round with and
  without remat from one state; reduced smollm-360m on the card and on
  the CPU; rows 1-3 timed at (4, 361,821,120);
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
  round's peak depth by depth up to the first that reaches it;
* a rebooted serving tier: qwen3-0.6b cut to 2 layers, one round with a
  snapshot of its 2.2 GB carry; ``pull_from_snapshot`` feeds a
  ``FederatedServer`` whose greedy tokens must equal a server's on the
  live federation's pull, and each corruption of a copy is refused;
* the models' prefill in fp32 compute (the reference's
  ``models/layers.py:COMPUTE_DTYPE = float32``, set for this phase only):
  one 1,024-token prompt of qwen3-0.6b and of hymba-1.5b, each cut to 2
  layers at its published width, through the fp32 flash-attention kernel,
  held against the plain attention path on the card.

* the ``core.gossip`` shim's five merges, masked and unmasked, bit-equal
  to the merge registry on the card; each ``examples/torch_*.py`` at its
  smallest flags on the card (``torch_scale_institutions`` at its
  published size on a 1-rank NCCL mesh), timed, its launches in the
  kernels line;
  and the dry-run's count on meta tensors (``launch.op_cost``) against
  real steps under ``FlopCounterMode`` (a qwen3-0.6b prefill of 1,024
  tokens, rwkv6-3b cut to 2 layers training on 256): equal matmul FLOPs,
  equal args bytes, and the predicted temp of a smollm-360m train step
  beside ``torch.cuda.max_memory_allocated``; then the dry-run on the
  production meshes (one combo on each of 16x16, 2x16x16 and
  2x16x16+overlay, counted on fake 256- and 512-rank groups) and rank 0's
  shards of a qwen3-0.6b decode step on a fake 256-rank ``cuda`` mesh,
  allocated on the card and run: predicted args equal to the real
  shards' bytes, outputs' local shapes equal to the count's.

Before the full-width paths, small runs on the card are held against the
same runs on the CPU (the CNN federation in each mode, under faults and
under each merge), and a mid-traffic hot-swap is checked for identity
with a fresh engine (dense and rwkv6).  Prints each kernel's time beside
its bound, its plain version's time and a PyTorch library call's time
where one exists, then a JSON line of kernels, the card's name and power
limit, and as the last line ``{"ok": true, "device": {...}}``.  Exits
non-zero, printing no result, without a CUDA device or outside the
repository.

The script leaves PyTorch's TF32 and cuDNN settings at their defaults, as
a user has them: the CNN's local step computes in IEEE float32 with
cuDNN's deterministic algorithms by itself, and the LMs compute in bf16
(hymba's scan inputs in fp32).
"""
import contextlib
import gc
import io
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

# the recurrent paths train within a few GiB of the card's capacity:
# segments that grow in place keep the allocator's fragmentation from
# adding gigabytes on top of the peak (set before CUDA starts)
os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")

import numpy as np  # noqa: E402
import torch  # noqa: E402

ROOT = Path(__file__).resolve().parent


def _card():
    """`repro_torch.continuum.H100_SXM`, from this checkout's
    ``continuum/resources.py`` loaded on its own: `--time-kernels` may put
    another tree's package on the path, one older than the constant."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "_chip_smoke_resources",
        ROOT / "src" / "repro_torch" / "continuum" / "resources.py")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod       # dataclasses look their module up
    spec.loader.exec_module(mod)
    return mod.H100_SXM


# H100 SXM rates.  HBM bytes/s and the bf16 tensor-core rate are
# `H100_SXM`'s (NVIDIA's data sheet); float32 ops/s (an add or a multiply
# is one op) from the same sheet.  Per-pipe rates from the CUDA C++ Programming Guide's throughput table
# for compute capability 9.0, in results per clock per SM, x 132 SMs x the
# 1,980 MHz boost clock: int32 shifts and logic run on the INT32 pipe
# (64), int32 multiplies on the FMA pipe (64), int32 adds on either;
# conversions (16) and the special functions log / sqrt / cos (16) are
# counted against their own rate.
H100 = _card()
HBM_BYTES_PER_S = H100.hbm_bandwidth
FP32_OPS_PER_S = 67e12
BF16_TC_FLOPS = H100.peak_flops_bf16
PER_CLOCK = 132 * 1.98e9
ALU_OPS_PER_S = IMAD_OPS_PER_S = 64 * PER_CLOCK
CVT_OPS_PER_S = SFU_OPS_PER_S = 16 * PER_CLOCK

P_FULL, N_FULL, N_RAGGED = 10, 109_634, 4_097
ROUNDS = 3
MODES = ("float", "int", "dp")

# the fused kernels on the card vs their plain versions and kernel-order
# models: (P, N, dead rows, storage offset of the rows).  The main path's
# shapes, P = 1, N = 2, 3 and 5, one column past a block's span of 128
# columns, N % 4 == 0 and != 0, and rows one element into their
# storage; a first dead row holds inf, a second NaN
AGG_CASES = [(P_FULL, N_FULL, (), 0), (P_FULL, N_FULL, (0, 4), 0),
             (P_FULL, N_RAGGED, (), 0), (P_FULL, N_RAGGED, (0, 4), 0),
             (1, 1, (), 0), (1, 129, (0,), 0), (2, 2, (), 0),
             (3, 3, (1,), 0), (5, 5, (0, 2), 0), (10, 129, (), 0),
             (16, 4096, (3, 9), 0), (16, 4097, (), 0),
             (10, 4096, (), 1), (7, 4099, (2, 5), 1)]
AGG_REPEATS = 21                          # calls held bit-identical
# the fused kernels past 16 rows (their P > 16 kernels), with the same
# standards: P = 17 (one past the register kernels), the fleet's 32, 64
# and 128, at N = 3, a ragged N and the main path's, all alive and rows 0
# and 4 dead (inf, NaN); each side of a 16-row tile's edge (the pair
# walk's tiles) at N = 3 and the ragged N, all alive, rows 0 and 4 dead
# and a whole tile dead; a dead tile at each P above; P = WIDE_GLOBAL_P,
# whose accumulators pass shared memory (a global workspace, and the
# float nets in 64 bits); and one case one element into its storage
WIDE_P = (17, 32, 64, 128)
WIDE_EDGE_P = (31, 33, 47, 48, 49)
WIDE_GLOBAL_P = 433


def dead_tile(P):
    """The rows of one whole 16-row tile of P: the middle one, or tile 0
    where the middle one is the ragged last."""
    T = -(-P // 16)
    t = T // 2 if 16 * (T // 2 + 1) <= P else 0
    return tuple(range(16 * t, 16 * t + 16))


WIDE_CASES = (
    [(P, N, dead, 0) for P in WIDE_P for N in (3, N_RAGGED, N_FULL)
     for dead in ((), (0, 4))]
    + [(P, N, dead, 0) for P in WIDE_EDGE_P for N in (3, N_RAGGED)
       for dead in ((), (0, 4), dead_tile(P))]
    + [(P, N_RAGGED, dead_tile(P), 0) for P in WIDE_P]
    + [(33, N_RAGGED, (0, 4), 1), (WIDE_GLOBAL_P, 3, (0, 4), 0),
       (WIDE_GLOBAL_P, 129, dead_tile(WIDE_GLOBAL_P), 0)])
# the kernel-order models and the plain versions hold (pairs, columns)
# int64 words at once: at most this many (1 GiB)
WIDE_WORDS = 2 ** 27
# flash attention on the card vs its plain version:
# (B, S, Hq, Hkv, hd, dtype, causal, window, layout); layout "" gives q,
# k, v their own (B, S, H, hd) tensors, "qkv" slices them from one fused
# (B, S, Hq + 2 Hkv, hd) projection (row stride wider than H hd), "odd"
# starts q one element into its storage (no 16-byte alignment: the bf16
# kernel's plain-load path)
FLASH_CASES = [
    (1, 1000, 16, 8, 128, torch.bfloat16, True, 0, ""),   # qwen3, ragged S
    (2, 192, 6, 3, 32, torch.bfloat16, True, 0, ""),
    (2, 192, 6, 3, 32, torch.float32, True, 0, ""),
    (1, 512, 4, 1, 80, torch.bfloat16, True, 0, ""),
    (2, 256, 15, 5, 64, torch.bfloat16, True, 0, ""),     # group 3
    (2, 256, 4, 2, 64, torch.float32, True, 16, ""),
    (2, 256, 4, 2, 64, torch.float32, True, 64, ""),
    (2, 256, 4, 2, 64, torch.float32, True, 100, ""),
    (1, 200, 4, 2, 64, torch.float32, False, 0, ""),      # non-causal ragged
]
FLASH_CASES.append(
    (1, 1152, 25, 5, 64, torch.bfloat16, True, 1024, ""))  # hymba's prefill
# the bf16 kernel's tile edges (64 q rows a warpgroup, 64 kv rows a tile):
# S on each side of one and two tiles, a window ending inside a kv tile,
# GQA group 5, hd 80 ragged, non-causal, fused and unaligned layouts
FLASH_CASES += [
    (1, 1, 4, 2, 64, torch.bfloat16, True, 0, ""),
    (1, 63, 4, 2, 128, torch.bfloat16, True, 0, ""),
    (1, 65, 4, 2, 128, torch.bfloat16, True, 0, ""),
    (1, 127, 4, 2, 32, torch.bfloat16, True, 0, ""),
    (1, 129, 4, 2, 80, torch.bfloat16, True, 0, ""),
    (1, 300, 4, 2, 64, torch.bfloat16, True, 100, ""),
    (1, 130, 10, 2, 64, torch.bfloat16, True, 0, ""),     # group 5
    (1, 200, 4, 2, 64, torch.bfloat16, False, 0, ""),
    (2, 190, 8, 2, 128, torch.bfloat16, True, 0, "qkv"),
    (2, 190, 8, 2, 64, torch.bfloat16, True, 0, "odd"),
]
# the fp32 kernel's tile edges (64 q rows a half-block, two q tiles a
# block, 64 kv rows a tile): S on each side of one and two tiles and of a
# pair, one q row, hd 80 and 32, non-causal, a window ending inside a kv
# tile, hymba's prefill (GQA group 5, window 1024), fused and unaligned
# layouts (the unaligned one takes the kernel's 4-byte copies)
FLASH_CASES += [
    (1, 1, 4, 2, 64, torch.float32, True, 0, ""),
    (1, 63, 4, 2, 128, torch.float32, True, 0, ""),
    (1, 65, 4, 2, 128, torch.float32, True, 0, ""),
    (1, 127, 4, 2, 32, torch.float32, True, 0, ""),
    (1, 129, 4, 2, 80, torch.float32, True, 0, ""),
    (1, 191, 4, 2, 80, torch.float32, False, 0, ""),
    (2, 193, 6, 3, 128, torch.float32, True, 100, ""),
    (1, 1152, 25, 5, 64, torch.float32, True, 1024, ""),
    (2, 190, 8, 2, 128, torch.float32, True, 0, "qkv"),
    (2, 190, 8, 2, 64, torch.float32, True, 0, "odd"),
]
# the MoE, audio and VLM families' prefill attention at full width:
# hubert-xlarge's encoder (non-causal, hd 80, group 1) over 1,500 frames,
# 30 s of audio at HuBERT's 20 ms frame rate (arXiv:2106.07447), 4
# clips; llava-next's 2,304 patch embeddings and 2,048 text tokens under
# its 4,096-token sliding window (hd 128, group 4); olmoe's served
# prompts (group 1, 64..1,024 tokens); dbrx's DBRX_BATCH prompts of
# DBRX_PROMPT tokens (group 6)
FLASH_HUBERT = (4, 1500, 16, 16, 80)
FLASH_LLAVA, LLAVA_WINDOW = (1, 4352, 32, 8, 128), 4096
FAMILY_FLASH_CASES = [
    FLASH_HUBERT + (torch.bfloat16, False, 0, ""),
    FLASH_LLAVA + (torch.bfloat16, True, LLAVA_WINDOW, ""),
    (1, 1000, 16, 16, 128, torch.bfloat16, True, 0, ""),
    (2, 1024, 48, 8, 128, torch.bfloat16, True, 0, ""),
]
FLASH_CASES += FAMILY_FLASH_CASES
# fp32 q rows that no key may attend to (they are 0): (Sq, Skv, hd,
# causal, window), Sq > Skv, across the tile edges
FLASH_EMPTY_CASES = [(130, 70, 64, True, 8), (200, 65, 128, True, 16),
                     (130, 40, 80, False, 8)]
FLASH_TOL = {torch.bfloat16: 2e-2, torch.float32: 2e-5}
FLASH_TIMED = (1, 1024, 16, 8, 128)       # qwen3's prefill at S = 1024
FLASH_HYMBA, HYMBA_WINDOW = (1, 1152, 25, 5, 64), 1024   # hymba's prefill
# WKV6 on the card vs its plain version: (B, T, H, hd, r/k/v dtype,
# w dtype, nonzero s0, strided input)
WKV6_CASES = [
    (1, 1000, 40, 64, torch.bfloat16, torch.float32, False, False),  # rwkv6
    (8, 1, 40, 64, torch.bfloat16, torch.float32, True, False),  # decode
    (2, 77, 4, 32, torch.float32, torch.float32, True, False),
    (2, 40, 3, 16, torch.bfloat16, torch.bfloat16, True, False),
    (1, 33, 2, 128, torch.float32, torch.float32, True, False),
    (2, 50, 4, 64, torch.bfloat16, torch.float32, True, True),
    # the split kernel's edges: 16-column groups and 8-row lanes at hd 16
    # / 32 / 128, T = 1 at other hd, T not a multiple of the 16-token chunk
    (2, 13, 3, 128, torch.bfloat16, torch.float32, True, False),
    (1, 21, 5, 32, torch.bfloat16, torch.bfloat16, True, True),
    (3, 1, 2, 16, torch.float32, torch.float32, True, False),
    (8, 1, 4, 128, torch.bfloat16, torch.float32, True, False),
    (1, 1001, 40, 64, torch.bfloat16, torch.float32, True, False),
]
WKV6_TIMED = (1, 1024, 40, 64)            # rwkv6-3b's prefill at T = 1024
WKV6_DECODE = (8, 1, 40, 64)              # one decode tick of 8 slots
# the selective scan on the card vs its plain version: (Bz, T, di, N,
# dtype, nonzero h0, inputs); inputs "" are contiguous with a =
# sigmoid(randn + 2), "strided" reads a every other token of a (Bz, 2T,
# di) tensor and bx from the first di columns of a (Bz, T, di + 8) one
# (16-byte aligned rows: TMA through strides), "odd" starts a and bx one
# element into their storage (the element-by-element copies), "a1" has
# a = 1 and "a0" a in (1e-4, 1e-2) (a chunk's decay product underflows
# to 0)
SSM_CASES = [
    (1, 1152, 3200, 16, torch.float32, False, ""),    # hymba's prefill
    (8, 1, 3200, 16, torch.float32, True, ""),        # decode
    (2, 100, 1001, 16, torch.float32, True, ""),      # ragged di
    (2, 70, 515, 8, torch.bfloat16, True, ""),
    (1, 37, 96, 5, torch.float32, True, ""),
    # the redesign's edges: T on each side of 4 boxes of 16 tokens, T = 2
    # and each side of the decode kernel's T <= 8, Bz = 3 at hymba's
    # prefill, N = 1 and 32, strided and unaligned views, decays of 1 and
    # near 0
    (2, 63, 384, 16, torch.float32, True, ""),
    (2, 64, 384, 16, torch.bfloat16, True, ""),
    (2, 65, 384, 16, torch.float32, True, ""),
    (3, 2, 640, 16, torch.float32, True, ""),
    (2, 7, 300, 16, torch.float32, True, ""),
    (2, 8, 300, 5, torch.bfloat16, True, ""),
    (2, 9, 300, 16, torch.float32, True, ""),
    (3, 1152, 3200, 16, torch.float32, True, ""),
    (2, 200, 256, 1, torch.float32, True, ""),
    (2, 200, 256, 32, torch.float32, True, ""),
    (2, 130, 256, 32, torch.bfloat16, True, ""),
    (2, 150, 512, 16, torch.float32, True, "strided"),
    (2, 150, 512, 16, torch.bfloat16, True, "odd"),
    (1, 1152, 256, 16, torch.float32, True, "a1"),
    (1, 1152, 256, 16, torch.float32, True, "a0"),
    # N a multiple of 4 below its padded NP (the decode kernel's quads
    # past a row's end hold none), at T = 1 and in a sequence
    (8, 1, 3200, 12, torch.float32, True, ""),
    (4, 1, 515, 24, torch.float32, True, ""),
    (2, 5, 300, 20, torch.bfloat16, True, ""),
    (2, 1, 256, 28, torch.float32, True, ""),
    (2, 100, 300, 12, torch.float32, True, ""),
    # T on each side of the 128-token chunk
    (2, 127, 384, 16, torch.float32, True, ""),
    (2, 128, 384, 16, torch.bfloat16, True, ""),
    (2, 129, 384, 16, torch.float32, True, ""),
]
SSM_TIMED = (1, 1152, 3200, 16)           # hymba-1.5b's prefill, 1024 + 128
SSM_DECODE = (8, 1, 3200, 16)             # one decode tick of 8 slots
SSM_REPEATS = 20                          # calls held bit-identical to one
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
            ("hymba-1.5b", 17, 0.1), ("olmoe-1b-7b", 2, 0.1)]
TRAIN_PEAK_LIMIT_GIB = 70.0
# the depths `--depth-probe` measures first, for its line through the
# peaks: olmoe's 1.68 GB a layer (402.65 M expert parameters) x 3
# institutions passes the limit before 6 layers
PROBE_DEPTHS = {"rwkv6-3b": (2, 6), "hymba-1.5b": (2, 6),
                "olmoe-1b-7b": (1, 2)}
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
    """The fewest operations per class the kernel's function needs for these
    inputs, at any P (only surviving pairs exchange pads).  A pad word is
    mask_bits through the split hash: mix32's first xor-shift distributes
    over xor, so the pair's half is computed once per launch and the
    counter's half, c ^ (c >> 16) with c = column x golden, once per
    column (1 multiply, 2 logic/shift ops); each (pair, column) then costs
    5 logic/shift ops and 2 multiplies.  The float pad adds a shift and an
    integer accumulate per pair and one conversion per alive row (the net
    pad is summed in int32), then per alive row a scale, the share, the
    sum and the 3-op blend, and one division per column.  The int kernel's
    output needs no pad word: in Z_2^32 each alive pair's word enters the
    survivors' sum once added and once subtracted, so the function is the
    survivors' encoded sum, per alive row a scale, a clamp (2), one
    conversion and an add.  DP: two words per (row, column) sharing the
    counter's half, plus 2 shifts, an add, 2 conversions, log / sqrt / cos
    and 11 float ops."""
    K = alive_rows * (alive_rows - 1) // 2
    A = alive_rows
    if kind == "masked_rolling_update":
        return dict(alu=N * (6 * K + 2), imad=N * (2 * K + 1), iadd=N * K,
                    fp=N * (6 * A + 1), cvt=N * A, sfu=0)
    if kind == "masked_field_wsum":
        return dict(alu=N * 2 * A, imad=0, iadd=N * A, fp=N * A, cvt=N * A,
                    sfu=0)
    return dict(alu=N * (A * 12 + 2), imad=N * (4 * A + 1), iadd=N * A,
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


def flash_bound(B, S, Hq, Hkv, hd, itemsize=2, window=0,
                rate=BF16_TC_FLOPS, causal=True):
    """(bytes_ms, ops_ms) of attention: q, k, v and o moved once; 4 * hd
    flops per unmasked (q, k) pair and head (QK^T and PV, a multiply-add
    each), S(S+1)/2 pairs when causal (fewer under a window), S^2
    without the mask, at `rate` (the bf16 tensor-core rate; fp32 inputs:
    the fp32 rate)."""
    nbytes = B * S * hd * (2 * Hq + 2 * Hkv) * itemsize
    W = min(window, S) if window > 0 else S
    if causal:
        pairs = W * (W + 1) / 2 + (S - W) * W
    else:
        assert window == 0, "no path runs a non-causal window"
        pairs = S * S
    flops = 4 * hd * B * Hq * pairs
    return nbytes / HBM_BYTES_PER_S * 1e3, flops / rate * 1e3


def wkv6_bound(B, T, H, hd, itemsize=2, w_itemsize=4):
    """(bytes_ms, ops_ms) of WKV6: r, k, v, w read and y written once, u
    and the two states moved once; 5 fp32 operations per state element
    and token (r·S and the sum over i, k·v, w·S + kv), the bonus term
    y += v_j Σ_i r_i u_i k_i costing O(hd) a token, not O(hd²)."""
    n = B * T * H * hd
    nbytes = (n * (4 * itemsize + w_itemsize) + H * hd * 4
              + 2 * B * H * hd * hd * 4)
    return (nbytes / HBM_BYTES_PER_S * 1e3,
            5 * n * hd / FP32_OPS_PER_S * 1e3)


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


PRIME_SPINS = 64    # short spin kernels that open each trace


def prime_trace():
    """Opens a trace with PRIME_SPINS short spin kernels and a 5 ms
    pause.  Late in a long process a trace has missed up to its first 13
    launches on the H100, and with them every launch of a short window;
    the spins, left out of the results (`device_events`), stand in the
    place of those launches."""
    for _ in range(PRIME_SPINS):
        torch.cuda._sleep(100)
    torch.cuda.synchronize()
    time.sleep(0.005)


def device_events(prof):
    """(name, start, device us) of each CUDA activity in a finished
    trace, in start order, without `prime_trace`'s spins."""
    return sorted(((e.name, e.time_range.start, e.time_range.elapsed_us())
                   for e in prof.events()
                   if str(e.device_type).endswith("CUDA")
                   and "spin_kernel" not in e.name), key=lambda e: e[1])


def traced(fn, iters, host=True):
    """`device_events` of `iters` calls of fn(i) under torch.profiler's
    CUDA activity, after `prime_trace`.  `host=False` traces the card
    alone, which costs the host far less per operation."""
    acts = [torch.profiler.ProfilerActivity.CUDA]
    if host:
        acts.append(torch.profiler.ProfilerActivity.CPU)
    with torch.profiler.profile(activities=acts) as prof:
        prime_trace()
        for i in range(iters):
            fn(i)
        torch.cuda.synchronize()
    return device_events(prof)


def device_us(fn, iters, host=True):
    """{kernel name: [device us of each launch, in start order]} over
    `iters` calls of fn(i) (`traced`): the kernels' own time on the
    card, without the host's launch gaps."""
    out = {}
    for name, _, us in traced(fn, iters, host):
        out.setdefault(name, []).append(us)
    return out


LEAD_IN = 5     # calls ahead of the timed ones in each profiled window


def idle_share(busy_ms, ms):
    """The card's idle share of `ms` given its busy time from a trace;
    a trace that recorded no device activity measured nothing."""
    if busy_ms <= 0:
        return "idle not measured: the trace recorded no device activity"
    return f"idle {1 - busy_ms / ms:.1%}"


def kernel_median_ms(fn, iters, tag):
    """Median device ms of one launch of the kernel whose name holds
    `tag` (a dict {tag: launches a call}: the call's kernels, each
    median times its launches, summed): fn(i) is called LEAD_IN + iters
    times under torch.profiler's CUDA activity, and each median is taken
    over the last launches the trace recorded, in start order.  Late in a
    long process the trace can miss launches at the start of its window
    (seen on the card: one of 101, two and three of 22, 13 of 21) or all
    of them (0 of 26, three traces in a row); `prime_trace` and the
    lead-in calls absorb them, a trace that recorded too few is taken
    again, and after three such traces the calls are timed by CUDA
    events instead (`event_call_ms`: every kernel a call launches)."""
    tags = {tag: 1} if isinstance(tag, str) else tag
    for _ in range(3):
        events = traced(fn, LEAD_IN + iters, host=False)
        ms = 0.0
        for t, per_call in tags.items():
            mine = [us for name, _, us in events if t in name]
            if len(mine) < iters * per_call:
                break
            ms += per_call * float(np.median(mine[-iters * per_call:])) / 1e3
        else:
            return ms
    ms = event_call_ms(fn, iters)
    print(f"  (the profiler missed launches of {list(tags)} in three "
          f"traces: {ms * 1e3:.2f} us a call by CUDA events)")
    return ms


def event_call_ms(fn, iters):
    """Median device ms of one fn(i) call by CUDA events around it, each
    call queued behind a 0.5 ms spin of the card so that the events time
    the call's kernels (and the gaps between them), not the host's
    launches."""
    spans = []
    for i in range(LEAD_IN + iters):
        torch.cuda._sleep(1_000_000)
        start, stop = (torch.cuda.Event(enable_timing=True)
                       for _ in range(2))
        start.record()
        fn(i)
        stop.record()
        spans.append((start, stop))
    torch.cuda.synchronize()
    return float(np.median([a.elapsed_time(b)
                            for a, b in spans[LEAD_IN:]]))


def cuobjdump(*args):
    """cuobjdump's standard output for `args`, or None without it."""
    from repro_torch.kernels import _cuda
    exe = shutil.which("cuobjdump") or str(
        Path(_cuda._nvcc()).with_name("cuobjdump"))
    if not Path(exe).exists():
        return None
    return subprocess.run([exe, *map(str, args)], capture_output=True,
                          text=True).stdout


def kernel_sass(lib_path, tag):
    """The SASS of the kernel whose mangled name holds `tag`, or None
    without cuobjdump."""
    sass = cuobjdump("-sass", lib_path)
    if sass is None:
        return None
    return next(f for f in sass.split("Function : ")[1:]
                if tag in f.split("\n", 1)[0])


def print_resource_usage(lib_path, tag):
    """Registers and spills of the kernels whose mangled name holds
    `tag`, from cuobjdump."""
    usage = cuobjdump("--dump-resource-usage", lib_path)
    if usage is None:
        return
    lines = usage.splitlines()
    for name, counts in zip(lines, lines[1:]):   # "Function f:", "REG:"
        if "Function" in name and tag in name:
            print(f"  {name.strip()} {counts.strip()}")


def print_sass_floor(lib_path, tag, n, threads=128):
    """The SASS instructions of the kernel whose mangled name holds `tag`
    (cuobjdump -sass): all of them; its main body (up to its last EXIT:
    the out-of-line slow paths of division and sqrt follow); the main
    body less the inline large-argument range reduction of cosf, which
    no |argument| < 105615 takes (the kernel's are below 2 pi); its MUFU
    ones.  Then the issue-rate floor of that last count at n columns, one
    column a thread: one warp instruction a clock on each of the 4
    schedulers of each SM."""
    body = kernel_sass(lib_path, tag)
    if body is None:
        return
    ops = [(int(a, 16), op, rest) for a, op, rest in re.findall(
        r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z][\w.]*)([^;]*);",
        body) if op != "NOP"]
    end = max(a for a, op, _ in ops if op == "EXIT")
    main = [(a, op, rest) for a, op, rest in ops if a <= end]
    skipped = set()      # cosf's Payne-Hanek path: the compare with
    for i, (_, op, rest) in enumerate(main):    # 105615, then a branch
        if op.startswith("FSETP") and "105615" in rest:   # around it
            a_br, _, target = next(x for x in main[i + 1:]
                                   if x[1] == "BRA")
            skipped |= {a for a, _, _ in main
                        if a_br < a < int(target.split()[-1], 16)}
    fast = len(main) - len(skipped)
    warps = -(-n // threads) * threads // 32
    floor_ms = fast * warps / (132 * 4 * 1.98e9) * 1e3
    mufu = sum(op.startswith("MUFU") for _, op, _ in main)
    print(f"  sass {tag}: {len(ops)} instructions, {len(main)} in the main "
          f"body, {fast} of them outside cosf's large-argument path "
          f"({len(skipped) // max(1, sum('105615' in r for _, _, r in main))}"
          f" each), {mufu} MUFU; issue-rate floor of those {fast} at N = "
          f"{n}: {floor_ms * 1e3:.2f} us")


def print_sass_hashes(lib_path, tag):
    """The SASS instructions of the kernel whose mangled name holds `tag`
    that multiply by mix32's first constant (kMulA, 0x7feb352d): one a
    hashed word in the pair walks' unrolled bodies (the diagonal tile's
    120 words, 16 in each copy of an off-diagonal row's loop) and one a
    staged key, so the count shows that the walk hashes each of a tile
    pair's words once and that the int kernel's cancelling pads were not
    folded away.  Returns the count (None without cuobjdump)."""
    body = kernel_sass(lib_path, tag)
    if body is None:
        return None
    ops = re.findall(r"/\*[0-9a-f]{4,}\*/\s+([^;]*);", body)
    hashes = sum("0x7feb352d" in op.lower() for op in ops)
    print(f"  sass {tag}: {len(ops)} instructions, {hashes} multiply by "
          f"mix32's first constant")
    return hashes


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
            plain=lambda u, m, chunk=1 << 20:
                agg_ref.masked_rolling_update_reference(
                    u, 0xC0FFEE, 0.7, m, chunk=chunk),
            model=lambda u, m: agg_ref.masked_rolling_update_kernel_order(
                u, 0xC0FFEE, 0.7, m)),
        "masked_field_wsum": dict(
            wrapper=agg_kernel.masked_field_wsum_flat,
            source="src/repro_torch/csrc/secure_agg.cu",
            replaces="src/repro/kernels/secure_agg/kernel.py:177",
            run=lambda u, m: agg_kernel.masked_field_wsum_flat(
                u, 0xC0FFEE, m),
            plain=lambda u, m, chunk=1 << 20:
                agg_ref.masked_field_wsum_reference(u, 0xC0FFEE, m,
                                                    chunk=chunk),
            model=lambda u, m: agg_ref.masked_field_wsum_kernel_order(
                u, 0xC0FFEE, m)),
        "clip_noise": dict(
            wrapper=dp_kernel.clip_noise_flat,
            source="src/repro_torch/csrc/secure_agg.cu",
            replaces="src/repro/kernels/dp/kernel.py:69",
            run=lambda u, m: dp_kernel.clip_noise_flat(
                u, dp_ref._row_norms(u), 0xC0FFEE, 0.5, 1.0, m),
            plain=lambda u, m, chunk=1 << 20: dp_ref.clip_noise_reference(
                u, 0xC0FFEE, 0.5, 1.0, m, dp_ref._row_norms(u), chunk=chunk),
            model=lambda u, m: dp_ref.clip_noise_kernel_order(
                u, 0xC0FFEE, 0.5, 1.0, m, dp_ref._row_norms(u))),
    }


def agg_case(rng, dev, P, N, dead, offset):
    """(P, N) f32 rows from `rng` and their (P,) mask (None: all alive);
    the first dead row holds inf, the second NaN; the rows start `offset`
    elements into their storage."""
    u = torch.from_numpy(rng.standard_normal((P, N)).astype(np.float32))
    m = None
    if dead:
        mask = np.ones(P, np.float32)
        mask[list(dead)] = 0.0
        u[dead[0]] = float("inf")
        if len(dead) > 1:
            u[dead[1]] = float("nan")
        m = torch.from_numpy(mask).to(dev)
    return at_offset(u.to(dev), offset), m


def check_secure_agg(kernels, dev):
    """The three kernels against their plain versions and kernel-order
    models on AGG_CASES: the Z_2^32 share-sum equal to both; the float
    round equal bit for bit to its model and within atol = P * 1e-6 of the
    plain version; the DP noise within rtol = 1e-5, atol = 1e-6 of the
    plain version, its elements that differ from its model counted; dead
    rows bit-untouched.  Then AGG_REPEATS calls of each kernel at the main
    path's shape with rows 0 and 4 dead, held bit-identical."""
    rng = np.random.default_rng(0)
    for name, k in kernels.items():
        k["max_abs_err"] = 0.0
        differ = 0
        for P, N, dead, offset in AGG_CASES:
            u, m = agg_case(rng, dev, P, N, dead, offset)
            got, want = k["run"](u, m), k["plain"](u, m)
            torch.cuda.synchronize()
            case = (name, P, N, dead, offset)
            model = k["model"](u, m)
            if name == "clip_noise":
                differ += int((got.view(torch.int32)
                               != model.view(torch.int32)).sum())
            else:
                assert same_bits(got, model), case
            if name == "masked_field_wsum":
                assert torch.equal(got, want), case
                continue
            tol = (dict(atol=P * 1e-6, rtol=0)
                   if name == "masked_rolling_update"
                   else dict(atol=1e-6, rtol=1e-5))
            torch.testing.assert_close(got, want, equal_nan=True, **tol)
            alive = [p for p in range(P) if p not in dead]
            if alive:
                err = float((got[alive] - want[alive]).abs().max())
                k["max_abs_err"] = max(k["max_abs_err"], err)
            for p in dead:
                assert same_bits(got[p], u[p]), case
        print(f"check {name}: kernel == plain on {len(AGG_CASES)} (P, N, "
              f"dead rows, offset) cases; "
              + (f"{differ} elements differ from the kernel-order model"
                 if name == "clip_noise"
                 else "== the kernel-order model bit for bit")
              + f"; max |err| {k['max_abs_err']:.3g}")
    for name, k in kernels.items():
        u, m = agg_case(rng, dev, P_FULL, N_FULL, (0, 4), 0)
        first = k["run"](u, m)
        for _ in range(AGG_REPEATS - 1):
            assert same_bits(k["run"](u, m), first), name
        print(f"check {name}: {AGG_REPEATS} calls at ({P_FULL}, {N_FULL}) "
              f"bit-identical")


def check_secure_agg_wide(kernels, dev):
    """The three fused wrappers past 16 rows, where they launch their P >
    16 kernels (counted on `launches_wide`, asserted), on WIDE_CASES with
    `check_secure_agg`'s standards: the share-sum equal to the plain
    version, the float round within atol = P * 1e-6 of it, the DP noise
    within rtol = 1e-5, atol = 1e-6; all three equal bit for bit to their
    kernel-order models (the pair models on the first WIDE_WORDS / pairs
    columns: a column's result depends on that column alone); dead rows
    bit-untouched."""
    rng = np.random.default_rng(1)
    for name, k in kernels.items():
        k["wide_max_abs_err"] = 0.0
        t0 = time.perf_counter()
        for P, N, dead, offset in WIDE_CASES:
            u, m = agg_case(rng, dev, P, N, dead, offset)
            case = (name, P, N, dead, offset)
            before = k["wrapper"].launches_wide
            got = k["run"](u, m)
            torch.cuda.synchronize()
            assert k["wrapper"].launches_wide == before + 1, case
            # the DP model's row norms need whole rows; it holds no pairs
            pairs = P * (P - 1) // 2
            cols = N if name == "clip_noise" else min(N, WIDE_WORDS // pairs)
            model = k["model"](u if cols == N else
                               u[:, :cols].contiguous(), m)
            assert same_bits(got[..., :cols], model), case
            want = k["plain"](u, m, chunk=max(1024, WIDE_WORDS // pairs))
            if name == "masked_field_wsum":
                assert torch.equal(got, want), case
                continue
            tol = (dict(atol=P * 1e-6, rtol=0)
                   if name == "masked_rolling_update"
                   else dict(atol=1e-6, rtol=1e-5))
            torch.testing.assert_close(got, want, equal_nan=True, **tol)
            alive = [p for p in range(P) if p not in dead]
            err = float((got[alive] - want[alive]).abs().max())
            k["wide_max_abs_err"] = max(k["wide_max_abs_err"], err)
            for p in dead:
                assert same_bits(got[p], u[p]), case
        print(f"check {name} P > 16: kernel == plain on {len(WIDE_CASES)} "
              f"(P, N, dead rows, offset) cases, P in "
              f"{sorted({c[0] for c in WIDE_CASES})}; == the "
              f"kernel-order model bit for bit; max |err| "
              f"{k['wide_max_abs_err']:.3g} ({time.perf_counter() - t0:.1f}"
              f" s)")


def check_flash(dev, cases=None):
    """The flash kernel against its plain version on every shape of
    `cases` (FLASH_CASES by default, and then on rows without keys too);
    returns the largest |err| over the bf16 cases and over the fp32
    ones."""
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention import ref as fa_ref
    worst = {torch.bfloat16: 0.0, torch.float32: 0.0}
    for i, (B, S, Hq, Hkv, hd, dtype, causal, window, layout) in enumerate(
            cases or FLASH_CASES):
        g = torch.Generator(dev).manual_seed(i)
        q, k, v = flash_inputs(g, dev, B, S, Hq, Hkv, hd, dtype, layout)
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
        worst[dtype] = max(worst[dtype], err)
        print(f"check flash_attention_bhsd (B,S,Hq,Hkv,hd)="
              f"{(B, S, Hq, Hkv, hd)} {str(dtype)[6:]} causal={causal} "
              f"window={window}{' ' + layout if layout else ''}: max |err| "
              f"{err:.3g} (tol {tol})")
        del q, k, v, got, want
    tol = FLASH_TOL[torch.float32]
    for i, (Sq, Skv, hd, causal, window) in enumerate(
            [] if cases else FLASH_EMPTY_CASES):
        g = torch.Generator(dev).manual_seed(100 + i)
        q, k, v = (torch.randn((1, h, s, hd), generator=g, device=dev)
                   for h, s in ((4, Sq), (2, Skv), (2, Skv)))
        got = fa_kernel.flash_attention_bhsd(q, k, v, causal=causal,
                                             window=window)
        want = fa_ref.attention_reference(q, k, v, causal=causal,
                                          window=window)
        torch.testing.assert_close(got, want, atol=tol, rtol=tol)
        empty = Skv + window - 1   # q - window >= the last key
        assert bool((got[:, :, empty:] == 0).all()), (Sq, Skv, window)
        err = float((got - want).abs().max())
        worst[torch.float32] = max(worst[torch.float32], err)
        print(f"check flash_attention_bhsd fp32 Sq={Sq} Skv={Skv} hd={hd} "
              f"causal={causal} window={window}: rows {empty}.. without "
              f"keys are 0; max |err| {err:.3g} (tol {tol})")
    return worst[torch.bfloat16], worst[torch.float32]


def flash_inputs(g, dev, B, S, Hq, Hkv, hd, dtype, layout):
    """q, k, v in the model layout (B, S, H, hd), laid out as `layout`
    says (FLASH_CASES)."""
    if layout == "qkv":
        qkv = torch.randn((B, S, Hq + 2 * Hkv, hd), generator=g,
                          device=dev).to(dtype)
        return qkv.split([Hq, Hkv, Hkv], dim=2)
    q, k, v = (torch.randn((B, S, h, hd), generator=g, device=dev)
               .to(dtype) for h in (Hq, Hkv, Hkv))
    if layout == "odd":
        q = torch.cat([q.new_zeros(1), q.flatten()])[1:].view(q.shape)
        assert q.data_ptr() % 16
    return q, k, v


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


def ssm_view(x, kind, which):
    """a or bx (`which`), (Bz, T, di), laid out as SSM_CASES' `kind`
    says."""
    Bz, T, di = x.shape
    if kind == "strided":
        if which == "a":
            big = torch.zeros((Bz, 2 * T, di), dtype=x.dtype, device=x.device)
            big[:, ::2] = x
            return big[:, ::2]
        big = torch.zeros((Bz, T, di + 8), dtype=x.dtype, device=x.device)
        big[..., :di] = x
        return big[..., :di]
    if kind == "odd":
        flat = torch.zeros(x.numel() + 1, dtype=x.dtype, device=x.device)
        flat[1:] = x.flatten()
        return flat[1:].view(x.shape)
    return x


def check_ssm(dev):
    """The selective-scan kernel against its plain version on every
    listed shape; returns the largest |err| of y."""
    from repro_torch.kernels.ssm_scan import kernel as ssm_kernel
    from repro_torch.kernels.ssm_scan import ref as ssm_ref
    worst = 0.0
    for i, (Bz, T, di, N, dtype, h0_nz, kind) in enumerate(SSM_CASES):
        g = torch.Generator(dev).manual_seed(200 + i)

        def randn(*shape):
            return torch.randn(shape, generator=g, device=dev)
        a = torch.sigmoid(randn(Bz, T, di) + 2.0)
        if kind == "a1":
            a = torch.ones_like(a)
        elif kind == "a0":
            a = 1e-4 + (1e-2 - 1e-4) * torch.rand(a.shape, generator=g,
                                                  device=dev)
        a = ssm_view(a.to(dtype), kind, "a")
        bx = ssm_view(randn(Bz, T, di).to(dtype), kind, "bx")
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
              f"{str(dtype)[6:]} h0={'randn' if h0_nz else 0}"
              f"{' ' + kind if kind else ''}: y max |err| "
              f"{err:.3g} (rel {rel_err(y, y_ref):.3g}), state rel err "
              f"{rel_err(h, h_ref):.3g}")
    # the carries compose in a fixed order: every call gives the same bits
    for Bz in (SSM_TIMED[0], 3):
        g = torch.Generator(dev).manual_seed(300 + Bz)
        shape = (Bz,) + SSM_TIMED[1:3]
        a = torch.sigmoid(torch.randn(shape, generator=g, device=dev) + 2)
        bx = torch.randn(shape, generator=g, device=dev)
        Bm, Cm = (torch.randn((Bz, SSM_TIMED[1], SSM_TIMED[3]), generator=g,
                              device=dev) for _ in range(2))
        h0 = torch.randn((Bz, SSM_TIMED[2], SSM_TIMED[3]), generator=g,
                         device=dev)
        y0, h_last0 = ssm_kernel.ssm_scan_btd(a, bx, Bm, Cm, h0)
        for _ in range(SSM_REPEATS):
            y, h = ssm_kernel.ssm_scan_btd(a, bx, Bm, Cm, h0)
            assert torch.equal(y, y0) and torch.equal(h, h_last0), \
                f"ssm_scan_btd at Bz={Bz} differs from call to call"
        print(f"check ssm_scan_btd (Bz,T,di,N)={shape + SSM_TIMED[3:]} "
              f"fp32: {SSM_REPEATS + 1} calls bit-identical")
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


def kernel_wrappers():
    """{name: wrapper} of the kernels the LM paths launch."""
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.kernels.rwkv6_scan import kernel as wkv_kernel
    from repro_torch.kernels.ssm_scan import kernel as ssm_kernel
    return {"flash_attention_bhsd": fa_kernel.flash_attention_bhsd,
            "wkv6_bthd": wkv_kernel.wkv6_bthd,
            "ssm_scan_btd": ssm_kernel.ssm_scan_btd}


def expected_launches(cfg, prefills, ticks, forwards=0):
    """The launches of each LM kernel that `prefills` prefills, `ticks`
    decode steps and `forwards` encoder forwards of `cfg` must make:
    prefill (and encoder) attention goes through the flash kernel, each
    recurrence through its kernel in prefill and decode alike; decode
    attention is plain code."""
    L = cfg.n_layers
    return {"flash_attention_bhsd": L * (prefills + forwards)
            if cfg.family != "ssm" else 0,
            "wkv6_bthd": L * (prefills + ticks) if cfg.family == "ssm"
            else 0,
            "ssm_scan_btd": L * (prefills + ticks)
            if cfg.family == "hybrid" else 0}


def lm_card_vs_cpu(dev, arch, compute=None):
    """Reduced `arch` prefill (with its patch embeddings for a VLM) and
    4 decode steps, or one encoder forward (hubert), card (the kernels,
    cuBLAS) against CPU (plain path), with the same params and inputs;
    `compute`: the models' COMPUTE_DTYPE for the call (default bf16).
    MoE routing is compared call by call (`compare.routing_flips`); in
    fp32 it must be equal.  The logits are held within 8 bf16 ulps of
    the largest (fp32: FP32_LOGIT_TOL of it), tokens flipped or not."""
    from repro_torch import models
    from repro_torch.configs import ARCHS, reduced
    from repro_torch.models import layers
    from repro_torch.models.compare import (RouterTap, bf16_ulps,
                                            family_batch, routes,
                                            routing_flips)
    from repro_torch.pytree import tree_map

    cfg = reduced(ARCHS[arch])
    compute = compute or layers.COMPUTE_DTYPE
    before_dtype, layers.COMPUTE_DTYPE = layers.COMPUTE_DTYPE, compute
    wrappers = kernel_wrappers()
    params = models.init_params(cfg, torch.Generator().manual_seed(0))
    batch = family_batch(cfg, 2, 77, 0)
    S = 77 + (cfg.n_image_patches if cfg.modality == "vlm" else 0)
    nxt = torch.from_numpy(np.random.default_rng(1).integers(
        1, cfg.vocab_size, (2, 4)).astype(np.int32))
    want = (expected_launches(cfg, 0, 0, forwards=1) if cfg.encoder_only
            else expected_launches(cfg, 1, 4))
    out, taps = {}, {}
    try:
        for where in ("cpu", dev):
            p = tree_map(lambda x: x.to(where), params)
            b = {k: v.to(where) for k, v in batch.items()}
            before = {k: w.launches for k, w in wrappers.items()}
            with RouterTap() as tap:
                if cfg.encoder_only:
                    logits = [models.forward(cfg, p, b)[0]]
                else:
                    lg, st, _ = models.prefill(cfg, p, b, 128)
                    logits = [lg[:, -1]]
                    for t in range(4):
                        pos = torch.full((2,), S + t, dtype=torch.int32,
                                         device=where)
                        d, st = models.decode_step(cfg, p, st,
                                                   nxt[:, t].to(where), pos)
                        logits.append(d)
            launched = {k: w.launches - before[k]
                        for k, w in wrappers.items()}
            assert launched == (dict.fromkeys(wrappers, 0) if where == "cpu"
                                else want), (arch, where, launched, want)
            out[str(where)] = [x.float().cpu() for x in logits]
            taps[str(where)] = routes(tap.calls)
    finally:
        layers.COMPUTE_DTYPE = before_dtype
    fp32 = compute == torch.float32
    report = routing_flips(taps[str(dev)], taps["cpu"]) if cfg.is_moe \
        else None
    assert not (fp32 and report.flips), report.flips
    worst = 0.0
    for a, b in zip(out["cpu"], out[str(dev)]):
        # bf16 matmuls round in other places on cuBLAS than on the CPU,
        # and the kernels sum in another order: held to 8 bf16 ulps of
        # the largest logit; fp32 compute within FP32_LOGIT_TOL of it
        atol = (FP32_LOGIT_TOL * float(a.abs().max()) if fp32
                else bf16_ulps(a, 8))
        torch.testing.assert_close(b, a, atol=atol, rtol=0)
        worst = max(worst, float((a - b).abs().max()) / atol)
    patches = ", 16 patches" if cfg.modality == "vlm" else ""
    what = ("one encoder forward (B=2, S=77)" if cfg.encoder_only else
            f"prefill (B=2, S={S}{patches}) + 4 decode steps")
    bound = (f"{worst * FP32_LOGIT_TOL:.3g} of the largest logit (bound "
             f"{FP32_LOGIT_TOL:g})" if fp32 else
             f"{worst * 8:.2f} bf16 ulps of the largest logit (bound 8)")
    print(f"reference {arch}-reduced{' fp32 compute' if fp32 else ''}: "
          f"card == CPU on {what}, max |err| {bound}"
          + (f"; {report.note()}" if report else "")
          + f"; card launches {want}")


# the fp32-compute prefill: the reference's own switch
# (models/layers.py:COMPUTE_DTYPE = float32) sends the models' prefill
# attention through the fp32 flash kernel.  (arch, depth): published
# widths, cut to 2 layers (the path's kernels run once a layer; the cut
# keeps the phase to seconds); one prompt of FP32_PROMPT tokens
FP32_PATHS = [("qwen3-0.6b", 2), ("hymba-1.5b", 2)]
FP32_PROMPT = 1024
# kernel path vs plain path: logits within 1e-4 of the largest |logit|
# (both fp32; the flash and scan kernels sum in another order than the
# plain paths, as REC_TOL_F32)
FP32_LOGIT_TOL = 1e-4


def fp32_prefill_path(dev, all_wrappers):
    """For each FP32_PATHS model with COMPUTE_DTYPE = float32 (restored
    after): one prefill of a FP32_PROMPT-token prompt through
    `models.prefill(impl="auto")` (the kernels), every launch count 0
    just before it and read just after, against the same call with
    impl="chunked" (the plain paths) on the card; then one more call of
    each, timed on the host clock between synchronizes (the first calls
    carry the allocator's and the libraries' first-use costs).  Returns
    the flash kernel's launches on the counted calls."""
    import dataclasses
    from repro_torch import models
    from repro_torch.configs import get_config
    from repro_torch.models import layers

    wrappers = kernel_wrappers()
    total = 0
    before_dtype = layers.COMPUTE_DTYPE
    layers.COMPUTE_DTYPE = torch.float32
    try:
        for arch, depth in FP32_PATHS:
            full = get_config(arch)
            cfg = dataclasses.replace(full, n_layers=depth)
            params = models.init_params(cfg,
                                        torch.Generator(dev).manual_seed(0))
            toks = torch.from_numpy(np.random.default_rng(5).integers(
                1, cfg.vocab_size, (1, FP32_PROMPT)).astype(np.int32)).to(dev)
            for w in all_wrappers:
                w.launches = 0
            got, _, _ = models.prefill(cfg, params, {"tokens": toks}, 2048,
                                       impl="auto")
            torch.cuda.synchronize()
            launches = {k: w.launches for k, w in wrappers.items()}
            want = expected_launches(cfg, 1, 0)
            assert launches == want, (arch, launches, want)
            total += launches["flash_attention_bhsd"]
            plain, _, _ = models.prefill(cfg, params, {"tokens": toks},
                                         2048, impl="chunked")
            ms = {}
            for impl in ("auto", "chunked"):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                models.prefill(cfg, params, {"tokens": toks}, 2048,
                               impl=impl)
                torch.cuda.synchronize()
                ms[impl] = (time.perf_counter() - t0) * 1e3
            assert got.dtype == plain.dtype == torch.float32
            assert bool(torch.isfinite(got).all())
            scale = float(plain.abs().max())
            err = float((got - plain).abs().max())
            assert err <= FP32_LOGIT_TOL * scale, (arch, err, scale)
            print(f"main path {arch} fp32 compute: {depth} layers, cut from "
                  f"{full.n_layers} (published widths) | prefill of "
                  f"{FP32_PROMPT} tokens {ms['auto']:.2f} ms through the "
                  f"kernels, {ms['chunked']:.2f} ms plain (second calls) | "
                  f"logits max |err| "
                  f"{err:.3g} (bound {FP32_LOGIT_TOL:g} x {scale:.3g}) | "
                  f"launches " + ", ".join(f"{k} {v}" for k, v in
                                           launches.items() if v))
            del params, got, plain
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        layers.COMPUTE_DTYPE = before_dtype
    return total


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
        print(f"  device busy {busy:.2f} ms of {ms:.2f} ms/round ("
              f"{idle_share(busy, ms)}); top kernels: "
              + "; ".join(f"{key[:50]} {t:.3f} ms" for key, t in top))


def lm_requests(vocab):
    """N_REQUESTS greedy requests: prompt lengths uniform in [PROMPT_LO,
    PROMPT_HI], tokens uniform in [1, vocab), from a seeded numpy RNG."""
    from repro_torch.serving import Request
    rng = np.random.default_rng(0)
    lens = rng.integers(PROMPT_LO, PROMPT_HI + 1, N_REQUESTS)
    return [Request(uid=i, prompt=rng.integers(1, vocab, n).tolist(),
                    max_new_tokens=MAX_NEW) for i, n in enumerate(lens)]


def moe_dropped_frac(fed):
    """The mean dropped_frac (the share of token-expert assignments over
    their expert's capacity) of the round `fed` is about to run, on its
    first local step: each institution's forward on its first batch,
    outside the round's vmap (aux cannot leave it)."""
    from repro_torch import models
    from repro_torch.pytree import tree_map
    toks = fed._round_batches(fed.overlay.round_index)[0]
    with torch.no_grad():
        fracs = [models.forward(fed.cfg, tree_map(lambda x: x[i],
                                                  fed.stacked),
                                {"tokens": toks[i]},
                                impl="ref")[1]["dropped_frac"]
                 for i in range(fed.P)]
    return float(torch.stack(fracs).mean())


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
    recurrent = cfg.family in ("ssm", "hybrid")
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
    routed = ""
    if cfg.is_moe:
        routed = (f" | dropped_frac {moe_dropped_frac(fed):.4f} (the "
                  f"round's first local step)")
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
          f"{[round(float(x), 4) for x in loss[0]]}{routed} | publish "
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
              + (f" + {ticks} ticks" if recurrent else "")
              + f"; prefill {n_layers * n_prefill}"
              + (f", decode {n_layers * ticks} each recurrence"
                 if recurrent else "")
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
          f"{busy:.1f} ms ({idle_share(busy, wall_ms)}), "
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
    """For each cut family at its published width: the training round's
    peak at the two PROBE_DEPTHS, the line through them, then the peak
    at each depth from two below that line's fit upward, until one
    reaches the limit (or runs out of the card's memory): the depth
    before it is the cut.  At the path's depth, the round's largest param
    step at the harness's lr 0.1 and at the path's lr."""
    import dataclasses
    from repro_torch.configs import get_config

    def peak_at(full, d, lr):
        try:
            return train_round(dev, dataclasses.replace(full, n_layers=d),
                               lr)
        except torch.OutOfMemoryError:
            pass                        # past the card: past the limit
        gc.collect()
        torch.cuda.empty_cache()
        return float("inf")
    for arch, cut, lr in LM_PATHS[1:]:
        full = get_config(arch)
        lo, hi = PROBE_DEPTHS[arch]
        peak = {d: peak_at(full, d, lr) for d in (lo, hi)}
        per_layer = (peak[hi] - peak[lo]) / (hi - lo)
        base = peak[lo] - lo * per_layer
        depth = max(int((TRAIN_PEAK_LIMIT_GIB - base) // per_layer) - 2, 1)
        print(f"depth probe {arch}: {peak[lo]:.2f} GiB at {lo} layers, "
              f"{peak[hi]:.2f} GiB at {hi}: {per_layer:.3f} GiB a layer "
              f"over {base:.2f} GiB")
        while depth < full.n_layers:
            peak[depth] = peak_at(full, depth, lr)
            print(f"depth probe {arch}: {peak[depth]:.2f} GiB at {depth} "
                  f"layers")
            if peak[depth] >= TRAIN_PEAK_LIMIT_GIB:
                break
            depth += 1
        print(f"depth probe {arch}: the largest depth below "
              f"{TRAIN_PEAK_LIMIT_GIB:.0f} GiB is {depth - 1}; the path "
              f"runs {cut}")
        for rate in sorted({0.1, lr}, reverse=True):
            _, finite, step = train_round(
                dev, dataclasses.replace(full, n_layers=cut), rate, True)
            print(f"lr probe {arch} at {cut} layers, lr {rate:g}: params "
                  f"finite after the round {finite}, largest step of one "
                  f"param {step:.4g}")


def library_median_ms(fn, iters):
    """Device ms of one fn(i) call of a library: a call to warm it (cuDNN
    builds its plan on the first), then LEAD_IN + `iters` calls traced
    by torch.profiler on the card.  A kernel that the trace recorded at
    least once a call for `iters` calls (m times a call, m from its
    count over all the calls) gives its median over its last m * iters
    launches, times m; the kernels' figures are summed.  After three
    traces in which no kernel was recorded as often, the calls are
    timed by CUDA events (`event_call_ms`).  Returns (ms, each kernel's
    name with its launches a call and its median, least and largest
    us)."""
    fn(0)
    torch.cuda.synchronize()
    calls = LEAD_IN + iters
    for _ in range(3):
        per = device_us(fn, calls, host=False)
        mult = {k: max(1, round(len(v) / calls)) for k, v in per.items()}
        if any(len(v) >= iters * mult[k] for k, v in per.items()):
            break
    else:
        ms = event_call_ms(fn, iters)
        return ms, [f"kernels not traced (the profiler recorded "
                    f"{sum(map(len, per.values()))} launches of {calls} "
                    f"calls, three times): {ms * 1e3:.1f} us a call by "
                    f"CUDA events"]
    last = {k: v[-iters * mult[k]:] for k, v in per.items()}
    ms = sum(mult[k] * float(np.median(v)) for k, v in last.items()) / 1e3
    return ms, [f"{k[:120]} x{mult[k]} ({len(per[k])} of {calls} calls): "
                f"{np.median(v):.1f} ({min(v):.1f}-{max(v):.1f}) us"
                for k, v in last.items()]


def time_flash_shape(dev, shape, label, dtype=torch.bfloat16, causal=True,
                     window=0):
    """The flash kernel at `shape` (B, S, Hq, Hkv, hd) in `dtype`:
    profiler median over 101 launches cycling 8 input sets (past the 50
    MB L2), the plain version's mean over 8 calls by CUDA events, and
    SDPA's time on the same sets (`library_median_ms` over 101 calls;
    GQA through enable_gqa, or, under a window, k and v repeated to Hq
    heads outside the timing and the window as a boolean mask).  Prints
    a line with SDPA's kernels (its backend); returns (ms, plain_ms,
    bound_ms, bound_by, library_ms)."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention import ref as fa_ref
    B, S, Hq, Hkv, hd = shape
    g = torch.Generator(dev).manual_seed(7)
    sets = [[torch.randn((B, S, h, hd), generator=g, device=dev).to(dtype)
             for h in (Hq, Hkv, Hkv)] for _ in range(8)]

    def run(x):
        return fa_ops.flash_attention(*x, causal=causal, window=window)

    def plain(x):
        return fa_ref.attention_reference(*(t.transpose(1, 2) for t in x),
                                          causal=causal, window=window)
    tag = ("flash_attention_bf16_kernel" if dtype == torch.bfloat16
           else "flash_attention_f32_kernel")
    launch_ms = cuda_ms(run, sets, 100)
    p_ms = cuda_ms(plain, sets, 8)
    k_ms = kernel_median_ms(lambda i: run(sets[i % 8]), 101, tag)
    rep = Hq // Hkv if window else 1
    bhsd = [[t.transpose(1, 2).repeat_interleave(rep if j else 1, dim=1)
             .contiguous() for j, t in enumerate(st)] for st in sets]
    mask = None
    if window:
        i = torch.arange(S, device=dev)
        diff = i[:, None] - i[None, :]
        mask = (diff >= 0) & (diff < window)

    def library(i):
        return F.scaled_dot_product_attention(
            *bhsd[i % 8], attn_mask=mask, is_causal=causal and mask is None,
            enable_gqa=rep == 1 and Hq != Hkv)
    lib_ms, lib_names = library_median_ms(library, 101)
    f32 = dtype == torch.float32
    rate = FP32_OPS_PER_S if f32 else BF16_TC_FLOPS
    bytes_ms, ops_ms = flash_bound(B, S, Hq, Hkv, hd, itemsize=4 if f32
                                   else 2, window=window, rate=rate,
                                   causal=causal)
    b_ms = max(bytes_ms, ops_ms)
    b_by = "bytes" if bytes_ms >= ops_ms else "operations"
    flops = ops_ms / 1e3 * rate
    print(f"time flash_attention_bhsd {shape} {str(dtype)[6:]} ({label}) "
          f"causal={causal} window={window}: {tag} median "
          f"{k_ms * 1e3:.1f} us on the card ({flops / k_ms / 1e9:.1f} "
          f"TFLOP/s, {flops / 1e9:.1f} GFLOP; {launch_ms * 1e3:.1f} us per "
          f"call back to back, host launch included) | plain "
          f"{p_ms * 1e3:.1f} us | SDPA median {lib_ms * 1e3:.1f} us "
          f"({'; '.join(lib_names)}) | bound "
          f"{b_ms * 1e3:.2f} us by {b_by} (bytes {bytes_ms * 1e3:.2f} us, "
          f"operations{' at the fp32 rate' if f32 else ''} "
          f"{ops_ms * 1e3:.2f} us); kernel at {b_ms / k_ms:.2%} of bound")
    del sets, bhsd
    return k_ms, p_ms, b_ms, b_by, lib_ms


def time_flash(dev):
    """The flash kernel at the main paths' prefill shapes: qwen3's (S =
    1024, causal) in bf16 and fp32, hymba's window, hubert's encoder and
    llava's window (`time_flash_shape` each).  Returns ({dtype: the
    kernel line's (ms, plain_ms, bound_ms, bound_by, library_ms)} at
    qwen3's shape, {the flash row's keys hubert_* and llava_*})."""
    bf16 = time_flash_shape(dev, FLASH_TIMED, "qwen3")
    time_flash_shape(dev, FLASH_HYMBA, "hymba", window=HYMBA_WINDOW)
    f32 = time_flash_shape(dev, FLASH_TIMED, "qwen3", dtype=torch.float32)
    extra = {}
    for label, shape, causal, window in (
            ("hubert", FLASH_HUBERT, False, 0),
            ("llava", FLASH_LLAVA, True, LLAVA_WINDOW)):
        row = time_flash_shape(dev, shape, label, causal=causal,
                               window=window)
        extra.update({f"{label}_{k}": v for k, v in zip(
            ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms"), row)})
    return {torch.bfloat16: bf16, torch.float32: f32}, extra


def time_recurrent(dev, name, shape):
    """The WKV6 or selective-scan kernel at `shape` (the main path's
    prefill, or one decode tick): profiler median over 101 launches
    cycling through input sets that together exceed the 50 MB L2, the
    plain version's time on the same sets.  Library: none (no single
    PyTorch call computes either recurrence).  Returns (ms, plain_ms,
    bound_ms, bound_by)."""
    g = torch.Generator(dev).manual_seed(9)

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev)
    if name == "wkv6_bthd":
        from repro_torch.kernels.rwkv6_scan import kernel as mod
        from repro_torch.kernels.rwkv6_scan import ref
        B, T, H, hd = shape
        bytes_ms, ops_ms = wkv6_bound(*shape)

        def make():
            return (randn(*shape).bfloat16(), randn(*shape).bfloat16(),
                    randn(*shape).bfloat16(),
                    torch.exp(-torch.exp(randn(*shape) - 1.0)),
                    randn(H, hd) * 0.1, torch.zeros((B, H, hd, hd),
                                                    device=dev))
        run, plain, tag = mod.wkv6_bthd, ref.wkv6_reference, "wkv6_kernel"
    else:
        from repro_torch.kernels.ssm_scan import kernel as mod
        from repro_torch.kernels.ssm_scan import ref
        Bz, T, di, N = shape
        bytes_ms, ops_ms = ssm_bound(*shape)

        def make():
            return (torch.sigmoid(randn(Bz, T, di) + 2.0), randn(Bz, T, di),
                    randn(Bz, T, N), randn(Bz, T, N),
                    torch.zeros((Bz, di, N), device=dev))
        run, plain = mod.ssm_scan_btd, ref.ssm_scan_reference
        tag = "ssm_scan_kernel"
    # sets enough that their bytes (bytes_ms at the HBM rate) pass 64 MB
    n_sets = max(4, math.ceil(64e6 / (bytes_ms * 1e-3 * HBM_BYTES_PER_S)))
    sets = [make() for _ in range(n_sets)]
    launch_ms = cuda_ms(lambda x: run(*x), sets, 100)
    p_ms = cuda_ms(lambda x: plain(*x), sets, 4)
    k_ms = kernel_median_ms(lambda i: run(*sets[i % n_sets]), 101, tag)
    b_ms = max(bytes_ms, ops_ms)
    b_by = "bytes" if bytes_ms >= ops_ms else "operations"
    # every device activity of a call (the scan clears its look-back flags
    # with a memset before a sequence's launch)
    acts = device_us(lambda i: run(*sets[i % n_sets]), 21, host=False)
    per_call = ", ".join(f"{k[:32]} {float(np.median(v)):.2f} us x {len(v)}"
                         for k, v in acts.items())
    print(f"time {name} {shape}: kernel median {k_ms * 1e3:.1f} us on the "
          f"card ({launch_ms * 1e3:.1f} us per call back to back, host "
          f"launch included; 21 calls' device activities: {per_call}) | "
          f"plain {p_ms * 1e3:.1f} us | library: none | "
          f"bound {b_ms * 1e3:.2f} us by {b_by} (bytes {bytes_ms * 1e3:.2f} "
          f"us, operations {ops_ms * 1e3:.2f} us); kernel at "
          f"{b_ms / k_ms:.2%} of bound")
    return k_ms, p_ms, b_ms, b_by


def one_kernel_ms(fn, iters):
    """Median device ms of the one kernel (or copy) each fn(i) launches,
    over `iters` calls under torch.profiler's CUDA activity; after three
    traces that recorded under 90% of the launches, by CUDA events
    (`event_call_ms`)."""
    for _ in range(3):
        times = device_us(fn, iters, host=False)
        assert len(times) <= 1, list(times)
        us = next(iter(times.values()), [])
        if len(us) >= 0.9 * iters:
            return float(np.median(us)) / 1e3
    return event_call_ms(fn, iters)


def time_secure_agg(dev, kernels, totals):
    """Each fused kernel at the main path's shape, all rows alive and with
    rows 0 and 4 dead (42 of the 48 float launches on the fault path carry
    a mask), beside its bound, its plain version and a same-bytes floor
    (`copy_ms`): a copy of the (P, N) f32 rows for the float kernels, an
    int32 column sum of them for the int one; the DP kernel also beside
    its row-norm pre-pass (`prepass_ms`)."""
    from repro_torch.kernels.dp import kernel as dp_kernel
    from repro_torch.kernels.dp import ref as dp_ref
    n_buf = 12        # 12 x (10, 109634) f32 = 53 MB of inputs
    bufs = [torch.randn((P_FULL, N_FULL), device=dev) for _ in range(n_buf)]
    dead = torch.ones(P_FULL, device=dev)
    dead[[0, 4]] = 0.0
    sink = torch.empty((P_FULL, N_FULL), device=dev)
    floors = {
        "float": one_kernel_ms(lambda i: sink.copy_(bufs[i % n_buf]), 101),
        "int": one_kernel_ms(lambda i: torch.sum(
            bufs[i % n_buf].view(torch.int32), 0, dtype=torch.int32), 101)}
    # the DP kernel's row-norm pre-pass (square, sum, sqrt), summed over
    # its kernels' medians
    prepass_ms = call_ms(lambda i: dp_ref._row_norms(bufs[i % n_buf]), 101)
    rows = []
    for name, k in kernels.items():
        if name == "clip_noise":
            norms = {id(b): dp_ref._row_norms(b) for b in bufs}
            run = lambda u, m=None: dp_kernel.clip_noise_flat(   # noqa: E731
                u, norms[id(u)], 7, 0.5, 1.0, m)
            plain = lambda u: dp_ref.clip_noise_reference(   # noqa: E731
                u, 7, 0.5, 1.0, None, norms[id(u)])
        else:
            run = lambda u, m=None, k=k: k["run"](u, m)     # noqa: E731
            plain = lambda u, k=k: k["plain"](u, None)      # noqa: E731
        launch_ms = cuda_ms(run, bufs, 300)
        p_ms = cuda_ms(plain, bufs, 12)
        k_ms = kernel_median_ms(lambda i: run(bufs[i % n_buf]), 101,
                                f"{name}_kernel")
        m_ms = kernel_median_ms(lambda i: run(bufs[i % n_buf], dead), 101,
                                f"{name}_kernel")
        copy_ms = floors["int" if name == "masked_field_wsum" else "float"]
        bytes_ms, ops_ms = bound(name, P_FULL, N_FULL, P_FULL)
        b_ms = max(bytes_ms, ops_ms)
        b_by = "bytes" if bytes_ms >= ops_ms else "operations"
        mb_ms = max(bound(name, P_FULL, N_FULL, P_FULL - 2))
        print(f"time {name}: kernel median {k_ms * 1e3:.2f} us on the card "
              f"({launch_ms * 1e3:.2f} us per call back to back, host "
              f"launch included) | plain {p_ms * 1e3:.1f} us | bound "
              f"{b_ms * 1e3:.2f} us by {b_by} (bytes {bytes_ms * 1e3:.2f} "
              f"us, operations {ops_ms * 1e3:.2f} us); kernel at "
              f"{b_ms / k_ms:.1%} of bound | 2 dead rows {m_ms * 1e3:.2f} us "
              f"(bound {mb_ms * 1e3:.2f} us, {mb_ms / m_ms:.1%}) | "
              f"same-bytes floor {copy_ms * 1e3:.2f} us"
              + (f" | row-norm pre-pass {prepass_ms * 1e3:.2f} us"
                 if name == "clip_noise" else ""))
        rows.append({"name": name, "route": "cuda", "source": k["source"],
                     "replaces": k["replaces"], "launches": totals[name],
                     "max_abs_err": k["max_abs_err"], "ms": k_ms,
                     "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by,
                     "library_ms": None, "masked_ms": m_ms,
                     "copy_ms": copy_ms})
        if name == "clip_noise":
            rows[-1]["prepass_ms"] = prepass_ms
    return rows


WIDE_TIMED = (32, 128)


def time_secure_agg_wide(dev, kernels, launches_wide):
    """Each fused wrapper's P > 16 kernel at (P, N_FULL) for P in
    WIDE_TIMED, rows 0 and 4 dead: the device time of its one kernel
    (profiler median over 21 calls cycling inputs larger than the L2)
    beside its bound and the plain version's time (3 calls).  Returns
    the kernels line's rows, the fleet's P = 32 as `ms`, P = 128 as
    `ms_p128`."""
    from repro_torch.kernels.dp import kernel as dp_kernel
    from repro_torch.kernels.dp import ref as dp_ref
    rows = []
    for name, k in kernels.items():
        row = {"name": f"{name}_wide", "route": "cuda",
               "source": k["source"], "replaces": k["replaces"],
               "launches": launches_wide[name],
               "max_abs_err": k["wide_max_abs_err"], "library_ms": None}
        for P in WIDE_TIMED:
            n_buf = max(2, -(-60_000_000 // (P * N_FULL * 4)))
            bufs = [torch.randn((P, N_FULL), device=dev)
                    for _ in range(n_buf)]
            dead = torch.ones(P, device=dev)
            dead[[0, 4]] = 0.0
            chunk = max(1024, WIDE_WORDS // (P * (P - 1) // 2))
            if name == "clip_noise":
                norms = {id(b): dp_ref._row_norms(b) for b in bufs}
                run = lambda u: dp_kernel.clip_noise_flat(   # noqa: E731
                    u, norms[id(u)], 7, 0.5, 1.0, dead)
                plain = lambda u: dp_ref.clip_noise_reference(  # noqa: E731
                    u, 7, 0.5, 1.0, dead, norms[id(u)])
            else:
                run = lambda u, k=k: k["run"](u, dead)   # noqa: E731
                plain = lambda u, k=k, c=chunk: k["plain"](  # noqa: E731
                    u, dead, chunk=c)
            ms = kernel_median_ms(lambda i: run(bufs[i % n_buf]), 21,
                                  f"{name}_wide_kernel")
            p_ms = cuda_ms(plain, bufs, 3)
            bytes_ms, ops_ms = bound(name, P, N_FULL, P - 2)
            b_ms = max(bytes_ms, ops_ms)
            b_by = "bytes" if bytes_ms >= ops_ms else "operations"
            tag = "" if P == WIDE_TIMED[0] else f"_p{P}"
            row.update({f"ms{tag}": ms, f"plain_ms{tag}": p_ms,
                        f"bound_ms{tag}": b_ms, f"bound_by{tag}": b_by})
            print(f"time {name} P > 16 at ({P}, {N_FULL}), rows 0 and 4 "
                  f"dead: {ms * 1e3:.2f} us on the card | plain "
                  f"{p_ms * 1e3:.1f} us | bound "
                  f"{b_ms * 1e3:.2f} us by {b_by} (bytes "
                  f"{bytes_ms * 1e3:.2f} us, operations "
                  f"{ops_ms * 1e3:.2f} us); kernel at {b_ms / ms:.1%} of "
                  f"bound")
            del bufs
        rows.append(row)
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
        self.calls = []     # (round, committed, rows in, merged rows out)
        overlay._merge = self

    def __call__(self, stacked, key, committed, ref, rnd, part, survivors):
        from repro_torch.pytree import tree_flatten
        out = self.inner(stacked, key, committed, ref, rnd, part, survivors)
        self.calls.append((rnd, committed, stacked, out[0]))
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


# ----------------------------------------------------------------------
# the other merges and the fleet consensus (slice 9)

MERGE_ROUNDS = 3           # timed rounds after a warm-up round
ROBUST = ("trimmed_mean", "coordinate_median", "norm_gated_mean")
BACKBONE_N = 93_248        # the conv stack's parameters at width 1.0
FLEET_P = 32
FLEET_ROUNDS = 6


def partial_kwargs(domain, scheduled=False):
    """CNNFederation knobs of a partial federation: the conv stack is the
    shared backbone, merged by secure_mean in `domain`; each hospital
    keeps a personal head, or, `scheduled`, both blocks are shared and
    merge in turns, one a round."""
    from repro_torch.core.merges import BlockSchedule, BlockSpec
    kw = dict(merge="partial", inner_merge="secure_mean",
              secure_domain=domain,
              block_spec=BlockSpec.by_prefix(backbone="conv", head="head"))
    if scheduled:
        kw["block_schedule"] = BlockSchedule.round_robin(("backbone",
                                                          "head"))
    else:
        kw["merge_blocks"] = ("backbone",)
    return kw


def merge_runs():
    """(label, CNNFederation knobs, hierarchical group size or None) of
    the merges this slice ports; the robust ones under sign_flip_30."""
    from repro_torch.chaos import attack_scenarios
    robust = dict(attack_schedule=attack_scenarios(0)["sign_flip_30"],
                  trim_fraction=0.34)
    return ([("ring", dict(merge="ring"), None),
             ("hierarchical", dict(merge="hierarchical"), 2),
             ("hierarchical", dict(merge="hierarchical"), 5),
             ("quantized", dict(merge="quantized"), None)]
            + [(name, dict(merge=name, **robust), None) for name in ROBUST]
            + [("partial float", partial_kwargs("float"), None),
               ("partial int", partial_kwargs("int"), None),
               ("partial scheduled", partial_kwargs("float", True), None)])


def merge_card_vs_cpu(dev):
    """Each merge of `merge_runs` on a small federation (P = 5, 4 for
    the hierarchical merge's groups of 2; width 0.25, 16x16, FAULT_ROUNDS
    rounds) on the card and on the CPU: equal commits and survivors,
    params within atol = 1e-4.  The quantized merge's params are held
    round by round instead: the CPU merges the rows the card merged, and
    the results agree within atol = 1e-4.  Over whole runs they cannot:
    training's last bits differ between cuDNN and the CPU, and the
    quantizer rounds a few values to the neighbouring int8 step (on an
    H100: 5 of 1,280 head weights, 0.0089 apart; PERF.md)."""
    from repro_torch.chaos.harness import CNNFederation
    from repro_torch.core.merges import get_merge
    from repro_torch.pytree import tree_flatten, tree_map
    seen = set()
    for label, knobs, group in merge_runs():
        if label in seen or label == "partial scheduled":
            continue
        seen.add(label)
        small = dict(n_institutions=4 if group else 5, image_size=16,
                     width_scale=0.25, **knobs)
        g_fed = CNNFederation(None, 0, device=dev, **small)
        c_fed = CNNFederation(None, 0, device="cpu", **small)
        recorder = MergeRecorder(g_fed.overlay)
        _, gtrs = g_fed.run_rounds(FAULT_ROUNDS)
        _, ctrs = c_fed.run_rounds(FAULT_ROUNDS)
        assert [t.survivors for t in gtrs] == [t.survivors for t in ctrs]
        assert [t.committed for t in gtrs] == [t.committed for t in ctrs]
        if knobs["merge"] == "quantized":
            pairs = []
            for rnd, committed, before, after in recorder.calls:
                ctx = c_fed.overlay._merge_context(rnd, committed, None)
                want = get_merge("quantized").merge(
                    tree_map(lambda x: x.cpu(), before), ctx)
                pairs += zip(tree_flatten(after)[0], tree_flatten(want)[0])
        else:
            pairs = zip(tree_flatten(g_fed.stacked)[0],
                        tree_flatten(c_fed.stacked)[0])
        for a, b in pairs:
            np.testing.assert_allclose(a.cpu().numpy(), b.numpy(),
                                       atol=1e-4)
        print(f"reference merge {label}: card == CPU on "
              f"P={small['n_institutions']}, width 0.25, 16x16, "
              f"{FAULT_ROUNDS} rounds"
              + (" (each round's merge of the card's rows)"
                 if knobs["merge"] == "quantized" else "")
              + f"; committed {[t.committed for t in gtrs]}")


class RavelRecorder:
    """Stands in for the kernel module that the secure-agg ops call the
    fused wrappers through (`ops._k`) and records the (P, N) shape of
    every fused call (the launch counts stay on the wrappers); `close`
    puts the module back."""

    def __init__(self):
        from repro_torch.kernels.secure_agg import ops
        self.ops, self.module, self.shapes = ops, ops._k, []
        ops._k = self

    def __getattr__(self, name):
        fn = getattr(self.module, name)
        if not name.startswith("masked_"):
            return fn

        def record(updates, *args, **kwargs):
            self.shapes.append(tuple(updates.shape))
            return fn(updates, *args, **kwargs)
        return record

    def close(self):
        self.ops._k = self.module


def profiled_round(fed, ms):
    """Device busy time of one extra round and the idle share of `ms`."""
    busy = sum(sum(v) for v in device_us(lambda i: fed.run_rounds(1),
                                         1).values()) / 1e3
    return f"device busy {busy:.2f} ms of {ms:.2f} ms/round (" \
        f"{idle_share(busy, ms)})"


def merges_main_path(dev, kernels, totals):
    """The paper's federation at full width (P = 10, width 1.0, 64x64,
    batch 8, 2 local steps) under each merge of `merge_runs`: a warm-up
    round, then MERGE_ROUNDS timed rounds (the robust merges FAULT_ROUNDS
    under sign_flip_30), launch counts from 0.  Every param and loss
    stays finite; the ledger verifies.  The partial runs: the masked
    kernel launches once a round, on the backbone's BACKBONE_N-parameter
    ravel with personal heads, which leave every merge bit-untouched (a
    scheduled run: the block whose turn it is not); every merged
    transaction carries "blocks"; `per_institution_eval` gives finite
    (P,) losses."""
    from repro_torch.chaos.harness import CNNFederation
    from repro_torch.pytree import tree_flatten
    for label, knobs, group in merge_runs():
        fed = CNNFederation(None, 0, n_institutions=P_FULL, local_steps=2,
                            batch=8, image_size=64, width_scale=1.0,
                            device=dev, **knobs)
        if group is not None:
            fed.overlay.cfg.group_size = group
        robust = knobs["merge"] in ROBUST
        fed.run_rounds(1)                     # warm-up
        recorder = MergeRecorder(fed.overlay)
        domain = knobs.get("secure_domain", "float")
        wrapper = ("masked_field_wsum" if domain == "int"
                   else "masked_rolling_update")
        ravel = RavelRecorder()
        for k in kernels.values():
            k["wrapper"].launches = 0
        rounds = FAULT_ROUNDS if robust else MERGE_ROUNDS
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            metrics, trs = fed.run_rounds(rounds)
            torch.cuda.synchronize()
        finally:
            ravel.close()
        ms = (time.perf_counter() - t0) * 1e3 / rounds
        counts = {n: k["wrapper"].launches for n, k in kernels.items()}
        for n in counts:
            totals[n] += counts[n]
        assert bool(torch.isfinite(metrics["loss"]).all()), label
        for x in tree_flatten(fed.stacked)[0]:
            assert bool(torch.isfinite(x).all()), label
        assert fed.overlay.registry.verify_log()
        assert recorder.aborted == sum(not t.committed for t in trs)
        extra = ""
        if knobs["merge"] == "partial":
            assert counts[wrapper] == rounds, (label, counts)
            sched = knobs.get("block_schedule")
            want_n = N_FULL if sched else BACKBONE_N
            assert ravel.shapes == [(P_FULL, want_n)] * rounds, ravel.shapes
            for rnd, committed, before, after in recorder.calls:
                active = sched.active(rnd) if sched else ("backbone",)
                for blk in ("conv", "head"):
                    if {"conv": "backbone", "head": "head"}[blk] in active:
                        continue
                    for a, b in zip(tree_flatten(before[blk])[0],
                                    tree_flatten(after[blk])[0]):
                        assert same_bits(a, b), (label, rnd, blk)
            metas = [json.loads(tx.metadata)
                     for tx in fed.overlay.registry.chain
                     if tx.kind == "rolling_update"]
            assert all("blocks" in m for m in metas), metas
            ev = fed.per_institution_eval()
            assert ev["loss"].shape == (P_FULL,)
            assert np.isfinite(ev["loss"]).all(), ev
            extra = (f" | ravel {ravel.shapes[0]} | per-institution eval "
                     f"loss {np.round(ev['loss'], 3).tolist()}")
        else:
            assert sum(counts.values()) == 0, (label, counts)
        print(f"merge path {label}"
              + (f" (group {group})" if group else "")
              + f": {ms:.2f} ms/round | committed "
              f"{sum(t.committed for t in trs)}/{rounds} | loss "
              f"{[round(float(v), 4) for v in metrics['loss'].mean(dim=1)]}"
              f" | launches {counts}{extra}")
        print(f"  {profiled_round(fed, ms)}")
        del fed, recorder


def fleet_main_path(dev, kernels, fed_kwargs, totals_wide):
    """A fleet at full width: FLEET_P = 32 hospitals, width 1.0, 64x64,
    `ProtocolParams.for_fleet(32)`, FLEET_ROUNDS rounds of secure_mean in
    each mode.  At least one round commits; each round launches the P >
    16 kernels of its mode once (asserted on `launches_wide`); after each
    committed round the institutions lie within 1e-3 of their mean (float
    and int); an aborted round hands back every row bit-untouched."""
    from repro_torch.chaos.harness import CNNFederation
    from repro_torch.core import ProtocolParams
    for mode in MODES:
        fed = CNNFederation(None, 0, n_institutions=FLEET_P, local_steps=2,
                            batch=8, image_size=64, width_scale=1.0,
                            device=dev,
                            consensus_params=ProtocolParams.for_fleet(
                                FLEET_P),
                            **fed_kwargs(mode))
        recorder = MergeRecorder(fed.overlay)
        for k in kernels.values():
            k["wrapper"].launches = k["wrapper"].launches_wide = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        metrics, trs = fed.run_rounds(FLEET_ROUNDS)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / FLEET_ROUNDS
        wide = {n: k["wrapper"].launches_wide for n, k in kernels.items()}
        narrow = {n: k["wrapper"].launches for n, k in kernels.items()}
        for n in wide:
            totals_wide[n] += wide[n]
        want = {"float": ("masked_rolling_update",),
                "int": ("masked_field_wsum",),
                "dp": ("masked_rolling_update", "clip_noise")}[mode]
        for n in kernels:
            assert wide[n] == (FLEET_ROUNDS if n in want else 0), (mode,
                                                                   wide)
        assert sum(narrow.values()) == 0, narrow
        assert any(t.committed for t in trs), "no fleet round committed"
        assert recorder.aborted == sum(not t.committed for t in trs)
        divs = [fed.overlay.divergence(out)
                for _, committed, _, out in recorder.calls if committed]
        if mode != "dp":
            assert max(divs) < 1e-3, divs
        assert bool(torch.isfinite(metrics["loss"]).all()) or mode == "dp"
        assert fed.overlay.registry.verify_log()
        print(f"fleet path P={FLEET_P} {mode}: {ms:.2f} ms/round | "
              f"committed {[t.committed for t in trs]} (aborted rounds "
              f"untouched: {recorder.aborted}) | divergence after the "
              f"committed rounds {max(divs):.3g} | loss "
              f"{[round(float(v), 4) for v in metrics['loss'].mean(dim=1)]}"
              f" | P > 16 launches {wide}")
        print(f"  {profiled_round(fed, ms)}")
        del fed, recorder


# ----------------------------------------------------------------------
# crash recovery (slice 12)

RECOVERY_ROUNDS = 6        # the reference's recovery runs (fig_recovery.py)
RECOVERY_EVERY = 2
# the fleet's crash at round 4 after a snapshot at round 3: round 3's
# work is lost and replayed, and the aborted round 4 runs after failover
FLEET_RECOVERY_EVERY = 3
# the serving tier's reboot: the fp32 phase's cut of qwen3-0.6b
REBOOT_ARCH, REBOOT_DEPTH, REBOOT_REQUESTS = "qwen3-0.6b", 2, 4
MODE_KERNELS = {"float": ("masked_rolling_update",),
                "int": ("masked_field_wsum",),
                "dp": ("masked_rolling_update", "clip_noise")}


def recovery_schedule():
    """The reference's own recovery schedule (its
    benchmarks/fig_recovery.py): 30% dropout and a coordinator crash at
    round 3 that kills the coordinating process."""
    from repro_torch.chaos import CoordinatorCrash, Dropout, compose
    return compose(Dropout(rate=0.3, seed=5),
                   CoordinatorCrash(rounds=(3,), fatal=True))


def fleet_recovery_schedule():
    """Half the fleet stranded in round 4, the round a fatal coordinator
    crash kills the coordinating process: the survivors lack a quorum, so
    round 4 and no other aborts (under the fleet parameters the crash
    round's re-election among 31 fails by itself as well)."""
    from repro_torch.chaos import CoordinatorCrash, Partition, compose
    return compose(Partition(start=4, stop=5,
                             minority=tuple(range(FLEET_P // 2))),
                   CoordinatorCrash(rounds=(4,), fatal=True))


def full_width_federation(dev, schedule, mode_kwargs, P=P_FULL, **kw):
    """The paper's federation at full width (width 1.0, 64x64, batch 8, 2
    local steps) of P hospitals under `schedule`."""
    from repro_torch.chaos.harness import CNNFederation
    return CNNFederation(schedule, 0, n_institutions=P, local_steps=2,
                         batch=8, image_size=64, width_scale=1.0,
                         device=dev, **mode_kwargs, **kw)


@contextlib.contextmanager
def cudnn_free_to_choose():
    """The local step as it was before its convolutions were held to
    cuDNN's deterministic algorithms: `cnn.full_fp32` with the flag
    cleared inside it (the caller's setting is restored on exit)."""
    from repro_torch.models import stigma_cnn as cnn
    held = cnn.full_fp32

    @contextlib.contextmanager
    def tf32_off_only():
        with held():
            torch.backends.cudnn.deterministic = False
            yield
    cnn.full_fp32 = tf32_off_only
    try:
        yield
    finally:
        cnn.full_fp32 = held


def determinism_path(dev, fed_kwargs):
    """Two same-seed full-width federations (P = 10, RECOVERY_ROUNDS
    rounds) in each mode end bit-equal: params fingerprint and chain
    digest (asserted; crash recovery is a replay only if they do).  The
    same pair with the local step's cuDNN free to choose its algorithms,
    for the record, and the main path's ms/round both ways, in turns
    (held, free, free, held; a warm-up round, then RECOVERY_ROUNDS timed
    rounds each)."""
    from repro_torch.pytree import tree_flatten

    def run(mode, free, timed=False):
        with cudnn_free_to_choose() if free else contextlib.nullcontext():
            fed = full_width_federation(dev, None, fed_kwargs(mode))
            if timed:
                fed.run_rounds(1)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fed.run_rounds(RECOVERY_ROUNDS)
            torch.cuda.synchronize()
        return fed, (time.perf_counter() - t0) * 1e3 / RECOVERY_ROUNDS

    for mode in MODES:
        (a, _), (b, _) = run(mode, False), run(mode, False)
        assert a.params_fingerprint() == b.params_fingerprint(), mode
        assert a.chain_digest() == b.chain_digest(), mode
        (c, _), (d, _) = run(mode, True), run(mode, True)
        differ = sum(int((x.view(torch.int32) != y.view(torch.int32)).sum())
                     for x, y in zip(tree_flatten(c.stacked)[0],
                                     tree_flatten(d.stacked)[0]))
        del a, b, c, d
        ms = {False: [], True: []}
        for free in (False, True, True, False):
            ms[free].append(run(mode, free, timed=True)[1])
        print(f"determinism {mode}: two same-seed runs of {RECOVERY_ROUNDS} "
              f"rounds bit-equal (fingerprint and chain digest) | with "
              f"cuDNN free to choose: {differ} of {P_FULL * N_FULL} params "
              f"differ between two runs | ms/round held "
              f"{ms[False][0]:.2f} {ms[False][1]:.2f}, free "
              f"{ms[True][0]:.2f} {ms[True][1]:.2f} (turns held, free, "
              f"free, held)")


def dir_bytes(path):
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, fs in os.walk(path) for f in fs)


class RecoveryProbe:
    """The federation factory `simulate_crash_run` calls, timing what
    recovery does: every snapshot's save (`saves`, on every federation
    built), and on the failover federation (the second built) its
    construction, its restore and verification (`resume_from`) and the
    run after it, whose launches of each kernel (`attr`: "launches" or
    "launches_wide") it counts (`run_launches`).  `on_make(fed)` sees
    every federation built."""

    def __init__(self, make, kernels, attr="launches", on_make=None):
        self.make, self.kernels, self.attr = make, kernels, attr
        self.on_make, self.built, self.saves = on_make, 0, []
        self.times = {}
        self.run_launches = None

    def counts(self):
        return {n: getattr(k["wrapper"], self.attr)
                for n, k in self.kernels.items()}

    def __call__(self):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fed = self.make()
        torch.cuda.synchronize()
        if self.on_make is not None:
            self.on_make(fed)
        save = Stopwatch(fed.overlay.snapshot)
        fed.overlay.snapshot = save
        self.saves.append(save)
        self.built += 1
        if self.built == 2:
            self.times["build"] = time.perf_counter() - t0
            resume, run = Stopwatch(fed.resume_from), fed.run_rounds

            def counted_run(*args, **kwargs):
                before = self.counts()
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                out = run(*args, **kwargs)
                torch.cuda.synchronize()
                self.times["run"] = time.perf_counter() - t1
                self.run_launches = {n: v - before[n]
                                     for n, v in self.counts().items()}
                return out
            fed.resume_from, fed.run_rounds = resume, counted_run
            self.resume = resume
        return fed

    @property
    def save_ms(self):
        calls = [c for s in self.saves for c in s.calls]
        return 1e3 * sum(calls) / len(calls)

    @property
    def restore_ms(self):
        return self.resume.seconds * 1e3


def recovery_main_path(dev, kernels, fed_kwargs, totals):
    """The paper's federation at full width (P = 10) under the reference's
    recovery schedule, in each mode, RECOVERY_ROUNDS rounds with a
    snapshot every RECOVERY_EVERY into a temporary directory: the crash
    round comes from `fatal_crash_rounds`; `simulate_crash_run` (launch
    counts 0 just before, read just after) must give `golden_run`'s chain
    digest and params fingerprint bit for bit, with the mode's kernels
    launched once a round after the failover; then one run per corruption
    mode, a snapshot every round and the newest corrupted, which must
    refuse it, fall back to the one before, and end bit-equal too.
    Prints the snapshot's bytes, the save, restore-and-verify, replay and
    whole-recovery times."""
    from repro_torch.chaos import (
        CORRUPTION_MODES, corrupt_snapshot, fatal_crash_rounds, golden_run,
        simulate_crash_run,
    )
    from repro_torch.checkpoint import list_snapshots
    sched = recovery_schedule()
    crash, = fatal_crash_rounds(sched, RECOVERY_ROUNDS)
    for mode in MODES:
        def make():
            return full_width_federation(dev, sched, fed_kwargs(mode))
        golden = golden_run(make, RECOVERY_ROUNDS)
        probe = RecoveryProbe(make, kernels)
        snap_dir = tempfile.mkdtemp(prefix="recovery-")
        try:
            for k in kernels.values():
                k["wrapper"].launches = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            rep = simulate_crash_run(probe, RECOVERY_ROUNDS, crash,
                                     snap_dir, snapshot_every=RECOVERY_EVERY)
            torch.cuda.synchronize()
            whole_ms = (time.perf_counter() - t0) * 1e3
            counts = {n: k["wrapper"].launches for n, k in kernels.items()}
            snap_bytes = dir_bytes(list_snapshots(snap_dir)[-1][1])
        finally:
            shutil.rmtree(snap_dir, ignore_errors=True)
        for n in counts:
            totals[n] += counts[n]
        assert (rep.chain_digest, rep.params_fingerprint) == golden, mode
        assert rep.restored_round == (crash // RECOVERY_EVERY) * \
            RECOVERY_EVERY and not rep.snapshots_skipped, rep
        after = RECOVERY_ROUNDS - rep.restored_round
        for n in kernels:
            want = after if n in MODE_KERNELS[mode] else 0
            assert probe.run_launches[n] == want, (mode, probe.run_launches)
        failover_ms = 1e3 * (probe.times["build"] + probe.times["run"]) + \
            probe.restore_ms
        run_ms = probe.times["run"] * 1e3
        print(f"recovery path {mode}: crash at round {crash} of "
              f"{RECOVERY_ROUNDS}, snapshot every {RECOVERY_EVERY} | "
              f"restored round {rep.restored_round}, {rep.rounds_replayed} "
              f"lost round replayed, final state bit-equal to the golden "
              f"run | snapshot {snap_bytes:,} bytes, save "
              f"{probe.save_ms:.2f} ms | failover: build "
              f"{probe.times['build'] * 1e3:.2f} ms, restore and verify "
              f"{probe.restore_ms:.2f} ms, replay and finish {after} rounds "
              f"{run_ms:.2f} ms ({run_ms / after:.2f} ms/round) | RTO "
              f"(build + restore + {rep.rounds_replayed} lost round) "
              f"{probe.times['build'] * 1e3 + probe.restore_ms + rep.rounds_replayed * run_ms / after:.2f} ms"
              f" | whole failover {failover_ms:.2f} ms, whole doomed + "
              f"failover run {whole_ms:.2f} ms | launches {counts}, after "
              f"the failover {probe.run_launches}")
        for cmode in CORRUPTION_MODES:
            snap_dir = tempfile.mkdtemp(prefix="recovery-")
            try:
                rep = simulate_crash_run(
                    make, RECOVERY_ROUNDS, crash, snap_dir, snapshot_every=1,
                    corrupt=lambda sd, c=cmode: corrupt_snapshot(
                        list_snapshots(sd)[-1][1], c))
            finally:
                shutil.rmtree(snap_dir, ignore_errors=True)
            assert (rep.chain_digest, rep.params_fingerprint) == golden, \
                (mode, cmode)
            assert rep.restored_round == crash - 1, (cmode, rep)
            assert [os.path.basename(p) for p in rep.snapshots_skipped] == \
                [f"round_{crash:06d}"], (cmode, rep)
        print(f"  each corruption of the newest snapshot "
              f"({', '.join(CORRUPTION_MODES)}) refused; fell back to round "
              f"{crash - 1}, final state bit-equal to the golden run")
        del probe


def fleet_recovery_path(dev, kernels, fed_kwargs, totals_wide):
    """A fleet at full width: FLEET_P = 32 hospitals,
    `ProtocolParams.for_fleet(32)`, under `fleet_recovery_schedule`, in
    each mode, RECOVERY_ROUNDS rounds with a snapshot every
    FLEET_RECOVERY_EVERY.  Exactly one round (4) aborts, in the golden run
    and in the failover run, and `MergeRecorder` sees its rows handed back
    bit-untouched; the recovered run equals the golden run bit for bit;
    the mode's P > 16 kernels launch (counts 0 just before, read just
    after) and the narrow ones do not."""
    from repro_torch.chaos import (
        fatal_crash_rounds, golden_run, simulate_crash_run,
    )
    from repro_torch.checkpoint import list_snapshots
    from repro_torch.core import ProtocolParams
    sched = fleet_recovery_schedule()
    crash, = fatal_crash_rounds(sched, RECOVERY_ROUNDS)
    for mode in MODES:
        recorders = []

        def make():
            fed = full_width_federation(
                dev, sched, fed_kwargs(mode), P=FLEET_P,
                consensus_params=ProtocolParams.for_fleet(FLEET_P))
            recorders.append(MergeRecorder(fed.overlay))
            return fed
        for k in kernels.values():
            k["wrapper"].launches = k["wrapper"].launches_wide = 0
        golden = golden_run(make, RECOVERY_ROUNDS)
        probe = RecoveryProbe(make, kernels, attr="launches_wide")
        snap_dir = tempfile.mkdtemp(prefix="fleet-recovery-")
        try:
            rep = simulate_crash_run(probe, RECOVERY_ROUNDS, crash, snap_dir,
                                     snapshot_every=FLEET_RECOVERY_EVERY)
            snap_bytes = dir_bytes(list_snapshots(snap_dir)[-1][1])
        finally:
            shutil.rmtree(snap_dir, ignore_errors=True)
        wide = {n: k["wrapper"].launches_wide for n, k in kernels.items()}
        narrow = {n: k["wrapper"].launches for n, k in kernels.items()}
        for n in wide:
            totals_wide[n] += wide[n]
        assert (rep.chain_digest, rep.params_fingerprint) == golden, mode
        assert rep.restored_round == FLEET_RECOVERY_EVERY, rep
        gold_rec, doomed_rec, failover_rec = recorders
        aborted = [[rnd for rnd, committed, _, _ in r.calls if not committed]
                   for r in recorders]
        assert aborted == [[crash], [], [crash]], aborted
        assert gold_rec.aborted == failover_rec.aborted == 1
        after = RECOVERY_ROUNDS - rep.restored_round
        for n in kernels:
            want = after if n in MODE_KERNELS[mode] else 0
            assert probe.run_launches[n] == want, (mode, probe.run_launches)
            assert (wide[n] > 0) == (n in MODE_KERNELS[mode]), (mode, wide)
        assert sum(narrow.values()) == 0, narrow
        print(f"fleet recovery P={FLEET_P} {mode}: round {crash} aborted "
              f"(survivors lost quorum) and its rows came back "
              f"bit-untouched, in the golden run and after failover; crash "
              f"at round {crash}, restored round {rep.restored_round}, "
              f"{rep.rounds_replayed} lost round replayed, final state "
              f"bit-equal to the golden run | snapshot {snap_bytes:,} bytes,"
              f" save {probe.save_ms:.2f} ms, restore and verify "
              f"{probe.restore_ms:.2f} ms | P > 16 launches {wide}")
        del recorders, probe, gold_rec, doomed_rec, failover_rec


# ----------------------------------------------------------------------
# the computing continuum: the device tier and the placement

DEV_P, DEV_D, DEV_CHUNK = 64, 16_384, 1_024   # fig_device_tier.py's headline
DEV_FEATURES = 32
DEV_ROUNDS = 4                     # timed rounds after a warm-up round
DEV_CHUNKS = (256, 1_024, 4_096)   # and the stacked baseline, one chunk of D
DEV_PARITY = (8, 2_048, 256)       # (P, D, chunk) held card == CPU
PLACE_P, PLACE_ROUNDS = 16, 3


def device_tier_parts(P, D, chunk, dev, seed=0):
    """fig_device_tier.py's configuration at P x D: the shard spec, the
    DeviceTierConfig, data and update functions, the overlay config and
    the base params on `dev`."""
    from repro_torch.chaos import DeviceSchedule
    from repro_torch.core import OverlayConfig, ProtocolParams
    from repro_torch.core.device_tier import DeviceTierConfig
    from repro_torch.data import (
        DeviceShardSpec, DirichletPartitioner, institution_class_mixes,
        make_centroid_pull_update, make_device_data_fn,
    )
    spec = DeviceShardSpec(n_classes=4, n_features=DEV_FEATURES,
                           min_samples=1, max_samples=16, seed=seed)
    mixes = institution_class_mixes(
        DirichletPartitioner(alpha=0.5, n_institutions=P, seed=seed), 4)
    sched = DeviceSchedule(dropout_rate=0.1, straggler_rate=0.15,
                           max_delay_s=2.0, deadline_s=1.5, seed=seed)
    cfg = DeviceTierConfig(n_devices=D, chunk_size=chunk, max_weight=16,
                           staleness_bound=1, faults=sched)
    ocfg = OverlayConfig(n_institutions=P, local_steps=1,
                         merge="hierarchical_device", merge_subtree="params",
                         consensus_params=ProtocolParams.for_fleet(P))
    base = {"w": torch.linspace(-1.0, 1.0, DEV_FEATURES, device=dev)}
    return spec, cfg, make_device_data_fn(spec, mixes), \
        make_centroid_pull_update(spec), ocfg, base


def leaves_same_bits(a, b):
    """Every leaf of two trees equal bit for bit (on the host: the card
    compares few uint32 operations)."""
    from repro_torch.pytree import tree_flatten
    la, lb = tree_flatten(a)[0], tree_flatten(b)[0]
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and np.array_equal(
            x.cpu().numpy().reshape(-1).view(np.uint8),
            y.cpu().numpy().reshape(-1).view(np.uint8))
        for x, y in zip(la, lb))


def device_weights_oracle(spec, sched, P, D, rounds):
    """Per round, each institution's on-time and late device counts and
    admitted weight, recounted on the host with numpy from
    `DeviceSchedule.draw_host` and the weight hash (staleness bound 1: a
    round admits the weight of the round before's late devices)."""
    from repro_torch.chaos import rng
    from repro_torch.data.pipeline import _DEV_STREAM_WEIGHT
    inst, ids = np.arange(P)[:, None], np.arange(D)[None, :]
    span = spec.max_samples - spec.min_samples + 1
    out, banked = [], np.zeros(P, np.int64)
    for r in range(rounds):
        on, late = sched.draw_host(r, inst, ids)
        w = spec.min_samples + (rng.hash_u32(
            spec.seed, _DEV_STREAM_WEIGHT, r, inst, ids) % np.uint32(span))
        w = w.astype(np.int64)
        out.append({"on_time": on.sum(1), "late": late.sum(1),
                    "weight": (w * on).sum(1) + banked,
                    "stale_w": (w * late).sum(1)})
        banked = out[-1]["stale_w"]
    return out


def device_tier_path(dev, kernels):
    """The device tier at the repo's headline size (benchmarks/
    fig_device_tier.py): P = 64 hospitals x D = 16,384 personal devices =
    2^20 device updates a round, chunks of 1,024, 10% dropout, 15%
    stragglers (late past 1.5 of 2 s, admitted the next round),
    `hierarchical_device` merge, `ProtocolParams.for_fleet(64)`; a warm-up
    round, then DEV_ROUNDS through `run_rounds`.  Gates: (1) `run_rounds`
    equals an eager `round()` loop on the card bit for bit on every leaf;
    (2) one institution's sweep at chunks 256, 1,024, 4,096 and the
    stacked baseline (16,384) gives identical limbs, stats and means; (3)
    every round's on-time and late counts and device weights, and the
    final stale weights, equal a numpy recount from
    `DeviceSchedule.draw_host` and the weight hash; (4) at P = 8, D =
    2,048 the card's local phase equals the CPU's bit for bit (integer
    leaves and the device-tier means) and its final state after 2 rounds
    equals the CPU's, integer leaves bit for bit and params within 1e-6.
    No kernel of ours is on this path (counts 0 before, asserted 0
    after)."""
    import dataclasses
    from repro_torch import random as prng
    from repro_torch.core import DecentralizedOverlay
    from repro_torch.core.device_tier import (
        device_sweep, device_sweep_ids, device_sweep_stacked,
        make_device_local_step, make_device_state,
    )
    P, D, R = DEV_P, DEV_D, DEV_ROUNDS
    spec, cfg, data_fn, update_fn, ocfg, base = device_tier_parts(
        P, D, DEV_CHUNK, dev)
    local_step = make_device_local_step(cfg, data_fn, update_fn)
    ids = device_sweep_ids(1 + R, 1, P, device=dev)
    keys = prng.split(prng.PRNGKey(0), 1 + R)
    for k in kernels.values():
        k["wrapper"].launches = k["wrapper"].launches_wide = 0
    ov = DecentralizedOverlay(ocfg)
    state, m0, _ = ov.run_rounds(make_device_state(base, P), ids[:1],
                                 local_step, keys[:1], 1)   # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, metrics, trs = ov.run_rounds(state, ids[1:], local_step, keys[1:],
                                        R)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / R
    ours = sum(k["wrapper"].launches + k["wrapper"].launches_wide
               for k in kernels.values())
    assert ours == 0, "the device tier launched a kernel of ours"
    assert all(t.committed for t in trs), [t.committed for t in trs]
    w = state["params"]["w"]
    assert bool(torch.isfinite(w).all()) and bool((w == w[0]).all())
    assert ov.registry.verify_log()

    # gate 1: the eager loop on the card
    ov_e = DecentralizedOverlay(ocfg)
    eager = make_device_state(base, P)
    t1 = time.perf_counter()
    for r in range(1 + R):
        eager, _, _ = ov_e.round(eager, ids[r], local_step, keys[r])
    torch.cuda.synchronize()
    eager_ms = (time.perf_counter() - t1) * 1e3 / (1 + R)
    assert leaves_same_bits(eager, state), "run_rounds != eager rounds"
    assert [tx.model_fingerprint for tx in ov_e.registry.chain] == \
        [tx.model_fingerprint for tx in ov.registry.chain]

    # gate 3: the host recount of every round
    oracle = device_weights_oracle(spec, cfg.faults, P, D, 1 + R)
    per_round = [{k: m0[k][0] for k in m0}] + \
        [{k: metrics[k][r] for k in metrics} for r in range(R)]
    for want, got in zip(oracle, per_round):
        for key, name in (("on_time", "device_on_time"),
                          ("late", "device_late"),
                          ("weight", "device_weight")):
            np.testing.assert_array_equal(
                got[name].cpu().numpy().astype(np.int64), want[key])
    np.testing.assert_array_equal(
        state["stale_w"].cpu().numpy().astype(np.int64),
        oracle[-1]["stale_w"])
    np.testing.assert_array_equal(
        state["device_w"].cpu().numpy().astype(np.int64),
        oracle[-1]["weight"])
    on_time = sum(int(o["on_time"].sum()) for o in oracle)
    late = sum(int(o["late"].sum()) for o in oracle)

    # gate 2: one institution's sweep at each chunk size, from a stale
    # buffer that holds late devices
    inst = 1
    params = {"w": state["params"]["w"][inst]}
    stale = {"lo": {"w": state["stale_lo"]["w"][inst]},
             "hi": {"w": state["stale_hi"]["w"][inst]},
             "w": state["stale_w"][inst]}
    sweep_id = torch.tensor(1 + R, dtype=torch.int32, device=dev)
    inst_id = torch.tensor(inst, dtype=torch.int32, device=dev)
    sweeps, peaks, sweep_ms = {}, {}, {}
    for chunk in DEV_CHUNKS + (D,):
        c = dataclasses.replace(cfg, chunk_size=chunk)
        fn = device_sweep_stacked if chunk == D else device_sweep
        fn(params, sweep_id, inst_id, stale, c, data_fn, update_fn)  # warm
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        t2 = time.perf_counter()
        out = fn(params, sweep_id, inst_id, stale, c, data_fn, update_fn)
        torch.cuda.synchronize()
        sweep_ms[chunk] = (time.perf_counter() - t2) * 1e3
        peaks[chunk] = torch.cuda.max_memory_allocated() - held
        sweeps[chunk] = out
    for chunk in sweeps:
        assert leaves_same_bits(sweeps[chunk], sweeps[DEV_CHUNK]), chunk
    assert int(sweeps[D][2]["late"]) > 0 and int(stale["w"]) > 0

    # gate 4: the card against the CPU at P = 8, D = 2,048
    Ps, Ds, Cs = DEV_PARITY
    runs = {}
    for where in (dev, torch.device("cpu")):
        _, c, dfn, ufn, oc, b = device_tier_parts(Ps, Ds, Cs, where)
        step = make_device_local_step(c, dfn, ufn)
        sids = device_sweep_ids(2, 1, Ps, device=where)
        skeys = prng.split(prng.PRNGKey(1), 2)
        o = DecentralizedOverlay(oc)
        local, _ = o.local_phase(make_device_state(b, Ps), sids[0], step)
        final, _, _ = o.run_rounds(make_device_state(b, Ps), sids, step,
                                   skeys, 2)
        runs[where.type] = (local, final)
    assert leaves_same_bits(runs["cuda"][0], runs["cpu"][0]), \
        "the card's sweep differs from the CPU's"
    g_final, c_final = runs["cuda"][1], runs["cpu"][1]
    for k in g_final:
        if k == "params":
            np.testing.assert_allclose(g_final[k]["w"].cpu().numpy(),
                                       c_final[k]["w"].numpy(), atol=1e-6,
                                       rtol=0)
        else:
            assert leaves_same_bits(g_final[k], c_final[k]), k
    params_bits = leaves_same_bits(g_final["params"], c_final["params"])

    # where a round's time goes on the card (a profiled extra round)
    one = device_sweep_ids(1, 1, P, start_round=1 + R, device=dev)
    prof = device_us(lambda i: ov.run_rounds(state, one, local_step,
                                             keys[:1], 1), 1)
    busy = sum(sum(v) for v in prof.values()) / 1e3
    activities = sum(len(v) for v in prof.values())
    top = sorted(((k, sum(v) / 1e3) for k, v in prof.items()),
                 key=lambda kv: -kv[1])[:4]
    print(f"device tier path P={P} x D={D:,} = {P * D:,} devices a round, "
          f"chunks of {DEV_CHUNK:,}: {ms:.2f} ms/round through run_rounds "
          f"({P * D / ms * 1e3:,.0f} devices/s; the eager loop "
          f"{eager_ms:.2f} ms/round) | committed "
          f"{[t.committed for t in trs]} | {on_time:,} on time and "
          f"{late:,} late device updates in {1 + R} rounds, every count and "
          f"weight equal to the host recount | run_rounds == eager, bit for "
          f"bit | launches of our kernels 0")
    print(f"  device busy {busy:.2f} ms of {ms:.2f} ms/round ("
          f"{idle_share(busy, ms)}), {activities:,} device activities a "
          f"round; top: " + "; ".join(f"{k[:40]} {t:.3f} ms" for k, t in top))
    print(f"  one institution's sweep of {D:,} devices: "
          + ", ".join(f"chunk {c:,} {sweep_ms[c]:.2f} ms, peak "
                      f"{peaks[c] / 2 ** 20:.2f} MiB" for c in DEV_CHUNKS)
          + f", stacked {sweep_ms[D]:.2f} ms, peak "
          f"{peaks[D] / 2 ** 20:.2f} MiB | limbs, stats and means identical "
          f"at every chunk size")
    print(f"  card == CPU at P={Ps} x D={Ds:,}: the local phase bit for bit, "
          f"2 rounds' integer leaves bit for bit, params "
          f"{'bit for bit' if params_bits else 'within 1e-6'}")
    return ms


def placement_path(dev, kernels, totals):
    """The paper's CNN federation placed on the continuum by the cost model
    (examples/scale_institutions.py): PLACE_P = 16 hospitals,
    `assign_institutions(16, FederationWorkload(flops_per_image(STIGMA_CNN,
    1.0), 500, 5.0))`, full width, 64x64, 2 local steps, batch 8,
    Dirichlet(0.2) data, `ProtocolParams.for_fleet(16)`, a warm-up round
    and PLACE_ROUNDS timed rounds of secure_mean float and int.  Without a deadline every round
    waits for the modelled stragglers (`straggler_wait_s` > 0) and all 16
    merge; with a deadline at the second-slowest tier's delay the slowest
    tier drops, a quorum stays, the ledger's survivors equal
    `PlacementSchedule.faults(...).participation`, the dropped rows come
    back bit-untouched (`MergeRecorder`), and the cost model's mask
    reaches the fused P <= 16 kernels (counts 0 before each run, read
    after, added to `totals`).  The same schedules at width 0.25 and 16x16
    run on the card and on the CPU: equal survivors, params within atol
    1e-4."""
    from repro_torch.chaos.harness import CNNFederation
    from repro_torch.configs.stigma_cnn import STIGMA_CNN
    from repro_torch.continuum import (
        FederationWorkload, PlacementSchedule, assign_institutions,
    )
    from repro_torch.core import ProtocolParams
    from repro_torch.models.stigma_cnn import flops_per_image
    from repro_torch.pytree import tree_flatten
    P = PLACE_P
    wl = FederationWorkload(flops_per_image(STIGMA_CNN, 1.0), 500, 5.0)
    placements = assign_institutions(P, wl)
    t = np.asarray([p.round_time_s for p in placements])
    delays = np.unique(t - t.min())
    deadline = float(delays[-2])
    tiers = {}
    for p in placements:
        tiers[f"{p.resource} ({p.tier})"] = \
            tiers.get(f"{p.resource} ({p.tier})", 0) + 1
    fleet = dict(n_institutions=P, local_steps=2, batch=8,
                 dirichlet_alpha=0.2,
                 consensus_params=ProtocolParams.for_fleet(P))
    for domain in ("float", "int"):
        name = {"float": "masked_rolling_update",
                "int": "masked_field_wsum"}[domain]
        for dl in (None, deadline):
            sched = PlacementSchedule(placements, deadline_s=dl)
            part = sched.faults(0, P).participation
            assert dl is None or P // 2 < part.sum() < P, part
            fed = CNNFederation(sched, 0, image_size=64, width_scale=1.0,
                                secure_domain=domain, device=dev, **fleet)
            recorder = MergeRecorder(fed.overlay)
            fed.run_rounds(1)                 # warm-up (cuDNN plans)
            for k in kernels.values():
                k["wrapper"].launches = k["wrapper"].launches_wide = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, trs = fed.run_rounds(PLACE_ROUNDS)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3 / PLACE_ROUNDS
            counts = {n: k["wrapper"].launches for n, k in kernels.items()}
            wide = sum(k["wrapper"].launches_wide for k in kernels.values())
            for n in counts:
                totals[n] += counts[n]
            assert counts[name] == PLACE_ROUNDS and wide == 0, counts
            assert all(tr.committed for tr in trs)
            assert all(tr.straggler_wait_s > 0 for tr in trs), \
                [tr.straggler_wait_s for tr in trs]
            survivors = [json.loads(tx.metadata)["survivors"]
                         for tx in fed.overlay.registry.chain
                         if tx.kind == "rolling_update"]
            for r, s in enumerate(survivors):
                want = sched.faults(r, P).participation
                assert s == [int(i) for i in np.flatnonzero(want)], (r, s)
            assert recorder.dead_rows == (1 + PLACE_ROUNDS) * int(
                (~part).sum())
            assert fed.overlay.registry.verify_log()
            print(f"placement path P={P} {domain}, deadline "
                  f"{'none' if dl is None else f'{dl:.4f} s'}: "
                  f"{ms:.2f} ms/round | survivors {int(part.sum())} of {P} "
                  f"as the cost model's mask says (dropped rows untouched: "
                  f"{recorder.dead_rows}) | straggler wait "
                  f"{[round(tr.straggler_wait_s, 4) for tr in trs]} s | "
                  f"launches {counts}")
            del fed, recorder
        small = dict(image_size=16, width_scale=0.25, secure_domain=domain,
                     **fleet)
        sched = PlacementSchedule(placements, deadline_s=deadline)
        g_fed = CNNFederation(sched, 0, device=dev, **small)
        c_fed = CNNFederation(sched, 0, device="cpu", **small)
        _, gtrs = g_fed.run_rounds(PLACE_ROUNDS)
        _, ctrs = c_fed.run_rounds(PLACE_ROUNDS)
        assert [tr.survivors for tr in gtrs] == [tr.survivors for tr in ctrs]
        for a, b in zip(tree_flatten(g_fed.stacked)[0],
                        tree_flatten(c_fed.stacked)[0]):
            np.testing.assert_allclose(a.cpu().numpy(), b.numpy(),
                                       atol=1e-4)
        print(f"  card == CPU under the same deadline at width 0.25, "
              f"16x16, {PLACE_ROUNDS} rounds ({domain})")
    print(f"  placement: {', '.join(f'{k} x{v}' for k, v in tiers.items())}"
          f"; modelled round times {t.min():.4f}-{t.max():.4f} s, "
          f"deadline {deadline:.4f} s")


# ----------------------------------------------------------------------
# the mesh-parallel federation (slice 17): the institution axis over ranks

MESH_P, MESH_ROUNDS = 16, 2
MESH_WORLDS = (2, 4)              # gloo ranks sharing the one card
MESH_RTOL, MESH_ATOL = 2e-5, 1e-6  # the reference's cross-layout bounds
# A rank vmaps its block of hospitals where one process vmaps all 16, and
# the local step's convolutions and bias reductions then sum in another
# order, so the layouts' params differ.  The least atol that holds every
# element at the reference's rtol, read on the card at W = 2 and 4 alike:
# float 6.53e-6 (healthy; 1.3e-7 under dropout); int 1.52e-5, one
# quantization step (2^-16 = 1.53e-5); DP 1.33e-7 healthy and 2.48e-5
# under dropout, where the dead replicas' rows reach 1,716 (one ulp
# 1.22e-4) and their small elements carry errors of the row's scale.
# Each mode is held at the reference's rtol and an atol set from those
# readings: about 3x the float one, one int step and a half, 2x DP's
MESH_TRAIN_ATOL = {"float": 2e-5, "int": 1.5 * 2 ** -16, "dp": 5e-5}
MESH_RUNS = [(mode, sched) for mode in MODES
             for sched in ("healthy", "dropout30")]


def mesh_federation(dev, mode, sched, mesh=None):
    """The paper's federation at full width, P = MESH_P, the fleet
    consensus, in `mode` under `sched` ("healthy" or 30% dropout)."""
    from repro_torch.chaos import Dropout
    from repro_torch.core import ProtocolParams
    from repro_torch.privacy.accountant import DPConfig
    kw = dict(secure_domain="int" if mode == "int" else "float",
              dp=DPConfig(clip_norm=0.5, noise_multiplier=1.0)
              if mode == "dp" else None)
    return full_width_federation(
        dev, None if sched == "healthy" else Dropout(rate=0.30, seed=0),
        kw, P=MESH_P, consensus_params=ProtocolParams.for_fleet(MESH_P),
        mesh=mesh)


def train_in_blocks(overlay, W):
    """Make `overlay.local_phase` train its rows in W blocks, one vmap a
    block, in turn: in one process, the arithmetic of a W-rank mesh."""
    from repro_torch.pytree import tree_map
    inner = overlay.local_phase

    def phase(stacked, batches, local_step):
        per = MESH_P // W
        outs = [inner(tree_map(lambda x: x[r * per:(r + 1) * per], stacked),
                      tree_map(lambda x: x[:, r * per:(r + 1) * per],
                               batches), local_step) for r in range(W)]
        return tuple(tree_map(lambda *xs: torch.cat(xs), *parts)
                     for parts in zip(*outs))
    overlay.local_phase = phase


def mesh_run(fed, kernels):
    """MESH_ROUNDS rounds of `fed` with the kernels' counts from 0, the
    gather timed around each call: (ms a round, gather ms a call,
    transcripts, launches)."""
    gather = Stopwatch(fed.overlay._gather_rows)
    fed.overlay._gather_rows = gather
    for k in kernels.values():
        k["wrapper"].launches = k["wrapper"].launches_wide = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, trs = fed.run_rounds(MESH_ROUNDS)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / MESH_ROUNDS
    counts = {n: k["wrapper"].launches for n, k in kernels.items()}
    assert not any(k["wrapper"].launches_wide for k in kernels.values())
    g_ms = (gather.seconds * 1e3 / len(gather.calls)) if gather.calls \
        else None
    return ms, g_ms, trs, counts


def mesh_record(fed, trs):
    """What a mesh run is held to: its leaves on the host, transcripts,
    stats and chain digest (None on a rank that keeps no ledger)."""
    from repro_torch.pytree import tree_flatten
    return {"leaves": [x.cpu() for x in tree_flatten(fed.stacked)[0]],
            "transcripts": [(t.committed, t.survivors) for t in trs],
            "stats": fed.overlay.stats,
            "digest": fed.chain_digest() if fed.overlay.registry.chain
            else None}


def mesh_rank(rank, world_size, ref_path, out_dir):
    """One rank of part (b) or (c): every MESH_RUNS federation on the
    ("inst",) mesh of all ranks.  Its state must equal bit for bit the
    one-process run that trains the same blocks (and rank 0's chain
    digest that run's), its transcripts and stats too, and lie within
    rtol MESH_RTOL, atol MESH_TRAIN_ATOL[mode] of part (a)'s; rows 1-3
    launched by this rank.  Writes a JSON report to `out_dir`."""
    from repro_torch.sharding import make_institution_mesh, rank_device
    dev = rank_device("cuda")
    mesh = make_institution_mesh(device=dev)
    kernels = secure_agg_kernels(dev)
    refs = torch.load(ref_path, weights_only=False)   # this program's
    mesh_federation(dev, "float", "healthy", mesh).run_rounds(1)  # warm-up
    runs = []
    for mode, sched in MESH_RUNS:
        fed = mesh_federation(dev, mode, sched, mesh)
        ms, g_ms, trs, counts = mesh_run(fed, kernels)
        got = mesh_record(fed, trs)
        want = refs["blocks"][f"{mode}-{sched}"]
        assert all(same_bits(a, b) for a, b in
                   zip(got["leaves"], want["leaves"])), (rank, mode, sched)
        assert got["transcripts"] == want["transcripts"], (mode, sched)
        assert got["stats"] == want["stats"], (mode, sched)
        if rank == 0:          # rank 0 alone keeps the ledger
            assert fed.overlay.registry.verify_chain()
            assert got["digest"] == want["digest"], (mode, sched)
        for name in MODE_KERNELS[mode]:
            assert counts[name] == MESH_ROUNDS, (rank, mode, sched, counts)
        one = refs["one"][f"{mode}-{sched}"]["leaves"]
        held = all(torch.allclose(a, b, rtol=MESH_RTOL,
                                  atol=MESH_TRAIN_ATOL[mode])
                   for a, b in zip(got["leaves"], one))
        err = max(float((a - b).abs().max())
                  for a, b in zip(got["leaves"], one))
        # the least atol that holds every element at rtol MESH_RTOL
        need = max(float(((a - b).abs() - MESH_RTOL * b.abs()).max())
                   for a, b in zip(got["leaves"], one))
        close = all(torch.allclose(a, b, rtol=MESH_RTOL, atol=MESH_ATOL)
                    for a, b in zip(got["leaves"], one))
        runs.append({"mode": mode, "sched": sched, "ms": ms,
                     "gather_ms": g_ms, "max_abs_err": err,
                     "atol_needed": need,
                     "rel": leaf_rel_err(got["leaves"], one),
                     "held": held, "within_reference_bounds": close,
                     "launches": counts, "device": str(dev)})
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(runs, f)


def mesh_ranks(world_size, backend, ref_path, totals):
    """Part (b) or (c): `mesh_rank` on `world_size` spawned ranks; prints
    each run's round ms, gather ms, distance from (a) and launches, rank
    by rank, then fails if a run of a rank lay outside its mode's bound."""
    from repro_torch.launch.mesh import spawn_ranks
    out = tempfile.mkdtemp(prefix="mesh_ranks_")
    try:
        t0 = time.perf_counter()
        spawn_ranks(mesh_rank, world_size, backend=backend,
                    args=(ref_path, out))
        secs = time.perf_counter() - t0
        reports = []
        for r in range(world_size):
            with open(os.path.join(out, f"rank{r}.json")) as f:
                reports.append(json.load(f))
    finally:
        shutil.rmtree(out, ignore_errors=True)
    missed = []
    for i, (mode, sched) in enumerate(MESH_RUNS):
        runs = [rep[i] for rep in reports]
        missed += [(mode, sched, r) for r, run in enumerate(runs)
                   if not run["held"]]
        for run in runs:
            for n, c in run["launches"].items():
                totals[n] += c
        print(f"  W={world_size} {backend} {mode} {sched}: ms/round "
              f"{[round(r['ms'], 2) for r in runs]}, gather ms/call "
              f"{[round(r['gather_ms'], 3) for r in runs]} (rank 0..) | "
              f"max |err| vs (a) {max(r['max_abs_err'] for r in runs):.3g}"
              f" (of the leaf's largest {max(r['rel'] for r in runs):.3g})"
              f", least atol at rtol {MESH_RTOL} "
              f"{max(r['atol_needed'] for r in runs):.3g} (held to "
              f"{MESH_TRAIN_ATOL[mode]:.3g}; within the reference's atol "
              f"{MESH_ATOL}: "
              f"{all(r['within_reference_bounds'] for r in runs)}) | "
              f"launches {runs[0]['launches']} on each of "
              f"{sorted({r['device'] for r in runs})}")
    assert not missed, f"W={world_size}: outside the mode's atol: {missed}"
    print(f"  W={world_size} {backend}: every rank bit-equal to one process "
          f"training the same {MESH_P // world_size}-row blocks (rank 0's "
          f"chain digest too), within rtol {MESH_RTOL} and each mode's "
          f"atol {MESH_TRAIN_ATOL} of (a); {secs:.1f} s with start-up")


def mesh_path(dev, kernels, totals):
    """The federation's institution axis over ranks (`run_rounds(mesh=)`),
    P = MESH_P at full width, MESH_ROUNDS rounds in each MESH_RUNS mode
    and schedule.  (a) A 1-rank NCCL mesh in this process, bit-identical
    to mesh=None (params, chain digest, stats), rows 1-3 launched.  (b)
    W = 2 and 4 spawned ranks sharing this card over gloo (NCCL refuses
    two ranks on one device): every rank's state bit-equal to one
    process training the same blocks (`train_in_blocks`; so the gather
    and the merge are exact), transcripts and stats equal, rank 0's chain
    verified and its digest equal, within rtol MESH_RTOL, atol
    MESH_TRAIN_ATOL[mode] of (a) (the least atol that holds, and whether
    the reference's does, printed), rows 1-3 launched by every rank.  (c)
    NCCL across min(4, count) cards where there is more than one.  Prints
    each run's round ms and the gather's ms on the host clock around the
    collective."""
    from repro_torch.launch.mesh import process_group
    from repro_torch.sharding import make_institution_mesh, mesh_barrier
    one = {}
    mesh_federation(dev, "float", "healthy").run_rounds(1)  # warm-up
    with process_group("nccl"):
        mesh = make_institution_mesh(1)
        mesh_barrier(mesh)                # NCCL's communicator, untimed
        for mode, sched in MESH_RUNS:
            plain = mesh_federation(dev, mode, sched)
            p_ms, _, p_trs, _ = mesh_run(plain, kernels)
            fed = mesh_federation(dev, mode, sched, mesh)
            ms, g_ms, trs, counts = mesh_run(fed, kernels)
            rec = mesh_record(fed, trs)
            assert all(same_bits(a, b.cpu()) for a, b in zip(
                rec["leaves"], mesh_record(plain, p_trs)["leaves"]))
            assert plain.chain_digest() == rec["digest"]
            assert plain.overlay.stats == fed.overlay.stats
            assert [t.committed for t in trs] == \
                [t.committed for t in p_trs] and any(t.committed for t in trs)
            for name in MODE_KERNELS[mode]:
                assert counts[name] == MESH_ROUNDS, (mode, sched, counts)
            for n, c in counts.items():
                totals[n] += c
            one[f"{mode}-{sched}"] = rec
            print(f"mesh path (a) 1-rank nccl {mode} {sched}: "
                  f"{ms:.2f} ms/round (mesh=None {p_ms:.2f}), gather "
                  f"{g_ms:.3f} ms/call | bit-identical to mesh=None "
                  f"(params, chain digest, stats) | launches {counts}")
            del plain, fed
    parts = [(W, "gloo") for W in MESH_WORLDS]
    cards = torch.cuda.device_count()
    if cards > 1:
        parts.append((min(4, cards), "nccl"))
    else:
        print("mesh path (c) NCCL across cards: not run, one card here")
    tmp = tempfile.mkdtemp(prefix="mesh_ref_")
    try:
        for W, backend in parts:
            blocks = one            # a W that P does not divide: replicated
            if MESH_P % W == 0:
                blocks = {}
                for mode, sched in MESH_RUNS:
                    fed = mesh_federation(dev, mode, sched)
                    train_in_blocks(fed.overlay, W)
                    blocks[f"{mode}-{sched}"] = mesh_record(
                        fed, mesh_run(fed, kernels)[2])
            ref_path = os.path.join(tmp, f"ref{W}.pt")
            torch.save({"one": one, "blocks": blocks}, ref_path)
            mesh_ranks(W, backend, ref_path, totals)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def mesh_alone(dev, t_start):
    """`--mesh`: the mesh path alone (after the build)."""
    kernels = secure_agg_kernels(dev)
    totals = {name: 0 for name in kernels}
    mesh_path(dev, kernels, totals)
    print(f"mesh alone: launches {totals}; took "
          f"{time.perf_counter() - t_start:.1f} s after start-up")
    return 0


def copy_snapshot(src, dst, mode):
    """A copy of the snapshot `src` at `dst` for `corrupt_snapshot(dst,
    mode)`: the file the mode rewrites is copied, the payload is
    hard-linked where the mode leaves it as it is."""
    os.makedirs(dst)
    for name in os.listdir(src):
        a, b = os.path.join(src, name), os.path.join(dst, name)
        if name == "arrays.npz" and mode not in ("flip_arrays",
                                                 "torn_arrays"):
            os.link(a, b)
        else:
            shutil.copyfile(a, b)


def serving_reboot_path(dev, all_wrappers):
    """A rebooted serving tier: qwen3-0.6b at its published width cut to
    REBOOT_DEPTH layers; one `LMFederation` round (P = 3) with
    snapshot_every=1 into a temporary directory (removed after);
    `pull_from_snapshot` (timed) feeds a `FederatedServer` on the card
    whose greedy tokens for REBOOT_REQUESTS requests must equal those of
    a server on the live federation's `pull_latest_model`; each
    corruption mode, applied to a copy of the snapshot, must raise
    `SnapshotError`.  Every launch count 0 at the start; returns {LM
    kernel: its launches}."""
    import dataclasses
    from repro_torch.chaos import CORRUPTION_MODES, corrupt_snapshot
    from repro_torch.checkpoint import SnapshotError, list_snapshots
    from repro_torch.configs import get_config
    from repro_torch.pytree import tree_flatten
    from repro_torch.serving import (
        FederatedServer, ModelStore, ServeConfig, pull_from_snapshot,
        pull_latest_model,
    )
    from repro_torch.serving.harness import LMFederation

    full = get_config(REBOOT_ARCH)
    cfg = dataclasses.replace(full, n_layers=REBOOT_DEPTH)
    scfg = ServeConfig(max_seq_len=2048, batch_size=REBOOT_REQUESTS)
    wrappers = kernel_wrappers()
    for w in all_wrappers:
        w.launches = 0
    snap_dir = tempfile.mkdtemp(prefix="reboot-")
    try:
        fed = LMFederation(cfg, 0, device=dev)
        n_params = sum(x[0].numel() for x in tree_flatten(fed.stacked)[0])
        save = Stopwatch(fed.overlay.snapshot)
        fed.overlay.snapshot = save
        _, trs = fed.run_rounds(1, snapshot_every=1, snapshot_dir=snap_dir)
        assert trs[0].committed
        (_, path), = list_snapshots(snap_dir)
        nbytes = dir_bytes(path)
        live_store = ModelStore()
        fed.publish(live_store)
        t0 = time.perf_counter()
        model = pull_from_snapshot(snap_dir, fed.stacked,
                                   cfg=fed.overlay.cfg, arch_family=cfg.name)
        pull_ms = (time.perf_counter() - t0) * 1e3
        live = pull_latest_model(fed.overlay.registry, live_store,
                                 arch_family=cfg.name)
        assert (model.fingerprint, model.version, model.ledger_root) == \
            (live.fingerprint, live.version, live.ledger_root)
        rebooted_store = ModelStore()
        rebooted_store.put(model.params)
        tokens = {}
        for label, store in (("rebooted", rebooted_store),
                             ("live", live_store)):
            srv = FederatedServer(cfg, fed.overlay.registry, store, scfg,
                                  trusted_root=model.ledger_root,
                                  arch_family=cfg.name, device=dev)
            for r in lm_requests(cfg.vocab_size)[:REBOOT_REQUESTS]:
                srv.engine.submit(r)
            tokens[label] = {r.uid: r.generated for r in srv.engine.run()}
            del srv
            gc.collect()
            torch.cuda.empty_cache()
        assert len(tokens["live"]) == REBOOT_REQUESTS
        assert tokens["rebooted"] == tokens["live"]
        launches = {k: w.launches for k, w in wrappers.items()}
        want = expected_launches(cfg, 2 * REBOOT_REQUESTS, 0)
        assert launches == want, (launches, want)
        refuse_ms = {}
        for cmode in CORRUPTION_MODES:
            parent = os.path.join(snap_dir, f"copy-{cmode}")
            copy_snapshot(path, os.path.join(parent,
                                             os.path.basename(path)), cmode)
            corrupt_snapshot(os.path.join(parent, os.path.basename(path)),
                             cmode)
            t0 = time.perf_counter()
            try:
                pull_from_snapshot(parent, fed.stacked, cfg=fed.overlay.cfg)
            except SnapshotError:
                refuse_ms[cmode] = (time.perf_counter() - t0) * 1e3
            finally:
                shutil.rmtree(parent)
            assert cmode in refuse_ms, f"{cmode}: snapshot not refused"
    finally:
        shutil.rmtree(snap_dir, ignore_errors=True)
    print(f"serving reboot {REBOOT_ARCH}: {REBOOT_DEPTH} layers, cut from "
          f"{full.n_layers} (published widths), {n_params:,} parameters | "
          f"1 round, snapshot of the P = 3 carry {nbytes:,} bytes saved in "
          f"{save.seconds * 1e3:.1f} ms | pull from snapshot (restore, "
          f"verify, provenance gate) {pull_ms:.1f} ms | the rebooted "
          f"server's greedy tokens for {REBOOT_REQUESTS} requests equal the "
          f"live server's | each corruption refused: "
          + ", ".join(f"{k} {v:.1f} ms" for k, v in refuse_ms.items())
          + " | launches " + ", ".join(f"{k} {v}" for k, v in
                                       launches.items() if v))
    del fed, model, live, rebooted_store, live_store
    gc.collect()
    torch.cuda.empty_cache()
    return launches


# ----------------------------------------------------------------------
# a redesigned kernel against its parent's, in turns

# ----------------------------------------------------------------------
# training (slice 14): the train launcher's overlay at smollm-360m width

# ----------------------------------------------------------------------
# the MoE, audio and VLM families

FAMILY_CARD_VS_CPU = [("dbrx-132b", None), ("hubert-xlarge", None),
                      ("llava-next-mistral-7b", None),
                      ("olmoe-1b-7b", torch.float32),
                      ("dbrx-132b", torch.float32)]
OLMOE_SERVE = ["--arch", "olmoe-1b-7b", "--requests", "16", "--batch", "8",
               "--max-seq", "2048", "--max-new", "32"]
HUBERT_TRAIN_STEPS = 3
LLAVA_TEXT, LLAVA_DECODE = 2048, 32
# dbrx-132b at its published width: 13.04 GB of fp32 weights a layer, so
# 40 layers (526 GB) cannot sit on one 80 GB card; 2 layers and the
# embeddings take 31.0 GB
DBRX_DEPTH, DBRX_BATCH, DBRX_PROMPT = 2, 2, 1024


def fresh_card(all_wrappers):
    """Every launch count 0, the card's memory free, its peak reset."""
    for w in all_wrappers:
        w.launches = 0
    gc.collect()
    torch.cuda.empty_cache()
    assert torch.cuda.memory_allocated() < 2 ** 30, "memory left over"
    torch.cuda.reset_peak_memory_stats()


def decode_cast_bytes(cfg):
    """The bytes one decode tick of `cfg` moves for its weights' casts,
    as the reference casts them at every product: each stacked matrix
    read in fp32, written in bf16 and read again by the product (8 bytes
    a parameter; the fp32 router read once, 4), and the LM head likewise
    (the norms aside)."""
    from repro_torch import models
    specs = models.param_specs(cfg)
    n = sum(int(np.prod(sp.shape)) * (4 if name == "router" else 8)
            for name, sp in specs["block"].items() if len(sp.shape) >= 3)
    head = specs["embed" if cfg.tie_embeddings else "lm_head"]
    return n + int(np.prod(head.shape)) * 8


def profile_calls(fn, n):
    """fn(i) for i < n between synchronizes, then again traced on the
    card alone: (host ms a call, device busy ms a call, the top kernels
    by device time a call)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(n):
        fn(i)
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3 / n
    per = {k: (sum(v) / 1e3 / n, len(v) / n)
           for k, v in device_us(fn, n, host=False).items()}
    busy = sum(t for t, _ in per.values())
    top = sorted(per.items(), key=lambda kv: -kv[1][0])[:5]
    return host_ms, busy, "; ".join(f"{k[:40]} {t:.2f} ms/{c:g}"
                                    for k, (t, c) in top)


def olmoe_serve_path(dev, all_wrappers):
    """olmoe-1b-7b at its published width and depth (16 layers,
    6,919,100,416 parameters) through the serving launcher,
    `launch.serve.main` (16 requests, batch 8, max_seq 2048, 32 new
    tokens each): prefills and decode ticks timed between synchronizes,
    every launch count 0 at the start.  Returns {LM kernel: launches}."""
    from repro_torch import models
    from repro_torch.configs import get_config
    from repro_torch.launch import serve

    cfg = get_config("olmoe-1b-7b")
    wrappers = kernel_wrappers()
    fresh_card(all_wrappers)
    prefill = Stopwatch(models.prefill, check=lambda out: bool(
        torch.isfinite(out[0][:, -1]).all()))
    step = Stopwatch(models.decode_step,
                     check=lambda out: bool(torch.isfinite(out[0]).all()))
    models.prefill, models.decode_step = prefill, step
    try:
        t0 = time.perf_counter()
        done = serve.main(OLMOE_SERVE)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        models.prefill, models.decode_step = prefill.fn, step.fn
    launches = {k: w.launches for k, w in wrappers.items()}
    n_prefill, ticks = len(prefill.calls), len(step.calls)
    assert len(done) == n_prefill == 16, (len(done), n_prefill)
    want = expected_launches(cfg, n_prefill, ticks)
    assert launches == want, (launches, want)
    decode_toks = sum(len(r.generated) for r in done) - n_prefill
    tick_ms = step.seconds * 1e3 / ticks
    cast = decode_cast_bytes(cfg)
    floor_ms = cast / HBM_BYTES_PER_S * 1e3
    print(f"main path olmoe-1b-7b serve (launch.serve, {cfg.n_layers} "
          f"layers, {models.param_count(cfg):,} parameters): "
          f"{' '.join(OLMOE_SERVE[2:])} | {wall:.2f} s in all (weights "
          f"drawn on the card) | {n_prefill} prefills "
          f"{prefill.seconds * 1e3:.1f} ms | {ticks} decode ticks, "
          f"{decode_toks} tokens: {tick_ms:.2f} ms a tick against the "
          f"weight casts' floor {floor_ms:.2f} ms ({cast / 1e9:.2f} GB a "
          f"tick at {HBM_BYTES_PER_S / 1e12:.2f} TB/s) | launches "
          f"flash_attention_bhsd {launches['flash_attention_bhsd']} "
          f"({cfg.n_layers} layers x {n_prefill} prefills) | peak device "
          f"memory {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
    # where a tick's time goes: 5 ticks of 8 slots on the launcher's
    # weights, timed, then traced on the card
    from repro_torch.launch.train import initial_params
    params = initial_params(cfg, dev)
    state = models.init_decode_state(cfg, 8, 2048, dev)
    toks = torch.arange(3, 11, dtype=torch.int32, device=dev)
    pos = torch.full((8,), 100, dtype=torch.int32, device=dev)
    models.decode_step(cfg, params, state, toks, pos)
    host_ms, busy, top = profile_calls(
        lambda i: models.decode_step(cfg, params, state, toks, pos), 5)
    print(f"  a decode tick of 8 slots again: {host_ms:.2f} ms on the host "
          f"clock, device busy {busy:.2f} ms ({idle_share(busy, host_ms)}"
          f"); top: {top}")
    del params, state
    return launches


def warm_then_time(call):
    """call("auto") (the kernels) and call("ref") (the plain path) once
    each to warm both (cuBLAS's handles, the first launches), then each
    again between synchronizes: ({impl: output}, {impl: ms})."""
    for impl in ("auto", "ref"):
        call(impl)
    out, ms = {}, {}
    for impl in ("auto", "ref"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out[impl] = call(impl)
        torch.cuda.synchronize()
        ms[impl] = (time.perf_counter() - t0) * 1e3
    return out, ms


def hubert_path(dev, all_wrappers):
    """hubert-xlarge at its published width and depth (48 layers,
    1,259,705,600 parameters), the launchers' weights: one encoder
    forward of 4 clips of 1,500 frames (30 s at 20 ms a frame) through
    `models.forward(impl="auto")` under no_grad, every launch count 0 at
    the start, held against impl="ref" on the card within 8 bf16 ulps of
    the largest logit (each timed after a warm-up call); then HUBERT_TRAIN_STEPS steps of
    `make_train_step` (AdamW, remat, the plain paths) on the per-frame
    labels of `SyntheticTokenDataset`, as `launch.train` runs them.
    Gates: the loss finite; AdamW's moments finite, m nonzero in every
    leaf but the untied `embed` (in no path of the loss: its moments stay
    0), the count the steps'.  Then reduced hubert's steps card == CPU.
    Returns {LM kernel: launches} of the forward."""
    from repro_torch import models
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticTokenDataset
    from repro_torch.launch.train import initial_params
    from repro_torch.models.compare import bf16_ulps
    from repro_torch.optim import adamw_init
    from repro_torch.pytree import tree_flatten
    from repro_torch.training import make_train_step

    cfg = get_config("hubert-xlarge")
    B, S = FLASH_HUBERT[:2]
    wrappers = kernel_wrappers()
    fresh_card(all_wrappers)
    params = initial_params(cfg, dev)
    frames = {"frame_embeddings": torch.randn(
        (B, S, cfg.d_model), generator=torch.Generator(dev).manual_seed(3),
        device=dev)}
    with torch.no_grad():
        out, ms = warm_then_time(lambda impl: models.forward(
            cfg, params, frames, impl=impl)[0])
    launches = {k: w.launches for k, w in wrappers.items()}
    want = expected_launches(cfg, 0, 0, forwards=2)     # warm-up, timed
    assert launches == want, (launches, want)
    got, ref = out["auto"].float(), out["ref"].float()
    assert got.shape == (B, S, cfg.vocab_size) and bool(
        torch.isfinite(got).all())
    atol = bf16_ulps(ref, 8)
    torch.testing.assert_close(got, ref, atol=atol, rtol=0)
    err = float((got - ref).abs().max()) / atol * 8
    del out, got, ref
    print(f"main path hubert-xlarge encoder: {cfg.n_layers} layers, "
          f"{models.param_count(cfg):,} parameters | forward of {B} x "
          f"{S} frames {ms['auto']:.1f} ms through the kernel, "
          f"{ms['ref']:.1f} ms plain (after a warm-up call each) | logits "
          f"max |err| "
          f"{err:.2f} bf16 ulps of the largest (bound 8) | launches "
          f"flash_attention_bhsd {launches['flash_attention_bhsd']}")

    step_fn = make_train_step(cfg, train_config())
    ds = SyntheticTokenDataset(cfg, DataConfig(seq_len=S, global_batch=B))
    opt = adamw_init(params)
    losses, step_ms = [], []
    for s in range(HUBERT_TRAIN_STEPS):
        batch = {k: torch.from_numpy(v).to(dev)
                 for k, v in ds.batch(s).items()}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt, metrics = step_fn(
            params, opt, torch.tensor(s, dtype=torch.int32, device=dev),
            batch)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(metrics["loss"]))
    assert all(math.isfinite(v) for v in losses), losses
    assert int(opt["count"]) == HUBERT_TRAIN_STEPS
    for key in ("m", "v"):
        assert all(bool(torch.isfinite(x).all())
                   for x in tree_flatten(opt[key])[0]), key
        assert not bool(opt[key]["embed"].any()), key
    zero_m = [n for n, x in opt["m"]["block"].items() if not bool(x.any())]
    assert not zero_m and bool(opt["m"]["lm_head"].any()), zero_m
    print(f"main path hubert-xlarge train: {HUBERT_TRAIN_STEPS} steps of "
          f"{B} x {S} frames (AdamW lr {TRAIN_LR:g}, {TRAIN_WARMUP} "
          f"warm-up steps, remat) | "
          f"{', '.join(f'{v:.1f}' for v in step_ms)} ms a step | loss "
          f"{[round(v, 4) for v in losses]} | AdamW m nonzero in every "
          f"leaf but the untied embed (0, as its v) | peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
    del params, opt, step_fn, metrics
    hubert_train_card_vs_cpu(dev)
    return launches


def hubert_train_card_vs_cpu(dev):
    """Reduced hubert, 2 steps of `make_train_step` (the path's config)
    on 4 x 32 frames on the card and on the CPU from the same weights
    (drawn on the CPU): AdamW's m within M_REL_CARD_CPU of each leaf's
    largest, as `training_card_vs_cpu` holds smollm's."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.data import DataConfig, SyntheticTokenDataset
    from repro_torch.launch.train import initial_params
    from repro_torch.optim import adamw_init
    from repro_torch.pytree import tree_map
    from repro_torch.training import make_train_step
    cfg = reduced(get_config("hubert-xlarge"))
    host = initial_params(cfg, torch.device("cpu"))
    ds = SyntheticTokenDataset(cfg, DataConfig(seq_len=32, global_batch=4))
    opts = {}
    for d in ("cpu", str(dev)):
        params = tree_map(lambda x: x.to(d), host)
        opt = adamw_init(params)
        step_fn = make_train_step(cfg, train_config())
        for s in range(2):
            batch = {k: torch.from_numpy(v).to(d)
                     for k, v in ds.batch(s).items()}
            params, opt, _ = step_fn(
                params, opt, torch.tensor(s, dtype=torch.int32, device=d),
                batch)
        opts[d] = tree_map(lambda x: x.cpu(), opt)
    m_err = leaf_rel_err(opts[str(dev)]["m"], opts["cpu"]["m"])
    v_err = leaf_rel_err(opts[str(dev)]["v"], opts["cpu"]["v"])
    assert m_err <= M_REL_CARD_CPU, m_err
    print(f"  hubert train card == CPU: reduced, 2 steps of 4 x 32 frames: "
          f"AdamW m within {m_err:.4g} of each leaf's largest (limit "
          f"{M_REL_CARD_CPU}), v within {v_err:.4g}")


def llava_path(dev, all_wrappers):
    """llava-next-mistral-7b at its published width and depth (32 layers,
    7,241,732,096 parameters), the launchers' weights: `models.prefill`
    of 2,304 patch embeddings (n_image_patches) and 2,048 text tokens
    (4,352 positions under the 4,096-token window, so the window masks),
    every launch count 0 at the start, held against impl="ref" on the
    card within 8 bf16 ulps of the largest logit (each timed after a
    warm-up call); then LLAVA_DECODE
    greedy `decode_step`s through the rolling cache (W = 4,096: the
    prefill's tail wraps the slots, and each step overwrites the oldest).
    Returns {LM kernel: launches}."""
    from repro_torch import models
    from repro_torch.configs import get_config
    from repro_torch.launch.train import initial_params
    from repro_torch.models.compare import bf16_ulps

    cfg = get_config("llava-next-mistral-7b")
    wrappers = kernel_wrappers()
    fresh_card(all_wrappers)
    params = initial_params(cfg, dev)
    g = torch.Generator(dev).manual_seed(4)
    batch = {"tokens": torch.randint(1, cfg.vocab_size, (1, LLAVA_TEXT),
                                     generator=g, device=dev,
                                     dtype=torch.int32),
             "patch_embeddings": torch.randn(
                 (1, cfg.n_image_patches, cfg.d_model), generator=g,
                 device=dev)}
    S = cfg.n_image_patches + LLAVA_TEXT
    assert (1, S) + FLASH_LLAVA[2:] == FLASH_LLAVA and S > LLAVA_WINDOW
    cache = S + LLAVA_DECODE
    with torch.no_grad():
        out, ms = warm_then_time(lambda impl: models.prefill(
            cfg, params, batch, cache, impl=impl))
        launches = {k: w.launches for k, w in wrappers.items()}
        got, state, _ = out["auto"]
        ref = out["ref"][0]
        assert got.shape == (1, S, cfg.vocab_size)
        atol = bf16_ulps(ref, 8)
        torch.testing.assert_close(got.float(), ref.float(), atol=atol,
                                   rtol=0)
        err = float((got.float() - ref.float()).abs().max()) / atol * 8
        assert state["k"].shape[2] == LLAVA_WINDOW
        tok = got[:, -1].argmax(-1).int()
        del out, ref
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for t in range(LLAVA_DECODE):
            pos = torch.full((1,), S + t, dtype=torch.int32, device=dev)
            logits, state = models.decode_step(cfg, params, state, tok, pos)
            assert bool(torch.isfinite(logits).all()), t
            tok = logits.argmax(-1).int()
        torch.cuda.synchronize()
        tick_ms = (time.perf_counter() - t0) * 1e3 / LLAVA_DECODE
        pos = torch.full((1,), cache, dtype=torch.int32, device=dev)
        host_ms, busy, top = profile_calls(
            lambda i: models.decode_step(cfg, params, state, tok, pos), 3)
    held = sorted(state["pos"][0, 0].tolist())
    assert held == list(range(cache - LLAVA_WINDOW, cache)), held[:4]
    after = {k: w.launches for k, w in wrappers.items()}
    want = expected_launches(cfg, 2, LLAVA_DECODE)      # warm-up, timed
    assert launches == after == want, (launches, after, want)
    print(f"main path llava-next-mistral-7b: {cfg.n_layers} layers, "
          f"{models.param_count(cfg):,} parameters | prefill of "
          f"{cfg.n_image_patches} patches + {LLAVA_TEXT} tokens (window "
          f"{LLAVA_WINDOW}) {ms['auto']:.1f} ms through the kernel, "
          f"{ms['ref']:.1f} ms plain (after a warm-up call each) | logits "
          f"max |err| "
          f"{err:.2f} bf16 ulps of the largest (bound 8) | "
          f"{LLAVA_DECODE} greedy decode steps {tick_ms:.2f} ms each, the "
          f"cache holding positions {held[0]}..{held[-1]} | launches "
          f"flash_attention_bhsd {launches['flash_attention_bhsd']} | peak "
          f"device memory {torch.cuda.max_memory_allocated() / 2 ** 30:.2f}"
          f" GiB")
    print(f"  a decode step again: {host_ms:.2f} ms on the host clock, "
          f"device busy {busy:.2f} ms ({idle_share(busy, host_ms)}); top: "
          f"{top}")
    del params, state
    return launches


def dbrx_path(dev, all_wrappers):
    """dbrx-132b at its published width cut to DBRX_DEPTH layers (see
    DBRX_DEPTH), the launchers' weights: `models.prefill` of DBRX_BATCH
    prompts of DBRX_PROMPT tokens and 4 decode steps, through the kernel
    (impl="auto", every launch count 0 at the start) and the plain path
    (impl="ref") on the card, each prefill timed after a warm-up call.
    MoE routing compared call by call (`compare.routing_flips`: the
    router inputs held within 8 bf16 ulps up to the first call with a
    flip, layer 0's prefill call at least, and that call's flips within
    8 bf16 ulps of its largest router logit); the logits within 8 bf16
    ulps of the largest when no token flipped (a flip changes the token's
    FFN output, and attention carries it on).  Returns {LM kernel:
    launches}."""
    import dataclasses
    from repro_torch import models
    from repro_torch.configs import get_config
    from repro_torch.launch.train import initial_params
    from repro_torch.models.compare import (RouterTap, bf16_ulps,
                                            family_batch, routes,
                                            routing_flips)

    full = get_config("dbrx-132b")
    cfg = dataclasses.replace(full, n_layers=DBRX_DEPTH)
    wrappers = kernel_wrappers()
    fresh_card(all_wrappers)
    params = initial_params(cfg, dev)
    batch = family_batch(cfg, DBRX_BATCH, DBRX_PROMPT, 6, dev)
    nxt = torch.from_numpy(np.random.default_rng(7).integers(
        1, cfg.vocab_size, (DBRX_BATCH, 4)).astype(np.int32)).to(dev)
    out, taps, ms = {}, {}, {}
    with torch.no_grad():
        for impl in ("auto", "ref"):                        # warm-up
            models.prefill(cfg, params, batch, 2 * DBRX_PROMPT, impl=impl)
        for impl in ("auto", "ref"):
            with RouterTap() as tap:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                lg, st, aux = models.prefill(cfg, params, batch,
                                             2 * DBRX_PROMPT, impl=impl)
                torch.cuda.synchronize()
                ms[impl] = (time.perf_counter() - t0) * 1e3
                logits = [lg[:, -1]]
                for t in range(4):
                    pos = torch.full((DBRX_BATCH,), DBRX_PROMPT + t,
                                     dtype=torch.int32, device=dev)
                    d, st = models.decode_step(cfg, params, st, nxt[:, t],
                                               pos)
                    logits.append(d)
            if impl == "auto":
                launches = {k: w.launches for k, w in wrappers.items()}
                dropped = float(aux["dropped_frac"])
            out[impl] = [x.float() for x in logits]
            taps[impl] = routes(tap.calls)
            del lg, st, tap
    want = expected_launches(cfg, 2, 0)                 # warm-up, timed
    assert launches == want, (launches, want)
    report = routing_flips(taps["auto"], taps["ref"])
    worst = 0.0
    for a, b in zip(out["ref"], out["auto"]):
        assert bool(torch.isfinite(b).all())
        atol = bf16_ulps(a, 8)
        if not report.flips:
            torch.testing.assert_close(b, a, atol=atol, rtol=0)
        worst = max(worst, float((a - b).abs().max()) / atol * 8)
    print(f"main path dbrx-132b: {DBRX_DEPTH} layers, cut from "
          f"{full.n_layers} (published widths; {full.n_layers} layers "
          f"would need {models.param_count(full) * 4 / 1e9:.0f} GB), "
          f"{models.param_count(cfg):,} parameters | prefill of "
          f"{DBRX_BATCH} x {DBRX_PROMPT} tokens {ms['auto']:.1f} ms "
          f"through the kernel, {ms['ref']:.1f} ms plain (after a warm-up "
          f"call each), dropped_frac {dropped:.4f} | prefill + 4 decode "
          f"steps, kernel vs plain: {report.note()} | logits max |err| "
          f"{worst:.2f} bf16 ulps of the largest (bound 8"
          f"{', not held: tokens flipped' if report.flips else ''}) | "
          f"launches flash_attention_bhsd "
          f"{launches['flash_attention_bhsd']} | peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
    del params, taps, out
    return launches


def family_paths(dev, all_wrappers, lap=print):
    """The MoE, audio and VLM families' full-width paths after the LM
    federation paths: olmoe served at full depth by `launch.serve`,
    hubert, llava, dbrx, each followed by lap(its name); returns the
    flash kernel's launches in them."""
    total = 0
    for path in (olmoe_serve_path, hubert_path, llava_path, dbrx_path):
        total += path(dev, all_wrappers)["flash_attention_bhsd"]
        lap(path.__name__)
    gc.collect()
    torch.cuda.empty_cache()
    return total


TRAIN_ARCH = "smollm-360m"
TRAIN_P, TRAIN_LOCAL_STEPS = 4, 2
TRAIN_SEQ, TRAIN_BATCH = 512, 16
TRAIN_ROUNDS = 3                 # timed rounds after a warm-up, each mode
TRAIN_LR, TRAIN_WARMUP, TRAIN_TOTAL = 3e-4, 5, 50
TRAIN_N = 361_821_120            # smollm-360m's parameters (tied head)
ROWS_EQUAL_ATOL = 1e-6           # a committed merge: the 4 rows agree
TRAIN_PARITY = dict(seq_len=32, global_batch=8, rounds=2)
REMAT_GATE_LAYERS = 8
# card vs CPU in bf16 compute: AdamW's m within this share of each leaf's
# largest |m| (PERF.md section 6 gives the readings behind it)
M_REL_CARD_CPU = 0.04


def train_config(remat=True):
    """The launcher's training config at the path's settings: AdamW lr
    3e-4, 5 warm-up steps, remat; ``impl="auto"``, which trains through
    the plain paths; the fused cross-entropy on by the reference's
    threshold (vocab 49,152 >= 16,384)."""
    from repro_torch.optim import AdamWConfig
    from repro_torch.training import TrainConfig
    return TrainConfig(optimizer=AdamWConfig(learning_rate=TRAIN_LR),
                       total_steps=TRAIN_TOTAL, warmup_steps=TRAIN_WARMUP,
                       remat=remat)


def training_overlay(dev, mode_kwargs, remat=True, data=None, cfg=None,
                     params=None):
    """The launcher's overlay parts (`launch.train.setup_overlay`) at the
    path's settings: (cfg, state, local step, overlay, dataset), so that
    the path can time and profile each round.  `params`: the starting
    weights (by default the launcher's, drawn on `dev`)."""
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig
    from repro_torch.launch.train import setup_overlay
    cfg = cfg or get_config(TRAIN_ARCH)
    data = data or DataConfig(seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH)
    return (cfg,) + setup_overlay(
        cfg, train_config(remat), data, n_inst=TRAIN_P,
        local_steps=TRAIN_LOCAL_STEPS, merge="secure_mean", alpha=1.0,
        device=dev, params=params, **mode_kwargs)


def training_round(state, local_step, overlay, ds, r):
    """Round r of the launcher's loop (`launch.train.overlay_round`):
    (state, mean loss, transcript)."""
    from repro_torch.launch.train import overlay_round
    state, metrics, tr = overlay_round(overlay, ds, state, local_step, r)
    return state, metrics["loss"].float().mean(), tr


def rows_spread(tree):
    """The largest distance of any institution's leaf from row 0's."""
    from repro_torch.pytree import tree_flatten
    return max(float((x - x[:1]).abs().max()) for x in tree_flatten(tree)[0])


def leaf_rel_err(got, want):
    """The largest |got - want| of a leaf over that leaf's largest |want|,
    the largest over the leaves: an error that scales with the values
    held, so a lost or wrong gradient reads near 1."""
    from repro_torch.pytree import tree_flatten
    return max(float((a.cpu() - b.cpu()).abs().max()
                     / b.cpu().abs().max().clamp_min(1e-30))
               for a, b in zip(tree_flatten(got)[0], tree_flatten(want)[0]))


def training_card_vs_cpu(dev):
    """Reduced smollm-360m, P = 4, seq 32, 2 rounds of secure_mean float
    and int through the launcher's parts on the card and on the CPU, from
    the same weights, drawn on the CPU: equal commits and survivors, and
    after each round AdamW's first moments (the steps' clipped gradients,
    each hospital's own) within M_REL_CARD_CPU of each leaf's largest.
    The params are printed, not held: AdamW moves a param by about lr a
    step whatever its gradient's size, so they cannot tell a wrong
    gradient from a right one."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.data import DataConfig
    from repro_torch.launch.train import initial_params
    from repro_torch.pytree import tree_flatten, tree_map
    cfg = reduced(get_config(TRAIN_ARCH))
    host = initial_params(cfg, torch.device("cpu"))
    data = DataConfig(seq_len=TRAIN_PARITY["seq_len"],
                      global_batch=TRAIN_PARITY["global_batch"])
    for domain in ("float", "int"):
        out = {}
        for d in ("cpu", dev):
            _, state, step, ov, ds = training_overlay(
                torch.device(d), {"secure_domain": domain}, data=data,
                cfg=cfg, params=tree_map(lambda x: x.to(d), host))
            trs, moments = [], []
            for r in range(TRAIN_PARITY["rounds"]):
                state, _, tr = training_round(state, step, ov, ds, r)
                trs.append((tr.committed, tr.survivors))
                moments.append(tree_map(lambda x: x.cpu(), state["opt"]))
            out[str(d)] = (trs, moments, [x.cpu() for x in
                                          tree_flatten(state["params"])[0]])
        cpu, card = out["cpu"], out[str(dev)]
        assert cpu[0] == card[0], (cpu[0], card[0])
        m_err = [leaf_rel_err(a["m"], b["m"]) for a, b in zip(card[1], cpu[1])]
        v_err = [leaf_rel_err(a["v"], b["v"]) for a, b in zip(card[1], cpu[1])]
        assert max(m_err) <= M_REL_CARD_CPU, (domain, m_err)
        diff = max(float((a - b).abs().max()) for a, b in zip(card[2], cpu[2]))
        print(f"  training card == CPU ({domain}): reduced {TRAIN_ARCH}, "
              f"P = 4, seq {data.seq_len}, {TRAIN_PARITY['rounds']} rounds: "
              f"commits and survivors equal; AdamW m within "
              f"{', '.join(f'{e:.4g}' for e in m_err)} of each leaf's "
              f"largest after each round (limit {M_REL_CARD_CPU}), v within "
              f"{', '.join(f'{e:.4g}' for e in v_err)}; params apart by "
              f"up to {diff:.3g} (not held)")


def training_remat_gate(dev):
    """One float round of the path from one state, with remat and without,
    at smollm-360m's published width cut to REMAT_GATE_LAYERS layers
    (without remat a layer keeps ~3 GB of plain attention's fp32 scores
    and softmax for the backward pass: 32 layers would not fit the card):
    params and both AdamW moments bit-equal (under the overlay's
    ``vmap(grad)`` the recompute runs the same ops in the same order);
    both peaks printed."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.pytree import tree_flatten, tree_map
    cfg = dataclasses.replace(get_config(TRAIN_ARCH),
                              n_layers=REMAT_GATE_LAYERS)
    gc.collect()
    torch.cuda.empty_cache()
    rows, peaks, losses = {}, {}, {}
    for remat in (True, False):
        _, state, step, ov, ds = training_overlay(
            dev, {"secure_domain": "float"}, remat=remat, cfg=cfg)
        ov._flush = lambda rounds: None       # the ledger is not gated here
        torch.cuda.reset_peak_memory_stats()
        state, loss, _ = training_round(state, step, ov, ds, 0)
        torch.cuda.synchronize()
        peaks[remat] = torch.cuda.max_memory_allocated() / 2 ** 30
        losses[remat] = float(loss)
        rows[remat] = tree_map(lambda x: x.cpu(), {     # off the card
            "params": tree_map(lambda x: x[0], state["params"]),
            "m": state["opt"]["m"], "v": state["opt"]["v"]})
        del state, step, ov
        gc.collect()
        torch.cuda.empty_cache()
    unequal = {key: sum(not torch.equal(a, b) for a, b in zip(
        tree_flatten(rows[True][key])[0], tree_flatten(rows[False][key])[0]))
        for key in rows[True]}
    m_max = max(float(x.abs().max())
                for x in tree_flatten(rows[True]["m"])[0])
    assert m_max > 0 and not any(unequal.values()), (unequal, m_max)
    print(f"  remat gate ({TRAIN_ARCH} cut to {REMAT_GATE_LAYERS} "
          f"layers): one round from one state, params, AdamW m (largest "
          f"{m_max:.3g}) and v with remat and without equal bit for bit; "
          f"loss {losses[True]:.4f} / {losses[False]:.4f}; peak "
          f"{peaks[True]:.2f} GiB with remat, {peaks[False]:.2f} GiB "
          f"without")


def training_path(dev, kernels, fed_kwargs, totals):
    """`launch.train`'s overlay at smollm-360m's published width and depth
    (32 layers, d 960, 15 heads of 64, vocab 49,152: N = 361,821,120 a
    hospital), P = 4, ``DataConfig(seq_len=512, global_batch=16)``, 2
    local steps, `train_config` (remat, the fused cross-entropy), merged
    by secure_mean in the float domain, the int domain and the float
    domain with DP (clip 0.5, sigma 1.0): a warm-up round and
    TRAIN_ROUNDS timed rounds each, counts from 0 after the warm-up, the
    last timed round traced on the card (device busy, idle share).
    Gates: every loss finite; every committed round leaves the 4 rows'
    params within ROWS_EQUAL_ATOL of each other while the AdamW moments
    stay each hospital's own; the ledger verifies; the mode's kernel
    launches once a round.  Then the remat and card-vs-CPU gates."""
    from repro_torch.pytree import tree_flatten
    expect = {"float": {"masked_rolling_update": TRAIN_ROUNDS},
              "int": {"masked_field_wsum": TRAIN_ROUNDS},
              "dp": {"masked_rolling_update": TRAIN_ROUNDS,
                     "clip_noise": TRAIN_ROUNDS}}
    for mode in MODES:
        gc.collect()
        torch.cuda.empty_cache()
        assert torch.cuda.memory_allocated() < 2 ** 30, "memory left over"
        torch.cuda.reset_peak_memory_stats()
        cfg, state, step, ov, ds = training_overlay(dev, fed_kwargs(mode))
        n = sum(x[0].numel() for x in tree_flatten(state["params"])[0])
        assert n == TRAIN_N, n
        flush = Stopwatch(ov._flush)
        ov._flush = flush
        state, loss, tr = training_round(state, step, ov, ds, 0)
        losses, ms = [float(loss)], []
        for k in kernels.values():
            k["wrapper"].launches = k["wrapper"].launches_wide = 0
        for r in range(1, 1 + TRAIN_ROUNDS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if r == TRAIN_ROUNDS:
                with torch.profiler.profile(activities=[
                        torch.profiler.ProfilerActivity.CUDA]) as prof:
                    state, loss, tr = training_round(state, step, ov, ds,
                                                     r)
                    torch.cuda.synchronize()
                per_kernel = {}
                for e in prof.events():
                    if str(e.device_type).endswith("CUDA"):
                        t_n = per_kernel.setdefault(e.name, [0.0, 0])
                        t_n[0] += e.time_range.elapsed_us() / 1e3
                        t_n[1] += 1
                del prof
            else:
                state, loss, tr = training_round(state, step, ov, ds, r)
                torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            losses.append(float(loss))
            assert tr.committed, (mode, r)
            spread = rows_spread(state["params"])
            assert spread <= ROWS_EQUAL_ATOL, (mode, r, spread)
        counts = {n_: k["wrapper"].launches for n_, k in kernels.items()}
        wide = sum(k["wrapper"].launches_wide for k in kernels.values())
        for n_ in counts:
            totals[n_] += counts[n_]
        want = dict.fromkeys(kernels, 0)
        want.update(expect[mode])
        assert counts == want and wide == 0, (mode, counts)
        assert all(math.isfinite(v) for v in losses), (mode, losses)
        assert all(bool(torch.isfinite(x).all())
                   for x in tree_flatten(state["params"])[0]), mode
        # the moments are each hospital's own: the merge never saw them
        m_spread = rows_spread(state["opt"]["m"])
        assert m_spread > 0, mode
        assert state["opt"]["count"].tolist() == \
            [(1 + TRAIN_ROUNDS) * TRAIN_LOCAL_STEPS] * TRAIN_P
        assert ov.registry.verify_chain() and ov.registry.verify_log()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        busy = sum(t for t, _ in per_kernel.values())
        top = sorted(per_kernel.items(), key=lambda kv: -kv[1][0])[:6]
        print(f"training path {TRAIN_ARCH} {mode}: {cfg.n_layers} layers, "
              f"{n:,} parameters a hospital, P = {TRAIN_P}, seq "
              f"{TRAIN_SEQ}, batch {TRAIN_BATCH}, {TRAIN_LOCAL_STEPS} local "
              f"steps | {np.mean(ms[:-1]):.2f} ms/round "
              f"({', '.join(f'{v:.1f}' for v in ms[:-1])}; the DLT flush "
              f"{np.mean(flush.calls[1:]) * 1e3:.1f} ms of a round: "
              f"{TRAIN_P + 1} fingerprints of {n * 4 / 1e9:.2f} GB on the "
              f"host) | the profiled round {ms[-1]:.1f} ms, device busy "
              f"{busy:.1f} ms ({idle_share(busy, ms[-1])}) | peak "
              f"{peak:.2f} GiB | loss a round "
              f"{[round(v, 4) for v in losses]} | rows within {spread:.2g}, "
              f"moments apart by up to {m_spread:.3g} | launches {counts}")
        print(f"  the profiled round's "
              f"{sum(c for _, c in per_kernel.values())} device activities;"
              f" top:" + "; ".join(f" {k[:48]} {t:.1f} ms/{c}"
                                   for k, (t, c) in top))
        del state, step, ov, flush, loss
    gc.collect()
    torch.cuda.empty_cache()
    training_remat_gate(dev)
    training_card_vs_cpu(dev)


def time_secure_agg_train(dev, kernels):
    """Rows 1-3 once each at the training path's (4, TRAIN_N), all rows
    alive: held against their plain versions on the same rows by
    `check_secure_agg`'s standards (the share-sum equal, the float round
    within atol = P * 1e-6, the DP noise within rtol = 1e-5, atol = 1e-6;
    the largest error kept as ``train_max_abs_err``), then timed beside
    their bounds (`bound`, `op_counts`) and a same-bytes floor (a copy_ of
    the (4, N) f32 rows; the int kernel's floor is the same copy, as its
    bytes are one read of the rows)."""
    from repro_torch.kernels.dp import kernel as dp_kernel
    from repro_torch.kernels.dp import ref as dp_ref
    gc.collect()
    torch.cuda.empty_cache()
    g = torch.Generator(dev).manual_seed(11)
    rows = torch.randn((TRAIN_P, TRAIN_N), generator=g, device=dev)
    sink = torch.empty_like(rows)
    copy_ms = kernel_median_ms(lambda i: sink.copy_(rows), 5,
                               "Memcpy DtoD")
    del sink
    norms = dp_ref._row_norms(rows)
    out = {}
    for name, k in kernels.items():
        got, want = k["run"](rows, None), k["plain"](rows, None)
        torch.cuda.synchronize()
        err = 0.0
        for p in range(TRAIN_P):           # a row at a time: 1.45 GB each
            if name == "masked_field_wsum":
                assert torch.equal(got[p], want[p]), (name, p)
                continue
            torch.testing.assert_close(
                got[p], want[p], equal_nan=True, **(
                    dict(atol=TRAIN_P * 1e-6, rtol=0)
                    if name == "masked_rolling_update"
                    else dict(atol=1e-6, rtol=1e-5)))
            err = max(err, float((got[p] - want[p]).abs().max()))
        del got, want
        torch.cuda.empty_cache()
        if name == "clip_noise":
            run = lambda: dp_kernel.clip_noise_flat(   # noqa: E731
                rows, norms, 7, 0.5, 1.0, None)
        else:
            run = lambda k=k: k["run"](rows, None)     # noqa: E731
        k_ms = kernel_median_ms(lambda i: run(), 5, f"{name}_kernel")
        bytes_ms, ops_ms = bound(name, TRAIN_P, TRAIN_N, TRAIN_P)
        b_ms = max(bytes_ms, ops_ms)
        out[name] = {"train_shape": [TRAIN_P, TRAIN_N], "train_ms": k_ms,
                     "train_max_abs_err": err,
                     "train_bound_ms": b_ms,
                     "train_bound_by": "bytes" if bytes_ms >= ops_ms
                     else "operations", "train_copy_ms": copy_ms}
        print(f"time {name} at ({TRAIN_P}, {TRAIN_N:,}): kernel == plain "
              f"(max |err| {err:.3g}) | kernel median "
              f"{k_ms:.3f} ms | bound {b_ms:.3f} ms by "
              f"{out[name]['train_bound_by']} (bytes {bytes_ms:.3f}, "
              f"operations {ops_ms:.3f}); kernel at {b_ms / k_ms:.1%} of "
              f"bound | same-bytes copy {copy_ms:.3f} ms")
    del rows, norms
    gc.collect()
    torch.cuda.empty_cache()
    return out


def call_ms(fn, iters):
    """Median device ms of one fn(i) call, all of its kernels: each
    kernel's median times its launches a call, summed, over LEAD_IN +
    `iters` calls traced by torch.profiler's CUDA activity.  A trace that
    recorded fewer launches than calls is taken again, and after three
    the calls are timed by CUDA events (`event_call_ms`)."""
    calls = LEAD_IN + iters
    for _ in range(3):
        acts = device_us(fn, calls, host=False)
        if sum(map(len, acts.values())) >= calls:
            return sum(round(len(v) / calls) * float(np.median(v))
                       for v in acts.values()) / 1e3
    return event_call_ms(fn, iters)


def time_kernels(dev):
    """`--time-kernels SRC`: from the package under SRC (built into its
    tree's own build directory), the fp32 flash kernel at FLASH_TIMED,
    causal, and the DP kernel past 16 rows at (P, N_FULL), P in
    WIDE_TIMED, rows 0 and 4 dead; each a call's device time (`call_ms`,
    101 and 21 calls cycling inputs larger than the L2).  The flash
    kernel also without the causal mask, where every q tile does the same
    work.  Prints them as one JSON line."""
    from repro_torch.kernels.dp import kernel as dp_kernel
    from repro_torch.kernels.dp import ref as dp_ref
    from repro_torch.kernels.flash_attention import ops as fa_ops
    g = torch.Generator(dev).manual_seed(7)
    B, S, Hq, Hkv, hd = FLASH_TIMED
    sets = [[torch.randn((B, S, h, hd), generator=g, device=dev)
             for h in (Hq, Hkv, Hkv)] for _ in range(4)]
    out = {f"flash_f32{tag}_us": call_ms(
        lambda i, c=causal: fa_ops.flash_attention(*sets[i % 4], causal=c),
        101) * 1e3 for tag, causal in (("", True), ("_noncausal", False))}
    del sets
    for P in WIDE_TIMED:
        n_buf = max(2, -(-60_000_000 // (P * N_FULL * 4)))
        bufs = [torch.randn((P, N_FULL), generator=g, device=dev)
                for _ in range(n_buf)]
        norms = [dp_ref._row_norms(b) for b in bufs]
        dead = torch.ones(P, device=dev)
        dead[[0, 4]] = 0.0
        out[f"clip_noise_p{P}_us"] = call_ms(
            lambda i: dp_kernel.clip_noise_flat(
                bufs[i % n_buf], norms[i % n_buf], 7, 0.5, 1.0, dead),
            21) * 1e3
        del bufs
    print(json.dumps(out))


# ---- the gossip shim, the torch examples and the dry-run's count ------
GOSSIP_P = 10
EXAMPLE_FLAGS = {      # each example's smallest flags (quickstart has none)
    "quickstart": [],
    "chaos_federation": ["--scenario", "churn", "--rounds", "1"],
    "adversarial_federation": ["--attack", "sign_flip_30", "--rounds", "1"],
    "personalized_federation": ["--rounds", "1"],
    "continuum_serve": ["--requests", "2", "--max-new", "1"],
    "device_tier_federation": ["--institutions", "2", "--devices", "8",
                               "--chunk", "4", "--rounds", "1"],
    # its published size, on a 1-rank NCCL mesh in this process
    "scale_institutions": ["--world-size", "1", "--backend", "nccl"],
}
# the kernels each example must launch on the card
EXAMPLE_KERNELS = {
    "quickstart": ("masked_rolling_update",),
    "chaos_federation": ("masked_rolling_update",),
    "adversarial_federation": ("clip_noise",),
    "personalized_federation": (),
    "continuum_serve": ("flash_attention_bhsd",),
    "device_tier_federation": (),
    "scale_institutions": ("masked_rolling_update",),
}
DRYRUN_PREFILL = ("qwen3-0.6b", 1, 1024)          # arch, batch, tokens
DRYRUN_RWKV = ("rwkv6-3b", 2, 1, 256)             # arch, layers, batch, tokens
DRYRUN_TRAIN = ("smollm-360m", 4, 512)            # arch, batch, tokens


def gossip_shim_path(dev, kernels, totals):
    """The five `core.gossip` shim functions, masked and unmasked, on a
    (P, ...) tree on the card: bit-equal to the merge registry's output
    for the same context.  secure_mean goes through the fused kernel."""
    from repro_torch import random as prng
    from repro_torch.core import gossip
    from repro_torch.core.merges import MergeContext, get_merge
    from repro_torch.pytree import tree_flatten
    g = torch.Generator(dev).manual_seed(7)
    tree = {"w": torch.randn(GOSSIP_P, 4096, generator=g, device=dev),
            "b": {"c": torch.randn(GOSSIP_P, 3, 17, generator=g,
                                   device=dev)}}
    mask = torch.ones(GOSSIP_P, dtype=torch.bool, device=dev)
    mask[[0, 4]] = False
    key = prng.PRNGKey(77)
    calls = {
        "mean": (lambda m: gossip.mean_merge(tree, True, alpha=0.7, mask=m),
                 lambda m: MergeContext(commit=True, mask=m, alpha=0.7)),
        "ring": (lambda m: gossip.ring_merge(tree, True, shift=2, alpha=0.4,
                                             mask=m),
                 lambda m: MergeContext(commit=True, mask=m, alpha=0.4,
                                        shift=2)),
        "hierarchical": (
            lambda m: gossip.hierarchical_merge(tree, True, group_size=5,
                                                alpha=0.7, mask=m),
            lambda m: MergeContext(commit=True, mask=m, alpha=0.7,
                                   group_size=5)),
        "quantized": (
            lambda m: gossip.quantized_mean_merge(tree, True, alpha=0.7,
                                                  mask=m),
            lambda m: MergeContext(commit=True, mask=m, alpha=0.7)),
        "secure_mean": (
            lambda m: gossip.secure_mean_merge(tree, True, alpha=0.7,
                                               key=key, mask=m),
            lambda m: MergeContext(commit=True, mask=m, alpha=0.7,
                                   key=key)),
    }
    for k in kernels.values():
        k["wrapper"].launches = 0
    for name, (shim, ctx) in calls.items():
        for m in (None, mask):
            got = tree_flatten(shim(m))[0]
            want = tree_flatten(get_merge(name).merge(tree, ctx(m)))[0]
            assert all(a.is_cuda and same_bits(a, b)
                       for a, b in zip(got, want)), (name, m is not None)
    counts = {name: k["wrapper"].launches for name, k in kernels.items()}
    for name in counts:
        totals[name] += counts[name]
    assert counts["masked_rolling_update"] == 4, counts    # shim + registry
    print(f"gossip shim at P = {GOSSIP_P} on the card: 5 merges x "
          f"(unmasked, masked) bit-equal to the registry | launches {counts}")


def example_module(name):
    import importlib.util
    path = ROOT / "examples" / f"torch_{name}.py"
    spec = importlib.util.spec_from_file_location(f"torch_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod    # spawned ranks unpickle by this name
    spec.loader.exec_module(mod)
    return mod


def examples_path(dev, kernels, lm_wrappers, totals, lm_launches):
    """Each `examples/torch_*.py` `main` at its smallest flags on the
    card, its wall time and the launches it made (counts from 0 before
    each), which go into the kernels line."""
    wrappers = {name: k["wrapper"] for name, k in kernels.items()}
    wrappers.update(lm_wrappers)
    for name, flags in EXAMPLE_FLAGS.items():
        mod = example_module(name)
        for w in wrappers.values():
            w.launches = 0
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            text = mod.main(flags)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = {n: w.launches for n, w in wrappers.items()}
        for n, c in counts.items():
            if n in totals:
                totals[n] += c
            else:
                lm_launches[n] += c
        for n in EXAMPLE_KERNELS[name]:
            assert counts[n] > 0, (name, counts)
        assert "nan" not in text.lower(), (name, text)
        last = text.strip().splitlines()[-1]
        print(f"example torch_{name} {' '.join(flags)} on cuda: "
              f"{secs:.2f} s | launches "
              f"{ {n: c for n, c in counts.items() if c} } | {last[:100]}")


def dryrun_crosscheck(dev):
    """The dry-run's count (`launch.op_cost` on meta tensors) against real
    steps on the card under ``torch.utils.flop_counter.FlopCounterMode``
    with the same impl: a qwen3-0.6b prefill and a reduced-depth rwkv6-3b
    train step (the matmul FLOPs must be equal, and the predicted args
    the bytes of the real params, optimizer state and batch); then the
    predicted temp of a smollm-360m train step beside
    ``torch.cuda.max_memory_allocated`` (printed, not held)."""
    import dataclasses
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.configs import get_config
    from repro_torch.configs.base import InputShape
    from repro_torch.launch import dryrun, op_cost
    from repro_torch.optim import adamw_init
    from repro_torch.pytree import tree_map

    def real_like(meta_args, vocab):
        """Seeded tensors on the card in the meta args' shapes; integer
        leaves are token ids."""
        def one(t):
            if t.is_floating_point():
                return 0.02 * torch.randn(t.shape, generator=gen, device=dev,
                                          dtype=t.dtype)
            return torch.randint(1, vocab, t.shape, generator=gen,
                                 device=dev, dtype=t.dtype)
        return tree_map(one, meta_args)

    def check(label, cfg, shape, real_args_fn, impl):
        fn, meta_args = dryrun.step_and_args(cfg, shape, impl)
        t0 = time.perf_counter()
        counts = op_cost.analyze_ops(fn, *meta_args)
        count_s = time.perf_counter() - t0
        temp = counts["peak_bytes"] - dryrun._storage_bytes(counts["out"])
        args = real_args_fn(meta_args)
        predicted = dryrun._storage_bytes(meta_args)
        real = dryrun._storage_bytes(args)
        assert predicted == real, (label, predicted, real)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        with FlopCounterMode(display=False) as fc:
            out = fn(*args)
        torch.cuda.synchronize()
        real_temp = (torch.cuda.max_memory_allocated() - before
                     - dryrun._storage_bytes(out))
        flops = fc.get_total_flops()
        assert counts["matmul_flops"] == flops, (label, counts, flops)
        for t in op_cost.tensors(out):
            assert bool(torch.isfinite(t.float()).all()), label
        gib = 2.0 ** 30
        print(f"dry-run cross-check {label}: matmul FLOPs counted on meta "
              f"{counts['matmul_flops']:.6e} == FlopCounterMode on the card "
              f"{flops:.6e}; args {predicted:,} B predicted == {real:,} B "
              f"real; temp predicted {temp / gib:.3f} GiB vs "
              f"max_memory_allocated less args and outputs "
              f"{real_temp / gib:.3f} GiB; count {count_s:.2f} s")
        del out, args

    gen = torch.Generator(dev).manual_seed(0)

    def train_args(vocab):
        def make(meta):
            params = real_like(meta[0], vocab)
            return (params, adamw_init(params),
                    torch.zeros((), dtype=torch.int32, device=dev),
                    real_like(meta[3], vocab))
        return make

    arch, B, S = DRYRUN_PREFILL
    cfg = get_config(arch)
    check(f"{arch} prefill ({B}, {S:,})", cfg,
          InputShape("prefill", S, B, "prefill"),
          lambda meta: real_like(meta, cfg.vocab_size), "ref")
    arch, layers, B, S = DRYRUN_RWKV
    cfg = dataclasses.replace(get_config(arch), n_layers=layers)
    check(f"{arch} ({layers} layers) train step ({B}, {S})", cfg,
          InputShape("train", S, B, "train"), train_args(cfg.vocab_size),
          "ref")
    arch, B, S = DRYRUN_TRAIN
    cfg = get_config(arch)
    check(f"{arch} train step ({B}, {S})", cfg,
          InputShape("train", S, B, "train"), train_args(cfg.vocab_size),
          "auto")


# one cheap combo per production mesh: (arch, shape, lower_one flags)
DRYRUN_MESH_COMBOS = (
    ("hubert-xlarge", "prefill_32k", {"single_pod": True}),
    ("hubert-xlarge", "prefill_32k", {"multi_pod": True}),
    ("hubert-xlarge", "train_4k", {"multi_pod": True, "overlay": True}),
)
DRYRUN_MESH_CARD = ("qwen3-0.6b", "decode_32k")   # rank 0's shards on the card


def rank0_shape(shape, placements, mesh_shape):
    """Rank 0's shard of a tensor of global `shape` laid out by
    `placements` over a mesh of `mesh_shape`, from the sizes alone: each
    ``Shard(d)`` keeps the first ceil(n / k) of dim d's n, GSPMD's padded
    share too."""
    local = list(shape)
    for k, p in zip(mesh_shape, placements):
        if p.is_shard():
            local[p.dim] = -(-local[p.dim] // k)
    return tuple(local)


def dryrun_mesh_path(dev):
    """The dry-run on the production meshes (`launch.dryrun` with a mesh:
    DTensors on a fake 256- or 512-rank group, counted as rank 0 runs
    the step, collectives priced by link): one combo on each of 16x16,
    2x16x16 and 2x16x16+overlay, its roofline lines printed.  Then the
    card check: on a fake 256-rank mesh, rank 0's shards of a qwen3-0.6b
    ``decode_32k`` serve step are allocated on the card and the step
    runs there.  The count's per-device args must equal the real shards'
    bytes and, leaf by leaf, the shards that each leaf's global shape and
    its placements' mesh sizes give rank 0 (`rank0_shape`); the outputs'
    local shapes must equal the count's; the predicted temp prints beside ``max_memory_allocated``.
    A fake group's collectives move nothing, so only shapes and bytes
    are checked, never values.  No kernel of ours runs here."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.configs import INPUT_SHAPES, get_config
    from repro_torch.launch import dryrun, op_cost
    from repro_torch.launch.mesh import fake_production_mesh
    from repro_torch.pytree import tree_map
    from repro_torch.sharding.api import use_rules

    for arch, shape_name, flags in DRYRUN_MESH_COMBOS:
        roof, mem = dryrun.lower_one(arch, shape_name, **flags)
        dryrun.print_roofline(f"{arch} x {shape_name} [{roof.mesh}]", roof,
                              mem)
        assert roof.n_chips == (512 if flags.get("multi_pod") else 256)
        assert roof.collective_bytes_per_device > 0 and roof.flops_per_device > 0

    arch, shape_name = DRYRUN_MESH_CARD
    cfg, shape = get_config(arch), INPUT_SHAPES[shape_name]
    gen = torch.Generator(dev).manual_seed(0)
    with fake_production_mesh() as mesh:
        rules = dryrun.mesh_rules(mesh)
        fn, meta_args = dryrun.mesh_step_and_args(cfg, shape, rules)
        t0 = time.perf_counter()
        counts, mem = dryrun.count_step(fn, meta_args, rules)
        count_s = time.perf_counter() - t0

        def real(t):
            loc = op_cost.local(t)
            if loc.is_floating_point():
                x = 0.02 * torch.randn(loc.shape, generator=gen, device=dev,
                                       dtype=loc.dtype)
            else:
                x = torch.randint(0, min(cfg.vocab_size, shape.seq_len),
                                  loc.shape, generator=gen, device=dev,
                                  dtype=loc.dtype)
            return DTensor.from_local(x, mesh, t.placements, run_check=False,
                                      shape=t.shape, stride=t.stride())
        args = tree_map(real, meta_args)
        real_args = dryrun._storage_bytes(args)
        derived = 0
        for t in op_cost.tensors(args):
            want = rank0_shape(t.shape, t.placements, mesh.shape)
            assert tuple(op_cost.local(t).shape) == want, (t.shape, want)
            derived += math.prod(want) * t.element_size()
        assert real_args == derived == mem["args"], (real_args, derived,
                                                     mem)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        with use_rules(rules), implicit_replication():
            out = fn(*args)
        torch.cuda.synchronize()
        step_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() - before
        got = [tuple(op_cost.local(t).shape) for t in op_cost.tensors(out)]
        want = [tuple(op_cost.local(t).shape)
                for t in op_cost.tensors(counts["out"])]
        assert got == want, (got, want)
        assert all(op_cost.local(t).is_cuda for t in op_cost.tensors(out))
        real_out = dryrun._storage_bytes(out)
        temp = counts["peak_bytes"] - mem["out"]
        gib = 2.0 ** 30
        print(f"dry-run mesh card check {arch} {shape_name} [16x16, rank 0 "
              f"of 256 on the card]: args {mem['args']:,} B predicted == "
              f"{real_args:,} B of real shards == {derived:,} B derived "
              f"from the global shapes; {len(got)} outputs' local "
              f"shapes equal the count's ({mem['out']:,} B predicted, "
              f"{real_out:,} B real); temp predicted {temp / gib:.3f} GiB "
              f"vs max_memory_allocated less args and outputs "
              f"{(peak - real_out) / gib:.3f} GiB; count {count_s:.2f} s, "
              f"step on the card {step_s:.2f} s")
        del out, args


def examples_alone(dev, t_start):
    """`--examples`: the gossip shim, the torch examples, the dry-run
    cross-check and the mesh dry-run alone (after the build)."""
    kernels = secure_agg_kernels(dev)
    lm = kernel_wrappers()
    totals = {name: 0 for name in kernels}
    launches = dict.fromkeys(lm, 0)
    gossip_shim_path(dev, kernels, totals)
    examples_path(dev, kernels, lm, totals, launches)
    dryrun_crosscheck(dev)
    dryrun_mesh_path(dev)
    print(f"examples alone: launches {totals} {launches}; took "
          f"{time.perf_counter() - t_start:.1f} s after start-up")
    return 0


def kernel_turns(parent):
    """`--turns PARENT`: `--time-kernels` in four fresh processes, on the
    package of the tree PARENT (the parent commit unpacked), this tree's,
    this tree's and the parent's, so that both are timed on one card in
    the same call.  Prints each process's line."""
    trees = [("parent", Path(parent).resolve() / "src"),
             ("this", ROOT / "src"), ("this", ROOT / "src"),
             ("parent", Path(parent).resolve() / "src")]
    for label, src in trees:
        run = subprocess.run(
            [sys.executable, str(Path(__file__).resolve()), "--time-kernels",
             str(src)], capture_output=True, text=True, timeout=900)
        if run.returncode != 0:
            print(run.stdout[-4000:] + run.stderr[-4000:], file=sys.stderr)
            return run.returncode
        print(f"turns {label} ({src}): {run.stdout.strip().splitlines()[-1]}")
    return 0


def families_alone(dev, t_start):
    """`--families`: the MoE, audio and VLM families' phases alone (after
    the build): their flash shapes against the plain version, the card
    against the CPU, olmoe's federation path, the full-width paths and
    the flash kernel's times."""
    check_flash(dev, FAMILY_FLASH_CASES)
    lm_card_vs_cpu(dev, "olmoe-1b-7b")
    for arch, compute in FAMILY_CARD_VS_CPU:
        lm_card_vs_cpu(dev, arch, compute)
    wrappers = list(kernel_wrappers().values())
    arch, depth, lr = LM_PATHS[-1]
    flash = lm_main_path(dev, arch, depth, lr, wrappers)[
        "flash_attention_bhsd"]
    flash += family_paths(dev, wrappers)
    print(json.dumps(time_flash(dev)[1]))
    print(f"families alone: flash launches {flash}; took "
          f"{time.perf_counter() - t_start:.1f} s after start-up")
    return 0


def flash_times_alone(dev):
    """`--time-flash`: `time_flash` in a fresh process, then hubert's
    shape again after the caching allocator has held 60 GiB (as it does
    after the full-width paths): whether SDPA's time there depends on
    the process's state."""
    print(json.dumps(time_flash(dev)[1]))
    held = [torch.empty(2 ** 30, dtype=torch.uint8, device=dev)
            for _ in range(60)]
    del held
    print(f"after 60 GiB held and freed: reserved "
          f"{torch.cuda.memory_reserved() / 2 ** 30:.1f} GiB")
    time_flash_shape(dev, FLASH_HUBERT, "hubert", causal=False)
    return 0


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    args = sys.argv[1:]
    src = ROOT / "src"
    if "--time-kernels" in args:
        src = Path(args[args.index("--time-kernels") + 1]).resolve()
    sys.path.insert(0, str(src))
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
          f"{torch.backends.cuda.matmul.allow_tf32} cudnn.deterministic="
          f"{torch.backends.cudnn.deterministic} (left as they are; the "
          f"federation's local step turns TF32 off and cuDNN's "
          f"deterministic algorithms on inside itself)")
    t_start = time.perf_counter()

    def lap(phase):
        print(f"[{time.perf_counter() - t_start:.1f} s] {phase} done")
    if "--depth-probe" in args:
        depth_probe(dev)
        return 0
    if "--time-kernels" in args:
        time_kernels(dev)
        return 0
    if "--turns" in args:
        return kernel_turns(args[args.index("--turns") + 1])

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
    print_sass_floor(built["secure_agg"][0], "17clip_noise_kernelILi10E",
                     N_FULL)
    # the P > 16 pair walks (shared-memory accumulators): registers, and
    # their hashes, which the int kernel's cancelling pads must keep
    print_resource_usage(built["secure_agg"][0], "wide_kernelIjLb1E")
    print_resource_usage(built["secure_agg"][0], "wide_kernelILb1E")
    for tag in ("33masked_rolling_update_wide_kernelIjLb1E",
                "29masked_field_wsum_wide_kernelILb1E"):
        hashes = print_sass_hashes(built["secure_agg"][0], tag)
        assert hashes is None or hashes >= 120 + 16, (tag, hashes)

    lap("build")

    # ---- each kernel against its plain version -----------------------
    kernels = secure_agg_kernels(dev)

    def fed_kwargs(mode):
        return dict(secure_domain="int" if mode == "int" else "float",
                    dp=DPConfig(clip_norm=0.5, noise_multiplier=1.0)
                    if mode == "dp" else None)
    if "--training" in args:
        totals = {name: 0 for name in kernels}
        training_path(dev, kernels, fed_kwargs, totals)
        time_secure_agg_train(dev, kernels)
        print(f"training path alone took "
              f"{time.perf_counter() - t_start:.1f} s after start-up")
        return 0

    if "--families" in args:
        return families_alone(dev, t_start)
    if "--examples" in args:
        return examples_alone(dev, t_start)
    if "--mesh" in args:
        return mesh_alone(dev, t_start)
    if "--time-flash" in args:
        return flash_times_alone(dev)

    check_secure_agg(kernels, dev)
    check_secure_agg_wide(kernels, dev)
    legacy = legacy_kernels()
    check_legacy(dev, legacy)
    flash_err, flash_err32 = check_flash(dev)
    wkv6_err = check_wkv6(dev)
    ssm_err = check_ssm(dev)
    lap("kernel checks")

    # ---- the card against the CPU, small -----------------------------
    cnn_card_vs_cpu(dev, fed_kwargs)
    fault_card_vs_cpu(dev)
    merge_card_vs_cpu(dev)
    for arch, _, _ in LM_PATHS:
        lm_card_vs_cpu(dev, arch)
    for arch, compute in FAMILY_CARD_VS_CPU:
        lm_card_vs_cpu(dev, arch, compute)
    for cfg in (TINY_SERVE, TINY_SERVE_SSM):
        hot_swap_on_card(dev, cfg)
    lap("card vs CPU")

    # ---- the main paths: full width, counts from 0 -------------------
    lm_kernels = kernel_wrappers()
    wrappers = [k["wrapper"] for k in kernels.values()] + list(
        lm_kernels.values())
    totals = {name: 0 for name in kernels}
    totals_wide = {name: 0 for name in kernels}
    lm_launches = dict.fromkeys(lm_kernels, 0)
    cnn_main_path(dev, kernels, fed_kwargs, totals)
    lap("cnn_main_path")
    fault_main_path(dev, kernels, fed_kwargs, totals)
    lap("fault_main_path")
    merges_main_path(dev, kernels, totals)
    lap("merges_main_path")
    fleet_main_path(dev, kernels, fed_kwargs, totals_wide)
    lap("fleet_main_path")
    determinism_path(dev, fed_kwargs)
    lap("determinism_path")
    recovery_main_path(dev, kernels, fed_kwargs, totals)
    lap("recovery_main_path")
    fleet_recovery_path(dev, kernels, fed_kwargs, totals_wide)
    lap("fleet_recovery_path")
    placement_path(dev, kernels, totals)
    lap("placement_path")
    mesh_path(dev, kernels, totals)
    lap("mesh_path")
    device_tier_path(dev, kernels)
    lap("device_tier_path")
    training_path(dev, kernels, fed_kwargs, totals)
    lap("training_path")
    gossip_shim_path(dev, kernels, totals)
    lap("gossip_shim_path")
    examples_path(dev, kernels, lm_kernels, totals, lm_launches)
    lap("examples_path")
    dryrun_crosscheck(dev)
    lap("dryrun_crosscheck")
    dryrun_mesh_path(dev)
    lap("dryrun_mesh_path")
    for name, n in list(totals.items()) + [
            (f"{k} P > 16", v) for k, v in totals_wide.items()]:
        assert n > 0, f"{name} never launched on the main path"
    legacy_launches = legacy_main_path(
        dev, legacy, [kernels[n]["wrapper"] for n in
                      ("masked_rolling_update", "masked_field_wsum")])
    for name, n in legacy_launches.items():
        assert n == len(LEGACY_POINTS), f"{name}: {n} launches"
    lap("legacy_main_path")

    # ---- timing at the main paths' shapes ----------------------------
    rows = time_secure_agg(dev, kernels, totals)
    for row, (name, extra) in zip(rows, time_secure_agg_train(
            dev, kernels).items()):
        assert row["name"] == name
        row.update(extra)
    rows += time_secure_agg_wide(dev, kernels, totals_wide)
    rows += time_legacy(dev, legacy, legacy_launches)
    lap("MPC and DP kernel timing")
    flash, flash_families = time_flash(dev)
    timed = {"flash_attention_bhsd": flash[torch.bfloat16]}
    for name, prefill, decode in (("wkv6_bthd", WKV6_TIMED, WKV6_DECODE),
                                  ("ssm_scan_btd", SSM_TIMED, SSM_DECODE)):
        timed[name] = time_recurrent(dev, name, prefill) + (None,)
        time_recurrent(dev, name, decode)
    lap("LM kernel timing")

    for arch, depth, lr in LM_PATHS:
        for name, n in lm_main_path(dev, arch, depth, lr, wrappers).items():
            lm_launches[name] += n
        lap(f"lm_main_path {arch}")
    for name, n in serving_reboot_path(dev, wrappers).items():
        lm_launches[name] += n
    lap("serving_reboot_path")
    lm_launches["flash_attention_bhsd"] += family_paths(dev, wrappers, lap)
    fp32_launches = fp32_prefill_path(dev, wrappers)
    lap("fp32_prefill_path")
    assert fp32_launches > 0, "the fp32 flash kernel never launched"
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
    next(r for r in rows if r["name"] == "flash_attention_bhsd").update(
        flash_families)
    # the fp32 kernel, launched by the fp32-compute prefill
    k_ms, p_ms, b_ms, b_by, lib_ms = flash[torch.float32]
    source, replaces = LM_KERNEL_SOURCES["flash_attention_bhsd"]
    rows.append({"name": "flash_attention_bhsd_f32", "route": "cuda",
                 "source": source, "replaces": replaces,
                 "launches": fp32_launches, "max_abs_err": flash_err32,
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
