"""Dry-run: the FLOPs, bytes and memory of one step of every (architecture
x input shape) on one H100, counted without touching the card.

For each combo this builds the real step function (train step with AdamW,
prefill forward, or serve step: 1 token against a seq_len cache) over
``meta`` tensors from the abstract param, optimizer, batch and cache
trees, counts one step op by op (`launch.op_cost`), and prices it at the
card's constants (`launch.analysis`).  Nothing is allocated on any
device: like the reference's placeholder devices, it models the card
without using it.  The counterpart of the reference's
``launch/dryrun.py``; its production meshes, ``--multi-pod``,
``--overlay`` and ``--pad-heads`` go with ROADMAP queue A item 27.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen3-0.6b --shape train_4k
  python -m repro_torch.launch.dryrun --all --out results/dryrun_h100.jsonl
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
import traceback

import torch

from repro_torch import models
from repro_torch.configs import ARCHS, INPUT_SHAPES, get_config
from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.data.pipeline import make_batch_specs
from repro_torch.launch import analysis, op_cost
from repro_torch.optim import optimizer_abstract_state
from repro_torch.serving import make_serve_step
from repro_torch.training import TrainConfig, make_train_step

SWA_VARIANT_WINDOW = 8192   # long_500k sliding-window variant, dense archs
MESH_NAME = "1xH100"
_MESH_FLAGS = ("multi_pod", "overlay", "pad_heads")


def resolve_variant(cfg: ModelConfig, shape: InputShape):
    """Apply the documented long-context variant; None => combo is skipped."""
    if cfg.encoder_only and shape.kind == "decode":
        return None, "skip: encoder-only arch has no decode step"
    if shape.name == "long_500k" and shape.kind == "decode":
        if cfg.family in ("ssm", "hybrid"):
            return cfg, "native (constant-size recurrent state)"
        if cfg.attn_window == 0:
            return (dataclasses.replace(cfg, attn_window=SWA_VARIANT_WINDOW),
                    f"+swa{SWA_VARIANT_WINDOW} (sliding-window variant)")
        return cfg, f"native SWA (window={cfg.attn_window})"
    return cfg, ""


def _refuse_meshes(**flags) -> None:
    on = [k for k in _MESH_FLAGS if flags.get(k)]
    if on:
        raise NotImplementedError(
            f"{', '.join(on)}: meshes are not ported to the PyTorch dry-run "
            f"yet (ROADMAP queue A item 27); it models one H100")


def _meta_batch(cfg: ModelConfig, shape: InputShape):
    specs, _ = make_batch_specs(cfg, shape.seq_len, shape.global_batch,
                                shape.kind)
    return {k: torch.empty(s, dtype=d, device="meta")
            for k, (s, d) in specs.items()}


def _storage_bytes(tree, skip=frozenset()) -> int:
    """Bytes of the distinct storages in `tree`, less those in `skip`."""
    seen = {}
    for t in op_cost.tensors(tree):
        st = t.untyped_storage()
        if st._cdata not in skip:
            seen[st._cdata] = st.nbytes()
    return sum(seen.values())


def step_and_args(cfg: ModelConfig, shape: InputShape, impl: str = "auto"):
    """(step function, its meta args) for one combo, as `lower_one`
    counts it."""
    params = models.abstract_params(cfg)
    if shape.kind == "train":
        step_fn = make_train_step(cfg, TrainConfig(remat=True, impl=impl))
        return step_fn, (params, optimizer_abstract_state(params),
                         torch.empty((), dtype=torch.int32, device="meta"),
                         _meta_batch(cfg, shape))
    if shape.kind == "prefill":
        def fn(params, batch):
            logits, _ = models.forward(cfg, params, batch, impl=impl)
            return logits
        return fn, (params, _meta_batch(cfg, shape))
    state, _ = models.decode_state_specs(cfg, shape.global_batch,
                                         shape.seq_len)
    batch = _meta_batch(cfg, shape)
    return make_serve_step(cfg), (params, state, batch["tokens"],
                                  batch["pos"])


def lower_one(arch: str, shape_name: str, *, impl: str = "auto",
              multi_pod: bool = False, overlay: bool = False,
              pad_heads: bool = False):
    """(Roofline, memory dict) of one step, or (None, reason) when the
    combo is skipped."""
    _refuse_meshes(multi_pod=multi_pod, overlay=overlay, pad_heads=pad_heads)
    cfg = get_config(arch)
    shape = INPUT_SHAPES[shape_name]
    cfg, variant = resolve_variant(cfg, shape)
    if cfg is None:
        return None, variant
    t0 = time.time()
    fn, args = step_and_args(cfg, shape, impl)
    counts = op_cost.analyze_ops(fn, *args)
    arg_keys = {t.untyped_storage()._cdata for t in op_cost.tensors(args)}
    mem = {"args": _storage_bytes(args),
           "out": _storage_bytes(counts["out"], skip=arg_keys)}
    roof = analysis.analyze(
        counts, arch=arch, shape_name=shape_name, mesh_name=MESH_NAME,
        n_chips=1, cfg=cfg, shape=shape, compile_seconds=time.time() - t0,
        variant=variant, args_bytes=mem["args"], out_bytes=mem["out"])
    mem["temp"] = roof.temp_bytes
    return roof, mem


def combos():
    for arch in ARCHS:
        for shape_name in INPUT_SHAPES:
            yield arch, shape_name


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=sorted(ARCHS))
    ap.add_argument("--shape", choices=sorted(INPUT_SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--overlay", action="store_true",
                    help="STIGMA overlay train step (pod = institution)")
    ap.add_argument("--all", action="store_true",
                    help="every (arch x shape) on this mesh")
    ap.add_argument("--out", default=None, help="append JSONL here")
    ap.add_argument("--impl", default="auto")
    ap.add_argument("--pad-heads", action="store_true",
                    help="allow padded head sharding")
    args = ap.parse_args(argv)
    _refuse_meshes(multi_pod=args.multi_pod, overlay=args.overlay,
                   pad_heads=args.pad_heads)
    if not args.all and not (args.arch and args.shape):
        ap.error("give --arch and --shape, or --all")

    todo = list(combos()) if args.all else [(args.arch, args.shape)]
    failures, records = [], []
    for arch, shape_name in todo:
        label = f"{arch} x {shape_name} [{MESH_NAME}]"
        try:
            roof, mem = lower_one(arch, shape_name, impl=args.impl)
            if roof is None:
                print(f"SKIP {label}: {mem}")
                rec = {"arch": arch, "shape": shape_name, "mesh": MESH_NAME,
                       "skipped": mem}
            else:
                gib = 2.0**30
                print(f"OK   {label} variant={roof.variant!r} "
                      f"count={roof.compile_seconds:.1f}s")
                print(f"     memory: args={mem['args'] / gib:.3f}GiB "
                      f"temp={mem['temp'] / gib:.3f}GiB "
                      f"out={mem['out'] / gib:.3f}GiB per device; "
                      f"fits {analysis.HBM_BYTES / gib:.0f} GiB: "
                      f"{'yes' if roof.fits else 'no'}")
                print(f"     op count: flops/dev={roof.flops_per_device:.3e} "
                      f"(matmul {roof.matmul_flops_per_device:.3e}) "
                      f"bytes/dev={roof.bytes_per_device:.3e} "
                      f"coll_bytes/dev="
                      f"{roof.collective_bytes_per_device:.3e}")
                print(f"     roofline: compute={roof.t_compute * 1e3:.2f}ms "
                      f"memory={roof.t_memory * 1e3:.2f}ms "
                      f"(kernel-adjusted "
                      f"{roof.t_memory_kernel_adjusted * 1e3:.2f}ms) "
                      f"collective={roof.t_collective * 1e3:.2f}ms "
                      f"-> {roof.bottleneck}-bound, "
                      f"mfu_bound={roof.mfu_bound:.2f}")
                rec = roof.to_json()
        except Exception as e:  # noqa: BLE001 (report and go on)
            traceback.print_exc()
            print(f"FAIL {label}: {type(e).__name__}: {e}")
            failures.append((label, str(e)))
            rec = {"arch": arch, "shape": shape_name, "error": str(e)}
        records.append(rec)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(rec) + "\n")
    if failures:
        print(f"\n{len(failures)} FAILURES")
        sys.exit(1)
    return records


if __name__ == "__main__":
    main()
