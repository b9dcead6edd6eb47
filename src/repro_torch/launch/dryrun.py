"""Dry-run: the FLOPs, bytes, memory and collectives of one step of every
(architecture x input shape), per device, on one H100 or on the
production meshes of H100s, counted without touching a card.

For each combo this builds the real step function (train step with AdamW,
prefill forward, or serve step: 1 token against a seq_len cache) over
``meta`` tensors from the abstract param, optimizer, batch and cache
trees, counts one step op by op (`launch.op_cost`), and prices it at the
card's constants (`launch.analysis`).  Nothing is allocated on any
device: like the reference's placeholder devices, it models the cards
without using them.  The counterpart of the reference's
``launch/dryrun.py``.

On a mesh (``--single-pod`` for 16x16, ``--multi-pod`` for 2x16x16,
``--pad-heads``)
the trees become DTensors on a fake production mesh
(`launch.mesh.fake_production_mesh`), laid out by the reference's
``SINGLE_POD_RULES`` / ``MULTI_POD_RULES``, and the step is counted as
rank 0 runs it: local FLOPs, bytes and memory, and the collectives
DTensor inserts, priced by link.  ``--overlay`` (with ``--multi-pod``)
stacks an institution axis on the pods and vmaps the train step over it,
then merges the institutions' params under a commit flag.  Without a
mesh flag the count is one H100's, as before.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen3-0.6b --shape train_4k
  python -m repro_torch.launch.dryrun --all --out results/dryrun_h100.jsonl
  python -m repro_torch.launch.dryrun --all --single-pod
  python -m repro_torch.launch.dryrun --arch qwen3-0.6b --shape train_4k \\
      --multi-pod --overlay        # the overlay: pod = institution
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
import traceback
from typing import Optional

import torch
from torch.distributed.tensor import DTensor, Shard, distribute_tensor
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch import models
from repro_torch.configs import ARCHS, INPUT_SHAPES, get_config
from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.core import gossip
from repro_torch.data.pipeline import make_batch_specs
from repro_torch.launch import analysis, op_cost
from repro_torch.launch.mesh import fake_production_mesh, make_rules
from repro_torch.optim import optimizer_abstract_state, optimizer_state_axes
from repro_torch.pytree import tree_map
from repro_torch.serving import make_serve_step
from repro_torch.sharding.api import (
    LogicalRules, is_axes, param_sharding_tree, use_rules,
)
from repro_torch.training import TrainConfig, make_train_step

SWA_VARIANT_WINDOW = 8192   # long_500k sliding-window variant, dense archs
ONE_CARD = "1xH100"


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


def mesh_name(*, single_pod: bool = False, multi_pod: bool = False,
              overlay: bool = False, pad_heads: bool = False,
              overlay_merge: str = "mean") -> str:
    """The reference's mesh label: 16x16 (`single_pod`, or `pad_heads`
    alone, as in the reference), 2x16x16, +overlay[:merge] (which
    `lower_one` holds to 2x16x16); with no mesh flag the one-card
    count's, 1xH100."""
    if not (single_pod or multi_pod or pad_heads or overlay):
        return ONE_CARD
    name = "2x16x16" if multi_pod else "16x16"
    if overlay:
        name += "+overlay"
        if overlay_merge != "mean":
            name += f":{overlay_merge}"
    return name


def _meta_batch(cfg: ModelConfig, shape: InputShape):
    specs, _ = make_batch_specs(cfg, shape.seq_len, shape.global_batch,
                                shape.kind)
    return {k: torch.empty(s, dtype=d, device="meta")
            for k, (s, d) in specs.items()}


def _storage_bytes(tree, skip=frozenset()) -> int:
    """Bytes of the distinct storages in `tree` (rank 0's shards of
    DTensors), less those in `skip`."""
    seen = {}
    for t in op_cost.tensors(tree):
        st = op_cost.local(t).untyped_storage()
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


def _arg_axes(cfg: ModelConfig, shape: InputShape):
    """The logical axes of `step_and_args`'s args, tree for tree."""
    p_axes = models.param_axes(cfg)
    if shape.kind == "decode":
        _, s_axes = models.decode_state_specs(cfg, shape.global_batch,
                                              shape.seq_len)
        _, b_axes = make_batch_specs(cfg, shape.seq_len, shape.global_batch,
                                     "decode")
        return (p_axes, s_axes, b_axes["tokens"], b_axes["pos"])
    _, b_axes = make_batch_specs(cfg, shape.seq_len, shape.global_batch,
                                 shape.kind)
    if shape.kind == "prefill":
        return (p_axes, b_axes)
    return (p_axes, optimizer_state_axes(p_axes), (), b_axes)


def _add_inst(tree, axes, n_inst: int, batch: bool):
    """The overlay's trees: a leading institution dim of `n_inst` on
    every leaf, named "inst"; the batch's rows split among them."""
    tree = tree_map(lambda t: torch.empty(
        (n_inst,) + ((t.shape[0] // n_inst,) + tuple(t.shape[1:]) if batch
                     else tuple(t.shape)), dtype=t.dtype, device="meta"),
        tree)
    return tree, _map_axes(lambda a: ("inst",) + a, axes)


def _map_axes(fn, axes):
    if is_axes(axes):
        return fn(axes)
    if isinstance(axes, dict):
        return {k: _map_axes(fn, v) for k, v in axes.items()}
    return type(axes)(_map_axes(fn, a) for a in axes)


def _distribute(tree, axes, rules: LogicalRules):
    """Each meta leaf as a DTensor on ``rules.mesh``, laid out by its
    logical axes."""
    placements = param_sharding_tree(axes, tree, rules)

    def walk(t, pl):
        if isinstance(t, torch.Tensor):
            return distribute_tensor(t, rules.mesh, pl)
        if isinstance(t, dict):
            return {k: walk(t[k], pl[k]) for k in t}
        return type(t)(walk(a, p) for a, p in zip(t, pl))
    return walk(tree, placements)


def overlay_step(step_fn, overlay_merge: str, step_rules: LogicalRules,
                 mesh):
    """The overlay's step over stacked institutions: the train step
    vmapped over the institution axis, then the consensus-gated merge of
    the params (the reference's ``lower_one`` overlay ``fn``).  The
    vmapped step runs on rank 0's pod under `step_rules`, over that
    pod's institutions, and the merge on `mesh`, the whole mesh, with
    the institutions sharded over its "pod" axis.  The port's gate reads
    a host bool (its consensus runs on the host), so the commit flag
    rides along as an argument, as the reference's, and the count takes
    the round that commits: the one that merges."""
    def fn(params, opt, step, batch, commit):
        del commit
        vstep = torch.func.vmap(step_fn, in_dims=(0, 0, None, 0))
        with use_rules(step_rules):
            params, opt, metrics = vstep(params, opt, step, batch)
        params = tree_map(lambda p: _over_pods(p, mesh), params)
        if overlay_merge == "mean":
            params = gossip.mean_merge(params, True, alpha=1.0)
        elif overlay_merge == "quantized":
            params = gossip.quantized_mean_merge(params, True, alpha=1.0)
        elif overlay_merge != "none":
            raise ValueError(overlay_merge)
        return params, opt, metrics
    return fn


def _over_pods(p: DTensor, mesh) -> DTensor:
    """A pod's (institutions, ...) DTensor as the whole mesh's, its
    institutions one shard of the "pod" axis (no data moves)."""
    n = mesh.size(mesh.mesh_dim_names.index("pod"))
    shape = (p.shape[0] * n,) + tuple(p.shape[1:])
    return DTensor.from_local(p.to_local(), mesh, (Shard(0),) + p.placements,
                              run_check=False, shape=torch.Size(shape),
                              stride=op_cost.contiguous_stride(shape))


def mesh_step_and_args(cfg: ModelConfig, shape: InputShape,
                       rules: LogicalRules, impl: str = "auto", *,
                       overlay: bool = False, overlay_merge: str = "mean"):
    """(step function, its args as DTensors on ``rules.mesh``): the
    counterpart of the reference's ``in_shardings``.

    With `overlay`, params, optimizer state and batch carry the
    institution axis, one institution a pod ("inst" -> "pod"), and the
    step takes a commit flag.  Rank 0 holds its pod's institutions
    only, so its args are laid out on its pod's ("data", "model")
    sub-mesh and the vmapped step runs there; the merge runs on the
    whole mesh.  The count is rank 0's either way, and DTensor's
    sharding propagation, which tries every placement of every dim on
    every mesh axis, is far cheaper on two axes than on three (minutes a
    combo on a CPU for the 5-d tensors of a vmapped step)."""
    fn, args = step_and_args(cfg, shape, impl)
    axes = _arg_axes(cfg, shape)
    if not overlay:
        return fn, tuple(_distribute(a, ax, rules)
                         for a, ax in zip(args, axes))
    mesh = rules.mesh
    names = mesh.mesh_dim_names
    n_inst = rules.axis_size(rules.rules["inst"])
    per_pod = n_inst // mesh.size(names.index("pod"))
    pod = mesh[tuple(n for n in names if n != "pod")]
    pod_rules = LogicalRules(dict(rules.rules, inst=None), mesh=pod,
                             pad_ok=rules.pad_ok)
    params, p_axes = _add_inst(args[0], axes[0], per_pod, False)
    opt, o_axes = _add_inst(args[1], axes[1], per_pod, False)
    batch, b_axes = _add_inst(args[3], axes[3], n_inst, True)
    batch = tree_map(lambda t: torch.empty((per_pod,) + tuple(t.shape[1:]),
                                           dtype=t.dtype, device="meta"),
                     batch)
    fn = overlay_step(fn, overlay_merge, pod_rules, mesh)
    args = (params, opt, args[2], batch,
            torch.empty((), dtype=torch.bool, device="meta"))
    axes = (p_axes, o_axes, (), b_axes, ())
    return fn, tuple(_distribute(a, ax, pod_rules)
                     for a, ax in zip(args, axes))


def count_step(fn, args, rules: Optional[LogicalRules] = None):
    """(op count, memory dict) of ``fn(*args)``: per device under
    `rules` (whose mesh is the args' DTensors'), else on one card."""
    if rules is None:
        counts = op_cost.analyze_ops(fn, *args)
    else:
        with use_rules(rules), implicit_replication():
            counts = op_cost.analyze_ops(fn, *args)
    arg_keys = {op_cost.storage_key(t) for t in op_cost.tensors(args)}
    return counts, {"args": _storage_bytes(args),
                    "out": _storage_bytes(counts["out"], skip=arg_keys)}


def mesh_rules(mesh, *, multi_pod: bool = False, pad_heads: bool = False,
               overlay: bool = False) -> LogicalRules:
    """The reference's rules on `mesh`: ``SINGLE_POD_RULES`` or
    ``MULTI_POD_RULES``, padded heads allowed with `pad_heads`, and with
    `overlay` the pod as the institution ("inst"), the batch sharded
    only within it."""
    rules = make_rules(mesh, multi_pod=multi_pod)
    if pad_heads:       # padded head sharding for odd head counts
        rules.pad_ok |= {"heads", "kv_heads"}
    if overlay:
        rules.rules = dict(rules.rules, batch="data", expert_batch="data",
                           inst="pod")
    return rules


def lower_one(arch: str, shape_name: str, *, impl: str = "auto",
              single_pod: bool = False, multi_pod: bool = False,
              overlay: bool = False, pad_heads: bool = False,
              overlay_merge: str = "mean"):
    """(Roofline, memory dict) of one step, or (None, reason) when the
    combo is skipped.  On the one card unless a mesh flag is set
    (`mesh_name`); there the count is rank 0's."""
    cfg = get_config(arch)
    shape = INPUT_SHAPES[shape_name]
    cfg, variant = resolve_variant(cfg, shape)
    if cfg is None:
        return None, variant
    if overlay:
        assert multi_pod, "overlay dry-run federates pods: needs --multi-pod"
        assert shape.kind == "train", "overlay is a training-time mechanism"
    name = mesh_name(single_pod=single_pod, multi_pod=multi_pod,
                     overlay=overlay, pad_heads=pad_heads,
                     overlay_merge=overlay_merge)
    t0 = time.time()
    if name == ONE_CARD:
        fn, args = step_and_args(cfg, shape, impl)
        counts, mem = count_step(fn, args)
        n_chips = 1
    else:
        with fake_production_mesh(multi_pod=multi_pod) as mesh:
            rules = mesh_rules(mesh, multi_pod=multi_pod,
                               pad_heads=pad_heads, overlay=overlay)
            fn, args = mesh_step_and_args(cfg, shape, rules, impl,
                                          overlay=overlay,
                                          overlay_merge=overlay_merge)
            counts, mem = count_step(fn, args, rules)
            n_chips = mesh.size()
    if pad_heads:
        variant = (variant + " +pad_heads").strip()
    roof = analysis.analyze(
        counts, arch=arch, shape_name=shape_name, mesh_name=name,
        n_chips=n_chips, cfg=cfg, shape=shape,
        compile_seconds=time.time() - t0, variant=variant,
        args_bytes=mem["args"], out_bytes=mem["out"])
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
    ap.add_argument("--single-pod", action="store_true",
                    help="the 16x16 mesh of one pod (default: one H100)")
    ap.add_argument("--multi-pod", action="store_true",
                    help="the 2x16x16 mesh of two pods")
    ap.add_argument("--overlay", action="store_true",
                    help="STIGMA overlay train step (pod = institution)")
    ap.add_argument("--all", action="store_true",
                    help="every (arch x shape) on this mesh")
    ap.add_argument("--out", default=None, help="append JSONL here")
    ap.add_argument("--impl", default="auto")
    ap.add_argument("--pad-heads", action="store_true",
                    help="allow padded head sharding (a mesh: 16x16 "
                         "unless --multi-pod)")
    args = ap.parse_args(argv)
    if not args.all and not (args.arch and args.shape):
        ap.error("give --arch and --shape, or --all")
    flags = {"single_pod": args.single_pod, "multi_pod": args.multi_pod,
             "overlay": args.overlay, "pad_heads": args.pad_heads}
    name = mesh_name(**flags)

    todo = list(combos()) if args.all else [(args.arch, args.shape)]
    failures, records = [], []
    for arch, shape_name in todo:
        label = f"{arch} x {shape_name} [{name}]"
        try:
            if args.overlay and INPUT_SHAPES[shape_name].kind != "train":
                print(f"SKIP {label}: overlay applies to train shapes")
                continue
            roof, mem = lower_one(arch, shape_name, impl=args.impl,
                                  **flags)
            if roof is None:
                print(f"SKIP {label}: {mem}")
                rec = {"arch": arch, "shape": shape_name, "mesh": name,
                       "skipped": mem}
            else:
                print_roofline(label, roof, mem)
                rec = roof.to_json()
        except Exception as e:  # noqa: BLE001 (report and go on)
            traceback.print_exc()
            print(f"FAIL {label}: {type(e).__name__}: {e}")
            failures.append((label, str(e)))
            rec = {"arch": arch, "shape": shape_name, "mesh": name,
                   "error": str(e)}
        records.append(rec)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(rec) + "\n")
    if failures:
        print(f"\n{len(failures)} FAILURES")
        sys.exit(1)
    return records


def print_roofline(label: str, roof, mem) -> None:
    """The reference's OK lines, plus, on a mesh, the collectives by kind
    and the collective term by link."""
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
          f"coll_bytes/dev={roof.collective_bytes_per_device:.3e}")
    if roof.n_chips > 1:
        links = analysis.link_bytes(roof.collectives)
        t_link = roof.t_collective_by_link
        print("     collectives: " + (", ".join(
            f"{k} x{int(v['count'])} {v['bytes']:.3e}B"
            for k, v in sorted(roof.collectives.items())) or "none")
            + f"; nvlink {links['nvlink']:.3e}B "
            f"{t_link['nvlink'] * 1e3:.2f}ms, network "
            f"{links['network']:.3e}B {t_link['network'] * 1e3:.2f}ms")
    print(f"     roofline: compute={roof.t_compute * 1e3:.2f}ms "
          f"memory={roof.t_memory * 1e3:.2f}ms "
          f"(kernel-adjusted "
          f"{roof.t_memory_kernel_adjusted * 1e3:.2f}ms) "
          f"collective={roof.t_collective * 1e3:.2f}ms "
          f"-> {roof.bottleneck}-bound, "
          f"mfu_bound={roof.mfu_bound:.2f}")


if __name__ == "__main__":
    main()
