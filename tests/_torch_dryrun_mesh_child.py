"""The reference's side of `tests/test_torch_dryrun_mesh.py`, run as a
SUBPROCESS: the reference's dry-run lowers onto placeholder XLA devices,
and jax pins the device count when its backend first starts, so the
8-device meshes need a fresh interpreter.  jax starts here on 8 forced
CPU devices before ``repro.launch.dryrun`` is imported, so that module's
512-device flag comes too late to take effect.

The reference's files stay as they are: the test replaces
``make_production_mesh``, ``get_config`` and ``INPUT_SHAPES`` on the
imported ``repro.launch.dryrun`` module, to give its own `lower_one` a
(2, 4) ("data", "model") or (2, 2, 2) ("pod", "data", "model") mesh, a
reduced config and short shapes.  Prints ONE json object on stdout:

  steps   per case: memory_analysis's argument / temp / output bytes,
          analyze_hlo's flops, bytes and collectives, the HLO dot FLOPs
          with their trip counts
  micro   three small steps' collectives (kind -> count, wire bytes)
  wire    the reference's two `_wire_bytes` at every kind and group
"""
import dataclasses
import json
import os
import sys

os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=8 "
                           + os.environ.get("XLA_FLAGS", ""))
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax                                    # noqa: E402
import jax.numpy as jnp                       # noqa: E402
from jax.sharding import NamedSharding, PartitionSpec as P  # noqa: E402

assert len(jax.devices()) == 8, jax.devices()

from repro.configs import ARCHS, reduced     # noqa: E402
from repro.configs.base import InputShape    # noqa: E402
from repro.launch import analysis, hlo_cost  # noqa: E402
from repro.launch import dryrun              # noqa: E402
from repro.launch.mesh import _make_mesh     # noqa: E402

# the cases the test runs on both sides: name -> (arch, config changes,
# shape, mesh shape, mesh axes, lower_one flags)
CASES = {
    "train": ("qwen3-0.6b", {}, ("train", 64, 8), (2, 4),
              ("data", "model"), {}),
    "prefill": ("qwen3-0.6b", {}, ("prefill", 64, 8), (2, 4),
                ("data", "model"), {}),
    "decode": ("qwen3-0.6b", {}, ("decode", 64, 8), (2, 4),
               ("data", "model"), {}),
    "overlay": ("qwen3-0.6b", {"n_layers": 1}, ("train", 64, 8), (2, 2, 2),
                ("pod", "data", "model"), {"multi_pod": True,
                                           "overlay": True}),
    "pad_heads": ("qwen3-0.6b", {"n_heads": 6, "n_kv_heads": 2},
                  ("prefill", 64, 8), (2, 4), ("data", "model"),
                  {"pad_heads": True}),
    "pad_heads_train": ("qwen3-0.6b", {"n_heads": 6, "n_kv_heads": 2,
                                       "n_layers": 1},
                        ("train", 64, 8), (2, 4), ("data", "model"),
                        {"pad_heads": True}),
    "moe_train": ("olmoe-1b-7b", {"n_layers": 1}, ("train", 64, 8),
                  (2, 4), ("data", "model"), {}),
    "moe_prefill": ("olmoe-1b-7b", {"n_layers": 1}, ("prefill", 64, 8),
                    (2, 4), ("data", "model"), {}),
}


def dot_flops(text: str) -> float:
    comps = hlo_cost.parse_module(text)
    mult = hlo_cost.execution_counts(comps)
    return sum(mult.get(c.name, 0.0) * hlo_cost._op_flops(op, c)
               for c in comps.values() for op in c.ops if op.opcode == "dot")


def run_case(name):
    arch, changes, (kind, seq, batch), shape, axes, flags = CASES[name]
    cfg = dataclasses.replace(reduced(ARCHS[arch]), **changes)
    shape_name = f"{kind}_small"
    dryrun.get_config = lambda _arch: cfg
    dryrun.INPUT_SHAPES = {shape_name: InputShape(shape_name, seq, batch,
                                                  kind)}
    dryrun.make_production_mesh = lambda multi_pod=False: _make_mesh(
        shape, axes)
    roof, compiled = dryrun.lower_one(arch, shape_name, impl="ref", **flags)
    ma = compiled.memory_analysis()
    text = compiled.as_text()
    return {"args": ma.argument_size_in_bytes,
            "temp": ma.temp_size_in_bytes,
            "out": ma.output_size_in_bytes,
            "flops": roof.flops_per_device,
            "bytes": roof.bytes_per_device,
            "collectives": roof.collectives,
            "collective_bytes": roof.collective_bytes_per_device,
            "dot_flops": dot_flops(text)}


def micro():
    """Three small steps on the (2, 4) mesh and the collectives GSPMD
    gives them (see the test for the port's side)."""
    mesh = _make_mesh((2, 4), ("data", "model"))

    def sh(*spec):
        return NamedSharding(mesh, P(*spec))
    f32 = jnp.float32
    x = jax.ShapeDtypeStruct((8, 16), f32)
    w1 = jax.ShapeDtypeStruct((16, 32), f32)
    w2 = jax.ShapeDtypeStruct((32, 16), f32)
    y = jax.ShapeDtypeStruct((8, 8), f32)
    wg = jax.ShapeDtypeStruct((16, 8), f32)
    steps = {
        # x @ w1 column-parallel, @ w2 row-parallel, over the 2-wide
        # "data" axis (XLA lists that group's ranks, and the reference's
        # parser reads a listed group as 2), the batch over "model"
        "mlp": (lambda x, a, b: (x @ a) @ b, (x, w1, w2),
                (sh("model"), sh(None, "data"), sh("data", None)),
                sh("model", None)),
        # a weight whose rows are sharded over "data" (FSDP), used whole
        "fsdp": (lambda x, a: x @ a, (x, w1),
                 (sh("data"), sh("data", "model")), sh("data", "model")),
        # the gradient of a replicated weight over a data-sharded batch
        "dp_grad": (jax.grad(lambda w, x, y: jnp.mean((x @ w - y) ** 2)),
                    (wg, x, y), (sh(), sh("data"), sh("data")), sh()),
    }
    out = {}
    for name, (fn, args, ins, outs) in steps.items():
        text = jax.jit(fn, in_shardings=ins, out_shardings=outs).lower(
            *args).compile().as_text()
        out[name] = hlo_cost.analyze_hlo(text)["collectives"]
    return out


def main():
    names = sys.argv[1:] or list(CASES)
    kinds = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
             "collective-permute")
    wire = {f"{k}/{g}": [analysis._wire_bytes(k, 4096.0, g),
                         hlo_cost._wire_bytes(k, 4096.0, g)]
            for k in kinds for g in (2, 4, 16)}
    print(json.dumps({"steps": {n: run_case(n) for n in names},
                      "micro": micro(), "wire": wire}))


if __name__ == "__main__":
    main()
