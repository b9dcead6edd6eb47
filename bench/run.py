"""Run one cell of the benchmark once and print its result.

    python bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell is an entry of ``BENCHMARK.json``'s ``workloads``; its file
``bench/workloads/<cell>.json`` names its driver (``bench/drivers/
<driver>.py``) and its traffic, and its configuration's file holds the
model.  The driver builds the system under test (the ``repro_torch``
package under ``src/``) from ``--seed``, warms it up, measures it for
``--seconds`` seconds and checks what it produced against the plain
references under ``bench/reference/``.  With ``--trace 1`` part of the
window runs under torch.profiler and the per-layer metrics are printed
(each read by ``bench/layer_metrics/<metric>.py``); with ``--trace 0``
the end-to-end ones.

The last line of standard output is one JSON object; the numbers that
decided ``correct`` end standard error and the JSON object.  The run
exits 2 where the checkout lacks the program, 3 where the card is
missing, and 4 where JAX or the JAX package was loaded.
"""
from __future__ import annotations

import time

T_START = time.time()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def load_module(path: Path, name: str):
    """A module from a file of the benchmark's own, by path (the names of
    metric readers hold dots)."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules():
    """Loaded modules whose top-level name is JAX's or the JAX
    package's, compared whole: ``repro_torch`` is not ``repro``."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def cell_spec(bench: dict, name: str):
    """(workload entry, cell file, config entry, config file)."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; cells: "
                         f"{sorted(cells)}")
    entry = cells[name]
    cell = json.loads((BENCH / "workloads" / f"{name}.json").read_text())
    if (cell["config"], cell["traffic"]) != (entry["config"],
                                             entry["traffic"]):
        raise SystemExit(f"{name}: its file names {cell['config']} / "
                         f"{cell['traffic']}, BENCHMARK.json "
                         f"{entry['config']} / {entry['traffic']}")
    confs = {c["name"]: c for c in bench["configs"]}
    conf = confs[entry["config"]]
    return entry, cell, conf, json.loads((ROOT / conf["file"]).read_text())


def cell_metrics(bench: dict, name: str, trace: bool):
    """The metrics the cell reports: its end-to-end ones, or with a trace
    its per-layer ones (listed for it, or, unlisted, reported wherever
    the end-to-end metric they move is)."""
    e2e = [m for m in bench["end_to_end"]
           if name in m.get("workloads", [name])]
    if not trace:
        return e2e
    moved = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if (name in m["workloads"] if "workloads" in m
                else m["moves"] in moved)]


def finite(x) -> bool:
    return isinstance(x, (int, float)) and math.isfinite(x)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    if not (ROOT / "src" / "repro_torch" / "__init__.py").exists():
        print("bench: the program (src/repro_torch) is not in this "
              "checkout", file=sys.stderr)
        return 2
    # every cache of the program and of Triton stays at a fixed path in
    # the checkout; the port's CUDA libraries build into build/kernels
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
    os.environ["USE_FLAX"] = "0"
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))

    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    entry, cell, conf, config = cell_spec(bench, args.workload)

    import torch
    chips = int(entry["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"bench: {args.workload} needs {chips} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 3

    from bench.common import Context
    driver = load_module(BENCH / "drivers" / f"{cell['driver']}.py",
                         f"bench_driver_{cell['driver']}")
    ctx = Context(name=args.workload, cell=cell, config=config,
                  seed=args.seed, seconds=args.seconds,
                  trace=bool(args.trace), device=torch.device("cuda"),
                  t_start=T_START)
    out = driver.run(ctx)

    wanted = cell_metrics(bench, args.workload, bool(args.trace))
    metrics = {}
    for m in wanted:
        if args.trace:
            reader = load_module(BENCH / "layer_metrics" / f"{m['name']}.py",
                                 "bench_metric_" + m["name"].replace(".", "_"))
            value = reader.read(out)
        else:
            value = out.metrics.get(m["name"])
        if value is not None and finite(value):
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}

    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": chips, "memory_peak_bytes": int(out.memory_peak)}
    result = {"correct": out.correct, "attempted": int(out.attempted),
              "failed": int(out.failed), "metrics": metrics,
              "device": device}
    if args.trace and out.trace is not None:
        from bench import trace as tr
        device["busy_s"] = tr.busy_s(out.trace)
        device["window_s"] = out.trace["window_s"]
        result["breakdown"] = tr.breakdown(out.trace)

    loaded = forbidden_modules()
    if loaded:
        print(f"bench: the run loaded {loaded}, which the port must not "
              f"use", file=sys.stderr)
        return 4
    checks = {c.name: {"value": c.value, "limit": c.limit}
              for c in out.checks}
    result["checks"] = checks
    for c in out.checks:
        print(f"check {c.name}: {c.value!r} (limit {c.limit!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
