"""Readings from which a cell's correctness limits are set: the cell run
once a seed, in one process, with its numbers and the control's.

    python bench/readings.py --workload <cell> --seeds 11,12,13 \
        --seconds 10 [--control] [--out FILE]

A serving cell hands its weights to the engine without the ledger's
verified pull here (the same bytes, so the same served tokens), which
saves the publisher's and the pull's SHA-256 passes over the weights a
seed.  The control is the plain reference in the program's place, one
precision below the configuration's: for the CNN the reference with
TF32 on, for the served model the reference with float8 (e4m3) matrix
products, judged on the same served requests.  A CNN cell also reads
the faults "half of each batch left out" and "a step that returns its
state unchanged" (local training at learning rate 0), planted in the
reference.  Each seed prints one JSON line (also appended to FILE) with
the run's numbers, its control's, its end-to-end metrics and `correct`
against the cell's present limits.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

from bench import run as harness  # noqa: E402
from bench.common import Context  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("readings: no CUDA device", file=sys.stderr)
        return 3
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    _, cell, _, config = harness.cell_spec(bench, args.workload)
    driver = harness.load_module(BENCH / "drivers" / f"{cell['driver']}.py",
                                 f"bench_driver_{cell['driver']}")
    for seed in (int(s) for s in args.seeds.split(",")):
        ctx = Context(name=args.workload, cell=cell, config=config,
                      seed=seed, seconds=args.seconds, trace=False,
                      device=torch.device("cuda"), t_start=time.time())
        kw = {"verified_pull": False} if cell["driver"] == "serve" else {}
        out = driver.run(ctx, control=args.control, **kw)
        line = json.dumps({"workload": args.workload, "seed": seed,
                           "numbers": out.counters["numbers"],
                           "control": out.counters.get("control"),
                           "half_batch": out.counters.get("half_batch"),
                           "unchanged": out.counters.get("unchanged"),
                           "metrics": out.metrics,
                           "attempted": out.attempted,
                           "correct": out.correct,
                           "peak_bytes": out.memory_peak})
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
        del out
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
