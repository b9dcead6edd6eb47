"""Cells cut to a size the CPU runs in seconds, for the tests: the same
drivers, traffic files and limits, with the smaller sizes that each
configuration's file and each cell's file give under `tiny`."""
from __future__ import annotations

import copy
import json
import time
from pathlib import Path

import torch

from bench.common import Context

BENCH = Path(__file__).resolve().parents[1]
SPEC = json.loads((BENCH.parent / "BENCHMARK.json").read_text())


def cells(driver=None):
    """The cells of BENCHMARK.json, or those that `driver` runs."""
    return [w["name"] for w in SPEC["workloads"]
            if driver is None or cell_files(w["name"])[0]["driver"] ==
            driver]


def cell_files(name):
    cell = json.loads((BENCH / "workloads" / f"{name}.json").read_text())
    conf = json.loads((BENCH / "configs" / f"{cell['config']}.json")
                      .read_text())
    return cell, conf


def context(name, seed=2 ** 31 + 11, seconds=1.0):
    cell, conf = cell_files(name)
    cell, conf = copy.deepcopy(cell), copy.deepcopy(conf)
    cell["traffic_params"].update(cell["tiny"])
    conf["model"].update(conf["tiny"])
    return Context(name=name, cell=cell, config=conf, seed=seed,
                   seconds=seconds, trace=False,
                   device=torch.device("cpu"), t_start=time.time())


def driver(name):
    from bench import run as harness
    cell, _ = cell_files(name)
    return harness.load_module(BENCH / "drivers" / f"{cell['driver']}.py",
                               f"bench_driver_{cell['driver']}")
