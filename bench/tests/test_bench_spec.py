"""BENCHMARK.json and every cell and configuration file against the
benchmark's contract: keys, names, units, files, and what each
per-layer metric moves."""
import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "bench"
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["bench"]
    assert SPEC["command"][1] == "bench/run.py"
    assert 1 <= SPEC["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


@pytest.mark.parametrize("entry", SPEC["configs"], ids=lambda c: c["name"])
def test_config(entry):
    assert set(entry) == {"name", "source", "file", "reduced", "why"}
    assert NAME.match(entry["name"])
    assert entry["file"].startswith("bench/")
    conf = json.loads((ROOT / entry["file"]).read_text())
    assert conf["name"] == entry["name"]
    assert conf["reduced"] == entry["reduced"] == []
    # the plain reference the drivers load by name, and the sizes the CPU
    # tests cut the model to
    assert (BENCH / "reference" / f"{conf['reference']}.py").exists()
    assert set(conf["tiny"]) <= set(conf["model"])
    assert 1 <= len(entry["source"]) <= 200 and 1 <= len(entry["why"]) <= 200
    used = {w["config"] for w in SPEC["workloads"]}
    assert entry["name"] in used


@pytest.mark.parametrize("entry", SPEC["workloads"], ids=lambda w: w["name"])
def test_cell(entry):
    assert set(entry) == {"name", "config", "traffic", "chips", "why"}
    assert NAME.match(entry["name"]) and NAME.match(entry["traffic"])
    assert entry["chips"] == 1
    assert 1 <= len(entry["why"]) <= 200 and "\n" not in entry["why"]
    cell = json.loads((BENCH / "workloads" / f"{entry['name']}.json")
                      .read_text())
    assert (cell["config"], cell["traffic"]) == (entry["config"],
                                                 entry["traffic"])
    assert (BENCH / "drivers" / f"{cell['driver']}.py").exists()
    assert cell["limits"] and all(v >= 0 for v in cell["limits"].values())
    assert set(cell["tiny"]) <= set(cell["traffic_params"])
    reports = [m for m in SPEC["end_to_end"]
               if entry["name"] in m.get("workloads", [entry["name"]])]
    assert "setup_s" in [m["name"] for m in reports] and len(reports) >= 2
    assert any(entry["name"] in m["workloads"] for m in SPEC["per_layer"])


def test_names_and_units():
    metrics = SPEC["end_to_end"] + SPEC["per_layer"]
    names = [m["name"] for m in metrics]
    assert len(names) == len(set(names))
    assert len({w["name"] for w in SPEC["workloads"]}) == \
        len(SPEC["workloads"])
    pairs = {(w["config"], w["traffic"]) for w in SPEC["workloads"]}
    assert len(pairs) == len(SPEC["workloads"])
    for m in metrics:
        assert NAME.match(m["name"]), m["name"]
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES


def test_end_to_end_bounds():
    for m in SPEC["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}


@pytest.mark.parametrize("metric", SPEC["per_layer"], ids=lambda m: m["name"])
def test_per_layer_moves(metric):
    """Each per-layer metric names an end-to-end metric that every one of
    its cells reports, and has a reader of its own."""
    assert set(metric) == {"name", "unit", "better", "source", "layer",
                           "moves", "workloads"}
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    moved = e2e[metric["moves"]]
    for cell in metric["workloads"]:
        assert cell in moved.get("workloads", [cell])
    assert (BENCH / "layer_metrics" / f"{metric['name']}.py").exists()


def test_layers_share_names():
    """Metrics of one layer give the same `layer`, each a line."""
    for m in SPEC["per_layer"]:
        assert 1 <= len(m["layer"]) <= 200 and "\n" not in m["layer"]
    kernels = [m for m in SPEC["per_layer"] if m["name"].endswith(
        "_roofline") or "_roofline." in m["name"]]
    for k in kernels:
        assert k["unit"] == "%"
        # a kernel's roofline moves the same metric as an mfu share beside it
        assert any("mfu" in m["name"] and m["moves"] == k["moves"]
                   and set(k["workloads"]) <= set(m["workloads"])
                   for m in SPEC["per_layer"])


def test_every_cell_file_is_a_cell():
    """No cell file lies here that BENCHMARK.json does not run."""
    files = {p.stem for p in (BENCH / "workloads").glob("*.json")}
    assert files == {w["name"] for w in SPEC["workloads"]}
