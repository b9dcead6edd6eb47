"""Nothing the benchmark runs loads JAX or the JAX package, compared by
whole top-level module names (``repro_torch`` is not ``repro``), and the
harness refuses to run without the program or without a card."""
import ast
import json
import shutil
import subprocess
import sys
import types
from pathlib import Path

import pytest

from bench import run as harness

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "bench"


def test_forbidden_by_whole_top_level_name(monkeypatch):
    monkeypatch.delitem(sys.modules, "repro", raising=False)
    monkeypatch.delitem(sys.modules, "jax", raising=False)
    import repro_torch  # noqa: F401
    monkeypatch.setitem(sys.modules, "reprox", types.ModuleType("reprox"))
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "repro.core",
                        types.ModuleType("repro.core"))
    assert harness.forbidden_modules() == ["repro"]
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    assert harness.forbidden_modules() == ["jax", "repro"]


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


@pytest.mark.parametrize("path", sorted(p for p in BENCH.rglob("*.py")
                                        if "tests" not in p.parts),
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_sources_import_no_jax(path):
    tops = {m.split(".")[0] for m in _imports(path)}
    assert not tops & set(harness.FORBIDDEN)
    if "reference" in path.parts:
        assert "repro_torch" not in tops


CHILD = """
import sys, json
sys.path[:0] = [{src!r}, {root!r}]
from bench.tests import tiny
from bench import run as harness
for name in {{tiny.cell_files(n)[0]["driver"]: n
             for n in tiny.cells()}}.values():
    out = tiny.driver(name).run(tiny.context(name, seconds=0.3))
    assert out.checks
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
print(json.dumps(harness.forbidden_modules()))
"""


def test_a_run_loads_no_jax():
    code = CHILD.format(src=str(ROOT / "src"), root=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    loaded, bad = (json.loads(x) for x in out.stdout.strip().split("\n")[-2:])
    assert "repro_torch" in loaded
    assert bad == []


def test_refuses_without_the_program(tmp_path):
    """A checkout holding only BENCHMARK.json and the benchmark's paths
    exits non-zero and prints no result."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(BENCH, tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run(
        [sys.executable, "bench/run.py", "--workload", "cnn-p10-fedavg",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and out.stdout == ""


def test_refuses_without_a_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = subprocess.run(
        [sys.executable, "bench/run.py", "--workload", "cnn-p10-fedavg",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode == 3 and out.stdout == ""
