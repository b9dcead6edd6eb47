"""The benchmark's own tests: ``python -m pytest -q bench/tests`` from
the repository root (``-m cuda`` on the card).  The program and the
benchmark are imported from this checkout."""
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (ROOT / "src", ROOT):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; decides inside the test "
        "whether there is one and skips without")
