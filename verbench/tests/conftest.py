"""Tests of the benchmark itself: ``python -m pytest verbench/tests``
(CPU; the tests marked ``gpu`` skip without a card)."""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA device; skips where there is none")
