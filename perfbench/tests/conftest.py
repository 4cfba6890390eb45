"""The harness's own tests: ``python -m pytest perfbench/tests`` from the
root of the repository (the repository's suite does not collect them).
Tests marked ``card`` run only where a CUDA card is present."""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
for p in (ROOT, os.path.join(ROOT, "src")):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card (skips without one)")
