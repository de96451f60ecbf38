"""CPU tests of the benchmark (``python -m pytest benchmark/tests -q`` from
the root of the checkout). A test that needs the card carries the ``card``
marker and skips, from inside the test, where CUDA is missing."""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers",
                            "card: needs a CUDA card; skips without one")
