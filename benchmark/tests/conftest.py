"""The benchmark's own tests: the yardstick, the trace reduction, the
harness's lookups, the import check and the reference, on the CPU; the one
marked ``gpu`` runs a cell on a CUDA card and skips without one."""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent.parent))


def pytest_configure(config):
    config.addinivalue_line("markers", "gpu: needs a CUDA card; skips without one")
