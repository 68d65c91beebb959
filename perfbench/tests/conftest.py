"""The benchmark's tests import its modules as the harness does, from the
``perfbench`` folder, with the checkout's root beside it."""

import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
for p in (str(HERE), str(HERE.parent)):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line(
        'markers', 'cuda: needs an NVIDIA GPU; skips elsewhere')
