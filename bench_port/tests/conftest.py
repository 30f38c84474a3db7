"""The benchmark's tests: ``python -m pytest bench_port/tests`` from the checkout's root.

Tests marked ``card`` need a CUDA card; each decides inside itself and
skips with a reason on a machine without one.
"""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card (the benchmark's control runs)")
