"""The benchmark's own tests run on the CPU:

    python3 -m pytest benchmark/tests -q

They put the benchmark's directory and the checkout's root on the path, as
``benchmark/run.py`` does."""

import os
import sys

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for p in (BENCH, os.path.dirname(BENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)
