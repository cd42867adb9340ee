"""Readings of the check on many seeds in one process, the numbers the
limits are set from (``limits/<cell>.json``; ``PERF.md`` lists them).

    python3 benchmark/readings.py --workload <cell> --seeds 11 12 13 --seconds 2 \
        [--control bfloat16] [--fault <name of harness/faults.py>]

Runs the cell once per seed with a short window, each run's set-up, window
and check as ``run.py`` makes them, and prints one JSON line a seed: the
numbers compared (beside their limits), ``correct``, and the check's
further readings on standard error. The benchmark's own runs never plant a
fault or the control.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--control", choices=("bfloat16",), default=None)
    p.add_argument("--fault", default=None)
    args = p.parse_args(argv)
    os.environ["OMP_NUM_THREADS"] = os.environ["MKL_NUM_THREADS"] = "1"
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(ROOT, ".bench_cache", "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, ".bench_cache", "triton")
    sys.path[:0] = [HERE, ROOT]
    from harness import device
    from harness.cells import run_cell
    from harness.faults import FAULTS
    from harness.manifest import load_cell

    cell = load_cell(args.workload)
    device.require_cards(cell.chips)
    for seed in args.seeds:
        plant = FAULTS[args.fault]() if args.fault else contextlib.nullcontext()
        with plant:
            out = run_cell(cell, seed, args.seconds, False, time.time(),
                           compute_dtype=args.control)
        print(json.dumps({"seed": seed, "control": args.control, "fault": args.fault,
                          "correct": out["correct"], "failed": out["failed"],
                          "checks": out["checks"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
