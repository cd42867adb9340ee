"""Run one cell of the benchmark of the PyTorch and CUDA port on the card.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. Prints, as the last line of standard output,
one JSON object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the
cell's end-to-end metrics, or with ``--trace 1`` its per-layer ones),
``device``, with ``--trace 1`` ``breakdown``, and last ``checks``, each
number the check compared with its limit (also the last lines of standard
error). Exits with a code other than 0, printing no result, without a
card, without the program beside the benchmark, or when JAX or the JAX
package was loaded. ``--control bfloat16`` runs the program in bf16, the
control that the check has to refuse; the benchmark's own runs never pass
it. Build and kernel caches stay in fixed directories of the checkout. The
process runs its thread pools with one thread.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
CACHE = os.path.join(ROOT, ".bench_cache")


def process_start() -> float:
    """The process's start, epoch seconds (from /proc; now where it cannot
    be read)."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as f:
            btime = next(int(line.split()[1]) for line in f if line.startswith("btime"))
        return btime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, StopIteration, IndexError):
        return time.time()


STARTED_AT = process_start()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", choices=("bfloat16",), default=None)
    args = p.parse_args(argv)

    # thread pools of one thread: the host paces this program, and pool
    # threads waking on a shared machine widened the runs' spread
    os.environ["OMP_NUM_THREADS"] = os.environ["MKL_NUM_THREADS"] = "1"
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
    os.environ["USE_FLAX"] = "0"
    sys.path[:0] = [HERE, ROOT]
    if not os.path.isdir(os.path.join(ROOT, "d3feat_tpu_torch")):
        print(f"the program d3feat_tpu_torch is not beside the benchmark in {ROOT}",
              file=sys.stderr)
        return 2

    from harness import device
    from harness.manifest import load_cell

    cell = load_cell(args.workload)
    try:
        device.require_cards(cell.chips)
    except device.NoCard as e:
        print(f"no result: {e}", file=sys.stderr)
        return 3
    from harness.cells import run_cell

    print(f"card: {device.power_limit()}", file=sys.stderr)
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace), STARTED_AT,
                      compute_dtype=args.control)
    loaded = device.forbidden_modules()
    if loaded:
        print(f"no result: the run loaded {loaded}", file=sys.stderr)
        return 4
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
