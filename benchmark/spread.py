"""Runs of one cell, each a fresh process, and the spread of each metric.

    python3 benchmark/spread.py --workload <cell> --seeds 11 12 13 --seconds 30 \
        [--trace 0] [--control bfloat16] [--out DIR]

Runs ``benchmark/run.py`` once per seed, in order, and prints one JSON line
a run (its result, or its exit code and the end of its standard error)
and, last, per metric the median and the spread: the distance between the
first and the third quartile (``statistics.quantiles(values, n=4)``) as a
share of the median, the yardstick a bound is set from. With ``--out`` each
run's standard error is kept in ``DIR``.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def spread(values):
    """(median, interquartile distance over the median) of ``values``."""
    med = statistics.median(values)
    if len(values) < 2 or med == 0:
        return med, 0.0
    q = statistics.quantiles(values, n=4)
    return med, (q[2] - q[0]) / abs(med)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", default=None)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    values = {}
    for seed in args.seeds:
        cmd = [sys.executable, os.path.join(HERE, "run.py"), "--workload", args.workload,
               "--seed", str(seed), "--seconds", str(args.seconds), "--trace", str(args.trace)]
        if args.control:
            cmd += ["--control", args.control]
        r = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True)
        if args.out:
            os.makedirs(args.out, exist_ok=True)
            with open(os.path.join(args.out, f"{args.workload}.{seed}.{args.trace}.err"), "w") as f:
                f.write(r.stderr)
        lines = r.stdout.strip().splitlines()
        if r.returncode != 0 or not lines:
            print(json.dumps({"seed": seed, "rc": r.returncode, "stderr": r.stderr[-2000:]}),
                  flush=True)
            continue
        res = json.loads(lines[-1])
        print(json.dumps({"seed": seed, **res}), flush=True)
        for name, m in res["metrics"].items():
            values.setdefault(name, []).append(m["value"])
    print(json.dumps({"workload": args.workload, "runs": len(args.seeds),
                      "spread": {k: dict(zip(("median", "iqr_share"), spread(v)), n=len(v))
                                 for k, v in values.items()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
