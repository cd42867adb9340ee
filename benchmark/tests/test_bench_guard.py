"""The guard against JAX and the JAX package, compared by whole top-level
module names, and the runs that must print no result."""

import json
import os
import shutil
import subprocess
import sys

from harness.device import forbidden_modules
from harness.manifest import BENCH_DIR, MANIFEST, ROOT


def test_whole_top_level_names():
    names = ["d3feat_tpu_torch", "d3feat_tpu_torch.ops.select", "jaxfoo", "numpy",
             "d3feat_tpu_tools", "jax", "jax.numpy", "jaxlib.xla_client", "flax.linen",
             "d3feat_tpu", "d3feat_tpu.ops"]
    assert forbidden_modules(names) == sorted(["jax", "jax.numpy", "jaxlib.xla_client",
                                               "flax.linen", "d3feat_tpu", "d3feat_tpu.ops"])


def test_harness_and_program_load_no_jax():
    code = ("import sys; sys.path[:0] = [%r, %r]\n"
            "import harness.cells, harness.check, harness.program, harness.trace\n"
            "import reference.geometry, reference.model, reference.weights\n"
            "from harness.device import forbidden_modules\n"
            "print(forbidden_modules())") % (BENCH_DIR, ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, check=True)
    assert out.stdout.strip().splitlines()[-1] == "[]"


def _run(cwd, timeout=300):
    return subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                           json.load(open(MANIFEST))["workloads"][0]["name"], "--seed",
                           "3000000001", "--seconds", "1", "--trace", "0"],
                          cwd=cwd, capture_output=True, text=True, timeout=timeout,
                          env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))


def test_no_card_no_result():
    out = _run(ROOT)
    assert out.returncode != 0 and not out.stdout.strip()


def test_benchmark_alone_no_result(tmp_path):
    shutil.copy(MANIFEST, tmp_path / "BENCHMARK.json")
    shutil.copytree(BENCH_DIR, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run(tmp_path)
    assert out.returncode != 0 and not out.stdout.strip()
