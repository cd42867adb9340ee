"""The port's bench: fragment descriptor and score extraction on one GPU
(port of the JAX package's ``bench.py``).

Run from the repository root::

    python3 -m d3feat_tpu_torch.bench           # f32
    python3 -m d3feat_tpu_torch.bench --bf16    # compute_dtype="bfloat16"

It measures what ``bench.py`` measures: end-to-end fragments/s of
``make_extract_step``'s step (on-device pyramid, KPFCNN forward,
descriptors and detection scores) on simulated depth-scan fragments of
12k-16k points (``data.synthetic.scan_fragment`` from
``np.random.default_rng(0)``), ``BENCH_FRAGS_PER_CALL`` (default 2) per
call on ``max(2, B)`` cloud slots, at the capacities
``(16384, 8192, 2048, 768, 256)·B`` with 40 neighbours, ``query_tile``
512 and the top-M local-max gate at ``BENCH_GATE_TOPM`` (default
16·250·B). The weights are the port's random init (``init_kpfcnn``, seed
0). Every batch is packed and on the device before the clock starts; 3
warm-up calls, then 20 timed calls and one synchronisation after the
loop. Overflow is read on the warm-up calls and the last timed call; when
set, the same warning as ``bench.py``'s goes to stderr.

It prints one JSON line: ``bench.py``'s keys (``metric``, ``value``,
``unit``, ``vs_baseline``) and metric name, plus ``card`` (``nvidia-smi``'s
name and power limit) and ``compute_dtype``. ``vs_baseline`` divides by
the reference's CPU data pipeline alone, 13.7 batches/s with 10 workers,
as ``bench.py`` does. The command line needs a CUDA device; ``--dp``
(data parallelism) is not ported yet.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

BASELINE_FRAGMENTS_PER_S = 13.7  # reference CPU collate, 10 workers
N_MIN, N_MAX = 12000, 16000      # realistic post-downsample fragment sizes
WARMUP = 3
ITERS = 20
CAPS_PER_FRAGMENT = (16384, 8192, 2048, 768, 256)
NEIGHBORS = 40
TOPK = 250                       # keypoints per fragment of the registration protocol


def draw_fragments(rng: np.random.Generator, count: int, n_min: int = N_MIN,
                   n_max: int = N_MAX, **scan_kw):
    """``count`` fragments of ``scan_fragment(rng, **scan_kw)``, each drawn
    again until its size is within [n_min, n_max]."""
    from d3feat_tpu_torch.data.synthetic import scan_fragment

    out = []
    for _ in range(count):
        f = scan_fragment(rng, **scan_kw)
        while not (n_min <= len(f) <= n_max):
            f = scan_fragment(rng, **scan_kw)
        out.append(f)
    return out


def bench_config(bf16: bool = False, frags: int = 2, caps=CAPS_PER_FRAGMENT,
                 neighbors: int = NEIGHBORS):
    """``bench.py``'s configuration: the default model at capacities
    ``caps·frags``, ``query_tile`` 512, the top-M gate."""
    from d3feat_tpu_torch.config import D3FeatConfig, PyramidCaps

    cfg = D3FeatConfig()
    if bf16:
        cfg.compute_dtype = "bfloat16"
    cfg.caps = PyramidCaps(points=tuple(c * frags for c in caps),
                           neighbors=(neighbors,) * len(caps), corr=128)
    cfg.query_tile = 512
    cfg.eval_gate_topm = int(os.environ.get("BENCH_GATE_TOPM", 16 * TOPK * frags))
    return cfg


def card_name(device) -> str:
    """``nvidia-smi``'s name and power limit of the card, or "cpu"."""
    if torch.device(device).type != "cuda":
        return "cpu"
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def run_bench(fragments, cfg, *, frags: int = 2, device="cuda", warmup: int = WARMUP,
              iters: int = ITERS):
    """Time ``iters`` extraction calls of ``frags`` fragments each (after
    ``warmup`` calls) on the first ``(warmup + iters)·frags`` of
    ``fragments``, with the weights of ``init_kpfcnn(cfg, seed=0)``.
    Returns the JSON line as a dict and whether a pyramid overflowed (then
    also warned on stderr)."""
    from d3feat_tpu_torch import resolve_device
    from d3feat_tpu_torch.data.pack import pack_fragments
    from d3feat_tpu_torch.models.kpfcnn import init_kpfcnn
    from d3feat_tpu_torch.train.step import make_extract_step

    dev = resolve_device(device)
    if len(fragments) < (warmup + iters) * frags:
        raise ValueError(f"{len(fragments)} fragments for {warmup + iters} calls of {frags}")
    num_clouds = max(2, frags)
    model = init_kpfcnn(cfg, seed=0, device=dev)
    extract = make_extract_step(cfg, num_clouds=num_clouds)
    batches = []
    for i in range(warmup + iters):
        b = pack_fragments(fragments[i * frags:(i + 1) * frags],
                           point_capacity=cfg.caps.points[0], num_clouds=num_clouds)
        batches.append({k: torch.from_numpy(v).to(dev) for k, v in b.items()})
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    sync()

    overflowed = False
    for i in range(warmup):
        overflowed |= bool(extract(model, batches[i])[2])
    t0 = time.perf_counter()
    for i in range(warmup, warmup + iters):
        out = extract(model, batches[i])
    sync()
    dt = time.perf_counter() - t0
    overflowed |= bool(out[2])
    if overflowed:
        print("WARNING: pyramid capacity overflow during bench — outputs "
              "degraded, capacities need recalibration", file=sys.stderr)
    fps = iters * frags / dt
    return {"metric": "fragment_extraction_throughput", "value": round(fps, 3),
            "unit": "fragments/s", "vs_baseline": round(fps / BASELINE_FRAGMENTS_PER_S, 3),
            "card": card_name(dev), "compute_dtype": cfg.compute_dtype}, overflowed


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if "--dp" in argv:
        raise NotImplementedError("--dp: data parallelism is not ported yet")
    if not torch.cuda.is_available():
        print("bench: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 2
    # the f32 products of the unary layers in full f32, their bf16 products
    # with f32 accumulation, as the JAX package computes them
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    torch.backends.cudnn.allow_tf32 = False
    frags = int(os.environ.get("BENCH_FRAGS_PER_CALL", "2"))
    cfg = bench_config(bf16="--bf16" in argv, frags=frags)
    fragments = draw_fragments(np.random.default_rng(0), (WARMUP + ITERS) * frags)
    line, _ = run_bench(fragments, cfg, frags=frags, device="cuda")
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
