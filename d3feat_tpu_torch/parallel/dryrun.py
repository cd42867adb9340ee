"""One data-parallel train step and one data-parallel extraction over N
ranks, each held against the single-process steps (counterpart of
``__graft_entry__.py::dryrun_multichip``).

    python3 -m d3feat_tpu_torch.parallel.dryrun N           # N CPU ranks, gloo
    python3 -m d3feat_tpu_torch.parallel.dryrun N --cuda    # N cards, NCCL

starts N processes with one torch thread each, joined on a ``file://``
store in a temporary directory (rank r on card r with ``--cuda``: the
kernels; on the CPU their plain twins). Each rank takes its own synthetic
pair (seed = its rank) of a stacked batch and runs one step of the full
5-layer depth at ``first_features_dim=64`` (every encoder level, the whole
decoder and the detector head; pyramid, forward, losses, averaged
gradients, the global non-finite gate, SGD update). It asserts

- a finite loss, and the same weights on every rank after the step;
- the averaged gradients against the mean of the N single-process steps'
  gradients, which every rank recomputes on its own device (summed in
  rank order, then divided by N): relative L2 at most ``GRAD_RTOL`` (the
  collective may sum in another order; gloo with 2 ranks sums in the
  same one), and the loss against the mean of their losses (rtol 1e-6);
- extraction (``make_dp_extract_step``): every rank holds all N ranks'
  outputs, each equal bit for bit to that fragment's single extraction
  on this rank (overflow flag included). On the CPU each rank extracts
  the pair of its train step (whose tiny capacities overflow at the
  subsampled levels, as ``dryrun_multichip``'s do); with ``--cuda`` it
  extracts one ``scan_fragment`` of 12k-16k points
  (``data.synthetic.draw_fragments`` from seed 0, fragment r on rank r)
  at the card checks' configuration (``data.pack.bench_config``) on two
  cloud slots, and no pyramid may overflow there.

With ``--cuda`` rank 0 also times the gradient all-reduce (one flat f32
buffer, CUDA events, median of 5) and one more DP train step, and prints
one JSON line with the checks, those times and the card (``nvidia-smi``
name and power limit). A rank that fails stops the others within the
group's timeout; the command fails if any rank fails.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import tempfile

TIMEOUT_S = 300.0
GRAD_RTOL = 1e-5  # a re-association of N f32 sums moves the mean by ~1e-7


def dryrun_config():
    """``dryrun_multichip``'s configuration: capacities (768, 384, 192, 96,
    64), 16 neighbours, 32 correspondences, ``query_tile`` 128, 5 layers,
    width 64."""
    from d3feat_tpu_torch.config import D3FeatConfig, PyramidCaps

    cfg = D3FeatConfig()
    cfg.num_layers = 5
    cfg.first_features_dim = 64
    cfg.caps = PyramidCaps(points=(768, 384, 192, 96, 64), neighbors=(16,) * 5, corr=32)
    cfg.query_tile = 128
    return cfg


def packed_pair(cfg, n=180, num_corr=16, seed=0):
    """A synthetic pair packed at the config's capacities (``__graft_entry__``'s
    ``_packed_pair``)."""
    import numpy as np

    from d3feat_tpu_torch.data.pack import pack_pair
    from d3feat_tpu_torch.data.synthetic import synthetic_pair

    rng = np.random.default_rng(seed)
    pts0, pts1, corr, dk = synthetic_pair(rng, n_points=n, num_corr=num_corr)
    p = pack_pair(pts0, pts1, np.ones((n, 1), np.float32), np.ones((n, 1), np.float32), corr,
                  dk, point_capacity=cfg.caps.points[0], corr_capacity=cfg.caps.corr)
    return {k: getattr(p, k) for k in
            ("points", "features", "lengths", "corr", "corr_valid", "dist_keypts")}


def _flat_grads(model):
    import torch

    from d3feat_tpu_torch.train.optim import train_tensors

    return torch.cat([t.grad.reshape(-1) for _, t in train_tensors(model)])


def _mean_of_singles(cfg, pairs, dev):
    """(mean loss, mean flat gradient) of the single-process steps on
    ``pairs``, summed in order."""
    import torch

    from d3feat_tpu_torch.models.kpfcnn import init_kpfcnn
    from d3feat_tpu_torch.train.optim import make_optimizer
    from d3feat_tpu_torch.train.step import TrainState, make_train_step

    step, loss, grad = make_train_step(cfg), 0.0, None
    for p in pairs:
        model = init_kpfcnn(cfg, seed=0, device=dev)
        _, m = step(TrainState(model, make_optimizer(cfg, model)),
                    {k: torch.as_tensor(v).to(dev) for k, v in p.items()}, 0)
        g = _flat_grads(model)
        loss, grad = loss + m.loss, g if grad is None else grad + g
    return loss / len(pairs), grad / len(pairs)


def _extraction(world, rank, dev):
    """(config, this rank's packed batch, every rank's packed batch) of the
    extraction check."""
    import numpy as np
    import torch

    if dev.type == "cuda":
        from d3feat_tpu_torch.data.pack import bench_config, pack_fragments
        from d3feat_tpu_torch.data.synthetic import draw_fragments

        cfg = bench_config(frags=2)
        frags = draw_fragments(np.random.default_rng(0), world)
        packed = [pack_fragments([f], point_capacity=cfg.caps.points[0], num_clouds=2)
                  for f in frags]
    else:
        cfg = dryrun_config()
        packed = [packed_pair(cfg, seed=i) for i in range(world)]
    batches = [{k: torch.as_tensor(p[k]).to(dev) for k in ("points", "features", "lengths")}
               for p in packed]
    return cfg, batches[rank], batches


def run_rank(rank: int, world: int, store: str, device: str = "cpu") -> dict:
    """One rank's checks; returns rank 0's summary (module docstring)."""
    import torch
    import torch.distributed as dist

    from d3feat_tpu_torch.models.kpfcnn import init_kpfcnn
    from d3feat_tpu_torch.parallel import init_group, make_dp_extract_step, \
        make_dp_train_step, rank_device, shard_batch, stack_batches
    from d3feat_tpu_torch.train.optim import make_optimizer
    from d3feat_tpu_torch.train.step import TrainState, make_extract_step

    init_group(device, world_size=world, rank=rank, init_method=f"file://{store}",
               timeout_s=TIMEOUT_S)
    dev = rank_device(device, rank)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    try:
        cfg = dryrun_config()
        model = init_kpfcnn(cfg, seed=0, device=dev)
        state = TrainState(model, make_optimizer(cfg, model))
        step = make_dp_train_step(cfg)
        pairs = [packed_pair(cfg, seed=i) for i in range(world)]
        mine = shard_batch(stack_batches(pairs), rank, dev, world)
        state, m = step(state, mine, 0)
        if not math.isfinite(m.loss) or m.skipped:
            raise AssertionError(f"rank {rank}: loss {m.loss}, skipped {m.skipped}")
        flat = torch.cat([p.detach().reshape(-1) for p in model.parameters()])
        first = flat.clone()
        dist.broadcast(first, 0)
        if not torch.equal(flat, first):
            raise AssertionError(f"rank {rank}: weights differ from rank 0's after the step")
        grad = _flat_grads(model)
        ref_loss, ref_grad = _mean_of_singles(cfg, pairs, dev)
        grad_err = float((grad.double() - ref_grad.double()).norm() / ref_grad.double().norm())
        if not (grad_err <= GRAD_RTOL and math.isclose(m.loss, ref_loss, rel_tol=1e-6)):
            raise AssertionError(f"rank {rank}: averaged gradients {grad_err:.3g} (relative "
                                 f"L2) from the singles' mean, loss {m.loss} vs {ref_loss}")

        ecfg, eb, all_eb = _extraction(world, rank, dev)
        emodel = init_kpfcnn(ecfg, seed=0, device=dev)
        feats, scores, overflow = make_dp_extract_step(ecfg, num_clouds=2)(emodel, eb)
        single = make_extract_step(ecfg, num_clouds=2)
        for j, b in enumerate(all_eb):
            f, s, o = single(emodel, b)
            if not (torch.equal(feats[j], f) and torch.equal(scores[j], s)
                    and bool(overflow[j]) == bool(o)):
                raise AssertionError(f"rank {rank}: gathered extraction {j} differs from its "
                                     f"single extraction")
        if feats.shape[0] != world or (dev.type == "cuda" and bool(overflow.any())):
            raise AssertionError(f"rank {rank}: gathered {tuple(feats.shape)}, overflow "
                                 f"{overflow.tolist()}")
        out = {"dryrun": world, "backend": dist.get_backend(), "loss": m.loss,
               "grad_rel_l2_vs_singles": grad_err, "extract_bitwise": True,
               "extract_overflow": overflow.tolist(),
               "extract_points": [int(b["lengths"].sum()) for b in all_eb]}
        if dev.type == "cuda":
            out.update(_card_times(step, state, mine, grad, sync))
            from d3feat_tpu_torch import card_name

            out["card"] = card_name(dev)
        if rank == 0:
            print(f"dryrun({world}): loss={m.loss:.4f} skipped={m.skipped} step=1", flush=True)
            print(json.dumps(out), flush=True)
        return out
    finally:
        dist.destroy_process_group()


def _cuda_ms(fn, sync, reps=5):
    import torch

    fn()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        sync()
        times.append(a.elapsed_time(b))
    return sorted(times)[reps // 2]


def _card_times(step, state, batch, grad, sync):
    """The gradient all-reduce's bytes and ms, and one more DP step's ms."""
    import time

    import torch.distributed as dist

    buf = grad.clone()
    ar_ms = _cuda_ms(lambda: dist.all_reduce(buf), sync)
    sync()
    dist.barrier()
    t0 = time.perf_counter()
    step(state, batch, 0)
    sync()
    return {"allreduce_bytes": buf.numel() * buf.element_size(), "allreduce_ms": ar_ms,
            "dp_step_ms": (time.perf_counter() - t0) * 1e3}


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    device = "cuda" if "--cuda" in argv else "cpu"
    argv = [a for a in argv if a != "--cuda"]
    if argv and argv[0] == "--rank":  # a worker: --rank R N STORE
        run_rank(int(argv[1]), int(argv[2]), argv[3], device)
        return 0
    world = int(argv[0]) if argv else 2
    env = dict(os.environ, OMP_NUM_THREADS="1")
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    with tempfile.TemporaryDirectory() as tmp:
        store = os.path.join(tmp, "store")
        extra = ["--cuda"] if device == "cuda" else []
        procs = [subprocess.Popen([sys.executable, "-m", "d3feat_tpu_torch.parallel.dryrun",
                                   "--rank", str(r), str(world), store, *extra], env=env,
                                  cwd=root)
                 for r in range(world)]
        rcs = []
        for p in procs:
            try:
                rcs.append(p.wait(timeout=2 * TIMEOUT_S))
            except subprocess.TimeoutExpired:
                p.kill()
                rcs.append(p.wait())
    if any(rcs):
        print(f"dryrun({world}): ranks exited with {rcs}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
