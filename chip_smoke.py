#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``d3feat_tpu_torch``) once on one GPU.

Run from the repository root with no arguments::

    python3 chip_smoke.py            # add --profile for a device-time breakdown

It needs one CUDA device, ``nvcc`` (the CUDA toolkit), the committed r5
weights (``artifacts/model_best_acc_r5.npz``) and the committed eval-cache
fragments (``artifacts/eval_cache``); it imports nothing of JAX or of the
JAX package. Phases, each announced with the elapsed seconds:

1. device: name, count, and ``nvidia-smi`` name and power limit;
2. build: the three kernels from ``d3feat_tpu_torch/ops/cuda/*.cu`` with
   ``nvcc``, one process per source, all started together;
3. kernels vs twins on one real pyramid (two eval-cache fragments at the
   bench capacities): K1 bit for bit (positions, d2, thr, ptie of all 13
   searches), K2 at level 0 and at the widest level (atol 3e-5, rtol 1e-4,
   density exact), K3 (sums atol 1e-6, counts exact); kernel and twin times
   by CUDA events;
4. main path: ``FeatureExtractor(batch_fragments=2)`` with the r5 weights on
   the eval-cache fragments of 12k-16k points: launch counts of one counted
   call, output checks, the same batch through the twins on the card, and
   fragments/s over 20 calls after warm-up; with ``--profile``, device time
   by operator over 4 more calls (``torch.profiler``);
5. one JSON line with every kernel's numbers, then the result line.

Any failed check exits non-zero before the result line.
"""

import json
import os
import subprocess
import sys
import time

T0 = time.perf_counter()
BENCH_CAPS = tuple(2 * c for c in (16384, 8192, 2048, 768, 256))
N_MIN, N_MAX = 12000, 16000  # fragment sizes of the JAX package's bench.py
TOPK = 250                   # keypoints per fragment of the registration protocol
WARMUP, ITERS = 3, 20
PEAK_BYTES_S = 3.35e12       # H100 SXM HBM3, data sheet
PEAK_FP32_S = 67e12          # H100 SXM FP32 outside the tensor cores, data sheet
D2_OPS = 8  # per query-row pair: 3 subtractions, 1 multiply, 2 fused multiply-adds


def phase(msg):
    print(f"[{time.perf_counter() - T0:8.2f} s] {msg}", flush=True)


def fail(msg):
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def check(cond, msg):
    if not cond:
        fail(msg)


def cuda_ms(fn, reps=5):
    """Median milliseconds of ``fn()`` on the current stream, after one
    warm-up call."""
    import torch

    fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return sorted(times)[len(times) // 2]


def bound(nbytes, ops):
    t_bytes, t_ops = nbytes / PEAK_BYTES_S, ops / PEAK_FP32_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def window_rows(args):
    """Window rows walked, summed over the queries of every tile."""
    return int((args["wends"] - args["starts"]).clamp(min=0).sum()) * args["query_tile"]


def bench_config():
    from d3feat_tpu_torch.config import D3FeatConfig, PyramidCaps

    cfg = D3FeatConfig(experiment_id="chip_smoke")
    cfg.caps = PyramidCaps(points=BENCH_CAPS, neighbors=(40,) * 5, corr=128)
    cfg.query_tile = 512
    cfg.eval_gate_topm = 16 * TOPK * 2
    return cfg


def sorted_levels(pyr, spec):
    """The pyramid's SortedLevels, rebuilt from its sorted level points."""
    import torch
    from d3feat_tpu_torch.ops.neighbors import SortedLevel, make_level_frame
    from d3feat_tpu_torch.ops.pyramid import level_band_pad

    B = spec.num_clouds
    pts0 = pyr["points"][0][pyr["band"][0]["inv"]]
    axis, origin = make_level_frame(pts0, pyr["lengths"][0], B)
    levels = []
    for l in range(spec.num_levels):
        p = pyr["points"][l][pyr["band"][l]["inv"]]
        levels.append(SortedLevel(p, pyr["lengths"][l], B, axis, origin,
                                  band_pad=level_band_pad(spec, l, p.shape[0])))
        check(torch.equal(levels[l].key_sorted, pyr["band"][l]["key_sorted"]),
              f"level {l}: rebuilt sorted level differs from the pyramid's")
    return levels


def check_k1(pyr, spec, report):
    import torch
    from d3feat_tpu_torch.ops.pyramid import level_band_cap, level_search
    from d3feat_tpu_torch.ops.neighbors import search_windows
    from d3feat_tpu_torch.ops.select import band_select

    levels = sorted_levels(pyr, spec)
    searches = []
    for l in range(spec.num_levels):
        r = spec.radii[l]
        searches.append((f"conv{l}", levels[l], levels[l], r, spec.neighbor_caps[l]))
        if l + 1 < spec.num_levels:
            searches.append((f"pool{l}", levels[l + 1], levels[l], r, spec.neighbor_caps[l]))
            searches.append((f"up{l}", levels[l], levels[l + 1], 2.0 * r, 1))
    for name, q, s, r, k in searches:
        got = level_search(q, s, r, k, spec, impl="kernel")
        ref = level_search(q, s, r, k, spec, impl="plain")
        for i, (a, b) in enumerate(zip(got, ref)):
            check(torch.equal(a, b), f"K1 {name}: kernel output {i} differs from the twin")
    check(torch.equal(level_search(levels[0], levels[0], spec.radii[0], 40, spec)[0],
                      pyr["neighbors"][0]), "K1 conv0: lists differ from the pyramid's")

    # raw outputs and times at the largest search (conv0)
    qt = 256
    band_cap = level_band_cap(levels[0].n, spec.num_clouds, spec.band_frac, tile=qt)
    q_rows, starts, wends, r2, _ = search_windows(levels[0], levels[0], spec.radii[0],
                                                  query_tile=qt, band_cap=band_cap)
    kw = dict(query_tile=qt, r2=r2, max_k=40)
    s_rows = levels[0].s_rows
    kp, kd = band_select(q_rows, s_rows, starts, wends, impl="kernel", **kw)
    pp, pd = band_select(q_rows, s_rows, starts, wends, impl="plain", **kw)
    check(torch.equal(kp, pp) and torch.equal(kd, pd), "K1 conv0: raw outputs differ")
    ms = cuda_ms(lambda: band_select(q_rows, s_rows, starts, wends, impl="kernel", **kw))
    plain_ms = cuda_ms(lambda: band_select(q_rows, s_rows, starts, wends, impl="plain", **kw))
    args = dict(starts=starts, wends=wends, query_tile=qt)
    b_ms, b_by = bound(nbytes(q_rows, s_rows, starts, wends, kp, kd),
                       D2_OPS * window_rows(args))
    report["K1 select"] = dict(max_abs_err=0.0, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                               bound_by=b_by, library_ms=None)
    phase(f"K1 select: 13 searches bit-exact vs twin; conv0 {q_rows.shape[0]} queries x 40: "
          f"kernel {ms:.3f} ms, twin {plain_ms:.3f} ms, bound {b_ms:.4f} ms ({b_by})")


def check_k2(pyr, cfg, model, report, device="cuda"):
    import torch
    from d3feat_tpu_torch.models.blocks import band_conv_inputs
    from d3feat_tpu_torch.ops.band_conv import band_conv

    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    worst = 0.0
    for i in (1, len(model.specs.encoder) - 1):  # resnetb at level 0, at the widest level
        spec = model.specs.encoder[i]
        conv = model.encoder[i].conv
        args = band_conv_inputs(spec, pyr, cfg)
        ns_pad, cin = args["s_rows"].shape[0], conv.weights.shape[1]
        n_valid = int(pyr["lengths"][spec.layer].sum())
        x = torch.zeros((ns_pad, cin), device=device)
        x[:n_valid] = torch.nn.functional.leaky_relu(
            torch.randn((n_valid, cin), generator=gen, device=device), 0.1)
        kw = dict(args, x=x, weights=conv.weights.data, kernel_points=conv.kernel_points)
        ko, kden = band_conv(impl="kernel", **kw)
        po, pden = band_conv(impl="plain", **kw)
        check(torch.equal(kden, pden), f"K2 layer {spec.layer}: density differs from the twin")
        err = float((ko - po).abs().max())
        check(torch.allclose(ko, po, atol=3e-5, rtol=1e-4),
              f"K2 layer {spec.layer}: max |kernel - twin| = {err}")
        worst = max(worst, err)
        ms = cuda_ms(lambda: band_conv(impl="kernel", **kw))
        plain_ms = cuda_ms(lambda: band_conv(impl="plain", **kw), reps=3)
        cout = conv.weights.shape[2]
        lists = pyr["pools" if spec.strided else "neighbors"][spec.layer]
        # listed (= selected) query-support pairs; shadow entries equal the level size
        pairs = int((lists < pyr["points"][spec.layer].shape[0]).sum())
        q_live = int((args["q_rows"][:, 3] >= 0).sum())
        # window scan, influence weights (~12 operations a pair and kernel
        # point), then per kernel point [pairs x Cin] and [queries x Cin x Cout]
        kpn = conv.weights.shape[0]
        ops = (D2_OPS * window_rows(args) + kpn * 12 * pairs
               + kpn * (2 * pairs * cin + 2 * q_live * cin * cout))
        b_ms, b_by = bound(nbytes(args["q_rows"], args["thr"], args["ptie"], args["s_rows"],
                                  x, conv.weights, ko, kden), ops)
        phase(f"K2 band_conv layer {spec.layer} ({cin} -> {cout}, {args['q_rows'].shape[0]} "
              f"queries): max err {err:.3g}; kernel {ms:.3f} ms, twin {plain_ms:.3f} ms, "
              f"bound {b_ms:.4f} ms ({b_by})")
        report["K2 band_conv"] = dict(max_abs_err=worst, ms=ms, plain_ms=plain_ms,
                                      bound_ms=b_ms, bound_by=b_by, library_ms=None)


def check_k3(pyr, cfg, report, device="cuda"):
    import torch
    from d3feat_tpu_torch.models.kpfcnn import band_head_inputs
    from d3feat_tpu_torch.ops.head import band_head

    args = band_head_inputs(pyr, cfg)
    gen = torch.Generator(device=device)
    gen.manual_seed(1)
    n_valid = int(pyr["lengths"][0].sum())
    x = torch.zeros((args["s_rows"].shape[0], cfg.output_dim), device=device)
    x[:n_valid] = torch.rand((n_valid, cfg.output_dim), generator=gen, device=device)
    x[:n_valid:11] = 0.0  # listed but not counted
    ks, kc = band_head(x=x, impl="kernel", **args)
    ps, pc = band_head(x=x, impl="plain", **args)
    err = float((ks - ps).abs().max())
    check(torch.equal(kc, pc), "K3: counts differ from the twin")
    check(err <= 1e-6, f"K3: max |kernel - twin| = {err}")
    ms = cuda_ms(lambda: band_head(x=x, impl="kernel", **args))
    plain_ms = cuda_ms(lambda: band_head(x=x, impl="plain", **args), reps=3)
    ops = D2_OPS * window_rows(args) + int(kc.sum()) * cfg.output_dim
    b_ms, b_by = bound(nbytes(args["q_rows"], args["thr"], args["ptie"], args["s_rows"],
                              x, ks, kc), ops)
    report["K3 band_head"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                                  bound_by=b_by, library_ms=None)
    phase(f"K3 band_head ({args['q_rows'].shape[0]} queries x {cfg.output_dim}): max err "
          f"{err:.3g}; kernel {ms:.3f} ms, twin {plain_ms:.3f} ms, bound {b_ms:.4f} ms ({b_by})")


def topk_agree(a, b, k, atol):
    """The top-k index sets of two score vectors agree, up to swaps of
    scores within ``atol`` of the k-th score (ties at the boundary)."""
    import numpy as np

    ia, ib = np.argsort(-a, kind="stable")[:k], np.argsort(-b, kind="stable")[:k]
    kth = min(a[ia[-1]], b[ib[-1]])
    diff = set(ia.tolist()) ^ set(ib.tolist())
    return all(abs(a[i] - kth) <= atol and abs(b[i] - kth) <= atol for i in diff)


def main_path(cfg, model, frags, report, device="cuda"):
    import numpy as np
    import torch
    from d3feat_tpu_torch.data.pack import pack_fragments
    from d3feat_tpu_torch.eval.extract import FeatureExtractor
    from d3feat_tpu_torch.ops.band_conv import band_conv
    from d3feat_tpu_torch.ops.head import band_head
    from d3feat_tpu_torch.ops.pyramid import build_pyramid, make_pyramid_spec
    from d3feat_tpu_torch.ops.select import band_select

    wrappers = {"K1 select": band_select, "K2 band_conv": band_conv,
                "K3 band_head": band_head}
    # the serving policy: a group that overflows the bench bucket is run
    # again in the next larger one, so no served output is degraded
    ex = FeatureExtractor(cfg, model, batch_fragments=2, device=device)
    groups = [frags[i:i + 2] for i in range(0, len(frags) - 1, 2)]
    for i in range(WARMUP):
        ex.extract_many(groups[i % len(groups)])
    torch.cuda.synchronize()

    for w in wrappers.values():
        w.launches = 0
    ex._steps.clear()
    out = ex.extract_many(groups[0])  # one extraction call: the counted main-path run
    torch.cuda.synchronize()
    check(list(ex._steps) == [(cfg.caps.points[0], 2)],
          "main path: the counted call overflowed the bench bucket")
    for name, w in wrappers.items():
        report[name]["launches"] = w.launches
        check(w.launches > 0, f"{name}: no launch on the main path")
    phase("main path launches per call: " + ", ".join(
        f"{n} {report[n]['launches']}" for n in wrappers))

    for (desc, scores), frag in zip(out, groups[0]):
        check(desc.shape == (len(frag), cfg.output_dim) and scores.shape == (len(frag),),
              "main path: output shapes")
        check(np.isfinite(desc).all() and np.isfinite(scores).all(), "main path: non-finite")
        norms = np.linalg.norm(desc, axis=1)
        check(np.abs(norms - 1.0).max() < 1e-5, f"main path: norms off by "
              f"{np.abs(norms - 1.0).max()}")
        phase(f"fragment of {len(frag)} points: {(scores > 0).sum()} detected keypoints")

    twin = FeatureExtractor(cfg, model, batch_fragments=2, on_overflow="raise", impl="plain",
                            device=device)
    out_p = twin.extract_many(groups[0])
    worst_d, ok_sets = 0.0, True
    for (d, s), (dp, sp) in zip(out, out_p):
        worst_d = max(worst_d, float(np.abs(d - dp).max()))
        ok_sets &= topk_agree(s, sp, TOPK, 1e-4)
    check(worst_d <= 1e-4, f"main path: descriptors differ from the twins' by {worst_d}")
    check(ok_sets, "main path: top-250 keypoint sets differ from the twins'")
    phase(f"main path vs twins on the card: max descriptor diff {worst_d:.3g}, "
          f"top-{TOPK} sets agree")

    spec = make_pyramid_spec(cfg, num_clouds=2)
    over = {}
    for gi, g in enumerate(groups[:ITERS]):
        b = pack_fragments(g, point_capacity=cfg.caps.points[0], num_clouds=2)
        p = build_pyramid(torch.from_numpy(b["points"]).to(device),
                          torch.from_numpy(b["lengths"]).to(device), spec=spec)
        srcs = [k for k, v in p["overflow_by"].items() if bool(v)]
        if srcs:
            over[gi] = srcs
    phase(f"bench-bucket overflow in {len(over)} of {min(ITERS, len(groups))} groups "
          f"{over}; those run again in the next bucket")

    torch.cuda.synchronize()
    t = time.perf_counter()
    for i in range(ITERS):
        ex.extract_many(groups[i % len(groups)])
    torch.cuda.synchronize()
    fps = 2 * ITERS / (time.perf_counter() - t)
    phase(f"throughput: {fps:.3f} fragments/s ({ITERS} calls of 2 fragments, "
          f"gate top-{cfg.eval_gate_topm})")
    if "--profile" in sys.argv:
        profile(ex, groups)
    return fps


def profile(ex, groups, calls=4):
    """Device time by operator over a few extraction calls, and the device
    busy share of their wall time (``--profile``)."""
    import torch
    from torch.profiler import ProfilerActivity, profile as torch_profile

    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for i in range(calls):
            ex.extract_many(groups[i % len(groups)])
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    rows = [(getattr(e, "self_device_time_total", 0.0) / 1e3, e.count, e.key)
            for e in prof.key_averages()]
    rows = sorted((r for r in rows if r[0] > 0), reverse=True)
    busy = sum(r[0] for r in rows)
    phase(f"profile: {calls} calls, wall {wall_ms:.1f} ms, device busy {busy:.1f} ms "
          f"({100 * busy / wall_ms:.1f} %)")
    for ms, n, key in rows[:20]:
        print(f"    {ms:9.3f} ms  {n:6d}x  {key[:90]}", flush=True)


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    from d3feat_tpu_torch.compat.weights import load_npz
    from d3feat_tpu_torch.data.pack import load_eval_fragments, pack_fragments
    from d3feat_tpu_torch.models.kpfcnn import init_kpfcnn
    from d3feat_tpu_torch.ops import build
    from d3feat_tpu_torch.ops.pyramid import build_pyramid, make_pyramid_spec

    torch.backends.cuda.matmul.allow_tf32 = False  # full FP32 everywhere
    torch.backends.cudnn.allow_tf32 = False

    phase("device")
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    phase(f"torch {torch.__version__} cuda {torch.version.cuda}; {kind} x {count}")

    phase("build")
    secs = build.build(["select", "band_conv", "head"])
    phase("built: " + ", ".join(f"{k} {v:.1f} s" for k, v in secs.items()))

    cfg = bench_config()
    frags = load_eval_fragments(N_MIN, N_MAX)
    check(len(frags) >= 2, "fewer than two eval-cache fragments of 12k-16k points")
    model = init_kpfcnn(cfg, device="cuda")
    meta = load_npz(model, os.path.join(here, "artifacts", "model_best_acc_r5.npz"))
    phase(f"r5 weights loaded (epoch {meta['epoch']}); {len(frags)} fragments of "
          f"{N_MIN}-{N_MAX} points")

    phase("kernels vs twins")
    spec = make_pyramid_spec(cfg, num_clouds=2)
    b = pack_fragments(frags[:2], point_capacity=cfg.caps.points[0], num_clouds=2)
    pyr = build_pyramid(torch.from_numpy(b["points"]).cuda(),
                        torch.from_numpy(b["lengths"]).cuda(), spec=spec, impl="plain")
    check(not bool(pyr["overflow"]), "reference pyramid overflowed")
    report = {}
    check_k1(pyr, spec, report)
    check_k2(pyr, cfg, model, report)
    check_k3(pyr, cfg, report)

    phase("main path")
    fps = main_path(cfg, model, frags, report)

    sources = {"K1 select": ("select.cu", "d3feat_tpu/ops/pallas/select.py:252"),
               "K2 band_conv": ("band_conv.cu", "d3feat_tpu/ops/pallas/band_conv.py:351"),
               "K3 band_head": ("head.cu", "d3feat_tpu/ops/pallas/head.py:173")}
    kernels = []
    for name, (src, replaces) in sources.items():
        r = report[name]
        kernels.append({"name": name, "route": "cuda",
                        "source": f"d3feat_tpu_torch/ops/cuda/{src}", "replaces": replaces,
                        "launches": r["launches"], "max_abs_err": r["max_abs_err"],
                        "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
    print(json.dumps({"fragments_per_s": fps, "card": smi}), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                              "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
