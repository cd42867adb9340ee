#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``d3feat_tpu_torch``) once on one GPU.

Run from the repository root with no arguments::

    python3 chip_smoke.py            # add --profile for a device-time breakdown

It needs one CUDA device, ``nvcc`` (the CUDA toolkit), the committed r5
weights (``artifacts/model_best_acc_r5.npz``) and the committed eval-cache
fragments and poses (``artifacts/eval_cache``); it imports nothing of JAX
or of the JAX package. Phases, each announced with the elapsed seconds:

1. device: name, count, and ``nvidia-smi`` name and power limit;
2. build: the kernel sources ``d3feat_tpu_torch/ops/cuda/*.cu`` with
   ``nvcc``, one process per source, all started together;
3. kernels vs twins on one real pyramid (two eval-cache fragments at the
   bench capacities): K1 bit for bit (positions, d2, thr, ptie) on all 13
   searches, each timed; the list stage of K2/K4 and its transpose bit for
   bit on the 9 searches the convs use; K2 at all 14 convs (atol 3e-5,
   rtol 1e-4, density exact); K3 from conv0's lists (sums atol 1e-6,
   counts exact); K4 at all 14 convs from the forward's lists and weighted
   rows and a seeded cotangent (dx and dW at atol 5e-4, rtol 1e-3); K5
   from the transpose of conv0's lists (atol 1e-5). Kernel and twin times
   by CUDA events (a call's launches, the host's launch work included),
   kernel device time by ``torch.profiler``, and each bound; K1's sums over
   the 13 searches, K2's and K4's over the 14 convs; for K3's sums and K5,
   the time of one cuSPARSE SpMM (``torch.sparse.mm``) of the same lists
   as a CSR matrix of ones, as the library's yardstick;
4. serving path: ``FeatureExtractor(batch_fragments=2)`` with the r5
   weights on the eval-cache fragments of 12k-16k points: launch counts of
   one counted call, output checks, the same batch through the twins on
   the card, and fragments/s over 20 calls after warm-up;
5. training path: ``make_train_step`` at full width from a copy of the r5
   weights on the first ground-truth-posed eval-cache pair that fits the
   bench capacities (correspondences within 0.0375, 128 of them): launch
   counts of one counted step (one transpose per search, one K5 launch),
   that step's loss and gradients against a
   step through the twins (loss rtol 1e-3, gradients atol 5e-3, rtol
   5e-3), then 10 more kernel steps (finite, none skipped, no overflow)
   and train steps/s;
6. with ``--profile``, device time by kernel and the device busy share
   over 4 extraction calls and over 3 train steps (``torch.profiler``);
7. one JSON line with every kernel's numbers, then the result line.

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
TRAIN_STEPS = 10             # timed kernel train steps after the counted one
CORR_RADIUS = 0.0375         # ground-truth correspondence radius (synthetic.py's corr_radius)
NUM_NODE = 128               # correspondences per pair (the reference's num_node)
PEAK_BYTES_S = 3.35e12       # H100 SXM HBM3, data sheet
PEAK_FP32_S = 67e12          # H100 SXM FP32 outside the tensor cores, data sheet
PEAK_3XTF32_S = 495e12 / 3   # H100 SXM dense TF32 tensor cores, 3 products per f32 product
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


def device_events(prof):
    """(device ms, launches, name) of every device event of a profile: the
    kernels and copies themselves; a host operator's device time repeats
    that of the kernels it launched, an annotation's (such as an autograd
    function's range) that of the kernels inside it."""
    import torch

    return [(e.self_device_time_total / 1e3, e.count, e.key) for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)]


def device_ms(fn, reps=5):
    """Device milliseconds per call of ``fn()``: the time its kernels (and
    copies) ran on the card, without the host's launch overhead, over
    ``reps`` calls after one warm-up call (``torch.profiler``)."""
    import torch
    from torch.profiler import ProfilerActivity, profile as torch_profile

    fn()
    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sum(ms for ms, _, _ in device_events(prof)) / reps


def bound(nbytes, ops, tc_ops=0):
    """(least milliseconds, what bounds them): bytes at the memory rate, or
    ``ops`` at the FP32 rate plus ``tc_ops`` (f32-accurate products on the
    tensor cores as 3xTF32) at a third of the TF32 rate."""
    t_bytes, t_ops = nbytes / PEAK_BYTES_S, ops / PEAK_FP32_S + tc_ops / PEAK_3XTF32_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def window_rows(args):
    """Window rows walked, summed over the queries of every tile."""
    return int((args["wends"] - args["starts"]).clamp(min=0).sum()) * args["query_tile"]


def csr_spmm(crow, col, shape, dense):
    """(ms by events, device ms, result) of one cuSPARSE SpMM: the CSR
    matrix of ones with rows ``crow``/``col`` (built outside the timed
    call) times ``dense``, ``torch.sparse.mm``: a library's yardstick for a
    kernel that sums listed rows, never called by the port."""
    import torch

    a = torch.sparse_csr_tensor(crow, col, torch.ones(col.shape[0], device=dense.device),
                                size=shape, check_invariants=True)
    run = lambda: torch.sparse.mm(a, dense)  # noqa: E731
    return cuda_ms(run), device_ms(run), run()


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


def k1_searches(spec, levels):
    """(name, query level, support level, radius, K) of the pyramid's 13
    searches, in the order ``build_pyramid`` runs them."""
    out = []
    for l in range(spec.num_levels):
        r = spec.radii[l]
        out.append((f"conv{l}", levels[l], levels[l], r, spec.neighbor_caps[l]))
        if l + 1 < spec.num_levels:
            out.append((f"pool{l}", levels[l + 1], levels[l], r, spec.neighbor_caps[l]))
            out.append((f"up{l}", levels[l], levels[l + 1], 2.0 * r, 1))
    return out


def k1_args(q, s, r, k, spec):
    """The K1 call of one search as ``pyramid.level_search`` makes it:
    (q_rows, s_rows, starts, wends, keyword arguments)."""
    from d3feat_tpu_torch.ops.neighbors import search_windows
    from d3feat_tpu_torch.ops.pyramid import level_band_cap

    ratio = -(-s.n // q.n)
    qt = 128 if (ratio > 1 or s.n < 256) else 256
    band_cap = level_band_cap(s.n, spec.num_clouds, spec.band_frac, tile=qt, ratio=ratio)
    q_rows, starts, wends, r2, _ = search_windows(q, s, r, query_tile=qt, band_cap=band_cap)
    return q_rows, s.s_rows, starts, wends, dict(query_tile=qt, r2=r2, max_k=min(k, band_cap))


def check_k1(pyr, spec, report):
    """K1 bit for bit against its twin on every search of the pyramid (13
    at the default config), through ``level_search`` (positions, overflow,
    thr, ptie) and raw (positions, d2), each search timed (kernel and twin
    by events, kernel device time) beside its bound; its ms in the kernels
    line is the sum over the searches of one extraction call."""
    import torch
    from d3feat_tpu_torch.ops.pyramid import level_search
    from d3feat_tpu_torch.ops.select import band_select

    levels = sorted_levels(pyr, spec)
    tot = dict(ms=0.0, dev_ms=0.0, plain_ms=0.0, bound_ms=0.0, ops=0.0, bytes=0.0)
    conv0 = None
    searches = k1_searches(spec, levels)
    for name, q, s, r, k in searches:
        got = level_search(q, s, r, k, spec, impl="kernel")
        ref = level_search(q, s, r, k, spec, impl="plain")
        for i, (a, b) in enumerate(zip(got, ref)):
            check(torch.equal(a, b), f"K1 {name}: kernel output {i} differs from the twin")
        q_rows, s_rows, starts, wends, kw = k1_args(q, s, r, k, spec)
        kp, kd = band_select(q_rows, s_rows, starts, wends, impl="kernel", **kw)
        pp, pd = band_select(q_rows, s_rows, starts, wends, impl="plain", **kw)
        check(torch.equal(kp, pp) and torch.equal(kd, pd), f"K1 {name}: raw outputs differ")

        def run(impl):
            return band_select(q_rows, s_rows, starts, wends, impl=impl, **kw)

        ms, dev_ms = cuda_ms(lambda: run("kernel")), device_ms(lambda: run("kernel"))
        plain_ms = cuda_ms(lambda: run("plain"), reps=3)
        nb = nbytes(q_rows, s_rows, starts, wends, kp, kd)
        ops = D2_OPS * window_rows(dict(starts=starts, wends=wends, query_tile=kw["query_tile"]))
        b_ms, b_by = bound(nb, ops)
        for f, v in (("ms", ms), ("dev_ms", dev_ms), ("plain_ms", plain_ms), ("bound_ms", b_ms),
                     ("ops", ops), ("bytes", nb)):
            tot[f] += v
        if name == "conv0":
            conv0 = (ms, dev_ms, plain_ms, b_ms, b_by)
        phase(f"K1 select {name} ({q_rows.shape[0]} queries x {kw['max_k']}, tile "
              f"{kw['query_tile']}, {int((wends - starts).clamp(min=0).max())} rows in the widest "
              f"window): bit-exact vs twin; kernel {ms:.4f} ms (device {dev_ms:.4f} ms), twin "
              f"{plain_ms:.3f} ms, bound {b_ms:.4f} ms ({b_by})")
    check(torch.equal(level_search(levels[0], levels[0], spec.radii[0],
                                   spec.neighbor_caps[0], spec)[0],
                      pyr["neighbors"][0]), "K1 conv0: lists differ from the pyramid's")
    phase(f"K1 select conv0: kernel {conv0[0]:.4f} ms (device {conv0[1]:.4f} ms), twin "
          f"{conv0[2]:.3f} ms, bound {conv0[3]:.4f} ms ({conv0[4]})")
    phase(f"K1 select, sum over the {len(searches)} searches of one extraction call: kernel "
          f"{tot['ms']:.4f} ms (device {tot['dev_ms']:.4f} ms), twin {tot['plain_ms']:.3f} ms, "
          f"bound {tot['bound_ms']:.4f} ms")
    report["K1 select"] = dict(max_abs_err=0.0, ms=tot["ms"], plain_ms=tot["plain_ms"],
                               bound_ms=tot["bound_ms"],
                               bound_by=bound(tot["bytes"], tot["ops"])[1], library_ms=None)


def conv_cases(pyr, cfg, model):
    """(spec, conv, band_conv_inputs) of every band conv of the encoder, in
    the order the forward runs them (14 at the default config)."""
    from d3feat_tpu_torch.models.blocks import band_conv_inputs

    return [(model.specs.encoder[i], blk.conv, band_conv_inputs(model.specs.encoder[i], pyr, cfg))
            for i, blk in enumerate(model.encoder) if hasattr(blk, "conv")]


def conv_features(spec, pyr, args, cin, gen, device):
    """Seeded leaky-ReLU features on the valid support rows, zero padding."""
    import torch

    n_valid = int(pyr["lengths"][spec.layer].sum())
    x = torch.zeros((args["s_rows"].shape[0], cin), device=device)
    x[:n_valid] = torch.nn.functional.leaky_relu(
        torch.randn((n_valid, cin), generator=gen, device=device), 0.1)
    return x


def conv_pairs(spec, pyr):
    """Listed (= selected) query-support pairs of the conv's search; shadow
    entries equal the support level's size."""
    lists = pyr["pools" if spec.strided else "neighbors"][spec.layer]
    return int((lists < pyr["points"][spec.layer].shape[0]).sum())


def conv_label(spec, conv, args):
    kpn, cin, cout = conv.weights.shape
    return (f"{'pool' if spec.strided else 'conv'}{spec.layer} {cin} -> {cout}, "
            f"{args['q_rows'].shape[0]} queries")


def list_nbytes(lists):
    return nbytes(lists.lpos, lists.ld2, lists.lcnt)


def check_lists(pyr, cfg, model, report):
    """The list stage and its transpose (K4's dx order) bit for bit against
    their twins on every search the convs use (9 at the default config);
    their ms in the kernels line are the sums over those searches (the
    builds: one extraction call's; the transposes: one train step's)."""
    import torch
    from d3feat_tpu_torch.ops.band_lists import band_lists, transpose_lists

    seen = {}
    tot = {k: dict(ms=0.0, plain_ms=0.0, dev_ms=0.0, bound_ms=0.0, ops=0.0, bytes=0.0)
           for k in "lt"}
    for spec, conv, args in conv_cases(pyr, cfg, model):
        name = f"{'pool' if spec.strided else 'conv'}{spec.layer}"
        if name in seen:
            continue
        kw = {k: args[k] for k in ("q_rows", "thr", "ptie", "s_rows", "starts", "wends",
                                   "query_tile")}
        got = band_lists(impl="kernel", **kw)
        ref = band_lists(impl="plain", **kw)
        for f in ("lpos", "ld2", "lcnt"):
            check(torch.equal(getattr(got, f), getattr(ref, f)),
                  f"band_lists {name}: {f} differs from the twin")
        ns = args["s_rows"].shape[0]
        tk, tp = (transpose_lists(got, ns, impl=i) for i in ("kernel", "plain"))
        check(all(torch.equal(a, b) for a, b in zip(tk, tp)),
              f"band_lists {name}: the transpose differs from the twin's")
        seen[name] = int(got.lcnt.sum())
        fns = dict(l=lambda impl: band_lists(impl=impl, **kw),
                   t=lambda impl: transpose_lists(got, ns, impl=impl))
        times = {k: (cuda_ms(lambda: f("kernel")), cuda_ms(lambda: f("plain"), reps=3),
                     device_ms(lambda: f("kernel"))) for k, f in fns.items()}
        work = dict(  # (bytes, operations): the d2 tests of the windows; a transpose moves ints
            l=(nbytes(args["q_rows"], args["thr"], args["ptie"], args["s_rows"])
               + list_nbytes(got), D2_OPS * window_rows(args)),
            t=(nbytes(got.lpos, got.lcnt, tk[0]) + 4 * seen[name], 0))
        for k in "lt":
            b_ms, b_by = bound(*work[k])
            for f, v in (("ms", times[k][0]), ("plain_ms", times[k][1]), ("dev_ms", times[k][2]),
                         ("bound_ms", b_ms), ("bytes", work[k][0]), ("ops", work[k][1])):
                tot[k][f] += v
        phase(f"band_lists {name} ({args['q_rows'].shape[0]} queries, {seen[name]} listed "
              f"rows): bit-exact vs twin; kernel {times['l'][0]:.4f} ms (device "
              f"{times['l'][2]:.4f} ms), twin {times['l'][1]:.3f} ms, bound "
              f"{bound(*work['l'])[0]:.4f} ms; transpose bit-exact, kernel {times['t'][0]:.4f} ms "
              f"(device {times['t'][2]:.4f} ms), twin {times['t'][1]:.3f} ms, bound "
              f"{bound(*work['t'])[0]:.4f} ms")
    for k, what in (("l", "band_lists"), ("t", "band_lists transpose")):
        phase(f"{what}, sum over the {len(seen)} searches: kernel {tot[k]['ms']:.4f} ms (device "
              f"{tot[k]['dev_ms']:.4f} ms), twin {tot[k]['plain_ms']:.3f} ms, bound "
              f"{tot[k]['bound_ms']:.4f} ms")
    for k, key in (("l", "K2/K4 band_lists"), ("t", "K4 band_lists transpose")):
        report[key] = dict(max_abs_err=0.0, ms=tot[k]["ms"], plain_ms=tot[k]["plain_ms"],
                           bound_ms=tot[k]["bound_ms"],
                           bound_by=bound(tot[k]["bytes"], tot[k]["ops"])[1], library_ms=None)


def k2_work(spec, conv, args, pyr):
    """(FP32 operations, tensor-core products) of one K2 call on its lists:
    the influence weights (~12 operations a pair and kernel point), the
    first product [pairs x Cin] and the second [queries x KP * Cin x Cout]
    (the first product of a single input feature runs on FP32 FMA)."""
    kpn, cin, cout = conv.weights.shape
    pairs = conv_pairs(spec, pyr)
    q_live = int((args["q_rows"][:, 3] >= 0).sum())
    first = 2 * kpn * pairs * cin
    simt = kpn * 12 * pairs + (first if cin < 8 else 0)
    return simt, (0 if cin < 8 else first) + 2 * q_live * kpn * cin * cout


def check_k2(pyr, cfg, model, report, device="cuda"):
    """K2 against its twin at every conv of the forward; its ms in the
    kernels line is the sum over the 14 convs of one extraction call."""
    import torch
    from d3feat_tpu_torch.ops.band_conv import band_conv

    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    worst = 0.0
    tot = dict(ms=0.0, dev_ms=0.0, plain_ms=0.0, bound_ms=0.0, ops=0.0, tc=0.0, bytes=0.0)
    for spec, conv, args in conv_cases(pyr, cfg, model):
        kpn, cin, cout = conv.weights.shape
        x = conv_features(spec, pyr, args, cin, gen, device)
        kw = dict(args, x=x, weights=conv.weights.data, kernel_points=conv.kernel_points)
        ko, kden = band_conv(impl="kernel", **kw)
        po, pden = band_conv(impl="plain", **kw)
        check(torch.equal(kden, pden), f"K2 {conv_label(spec, conv, args)}: density differs "
              f"from the twin")
        err = float((ko - po).abs().max())
        check(torch.allclose(ko, po, atol=3e-5, rtol=1e-4),
              f"K2 {conv_label(spec, conv, args)}: max |kernel - twin| = {err}")
        worst = max(worst, err)
        ms = cuda_ms(lambda: band_conv(impl="kernel", **kw))
        dev_ms = device_ms(lambda: band_conv(impl="kernel", **kw))
        plain_ms = cuda_ms(lambda: band_conv(impl="plain", **kw), reps=3)
        ops, tc = k2_work(spec, conv, args, pyr)
        nb = (nbytes(args["q_rows"], args["s_rows"], x, conv.weights, conv.kernel_points, ko,
                     kden) + list_nbytes(args["lists"]))
        b_ms, b_by = bound(nb, ops, tc)
        for k, v in (("ms", ms), ("dev_ms", dev_ms), ("plain_ms", plain_ms), ("bound_ms", b_ms),
                     ("ops", ops), ("tc", tc), ("bytes", nb)):
            tot[k] += v
        phase(f"K2 band_conv {conv_label(spec, conv, args)}: max err {err:.3g}; kernel "
              f"{ms:.4f} ms (device {dev_ms:.4f} ms), twin {plain_ms:.3f} ms, bound "
              f"{b_ms:.4f} ms ({b_by})")
    phase(f"K2 band_conv, sum over the {len(conv_cases(pyr, cfg, model))} convs of one "
          f"extraction call: kernel {tot['ms']:.4f} ms (device {tot['dev_ms']:.4f} ms), twin "
          f"{tot['plain_ms']:.3f} ms, bound {tot['bound_ms']:.4f} ms")
    report["K2 band_conv"] = dict(max_abs_err=worst, ms=tot["ms"], plain_ms=tot["plain_ms"],
                                  bound_ms=tot["bound_ms"],
                                  bound_by=bound(tot["bytes"], tot["ops"], tot["tc"])[1],
                                  library_ms=None)


def check_k3(pyr, cfg, report, device="cuda"):
    """K3 against its twin on the level-0 band (sums atol 1e-6, counts
    exact), timed by events and by device time, with the bound of the
    route that reads conv0's lists beside that of the route that selects
    from the windows."""
    import torch
    from d3feat_tpu_torch.models.kpfcnn import band_head_inputs
    from d3feat_tpu_torch.ops.head import band_head

    args = band_head_inputs(pyr, cfg)
    lists = pyr["band_args"]["conv0"]["lists"]  # built by the convs' checks
    gen = torch.Generator(device=device)
    gen.manual_seed(1)
    n_valid = int(pyr["lengths"][0].sum())
    c = cfg.output_dim
    x = torch.zeros((args["s_rows"].shape[0], c), device=device)
    x[:n_valid] = torch.rand((n_valid, c), generator=gen, device=device)
    x[:n_valid:11] = 0.0  # listed but not counted
    ks, kc = band_head(x=x, impl="kernel", **args)
    ps, pc = band_head(x=x, impl="plain", **args)
    err = float((ks - ps).abs().max())
    check(torch.equal(kc, pc), "K3: counts differ from the twin")
    check(err <= 1e-6, f"K3: max |kernel - twin| = {err}")
    ms = cuda_ms(lambda: band_head(x=x, impl="kernel", **args))
    dev_ms = device_ms(lambda: band_head(x=x, impl="kernel", **args))
    plain_ms = cuda_ms(lambda: band_head(x=x, impl="plain", **args), reps=3)
    pairs = int(lists.lcnt.sum())
    # the lists' route: lists read up to their counts, x once, sums and counts written
    b_ms, b_by = bound(4 * pairs + nbytes(lists.lcnt, x, ks, kc), pairs * c)
    # the windows' route: every window row tested against every query of its tile
    w_ms, w_by = bound(nbytes(args["q_rows"], args["thr"], args["ptie"], args["s_rows"],
                              x, ks, kc), D2_OPS * window_rows(args) + pairs * c)
    # the sums alone as a library call: the lists as a CSR [Nq_pad, Ns_pad] times x
    live = torch.arange(lists.lpos.shape[1], device=device)[None, :] < lists.lcnt[:, None]
    crow = torch.cat([lists.lcnt.new_zeros(1), lists.lcnt.cumsum(0, dtype=torch.int32)])
    lib_ms, lib_dev, lib = csr_spmm(crow, lists.lpos[live], (ks.shape[0], x.shape[0]), x)
    lib_err = float((lib - ps).abs().max())
    report["K3 band_head"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                                  bound_by=b_by, library_ms=lib_ms)
    phase(f"K3 band_head ({args['q_rows'].shape[0]} queries x {c}, {pairs} listed rows): max "
          f"err {err:.3g}; kernel {ms:.4f} ms (device {dev_ms:.4f} ms), twin {plain_ms:.3f} ms, "
          f"bound {b_ms:.4f} ms ({b_by}) from the lists, {w_ms:.4f} ms ({w_by}) from the "
          f"windows; SpMM of the sums {lib_ms:.4f} ms (device {lib_dev:.4f} ms, max diff "
          f"{lib_err:.3g} from the twin)")


def check_k4(pyr, cfg, model, report, device="cuda"):
    """K4 against its twin at every conv of the backward (the first, on the
    input features, without dx as in the train step), from the lists and
    the weighted rows of the forward as the train step runs it; its ms in
    the kernels line is the sum over the 14 convs of one train step."""
    import torch
    from d3feat_tpu_torch.ops.band_conv import band_conv_bwd, band_conv_kernel

    gen = torch.Generator(device=device)
    gen.manual_seed(2)
    worst = 0.0
    tot = dict(ms=0.0, dev_ms=0.0, plain_ms=0.0, bound_ms=0.0, ops=0.0, tc=0.0, bytes=0.0)
    for ci, (spec, conv, args) in enumerate(conv_cases(pyr, cfg, model)):
        kpn, cin, cout = conv.weights.shape
        nq = args["q_rows"].shape[0]
        n_q = pyr["points"][spec.layer + 1 if spec.strided else spec.layer].shape[0]
        x = conv_features(spec, pyr, args, cin, gen, device)
        gs = torch.zeros((nq, cout), device=device)
        gs[:n_q] = torch.randn((n_q, cout), generator=gen, device=device) * 1e-2
        need_dx = ci > 0
        kw = dict(args, x=x, weights=conv.weights.data, kernel_points=conv.kernel_points)
        wtd = band_conv_kernel(keep_weighted=True, **kw)[2]
        kw.update(gs=gs, need_dx=need_dx)
        kdx, kdw = band_conv_bwd(impl="kernel", weighted=wtd, **kw)
        pdx, pdw = band_conv_bwd(impl="plain", **kw)
        err = float((kdw - pdw).abs().max())
        ok = torch.allclose(kdw, pdw, atol=5e-4, rtol=1e-3)
        if need_dx:
            err = max(err, float((kdx - pdx).abs().max()))
            ok = ok and torch.allclose(kdx, pdx, atol=5e-4, rtol=1e-3)
        check(ok, f"K4 {conv_label(spec, conv, args)}: max |kernel - twin| = {err}")
        check(float(pdw.abs().max()) > 1e-3, f"K4 {conv_label(spec, conv, args)}: vacuous "
              f"comparison")
        worst = max(worst, err)
        ms = cuda_ms(lambda: band_conv_bwd(impl="kernel", weighted=wtd, **kw))
        dev_ms = device_ms(lambda: band_conv_bwd(impl="kernel", weighted=wtd, **kw))
        plain_ms = cuda_ms(lambda: band_conv_bwd(impl="plain", **kw), reps=3)
        pairs = conv_pairs(spec, pyr)
        q_live = int((args["q_rows"][:, 3] >= 0).sum())
        # dW on the tensor cores [queries x KP * Cin x Cout]; with dx, the
        # gather (influence weights and [pairs x Cout] per kernel point) and
        # dx = G W^T on the tensor cores over the listed support rows
        row_ptr = args["lists"].transpose(args["s_rows"].shape[0])[0]
        rows_live = int((row_ptr[1:] > row_ptr[:-1]).sum())
        tc = 2 * kpn * cin * cout * (q_live + (rows_live if need_dx else 0))
        ops = kpn * (12 + 2 * cout) * pairs if need_dx else 0
        nb = (nbytes(args["q_rows"], args["s_rows"], conv.weights, conv.kernel_points, gs, wtd,
                     kdw, *((kdx,) if need_dx else ())) + list_nbytes(args["lists"]))
        b_ms, b_by = bound(nb, ops, tc)
        for k, v in (("ms", ms), ("dev_ms", dev_ms), ("plain_ms", plain_ms), ("bound_ms", b_ms),
                     ("ops", ops), ("tc", tc), ("bytes", nb)):
            tot[k] += v
        phase(f"K4 band_conv_bwd {conv_label(spec, conv, args)}{'' if need_dx else ', no dx'}: "
              f"max err {err:.3g}; kernel {ms:.4f} ms (device {dev_ms:.4f} ms), twin "
              f"{plain_ms:.3f} ms, bound {b_ms:.4f} ms ({b_by})")
    phase(f"K4 band_conv_bwd, sum over the {ci + 1} convs of one train step: kernel "
          f"{tot['ms']:.4f} ms (device {tot['dev_ms']:.4f} ms), twin {tot['plain_ms']:.3f} ms, "
          f"bound {tot['bound_ms']:.4f} ms")
    report["K4 band_conv_bwd"] = dict(max_abs_err=worst, ms=tot["ms"],
                                      plain_ms=tot["plain_ms"], bound_ms=tot["bound_ms"],
                                      bound_by=bound(tot["bytes"], tot["ops"], tot["tc"])[1],
                                      library_ms=None)


def check_k5(pyr, cfg, report, device="cuda"):
    """K5 against its twin on the level-0 band (atol 1e-5), from the
    transpose of conv0's lists that the train step shares with K4 (held
    bit for bit against the twin's transpose first: K5 equals its twin bit
    for bit only on ascending entries), timed by events and by device time,
    with the bound of the route that reads the transpose beside that of the
    route that selects from the windows, and one SpMM of the transpose."""
    import torch
    from d3feat_tpu_torch.models.kpfcnn import band_head_inputs
    from d3feat_tpu_torch.ops.band_lists import LCAP, transpose_lists_plain
    from d3feat_tpu_torch.ops.head import band_head_bwd

    args = band_head_inputs(pyr, cfg)
    lists = args["lists"]  # conv0's, built by the convs' checks
    ns, nq, c = args["s_rows"].shape[0], args["q_rows"].shape[0], cfg.output_dim
    row_ptr, pairs = lists.transpose(ns)  # kept with the lists: the one K5 reads
    check(all(torch.equal(a, b) for a, b in zip((row_ptr, pairs),
                                                transpose_lists_plain(lists, ns))),
          "K5: conv0's transpose differs from the twin's")
    gen = torch.Generator(device=device)
    gen.manual_seed(3)
    n_valid = int(pyr["lengths"][0].sum())
    g = torch.zeros((nq, c), device=device)
    g[:n_valid] = torch.randn((n_valid, c), generator=gen, device=device)
    kdx = band_head_bwd(g=g, impl="kernel", **args)
    pdx = band_head_bwd(g=g, impl="plain", **args)
    err = float((kdx - pdx).abs().max())
    check(torch.allclose(kdx, pdx, atol=1e-5, rtol=0), f"K5: max |kernel - twin| = {err}")
    check(float(pdx.abs().max()) > 1.0, "K5: vacuous comparison")
    ms = cuda_ms(lambda: band_head_bwd(g=g, impl="kernel", **args))
    dev_ms = device_ms(lambda: band_head_bwd(g=g, impl="kernel", **args))
    plain_ms = cuda_ms(lambda: band_head_bwd(g=g, impl="plain", **args), reps=3)
    n_ent = int(row_ptr[-1])  # listed pairs
    # the transpose's route: row_ptr and the entries read, g once, dx written
    b_ms, b_by = bound(4 * n_ent + nbytes(row_ptr, g, kdx), n_ent * c)
    # the windows' route: every window row tested against every query of its tile
    w_ms, w_by = bound(nbytes(args["q_rows"], args["thr"], args["ptie"], args["s_rows"],
                              g, kdx), D2_OPS * window_rows(args) + n_ent * c)
    lib_ms, lib_dev, lib = csr_spmm(row_ptr, pairs[:n_ent] // LCAP, (ns, nq), g)
    lib_err = float((lib - pdx).abs().max())
    report["K5 band_head_bwd"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                                      bound_by=b_by, library_ms=lib_ms)
    phase(f"K5 band_head_bwd ({nq} queries x {c}, {n_ent} listed pairs): max err {err:.3g}; "
          f"kernel {ms:.4f} ms (device {dev_ms:.4f} ms), twin {plain_ms:.3f} ms, bound "
          f"{b_ms:.4f} ms ({b_by}) from the transpose, {w_ms:.4f} ms ({w_by}) from the "
          f"windows; SpMM {lib_ms:.4f} ms (device {lib_dev:.4f} ms, max diff {lib_err:.3g} "
          f"from the twin)")


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
    from d3feat_tpu_torch.ops.band_lists import band_lists
    from d3feat_tpu_torch.ops.head import band_head
    from d3feat_tpu_torch.ops.pyramid import build_pyramid, make_pyramid_spec
    from d3feat_tpu_torch.ops.select import band_select

    wrappers = {"K1 select": band_select, "K2/K4 band_lists": band_lists,
                "K2 band_conv": band_conv, "K3 band_head": band_head}
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
        profile(lambda i: ex.extract_many(groups[i % len(groups)]), 4, "extraction calls")
    return fps


def profile(run, calls, what):
    """Device time by kernel over ``calls`` calls of ``run(i)``, and the
    device busy share of their wall time (``--profile``); only the device's
    own events count (``device_events``)."""
    import torch
    from torch.profiler import ProfilerActivity, profile as torch_profile

    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for i in range(calls):
            run(i)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    rows = sorted((r for r in device_events(prof) if r[0] > 0), reverse=True)
    busy = sum(r[0] for r in rows)
    phase(f"profile: {calls} {what}, wall {wall_ms:.1f} ms, device busy {busy:.1f} ms "
          f"({100 * busy / wall_ms:.1f} %)")
    for ms, n, key in rows[:20]:
        print(f"    {ms:9.3f} ms  {n:6d}x  {key[:90]}", flush=True)


def training_pair(cfg, spec, device="cuda"):
    """The first ground-truth-posed eval-cache pair whose two fragments fit
    level 0 and whose pyramid does not overflow, packed as a train-step
    batch: correspondences are the pairs within ``CORR_RADIUS`` once
    ``frag_j`` is moved by ``pose_i_j`` into ``frag_i``'s frame,
    ``NUM_NODE`` of them drawn with a seeded generator; features are ones."""
    import glob
    import re

    import numpy as np
    import torch
    from scipy.spatial import cKDTree
    from d3feat_tpu_torch.data.pack import EVAL_CACHE, pack_pair
    from d3feat_tpu_torch.ops.pyramid import build_pyramid

    rng = np.random.default_rng(0)
    for path in sorted(glob.glob(os.path.join(EVAL_CACHE, "scene_*.npz"))):
        with np.load(path, allow_pickle=False) as z:
            keys = sorted((k for k in z.files if re.fullmatch(r"pose_\d+_\d+", k)),
                          key=lambda k: tuple(int(v) for v in k.split("_")[1:]))
            for key in keys:
                i, j = key.split("_")[1:]
                pts0 = np.asarray(z[f"frag_{i}"], np.float32)
                pts1 = np.asarray(z[f"frag_{j}"], np.float32)
                if len(pts0) + len(pts1) > cfg.caps.points[0]:
                    continue
                pose = np.asarray(z[key], np.float64)
                moved = pts1 @ pose[:3, :3].T + pose[:3, 3]
                dist, idx = cKDTree(pts0).query(moved, distance_upper_bound=CORR_RADIUS)
                hit = np.isfinite(dist)
                pairs = np.stack([idx[hit], np.nonzero(hit)[0]], 1).astype(np.int32)
                if len(pairs) < NUM_NODE:
                    continue
                sel = pairs[rng.choice(len(pairs), NUM_NODE, replace=False)]
                kp = pts0[sel[:, 0]]
                dk = np.linalg.norm(kp[:, None] - kp[None], axis=-1).astype(np.float32)
                packed = pack_pair(pts0, pts1, np.ones((len(pts0), 1), np.float32),
                                   np.ones((len(pts1), 1), np.float32), sel, dk,
                                   point_capacity=cfg.caps.points[0],
                                   corr_capacity=cfg.caps.corr)
                batch = {k: torch.from_numpy(np.asarray(getattr(packed, k))).to(device)
                         for k in packed._fields}
                if bool(build_pyramid(batch["points"], batch["lengths"], spec=spec)["overflow"]):
                    continue
                name = f"{os.path.basename(path)}:{key}"
                return batch, (name, len(pts0), len(pts1), len(pairs))
    fail("no eval-cache pair fits the bench capacities without overflow")


def train_phase(cfg, report, card, device="cuda"):
    """The training path at full width from a copy of the r5 weights: one
    counted kernel step against one twin step from the same state, then
    ``TRAIN_STEPS`` more kernel steps. Returns train steps/s."""
    import copy
    import math

    import torch
    from d3feat_tpu_torch.compat.weights import load_npz
    from d3feat_tpu_torch.models.kpfcnn import init_kpfcnn
    from d3feat_tpu_torch.ops.band_conv import band_conv, band_conv_bwd
    from d3feat_tpu_torch.ops.band_lists import band_lists, transpose_lists
    from d3feat_tpu_torch.ops.head import band_head, band_head_bwd
    from d3feat_tpu_torch.ops.pyramid import make_pyramid_spec
    from d3feat_tpu_torch.ops.select import band_select
    from d3feat_tpu_torch.train.optim import make_optimizer, train_tensors
    from d3feat_tpu_torch.train.step import TrainState, make_train_step

    spec = make_pyramid_spec(cfg)
    batch, (name, n0, n1, n_corr) = training_pair(cfg, spec, device)
    phase(f"training pair {name}: {n0} + {n1} points, {n_corr} correspondences within "
          f"{CORR_RADIUS}, {NUM_NODE} used")
    model = init_kpfcnn(cfg, device=device)  # its own copy: extraction keeps the r5 weights
    load_npz(model, os.path.join(os.path.dirname(os.path.abspath(__file__)), "artifacts",
                                 "model_best_acc_r5.npz"))
    twin_model = copy.deepcopy(model)
    state = TrainState(model, make_optimizer(cfg, model))
    twin_state = TrainState(twin_model, make_optimizer(cfg, twin_model))
    step = make_train_step(cfg, spec)
    twin_step = make_train_step(cfg, spec, impl="plain")

    wrappers = {"K1 select": band_select, "K2/K4 band_lists": band_lists,
                "K2 band_conv": band_conv, "K3 band_head": band_head,
                "K4 band_lists transpose": transpose_lists, "K4 band_conv_bwd": band_conv_bwd,
                "K5 band_head_bwd": band_head_bwd}
    torch.cuda.synchronize()
    for w in wrappers.values():
        w.launches = 0
    state, m = step(state, batch, 0)  # the counted training-path run
    torch.cuda.synchronize()
    counts = {n: w.launches for n, w in wrappers.items()}
    for n, c in counts.items():
        check(c > 0, f"{n}: no launch on the training path")
    searches = {(sp.layer, sp.strided) for sp, blk in zip(model.specs.encoder, model.encoder)
                if hasattr(blk, "conv")}
    check(counts["K4 band_lists transpose"] == len(searches),
          f"train step: {counts['K4 band_lists transpose']} transposes for {len(searches)} "
          f"searches (K5 and K4 share conv0's)")
    check(counts["K5 band_head_bwd"] == 1,
          f"train step: K5 launched {counts['K5 band_head_bwd']} times")
    for n in ("K4 band_lists transpose", "K4 band_conv_bwd", "K5 band_head_bwd"):
        report[n]["launches"] = counts[n]
    phase("training path launches per step: " + ", ".join(f"{n} {c}" for n, c in counts.items()))

    twin_state, tm = twin_step(twin_state, batch, 0)
    flat = torch.cat([t.grad.reshape(-1) for _, t in train_tensors(model)])
    flat_t = torch.cat([t.grad.reshape(-1) for _, t in train_tensors(twin_model)])
    gerr = float((flat - flat_t).abs().max())
    check(math.isfinite(m.loss) and abs(m.loss - tm.loss) <= 1e-3 * abs(tm.loss),
          f"train step: loss {m.loss} vs twins' {tm.loss}")
    check(torch.allclose(flat, flat_t, atol=5e-3, rtol=5e-3),
          f"train step: gradients differ from the twins' by {gerr}")
    check(float(flat_t.abs().max()) > 1e-4, "train step: vacuous gradient comparison")
    phase(f"train step vs twins on the card: loss {m.loss:.6f} vs {tm.loss:.6f}, max gradient "
          f"diff {gerr:.3g} over {flat.numel()} values (max |g| {float(flat_t.abs().max()):.3g})")
    del twin_state, twin_model

    losses = [m.loss]
    torch.cuda.synchronize()
    t = time.perf_counter()
    for i in range(TRAIN_STEPS):
        state, m = step(state, batch, 0)
        check(math.isfinite(m.loss) and m.skipped == 0.0 and m.overflow == 0.0,
              f"train step {i + 1}: loss {m.loss}, skipped {m.skipped}, overflow {m.overflow}")
        losses.append(m.loss)
    torch.cuda.synchronize()
    sps = TRAIN_STEPS / (time.perf_counter() - t)
    check(state.step == TRAIN_STEPS + 1, f"train state counts {state.step} updates")
    phase("train losses: " + ", ".join(f"{v:.5f}" for v in losses))
    phase(f"training: {sps:.3f} train steps/s on {card} ({TRAIN_STEPS} steps of one pair at "
          f"full width, lr {m.lr:.6g}, accuracy {m.accuracy:.1f} %)")
    if "--profile" in sys.argv:
        profile(lambda i: step(state, batch, 0), 3, "train steps")
    return sps


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
    secs = build.build(build.KERNELS)
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
    check_lists(pyr, cfg, model, report)
    check_k2(pyr, cfg, model, report)
    check_k3(pyr, cfg, report)
    check_k4(pyr, cfg, model, report)
    check_k5(pyr, cfg, report)
    del pyr

    phase("serving path")
    fps = main_path(cfg, model, frags, report)
    phase("training path")
    sps = train_phase(cfg, report, smi)

    sources = {"K1 select": ("select.cu", "d3feat_tpu/ops/pallas/select.py:252"),
               # the selection that K2's and K4's TPU kernels redo in every conv
               "K2/K4 band_lists": ("band_lists.cu", "d3feat_tpu/ops/pallas/band_conv.py:351"),
               "K2 band_conv": ("band_conv.cu", "d3feat_tpu/ops/pallas/band_conv.py:351"),
               "K3 band_head": ("head.cu", "d3feat_tpu/ops/pallas/head.py:173"),
               # the dx order of K4's TPU kernel, which walks each window's rows
               "K4 band_lists transpose": ("band_lists.cu",
                                           "d3feat_tpu/ops/pallas/band_conv.py:586"),
               "K4 band_conv_bwd": ("band_conv_bwd.cu",
                                    "d3feat_tpu/ops/pallas/band_conv.py:586"),
               "K5 band_head_bwd": ("head_bwd.cu", "d3feat_tpu/ops/pallas/head.py:304")}
    kernels = []
    for name, (src, replaces) in sources.items():
        r = report[name]
        kernels.append({"name": name, "route": "cuda",
                        "source": f"d3feat_tpu_torch/ops/cuda/{src}", "replaces": replaces,
                        "launches": r["launches"], "max_abs_err": r["max_abs_err"],
                        "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
    phase("library_ms: K3's sums and K5 by one cuSPARSE SpMM of their lists as a CSR of "
          "ones; null for the others, which no single PyTorch call computes (each includes "
          "the threshold selection of its rows)")
    print(json.dumps({"fragments_per_s": fps, "train_steps_per_s": sps, "card": smi}),
          flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                              "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
