"""The kernels' device time by stage on one GPU.

Run from the root of a checkout::

    python3 -m d3feat_tpu_torch.kernel_stages

On the pyramid of the first two eval-cache fragments of 12k-16k points at
the bench configuration (``bench.bench_config``: capacities
``(16384, 8192, 2048, 768, 256)·2``, 40 neighbours), with the r5 weights,
seeded features and seeded cotangents, it runs the 14 band convs through
K2 and their backward through K4 (the first conv without dx, as the train
step runs it), f32 and bf16 panels, each from the lists and the weighted
rows as the train step hands them over. Beside them: the pyramid's build
on the kernel route (K1's 13 searches, ``select_kernel``, among the
build's own PyTorch ops), the list stage and its transpose on the 9
searches the convs use, K3 on conv0's lists and K5 on their transpose,
with seeded features and cotangents. For each it prints the sums over
the convs or searches of: CUDA-event milliseconds per call (the host's
launch work included), device milliseconds per call (``torch.profiler``)
and, by CUDA kernel name, device milliseconds and launches per call; then
one JSON line with the same and the card (``nvidia-smi`` name and power
limit).

It calls the kernel wrappers only through arguments that every version of
the port since the bf16 panels takes, so that the same file measures two
trees' kernels in one process each on one card: copy it into the other
tree's package and run it from that tree's root.
"""

from __future__ import annotations

import json
import os
import re
import sys

import torch

REPS = 5


def _name(key):
    m = re.search(r"(\w+)\s*[<(]", key)
    return m.group(1) if m else key


def _events_ms(fn):
    fn()
    times = []
    for _ in range(REPS):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return sorted(times)[REPS // 2]


def _device(fn, stages):
    """Device ms per call of ``fn()``; adds (ms, launches) per call by
    kernel name into ``stages``."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(REPS):
            fn()
        torch.cuda.synchronize()
    total = 0.0
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA or getattr(e, "is_user_annotation",
                                                                      False):
            continue
        ms, n = e.self_device_time_total / 1e3 / REPS, e.count / REPS
        ms0, n0 = stages.get(_name(e.key), (0.0, 0.0))
        stages[_name(e.key)] = (ms0 + ms, n0 + n)
        total += ms
    return total


def main():
    from d3feat_tpu_torch.bench import bench_config, card_name
    from d3feat_tpu_torch.compat.weights import load_npz
    from d3feat_tpu_torch.data.pack import load_eval_fragments, pack_fragments
    from d3feat_tpu_torch.models.blocks import band_conv_inputs
    from d3feat_tpu_torch.models.kpfcnn import band_head_inputs, init_kpfcnn
    from d3feat_tpu_torch.ops.band_conv import band_conv, band_conv_bwd, band_conv_kernel
    from d3feat_tpu_torch.ops.band_lists import band_lists, transpose_lists
    from d3feat_tpu_torch.ops.head import band_head, band_head_bwd
    from d3feat_tpu_torch.ops.pyramid import build_pyramid, make_pyramid_spec

    if not torch.cuda.is_available():
        print("kernel_stages: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = bench_config()
    model = init_kpfcnn(cfg, device="cuda")
    load_npz(model, os.path.join("artifacts", "model_best_acc_r5.npz"))
    frags = load_eval_fragments(12000, 16000)[:2]
    b = pack_fragments(frags, point_capacity=cfg.caps.points[0], num_clouds=2)
    pts, lens = torch.from_numpy(b["points"]).cuda(), torch.from_numpy(b["lengths"]).cuda()
    spec = make_pyramid_spec(cfg, num_clouds=2)
    pyr = build_pyramid(pts, lens, spec=spec, impl="plain")
    convs = [(model.specs.encoder[i], blk.conv) for i, blk in enumerate(model.encoder)
             if hasattr(blk, "conv")]
    card = card_name("cuda")
    out = {}

    def row(name, calls):
        """Events and device ms (and stages) of ``calls``, summed."""
        r = dict(ms=0.0, device_ms=0.0, stages={})
        for fn in calls:
            r["ms"] += _events_ms(fn)
            r["device_ms"] += _device(fn, r["stages"])
        out[name] = r
        print(f"{name}: {r['ms']:.4f} ms by events, {r['device_ms']:.4f} ms on the device; "
              + ", ".join(f"{s} {ms:.4f} ms ({n:g}x)" for s, (ms, n) in
                          sorted(r["stages"].items(), key=lambda i: -i[1][0])), flush=True)

    row("pyramid", [lambda: build_pyramid(pts, lens, spec=spec)])
    searches = {}
    for spec_b, _ in convs:
        args = band_conv_inputs(spec_b, pyr, cfg)
        searches.setdefault((spec_b.layer, spec_b.strided), args)
    lists = [(band_lists(impl="kernel", **{k: a[k] for k in (
        "q_rows", "thr", "ptie", "s_rows", "starts", "wends", "query_tile")}), a)
        for a in searches.values()]
    row("lists", [lambda a=a: band_lists(impl="kernel", **{k: a[k] for k in (
        "q_rows", "thr", "ptie", "s_rows", "starts", "wends", "query_tile")})
        for a in searches.values()])
    row("transpose", [lambda lt=lt, a=a: transpose_lists(lt, a["s_rows"].shape[0],
                                                         impl="kernel") for lt, a in lists])
    head = band_head_inputs(pyr, cfg)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    xh = torch.rand((head["s_rows"].shape[0], cfg.output_dim), generator=gen, device="cuda")
    gh = torch.randn((head["q_rows"].shape[0], cfg.output_dim), generator=gen, device="cuda")
    row("K3", [lambda: band_head(x=xh, impl="kernel", **head)])
    row("K5", [lambda: band_head_bwd(g=gh, impl="kernel", **head)])
    for panel in ("float32", "bfloat16"):
        gen = torch.Generator(device="cuda")
        gen.manual_seed(0)
        rows = {"K2": dict(ms=0.0, device_ms=0.0, stages={}),
                "K4": dict(ms=0.0, device_ms=0.0, stages={})}
        for ci, (spec, conv) in enumerate(convs):
            args = band_conv_inputs(spec, pyr, cfg)
            kpn, cin, cout = conv.weights.shape
            n_valid = int(pyr["lengths"][spec.layer].sum())
            x = torch.zeros((args["s_rows"].shape[0], cin), device="cuda")
            x[:n_valid] = torch.nn.functional.leaky_relu(
                torch.randn((n_valid, cin), generator=gen, device="cuda"), 0.1)
            kw = dict(args, x=x, weights=conv.weights.data, kernel_points=conv.kernel_points,
                      panel_dtype=panel)
            k2 = lambda: band_conv(impl="kernel", **kw)  # noqa: E731
            rows["K2"]["ms"] += _events_ms(k2)
            rows["K2"]["device_ms"] += _device(k2, rows["K2"]["stages"])
            res = band_conv_kernel(keep_weighted=True, **kw)
            kept = dict(weighted=res[2])
            if len(res) > 3 and res[3] is not None:  # the bf16 panel of W, kept for K4
                kept["weights_panel"] = res[3]
            gs = torch.randn((args["q_rows"].shape[0], cout), generator=gen, device="cuda") * 1e-2
            k4 = lambda: band_conv_bwd(impl="kernel", gs=gs, need_dx=ci > 0, **kept,  # noqa: E731
                                       **kw)
            rows["K4"]["ms"] += _events_ms(k4)
            rows["K4"]["device_ms"] += _device(k4, rows["K4"]["stages"])
        for k, r in rows.items():
            name = f"{k} {panel}"
            out[name] = r
            print(f"{name}: {r['ms']:.4f} ms by events, {r['device_ms']:.4f} ms on the device; "
                  + ", ".join(f"{s} {ms:.4f} ms ({n:g}x)" for s, (ms, n) in
                              sorted(r["stages"].items(), key=lambda i: -i[1][0])), flush=True)
    print(json.dumps({"kernel_stages": out, "convs": len(convs), "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
