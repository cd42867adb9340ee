#!/usr/bin/env python3
"""Check the PyTorch/CUDA port (``d3feat_tpu_torch``) once on one GPU.

Run from the repository root with no arguments::

    python3 chip_smoke.py

It needs one CUDA device, ``nvcc`` (the CUDA toolkit), the committed r5
weights (``artifacts/model_best_acc_r5.npz``), the committed eval-cache
fragments and poses (``artifacts/eval_cache``) and the JAX recall
references (``tests/torch_port_recall_r5.json``, and
``tests/torch_port_recall_r5_gather.json`` for the gather route), and
``g++`` for the native host library; it imports nothing of JAX or of the
JAX package. Besides the kernels' build directory
(``d3feat_tpu_torch/_build``) it writes only into temporary directories
(under ``TMPDIR``) that it removes. It is a correctness check: the port is
measured by ``benchmark/run.py``. Its one timer is ``held_ms``, the
kernel-alone device time of each kernel by CUDA events on a stream held by
a spin kernel until the calls are queued (no launch is left out, the
host's launch gaps are not timed). Phases, each announced with the elapsed
seconds:

1. device: name, count, and ``nvidia-smi`` name and power limit;
2. build: the kernel sources ``d3feat_tpu_torch/ops/cuda/*.cu`` with
   ``nvcc``, one process per source, all started together;
3. kernels vs twins on one real pyramid (two eval-cache fragments at the
   bench capacities, ``data.pack.bench_config``): K1 bit for bit
   (positions, d2, thr, ptie) on all 13 searches; K1 on the same two
   fragments not pre-sorted (``radius_neighbors_pallas``, the
   original-order route's use) bit for bit on their conv0 and pool0
   searches; the list stage of K2/K4 and its transpose bit for bit on the
   9 searches the convs use; K2 at all 14 convs (atol 3e-5, rtol 1e-4,
   density exact); K3 from conv0's lists (sums atol 1e-6, counts exact);
   K4 at all 14 convs from the forward's lists and weighted rows and a
   seeded cotangent (dx and dW at atol 5e-4, rtol 1e-3); K5 from the
   transpose of conv0's lists (atol 1e-5). Then the bf16 panels of K2 and
   K4 (``compute_dtype="bfloat16"``) at all 14 convs: against their bf16
   twins, which round where the kernels round (out, dx and dW within
   relative L2 1e-4, density exact), and against the f32 kernels
   (relative L2 1e-2, the JAX suite's bf16 bound). Each kernel is timed by
   ``held_ms``: K1's ms are the sum over the 13 searches, K2's and K4's
   over the 14 convs. The gather KPConv's device time (forward, and
   forward and backward) at the 14 convs beside K2's route and K4's on the
   same lists, for phase 10 (a), by ``held_ms``. Then list mode (the TPU
   kernels' ``use_thr=False``) on the same pyramid without ``sel_thr``:
   the list-mode list stage (``band_lists_given``) and its transpose bit
   for bit on the 9 searches, K2 and K4 in list mode, f32 and bf16, at all
   14 convs against their list-mode twins at the same tolerances (K4's dx
   on the level's rows: the list stage drops the shadow and the zero pads
   past it), each timed, K2's distance to threshold mode printed (not
   gated). Then K7, the neighbourhood max, against its twin on the lists
   of a group of 8 eval-cache fragments at the 32,768-a-fragment bucket
   (``check_k7``): each strided block's pool lists at its input width and
   conv0's lists at the gate's 32 channels, equal under ``torch.equal``;
   all-shadow rows (0) and NaN as in the twin; K7 and the twin each timed
   by ``held_ms``, summed over the 5 calls;
4. serving path: ``FeatureExtractor(batch_fragments=2)`` with the r5
   weights on the eval-cache fragments of 12k-16k points: launch counts of
   one counted call (K1 on unsorted clouds counted too: none on this
   route; K7 once a strided block and once for the gate, its twin never),
   output checks, and the same batch through the twins on the
   card; then the same in bf16: one counted call (K2's bf16 kernel, never
   its f32 one), descriptors within relative L2 1e-2 of the bf16 twins',
   finite, unit norm, no overflow; their distance to the f32 path and the
   top-250 overlap (printed, not gated);
5. training path: ``make_train_step`` at full width from a copy of the r5
   weights on the first ground-truth-posed eval-cache pair that fits the
   bench capacities (correspondences within 0.0375, 128 of them): launch
   counts of one counted step (one transpose per search, one K5 launch),
   that step's loss and gradients against a step through the twins (loss
   rtol 1e-3, gradients atol 5e-3, rtol 5e-3), then 10 more kernel steps
   (finite, none skipped, no overflow); then one bf16 step (K4's bf16
   kernel, never the f32 K2 or K4) against one bf16 twin step: loss rtol
   1e-2, finite, not skipped, the flat gradient within twice the distance
   of a twin step from weights one f32 ulp away (the bf16 step's own
   noise; or within 1e-2 where that is smaller) and nearer the twins' than
   the f32 step's; then 10 more bf16 steps (finite, none skipped, no
   overflow);
6. the list path (no thresholds, ``list_path``): one extraction call and
   one train step through ``make_extract_step``/``make_train_step`` on
   pyramids whose ``sel_thr`` is removed, each counted with the counts set
   to 0 just before (list-mode K2 and its list stage; list-mode K4 and the
   transposes; no threshold-mode K2 or K4, no K3 or K5: the head takes the
   gather route), against the twins on the card (descriptors within 1e-4
   and the same top-250 sets; loss rtol 1e-3, gradients atol/rtol 5e-3),
   then one counted bf16 step (list-mode bf16 K2 and K4 only; loss rtol
   1e-2 to a bf16 twin step); distances to the threshold route printed;
7. data parallelism at world size 1 on NCCL (``dp_phase``, a group of one
   on a ``file://`` store in the temporary directory): the DP train step
   equal bit for bit to ``make_train_step`` (metrics, weights, momentum)
   and DP extraction to ``make_extract_step``; one JSON line
   ``{"data_parallel": ...}``;
8. the trainer: the port's ``Trainer`` at full width on a corpus that
   ``gen_corpus.write_scene`` writes into a temporary directory (at least 8
   scenes of the train role and 2 of the validation role, numbers that are
   multiples of ``VAL_MOD``), on the r5 npz's own config (width 128, 5
   layers, SGD lr 0.01, momentum 0.98, ``corpus_rotation`` mix, 128
   correspondences, r5's capacities) warm-started from r5: start epoch 114
   and r5's bests from its meta, two epochs of 8 steps, 2 validation steps
   each, a snapshot every epoch, the autoexport in the temporary directory.
   Gates: every epoch's mean loss finite and none skipped; ``config.json``,
   ``metrics.jsonl``, ``snapshot_epoch_115``, ``snapshot_epoch_116`` and
   ``model_final`` written; ``model_best_loss``, ``model_best_acc`` and the
   autoexport written exactly when validation beat r5's bests (the
   reference's rule; which ones is printed); the trainer's weights equal
   bit for bit to what ``final_recall.load_snapshot`` loads from the
   directory's ``model_final`` and from an npz that ``export_npz`` writes
   at the end; a second ``Trainer`` resumed from ``latest_periodic()`` with
   the same momentum, its next step on a fixed batch against the
   continuing trainer's (bit for bit, or else within the train-step gate,
   the largest difference printed); that continuing step counted: K1 13,
   the list stage 9, K2 14, K3 1, K4 14, the transpose 9, K5 1, and no twin
   (``count_twins`` covers the backward twins too); then the same run in
   bf16 (finite, none skipped, K2's and K4's bf16 kernels only). Printed:
   the overflow share, each epoch's mean train and validation losses in
   f32 and bf16, and the recall of the trained npz on scene 424245 (not
   gated); one JSON line ``{"trainer": ...}``;
9. registration recall (``d3feat_tpu_torch.final_recall``'s pass) on the
   4 axis scenes of ``artifacts/eval_cache`` (48 fragments, 68 gt pairs)
   with the r5 weights on the r5 npz's own config:
   ``FeatureExtractor(batch_fragments=2, on_overflow="warn")``, then the
   protocol at 250 keypoints, 0.10 and 5 % per scene. In f32: one counted
   call (K1, K2 f32 and K3 launched, no twin called in the pass), per
   scene gt pairs, matched pairs, recall, average inlier ratio and the
   groups that overflowed, and the mean recall; held against the JAX
   package's answer (``tests/torch_port_recall_r5.json``): gt pairs equal,
   overflowed groups equal on the band route, the matched state of every
   pair equal except where the reference ratio lies within one
   correspondence of 5 % (printed), equal correspondence and inlier counts
   where both fragments select the same top-250 sets; the top-250 overlap
   per fragment printed. Then the same in bf16 (K2's bf16 kernel, never
   its f32 one; finite), printed beside f32, not gated on recall; one JSON
   line ``{"recall": ...}``;
10. the gather route (``gather_phase``; the JAX package's XLA route:
   ``neighbor_search`` ``'banded'``, ``'grid'``, ``'brute'``, and the
   gather KPConv): (a) on the band pyramid of the serving batch, the
   gather KPConv at each of the 14 convs against K2 (atol 3e-5, rtol 1e-4)
   and its autograd dx and dW for a seeded cotangent against K4 (atol
   5e-4, rtol 1e-3) on the same sorted lists (their device ms come from
   phase 3); one extraction call with every conv on the gather KPConv
   (``bandconv_max_layer=-1``, no K2 or K4 launch) against the band
   route's (descriptors within 1e-4, the same top-250 sets) and one f32
   train step on the training pair against the band route's (loss rtol
   1e-3, gradients atol/rtol 5e-3), peak memory printed; (b) the
   original-order pyramid of the serving batch for each of the three
   searches, every level's points, lists, lengths, masks and overflow
   flags equal bit for bit to the same function on the CPU, no overflow
   for ``banded``; (c) serving on the gather route (``'banded'``, r5): one
   counted call with no K1-K5 launch and no twin call, finite unit
   descriptors, then the recall pass on the 4 axis scenes held pair by
   pair (``hold_recall``) to the JAX package's own CPU route,
   ``tests/torch_port_recall_r5_gather.json``; (d) training on the gather
   route from r5: one counted step with no K1-K5 launch and no twin call
   (finite, not skipped, no overflow), 10 more steps (the same gates),
   peak memory and the loss beside a band-route step (not gated); (e) K1
   on clouds that are not pre-sorted (``radius_neighbors_pallas``) for the
   serving batch's conv0 and pool0 searches: one counted call each (one
   launch), kernel against twin bit for bit, each row's set equal to the
   banded search's wherever neither list is full (the truncated rows
   counted); (f) ``calibrate_caps`` on 4 eval-cache pairs of fragments:
   the card's caps equal the CPU's. One JSON line ``{"gather_route":
   ...}``;
11. the modules that the JAX package keeps in XLA around its kernels
   (``variants_phase``), at full width on the bench capacities; every run
   below is counted (the launch counts set to 0 just before, read just
   after, no twin called on the card) and held against the same run
   through the twins on the card: (a) batch norm (``use_batch_norm``; r5's
   weights, each norm's scale 1 and offset r5's bias: at a random draw the
   step is near-tie noise): one train step on the training pair (K1-K5;
   loss rtol 1e-3, gradients atol/rtol 5e-3, the new running statistics
   within 1e-5; a twin step from weights one ulp away printed beside), 10
   more steps (finite, none skipped, no overflow), one eval-mode
   extraction of the serving batch with the running statistics (K1-K3;
   descriptors within 1e-4, the same top-250 sets, the statistics
   unmoved); (b) levels 3 and 4 deformable (``resnetb_deformable_strided``,
   ``resnetb_deformable`` twice), neighbour caps from ``calibrate_caps``
   (keep ratio 1, times 1.15; at ``deform_radius`` on the levels whose
   searches it widens), r5's weights where the shapes allow: the 13 K1
   searches at those caps (up to 256, four and eight slots a lane) bit for
   bit against the twin, then unmodulated and modulated one extraction
   (K1, K3, K2 at each rigid conv ``band_conv_eligible`` admits) and one
   train step (K2 and K4 at those convs, K5; the train gates), the
   fitting regularizer finite and positive, no overflow, 5 more steps,
   peak memory; (c) ``init_kpfcnn`` with randomised kernel points: every
   conv's kernel points equal to the same call on the CPU bit for bit, one
   extraction through K2 and K3 on them; (d) KPCNN (encoder to 2048
   channels, head 1024, 40 classes; its encoder from r5) on the serving
   batch's two fragments as clouds with fixed labels: one forward on the
   band route (K1, K2; logits atol 1e-4), one loss and backward (K4;
   gradients atol/rtol 5e-3), 3 SGD steps with finite losses, the logits
   on ``'banded'`` within 1e-4 of the band route's. One JSON line
   ``{"variants": ...}``;
12. the reference ``.pth`` bridges and the host utilities
   (``bridges_phase``), every size beside the card's name and power limit:
   (a) the r5 model out through
   ``compat/torch_export.py::save_torch_checkpoint`` and back through
   ``compat/torch_import.py::load_torch_checkpoint`` onto the card, every
   tensor bit for bit; the serving batch through ``FeatureExtractor``
   with both models, each call counted (K1, the list stage, K2, K3; no
   twin), descriptors and scores equal (max |diff| 0); phase 11's batch
   norm model (with its running statistics) and its deformable models
   round-tripped, tensors only; (b) ``python3 -m
   d3feat_tpu_torch.test_3dmatch --synthetic`` on the ``.pth`` (the r5
   npz's config as ``--chosen_snapshot``'s ``config.json``) and on the npz,
   in two subprocesses started together (they run beside (c)): their JSON
   lines equal; (c) the native library (``native/src/geometry.cpp``,
   ``g++ -fopenmp``) built; ``compute_correspondences`` on the training
   pair (within ``CORR_RADIUS``, mutual) on the native and the numpy
   route, the rows that differ, each differing row explained by the two
   routes' arithmetic (float32 against float64: a tie, or the threshold);
   ``grid_subsample_batch`` of the serving fragments at
   ``first_subsampling_dl`` against ``ops/subsample.py::voxel_subsample``
   on the card: counts per cloud equal, barycentres equal as sets (atol
   1e-4, as ``tests/test_native.py``); (d) ``utils/profiling.py``:
   ``trace`` around one extraction call, whose trace file must hold the
   port's spans (``port.extract[..]``, ``port.extract.step``,
   ``port.pyramid``, ``port.model.head``, ``port.sync.copy_out``), their
   counts and host ms printed, the port's kernel events in it counted
   (information: a profile can leave ``ctypes`` launches out);
   ``utils/metrics.py``'s ``accuracy`` and ``iou`` of a KPCNN forward's
   logits on the card equal to the same functions on the host copies. One
   JSON line ``{"bridges": ...}``;
13. one JSON line with every kernel's launches, largest difference from
   its twin and ``held_ms`` time (K1 on unsorted clouds with its launches
   counted on the main path, 0 on the band route, and those of phase 10's
   counted calls as ``gather_phase_launches``; every kernel's launches in
   phase 11's counted runs as ``variants_phase_launches``, in phase 12's
   as ``bridges_phase_launches``; K7 with its launches in the main path's
   counted call and the twin's ``held_ms`` as ``plain_ms``), then the
   result line.

The JSON lines come in this order before the last: ``{"recall": ...}``,
``{"trainer": ...}`` (per dtype the epochs' losses and accuracies, steps
and overflow share; the bests written, the resume comparison, the counted
step's launches, the recall on scene 424245, the card),
``{"data_parallel": ...}``, ``{"gather_route": ...}``, ``{"variants":
...}``, ``{"bridges": ...}`` and the kernels line.

Any failed check exits non-zero before the result line.
"""

import contextlib
import json
import os
import sys
import time

T0 = time.perf_counter()
N_MIN, N_MAX = 12000, 16000  # fragment sizes of the JAX package's bench.py
TOPK = 250                   # keypoints per fragment of the registration protocol
WARMUP = 3                   # extraction calls before a counted one
TRAIN_STEPS = 10             # kernel train steps after the counted one
CORR_RADIUS = 0.0375         # ground-truth correspondence radius (synthetic.py's corr_radius)
NUM_NODE = 128               # correspondences per pair (the reference's num_node)
BF16_TWIN_L2 = 1e-4          # bf16 kernels vs their bf16 twins (same rounding points), rel. L2
BF16_L2 = 1e-2               # bf16 vs f32: the JAX suite's bound (tests/test_band_conv.py:139-195)


def phase(msg):
    print(f"[{time.perf_counter() - T0:8.2f} s] {msg}", flush=True)


def fail(msg):
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def check(cond, msg):
    if not cond:
        fail(msg)


def held_ms(fn, reps=5):
    """Device milliseconds per call of ``fn()`` by CUDA events, with the
    stream held by a spin kernel (``torch.cuda._sleep``) until all ``reps``
    calls are queued: the events then time the card's work back to back,
    every launch included, without the host's launch gaps. Fails if the
    hold ran out before the calls were queued (``fn`` waited for the card,
    or the host stalled), since the events would then time the host too."""
    import torch

    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    fn()
    host_s = time.perf_counter() - t
    torch.cuda.synchronize()
    torch.cuda._sleep(int(2e9 * (0.02 + 4 * reps * host_s)))  # cycles, at most ~2 GHz
    held = torch.cuda.Event()
    held.record()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    check(not held.query(), f"held_ms: the hold ran out before {reps} calls were queued")
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def rel_l2(a, b):
    return float((a.double() - b.double()).norm() / b.double().norm())


PANELS = {"float32": "", "bfloat16": " bf16"}  # the tag of each panel dtype

_BC, _BW = "d3feat_tpu/ops/pallas/band_conv.py:351", "d3feat_tpu/ops/pallas/band_conv.py:586"
# Every kernel of the kernels line: (its name there, the wrapper's module and
# name, the wrapper's count attribute, the CUDA source, the TPU kernel it
# replaces). The one table the launch counts are reset and read from.
KERNELS = (
    ("K1 select", "ops.select", "band_select", "launches", "select.cu",
     "d3feat_tpu/ops/pallas/select.py:252"),
    # the selection that K2's and K4's TPU kernels redo in every conv
    ("K2/K4 band_lists", "ops.band_lists", "band_lists", "launches", "band_lists.cu", _BC),
    ("K2 band_conv", "ops.band_conv", "band_conv", "launches", "band_conv.cu", _BC),
    ("K3 band_head", "ops.head", "band_head", "launches", "head.cu",
     "d3feat_tpu/ops/pallas/head.py:173"),
    # the dx order of K4's TPU kernel, which walks each window's rows
    ("K4 band_lists transpose", "ops.band_lists", "transpose_lists", "launches", "band_lists.cu",
     _BW),
    ("K4 band_conv_bwd", "ops.band_conv", "band_conv_bwd", "launches", "band_conv_bwd.cu", _BW),
    ("K5 band_head_bwd", "ops.head", "band_head_bwd", "launches", "head_bwd.cu",
     "d3feat_tpu/ops/pallas/head.py:304"),
    ("K2 band_conv bf16", "ops.band_conv", "band_conv", "launches_bf16", "band_conv.cu", _BC),
    ("K4 band_conv_bwd bf16", "ops.band_conv", "band_conv_bwd", "launches_bf16",
     "band_conv_bwd.cu", _BW),
    # list mode (use_thr=False): the selection of :111 and :379 from the lists
    ("K2/K4 band_lists list", "ops.band_lists", "band_lists_given", "launches",
     "band_lists.cu", _BC),
    ("K2 band_conv list", "ops.band_conv", "band_conv", "launches_list", "band_conv.cu", _BC),
    ("K2 band_conv list bf16", "ops.band_conv", "band_conv", "launches_list_bf16",
     "band_conv.cu", _BC),
    ("K4 band_conv_bwd list", "ops.band_conv", "band_conv_bwd", "launches_list",
     "band_conv_bwd.cu", _BW),
    ("K4 band_conv_bwd list bf16", "ops.band_conv", "band_conv_bwd", "launches_list_bf16",
     "band_conv_bwd.cu", _BW),
    # radius_neighbors_pallas: K1 on clouds that are not pre-sorted
    ("K1 select unsorted", "ops.neighbors", "radius_neighbors_pallas", "launches", "select.cu",
     "d3feat_tpu/ops/pallas/select.py:252"),
)


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
    thr, ptie) and raw (positions, d2), each search timed by ``held_ms``;
    its ms in the kernels line is the sum over the searches of one
    extraction call."""
    import torch
    from d3feat_tpu_torch.ops.pyramid import level_search
    from d3feat_tpu_torch.ops.select import band_select

    levels = sorted_levels(pyr, spec)
    total = 0.0
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
        ms = held_ms(lambda: band_select(q_rows, s_rows, starts, wends, impl="kernel", **kw))
        total += ms
        phase(f"K1 select {name} ({q_rows.shape[0]} queries x {kw['max_k']}, tile "
              f"{kw['query_tile']}, {int((wends - starts).clamp(min=0).max())} rows in the widest "
              f"window): bit-exact vs twin; {ms:.4f} ms")
    check(torch.equal(level_search(levels[0], levels[0], spec.radii[0],
                                   spec.neighbor_caps[0], spec)[0],
                      pyr["neighbors"][0]), "K1 conv0: lists differ from the pyramid's")
    phase(f"K1 select, sum over the {len(searches)} searches of one extraction call: "
          f"{total:.4f} ms")
    report["K1 select"] = dict(max_abs_err=0.0, ms=total)


def conv_cases(pyr, cfg, model, min_width=0):
    """(spec, conv, band_conv_inputs) of every band conv of the encoder
    (``band_conv_eligible``) whose lists are wider than ``min_width``, in the
    order the forward runs them (14 at the default config)."""
    from d3feat_tpu_torch.models.blocks import band_conv_eligible, band_conv_inputs

    cases = [(spec, blk.conv, band_conv_inputs(spec, pyr, cfg))
             for spec, blk in zip(model.specs.encoder, model.encoder)
             if hasattr(blk, "conv") and band_conv_eligible(spec, pyr, cfg)]
    return [c for c in cases if c[2]["lists"].width > min_width]


def conv_features(spec, pyr, args, cin, gen, device):
    """Seeded leaky-ReLU features on the valid support rows, zero padding."""
    import torch

    n_valid = int(pyr["lengths"][spec.layer].sum())
    x = torch.zeros((args["s_rows"].shape[0], cin), device=device)
    x[:n_valid] = torch.nn.functional.leaky_relu(
        torch.randn((n_valid, cin), generator=gen, device=device), 0.1)
    return x


def conv_label(spec, conv, args):
    kpn, cin, cout = conv.weights.shape
    return (f"{'pool' if spec.strided else 'conv'}{spec.layer} {cin} -> {cout}, "
            f"{args['q_rows'].shape[0]} queries")


def without_thresholds(pyr):
    """The pyramid as a search without ``sel_thr`` sees it: every band
    conv takes list mode (its memo of band arguments shared, keyed by mode)."""
    return dict(pyr, sel_thr={}, band_args=pyr.setdefault("band_args", {}))


def check_lists(pyr, cfg, model, report, min_width=0):
    """The list stage and its transpose (K4's dx order) bit for bit against
    their twins on every search the convs use (9 at the default config;
    ``min_width`` as in ``conv_cases``); their ms in the kernels line are
    the sums over those searches (the builds: one extraction call's; the
    transposes: one train step's)."""
    import torch
    from d3feat_tpu_torch.ops.band_lists import band_lists, transpose_lists

    seen = {}
    tot = dict(l=0.0, t=0.0)
    for spec, conv, args in conv_cases(pyr, cfg, model, min_width):
        name = f"{'pool' if spec.strided else 'conv'}{spec.layer}"
        if name in seen:
            continue
        kw = {k: args[k] for k in ("q_rows", "thr", "ptie", "s_rows", "starts", "wends",
                                   "query_tile")}
        kw["width"] = args["lists"].width
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
        ms = dict(l=held_ms(lambda: band_lists(impl="kernel", **kw)),
                  t=held_ms(lambda: transpose_lists(got, ns, impl="kernel")))
        for k in "lt":
            tot[k] += ms[k]
        phase(f"band_lists {name} ({args['q_rows'].shape[0]} queries x {got.width}, "
              f"{seen[name]} listed rows): bit-exact vs twin, {ms['l']:.4f} ms; transpose "
              f"bit-exact, {ms['t']:.4f} ms")
    for k, what in (("l", "band_lists"), ("t", "band_lists transpose")):
        phase(f"{what}, sum over the {len(seen)} searches: {tot[k]:.4f} ms")
    for k, key in (("l", "K2/K4 band_lists"), ("t", "K4 band_lists transpose")):
        report[key] = dict(max_abs_err=0.0, ms=tot[k])


def check_list_stage(pyr, cfg, model, report, min_width=0):
    """List mode's list stage (``band_lists_given``) bit for bit against its
    twin on every search the convs use (``min_width`` as in
    ``conv_cases``), from the searches' own position lists (the pyramid
    without thresholds), with the transpose of its lists bit for bit; its
    ms in the kernels line is the sum over the searches of one extraction
    call."""
    import torch
    from d3feat_tpu_torch.ops.band_lists import band_lists_given, transpose_lists

    lpyr = without_thresholds(pyr)
    seen = {}
    total = 0.0
    for spec, conv, args in conv_cases(lpyr, cfg, model, min_width):
        name = f"{'pool' if spec.strided else 'conv'}{spec.layer}"
        if name in seen:
            continue
        kw = dict(neighb=args["neighb"], starts=args["starts"], wends=args["wends"],
                  query_tile=args["query_tile"], n_rows=pyr["points"][spec.layer].shape[0])
        got = band_lists_given(impl="kernel", **kw)
        ref = band_lists_given(impl="plain", **kw)
        for f in ("lpos", "lcnt"):
            check(torch.equal(getattr(got, f), getattr(ref, f)),
                  f"band_lists_given {name}: {f} differs from the twin")
        ns = args["s_rows"].shape[0]
        check(all(torch.equal(a, b) for a, b in zip(transpose_lists(got, ns, impl="kernel"),
                                                    transpose_lists(ref, ns, impl="plain"))),
              f"band_lists_given {name}: the transpose differs from the twin's")
        seen[name] = int(got.lcnt.sum())
        ms = held_ms(lambda: band_lists_given(impl="kernel", **kw))
        total += ms
        phase(f"band_lists_given {name} ({args['q_rows'].shape[0]} queries x "
              f"{args['neighb'].shape[0]}, {seen[name]} listed rows): bit-exact vs twin, "
              f"transpose bit-exact; {ms:.4f} ms")
    phase(f"band_lists_given, sum over the {len(seen)} searches: {total:.4f} ms")
    report["K2/K4 band_lists list"] = dict(max_abs_err=0.0, ms=total)


def check_k2(pyr, cfg, model, report, device="cuda", panel="float32", mode="threshold",
             min_width=0):
    """K2 against its twin at every conv of the forward (``min_width`` as
    in ``conv_cases``); its ms in the kernels line is the sum over the 14
    convs of one extraction call. With
    ``panel="bfloat16"``, the bf16 kernel against the bf16 twin (relative
    L2 ``BF16_TWIN_L2``, density exact) and against the f32 kernel
    (``BF16_L2``). With ``mode="list"``, list mode (the pyramid without
    thresholds, the same tolerances), its distance to threshold mode
    printed, not gated."""
    import torch
    from d3feat_tpu_torch.ops.band_conv import band_conv

    tag = PANELS[panel]
    if mode == "list":
        tag = " list" + tag
        thr_cases = conv_cases(pyr, cfg, model, min_width)
        pyr = without_thresholds(pyr)
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    worst = total = 0.0
    cases = conv_cases(pyr, cfg, model, min_width)
    for ci, (spec, conv, args) in enumerate(cases):
        kpn, cin, cout = conv.weights.shape
        x = conv_features(spec, pyr, args, cin, gen, device)
        kw = dict(args, x=x, weights=conv.weights.data, kernel_points=conv.kernel_points,
                  panel_dtype=panel)
        ko, kden = band_conv(impl="kernel", **kw)
        po, pden = band_conv(impl="plain", **kw)
        label = f"K2{tag} {conv_label(spec, conv, args)}"
        check(torch.equal(kden, pden), f"{label}: density differs from the twin")
        err = float((ko - po).abs().max())
        if panel == "float32":
            check(torch.allclose(ko, po, atol=3e-5, rtol=1e-4),
                  f"{label}: max |kernel - twin| = {err}")
            note = ""
        else:
            f32 = band_conv(impl="kernel", **dict(kw, panel_dtype="float32"))[0]
            e_twin, e_f32 = rel_l2(ko, po), rel_l2(ko, f32)
            check(e_twin < BF16_TWIN_L2, f"{label}: relative L2 {e_twin} from the bf16 twin")
            check(e_f32 < BF16_L2, f"{label}: relative L2 {e_f32} from the f32 kernel")
            note = f", relative L2 {e_twin:.3g} from the twin, {e_f32:.3g} from f32"
        if mode == "list":
            thr = band_conv(impl="kernel", **dict(thr_cases[ci][2], x=x, weights=conv.weights.data,
                                                   kernel_points=conv.kernel_points,
                                                   panel_dtype=panel))[0]
            note += (f", max |list - threshold mode| {float((ko - thr).abs().max()):.3g} "
                     f"(not gated)")
        worst = max(worst, err)
        ms = held_ms(lambda: band_conv(impl="kernel", **kw))
        total += ms
        phase(f"K2 band_conv{tag} {conv_label(spec, conv, args)}: max err {err:.3g}{note}; "
              f"{ms:.4f} ms")
    phase(f"K2 band_conv{tag}, sum over the {len(cases)} convs of one extraction call: "
          f"{total:.4f} ms")
    report[f"K2 band_conv{tag}"] = dict(max_abs_err=worst, ms=total)


def check_k3(pyr, cfg, report, device="cuda"):
    """K3 against its twin on the level-0 band (sums atol 1e-6, counts
    exact), from conv0's lists, timed by ``held_ms``."""
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
    ms = held_ms(lambda: band_head(x=x, impl="kernel", **args))
    report["K3 band_head"] = dict(max_abs_err=err, ms=ms)
    phase(f"K3 band_head ({args['q_rows'].shape[0]} queries x {c}, {int(lists.lcnt.sum())} "
          f"listed rows): max err {err:.3g}; {ms:.4f} ms")


def check_k4(pyr, cfg, model, report, device="cuda", panel="float32", mode="threshold",
             min_width=0):
    """K4 against its twin at every conv of the backward (``min_width`` as
    in ``conv_cases``; the first conv of the encoder, on the input
    features, without dx as in the train step), from the lists and
    the weighted rows of the forward as the train step runs it; its ms in
    the kernels line is the sum over the 14 convs of one train step. With
    ``panel="bfloat16"``, dx and dW of the bf16 kernel against the bf16
    twin (relative L2 ``BF16_TWIN_L2``) and the f32 kernel (``BF16_L2``).
    With ``mode="list"``, list mode (the same tolerances; dx on the level's
    rows: the list stage drops the shadow and the zero pads past it, whose
    dx the conv drops)."""
    import torch
    from d3feat_tpu_torch.ops.band_conv import band_conv_bwd, band_conv_kernel

    tag = PANELS[panel]
    if mode == "list":
        tag = " list" + tag
        pyr = without_thresholds(pyr)
    gen = torch.Generator(device=device)
    gen.manual_seed(2)
    worst = total = 0.0
    for ci, (spec, conv, args) in enumerate(conv_cases(pyr, cfg, model, min_width)):
        kpn, cin, cout = conv.weights.shape
        nq = args["q_rows"].shape[0]
        n_q = pyr["points"][spec.layer + 1 if spec.strided else spec.layer].shape[0]
        x = conv_features(spec, pyr, args, cin, gen, device)
        gs = torch.zeros((nq, cout), device=device)
        gs[:n_q] = torch.randn((n_q, cout), generator=gen, device=device) * 1e-2
        need_dx = ci > 0 or spec.layer > 0
        kw = dict(args, x=x, weights=conv.weights.data, kernel_points=conv.kernel_points,
                  panel_dtype=panel)
        _, _, wtd, wb = band_conv_kernel(keep_weighted=True, **kw)
        f32 = dict(kw, panel_dtype="float32")
        wtd32 = band_conv_kernel(keep_weighted=True, **f32)[2] if panel != "float32" else None
        kw.update(gs=gs, need_dx=need_dx)
        f32.update(gs=gs, need_dx=need_dx)
        kept = dict(weighted=wtd, weights_panel=wb)  # what the forward keeps for K4
        kdx, kdw = band_conv_bwd(impl="kernel", **kept, **kw)
        pdx, pdw = band_conv_bwd(impl="plain", **kw)
        if need_dx and mode == "list":
            n_real = pyr["points"][spec.layer].shape[0]
            kdx, pdx = kdx[:n_real], pdx[:n_real]
        label = f"K4{tag} {conv_label(spec, conv, args)}"
        err = float((kdw - pdw).abs().max())
        if need_dx:
            err = max(err, float((kdx - pdx).abs().max()))
        if panel == "float32":
            ok = torch.allclose(kdw, pdw, atol=5e-4, rtol=1e-3)
            if need_dx:
                ok = ok and torch.allclose(kdx, pdx, atol=5e-4, rtol=1e-3)
            check(ok, f"{label}: max |kernel - twin| = {err}")
            note = ""
        else:
            fdx, fdw = band_conv_bwd(impl="kernel", weighted=wtd32, **f32)
            fdx = fdx[:kdx.shape[0]] if need_dx else fdx
            outs = [("dW", kdw, pdw, fdw)] + ([("dx", kdx, pdx, fdx)] if need_dx else [])
            errs = {n: (rel_l2(k, p), rel_l2(k, f)) for n, k, p, f in outs}
            for n, (e_twin, e_f32) in errs.items():
                check(e_twin < BF16_TWIN_L2, f"{label}: {n} relative L2 {e_twin} from the twin")
                check(e_f32 < BF16_L2, f"{label}: {n} relative L2 {e_f32} from the f32 kernel")
            note = "".join(f", {n} relative L2 {a:.3g} from the twin, {b:.3g} from f32"
                           for n, (a, b) in errs.items())
        check(float(pdw.abs().max()) > 1e-3, f"{label}: vacuous comparison")
        worst = max(worst, err)
        ms = held_ms(lambda: band_conv_bwd(impl="kernel", **kept, **kw))
        total += ms
        phase(f"K4 band_conv_bwd{tag} {conv_label(spec, conv, args)}"
              f"{'' if need_dx else ', no dx'}: max err {err:.3g}{note}; {ms:.4f} ms")
    phase(f"K4 band_conv_bwd{tag}, sum over the {ci + 1} convs of one train step: "
          f"{total:.4f} ms")
    report[f"K4 band_conv_bwd{tag}"] = dict(max_abs_err=worst, ms=total)


def check_k5(pyr, cfg, report, device="cuda"):
    """K5 against its twin on the level-0 band (atol 1e-5), from the
    transpose of conv0's lists that the train step shares with K4 (held
    bit for bit against the twin's transpose first: K5 equals its twin bit
    for bit only on ascending entries), timed by ``held_ms``."""
    import torch
    from d3feat_tpu_torch.models.kpfcnn import band_head_inputs
    from d3feat_tpu_torch.ops.band_lists import transpose_lists_plain
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
    ms = held_ms(lambda: band_head_bwd(g=g, impl="kernel", **args))
    report["K5 band_head_bwd"] = dict(max_abs_err=err, ms=ms)
    phase(f"K5 band_head_bwd ({nq} queries x {c}, {int(row_ptr[-1])} listed pairs): max err "
          f"{err:.3g}; {ms:.4f} ms")


def check_k7(cfg, report, device="cuda"):
    """K7 against its twin on the lists of a group of 8 eval-cache
    fragments of 16,385-32,768 points at the 32,768-a-fragment bucket
    (``eval/extract.py::_bucket_caps`` of the bench capacities): each
    strided block's pool lists at its input width, conv0's lists at the
    gate's width, on random rows (a fifth of them below 0), equal under
    ``torch.equal``; then the level-2 pool and conv0 lists with every third
    list all shadow (0 out) and NaN rows (NaN where the twin's). K7's and
    the twin's ``held_ms``, summed over the 5 calls."""
    import torch
    from d3feat_tpu_torch.data.pack import load_eval_fragments, pack_fragments
    from d3feat_tpu_torch.eval.extract import _bucket_caps
    from d3feat_tpu_torch.models.kpfcnn import make_kpfcnn_specs
    from d3feat_tpu_torch.ops.neighbor_max import neighbor_max_kernel, neighbor_max_plain
    from d3feat_tpu_torch.ops.pyramid import build_pyramid, make_pyramid_spec

    group, bucket = 8, 32768
    frags = load_eval_fragments(bucket // 2 + 1, bucket)[:group]
    check(len(frags) == group, "K7: fewer than 8 eval-cache fragments of the 32,768 bucket")
    b = pack_fragments(frags, point_capacity=group * bucket, num_clouds=group)
    spec = make_pyramid_spec(route_config(cfg, caps=_bucket_caps(cfg, group * bucket)),
                             num_clouds=group)
    pyr = build_pyramid(torch.from_numpy(b["points"]).to(device),
                        torch.from_numpy(b["lengths"]).to(device), spec=spec)
    cases = [(f"pool{s.layer}", s.layer, pyr["pools"][s.layer], s.in_dim)
             for s in make_kpfcnn_specs(cfg).encoder if s.strided]
    cases.append(("gate", 0, pyr["neighbors"][0], cfg.output_dim))
    gen = torch.Generator(device=device).manual_seed(7)

    def rows_of(level, c):
        x = torch.randn((pyr["points"][level].shape[0], c), generator=gen, device=device)
        x[::5] = -x[::5].abs()
        return x

    ms, parts = [0.0, 0.0], []
    for label, level, inds, c in cases:
        x = rows_of(level, c)
        got, want = neighbor_max_kernel(x, inds), neighbor_max_plain(x, inds)
        torch.cuda.synchronize()
        check(torch.equal(got, want), f"K7 {label}: differs from the twin")
        t = (held_ms(lambda: neighbor_max_kernel(x, inds)),
             held_ms(lambda: neighbor_max_plain(x, inds)))
        ms = [a + b for a, b in zip(ms, t)]
        parts.append(f"{label} {tuple(inds.shape)} x {c} {t[0]:.4f} / {t[1]:.4f}")
    for label, level, inds, c in (cases[2], cases[-1]):
        shadow = pyr["points"][level].shape[0]
        inds = inds.clone()
        inds[::3] = shadow
        x = rows_of(level, c)
        nan_rows = inds[1::3, 0]
        x[nan_rows[nan_rows < shadow].long(), : c // 2] = float("nan")
        got, want = neighbor_max_kernel(x, inds), neighbor_max_plain(x, inds)
        torch.cuda.synchronize()
        ok = ~want.isnan()
        check(torch.equal(got[::3], torch.zeros_like(got[::3])), f"K7 {label}: an all-shadow "
              f"list is not 0")
        check(bool(want.isnan().any()) and torch.equal(got.isnan(), want.isnan())
              and torch.equal(got[ok], want[ok]), f"K7 {label}: NaN not as in the twin")
    report["K7 neighbor_max"] = dict(max_abs_err=0.0, ms=ms[0], plain_ms=ms[1])
    phase(f"K7 neighbor_max vs twin, a group of 8 at the 32,768 bucket (pyramid overflow "
          f"{bool(pyr['overflow'])}): equal; all-shadow lists 0, NaN as the twin's; ms K7 / twin: "
          + "; ".join(parts) + f"; sum {ms[0]:.4f} / {ms[1]:.4f}")


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
    from d3feat_tpu_torch.eval.extract import FeatureExtractor
    from d3feat_tpu_torch.ops.neighbor_max import neighbor_max

    names = ("K1 select", "K2/K4 band_lists", "K2 band_conv", "K3 band_head")
    # the serving policy: a group that overflows the bench bucket is run
    # again in the next larger one, so no served output is degraded
    ex = FeatureExtractor(cfg, model, batch_fragments=2, device=device)
    groups = [frags[i:i + 2] for i in range(0, len(frags) - 1, 2)]
    for i in range(WARMUP):
        ex.extract_many(groups[i % len(groups)])
    torch.cuda.synchronize()

    ex._steps.clear()
    # one extraction call: the counted main-path run
    k7 = (neighbor_max.launches, neighbor_max.launches_fallback)
    out, c = counted_run(lambda: ex.extract_many(groups[0]))
    k7 = (neighbor_max.launches - k7[0], neighbor_max.launches_fallback - k7[1])
    check(list(ex._steps) == [(cfg.caps.points[0], 2)],
          "main path: the counted call overflowed the bench bucket")
    n_pools = sum(s.strided for s in model.specs.encoder)
    check(k7 == (n_pools + 1, 0), f"main path: K7 launched {k7[0]} times and its twin ran "
          f"{k7[1]} times, for {n_pools} pools and the gate")
    report["K7 neighbor_max"]["launches"] = k7[0]
    check(c["K2 band_conv bf16"] == 0, "main path: f32 serving launched K2's bf16 kernel")
    for name in names:
        report[name]["launches"] = c[name]
        check(c[name] > 0, f"{name}: no launch on the main path")
    # K1 on unsorted clouds is the original-order route's; the main path is the band route
    report["K1 select unsorted"]["launches"] = c["K1 select unsorted"]
    phase("main path launches per call: " + ", ".join(
        f"{n} {report[n]['launches']}" for n in (*names, "K1 select unsorted", "K7 neighbor_max")))

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

    return out


def route_config(cfg, **fields):
    """A copy of ``cfg`` with ``fields`` set; a subclass keeps its
    ``architecture()``."""
    import dataclasses

    return dataclasses.replace(cfg, **fields)


def bf16_config(cfg):
    return route_config(cfg, compute_dtype="bfloat16")


def top_set(scores):
    import numpy as np

    return set(np.argsort(-scores, kind="stable")[:TOPK].tolist())


def serve_bf16(cfg, model, frags, report, f32_out, device="cuda"):
    """The serving path with ``compute_dtype="bfloat16"`` on the r5 weights
    and the f32 main path's batch: one counted call (K2's bf16 kernel
    launched, its f32 kernel never), the descriptors against the bf16
    twins on the card (relative L2 ``BF16_L2``; finite, unit norm, no
    overflow) and against the f32 kernel path (relative L2 and top-250
    overlap: measured, not gated)."""
    import numpy as np
    import torch
    from d3feat_tpu_torch.eval.extract import FeatureExtractor
    from d3feat_tpu_torch.ops.band_conv import band_conv

    bcfg = bf16_config(cfg)
    ex = FeatureExtractor(bcfg, model, batch_fragments=2, device=device)
    groups = [frags[i:i + 2] for i in range(0, len(frags) - 1, 2)]
    for i in range(WARMUP):
        ex.extract_many(groups[i % len(groups)])
    torch.cuda.synchronize()

    band_conv.launches = band_conv.launches_bf16 = 0
    ex._steps.clear()
    out = ex.extract_many(groups[0])  # the counted run of the bf16 serving path
    torch.cuda.synchronize()
    check(list(ex._steps) == [(cfg.caps.points[0], 2)],
          "bf16 serving: the counted call overflowed the bench bucket")
    check(band_conv.launches_bf16 > 0 and band_conv.launches == 0,
          f"bf16 serving: K2 launched {band_conv.launches_bf16} times in bf16, "
          f"{band_conv.launches} in f32")
    report["K2 band_conv bf16"]["launches"] = band_conv.launches_bf16
    phase(f"bf16 serving launches per call: K2 bf16 {band_conv.launches_bf16}, K2 f32 0")

    twin = FeatureExtractor(bcfg, model, batch_fragments=2, on_overflow="raise", impl="plain",
                            device=device)
    out_p = twin.extract_many(groups[0])
    for (d, s), (dp, _), (df, sf), frag in zip(out, out_p, f32_out, groups[0]):
        check(d.shape == (len(frag), cfg.output_dim) and np.isfinite(d).all()
              and np.isfinite(s).all(), "bf16 serving: output shape or non-finite values")
        norms = np.abs(np.linalg.norm(d, axis=1) - 1.0).max()
        check(norms < 1e-5, f"bf16 serving: norms off by {norms}")
        e_twin = float(np.linalg.norm(d - dp) / np.linalg.norm(dp))
        check(e_twin < BF16_L2, f"bf16 serving: descriptors at relative L2 {e_twin} from the "
              f"bf16 twins")
        e_f32 = float(np.linalg.norm(d - df) / np.linalg.norm(df))
        overlap = len(top_set(s) & top_set(sf))
        phase(f"bf16 fragment of {len(frag)} points: descriptors at relative L2 {e_twin:.4g} "
              f"from the bf16 twins on the card; {e_f32:.4g} from the f32 kernel path, top-{TOPK} "
              f"overlap {overlap}/{TOPK} (measured, not gated)")


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


def r5_model(cfg, device="cuda"):
    """A model of ``cfg`` with the r5 weights."""
    from d3feat_tpu_torch.compat.weights import load_npz
    from d3feat_tpu_torch.models.kpfcnn import init_kpfcnn

    model = init_kpfcnn(cfg, device=device)
    load_npz(model, os.path.join(os.path.dirname(os.path.abspath(__file__)), "artifacts",
                                 "model_best_acc_r5.npz"))
    return model


def train_phase(cfg, report, batch, device="cuda"):
    """The training path at full width from a copy of the r5 weights: one
    counted kernel step against one twin step from the same state, then
    ``TRAIN_STEPS`` more kernel steps."""
    import copy
    import math

    import torch
    from d3feat_tpu_torch.ops.pyramid import make_pyramid_spec
    from d3feat_tpu_torch.train.optim import make_optimizer, train_tensors
    from d3feat_tpu_torch.train.step import TrainState, make_train_step

    spec = make_pyramid_spec(cfg)
    model = r5_model(cfg, device)  # its own copy: extraction keeps the r5 weights
    twin_model = copy.deepcopy(model)
    state = TrainState(model, make_optimizer(cfg, model))
    twin_state = TrainState(twin_model, make_optimizer(cfg, twin_model))
    step = make_train_step(cfg, spec)
    twin_step = make_train_step(cfg, spec, impl="plain")

    (state, m), c = counted_run(lambda: step(state, batch, 0))  # the counted training-path run
    counts = {n: c[n] for n in ("K1 select", "K2/K4 band_lists", "K2 band_conv",
                                "K3 band_head", "K4 band_lists transpose", "K4 band_conv_bwd",
                                "K5 band_head_bwd")}
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
    for i in range(TRAIN_STEPS):
        state, m = step(state, batch, 0)
        check(math.isfinite(m.loss) and m.skipped == 0.0 and m.overflow == 0.0,
              f"train step {i + 1}: loss {m.loss}, skipped {m.skipped}, overflow {m.overflow}")
        losses.append(m.loss)
    check(state.step == TRAIN_STEPS + 1, f"train state counts {state.step} updates")
    phase("train losses: " + ", ".join(f"{v:.5f}" for v in losses))
    phase(f"training: {TRAIN_STEPS} steps of one pair at full width after the checked one, lr "
          f"{m.lr:.6g}, accuracy {m.accuracy:.1f} %")


def hold_bf16_step(label, cfg, spec, batch, model, base, m, pyramid=None):
    """Hold a counted bf16 train step (``model`` after it, its metrics
    ``m``, from the weights of ``base``) against one step through the bf16
    twins from the same weights: loss rtol ``BF16_L2``, finite, not
    skipped. The gradients are held to the noise of the bf16 step measured
    in the same run: the linear layers round their products to bf16 (as
    JAX's ``bf16 @ bf16``), so where two programs' f32 sums differ in the
    last bit (the kernels' and the twins' differ in summation order only) a
    rounding can flip, and the flips decide near-ties of the max pools and
    the loss's hardest pairs. The witness is a second twin step from the
    same weights moved by one f32 ulp each: the kernel step's flat gradient
    must lie within twice that step's distance to the twins' (or within
    ``BF16_L2`` where the step is not that sensitive), and nearer the
    twins' than the f32 step of the same state lies. ``pyramid``: the
    pyramid every step takes (default: each builds its own). Returns the
    line that reports the distances."""
    import copy
    import math

    import torch
    from d3feat_tpu_torch.train.optim import make_optimizer, train_tensors
    from d3feat_tpu_torch.train.step import TrainState, make_train_step

    bcfg = bf16_config(cfg)
    twin_model, nudged_model, f32_model = (copy.deepcopy(base) for _ in range(3))
    with torch.no_grad():
        for t in nudged_model.parameters():
            t.copy_(torch.nextafter(t, torch.full_like(t, math.inf)))
    kw = {} if pyramid is None else {"pyramid": pyramid}
    twin_step = make_train_step(bcfg, spec, impl="plain")
    _, tm = twin_step(TrainState(twin_model, make_optimizer(bcfg, twin_model)), batch, 0, **kw)
    _, nm = twin_step(TrainState(nudged_model, make_optimizer(bcfg, nudged_model)), batch, 0,
                      **kw)
    _, fm = make_train_step(cfg, spec)(TrainState(f32_model, make_optimizer(cfg, f32_model)),
                                       batch, 0, **kw)
    check(math.isfinite(m.loss) and m.skipped == 0.0 and tm.skipped == 0.0,
          f"{label}: loss {m.loss}, skipped {m.skipped}, twins' skipped {tm.skipped}")
    check(abs(m.loss - tm.loss) <= BF16_L2 * abs(tm.loss),
          f"{label}: loss {m.loss} vs bf16 twins' {tm.loss}")
    grads = [dict((n, t.grad) for n, t in train_tensors(mm))
             for mm in (model, twin_model, nudged_model, f32_model)]
    names = sorted(grads[0])
    flat = [torch.cat([g[n].reshape(-1) for n in names]) for g in grads]
    check(bool(torch.isfinite(flat[0]).all()), f"{label}: non-finite gradients")
    e_twin, noise, floor = (rel_l2(flat[i], flat[1]) for i in (0, 2, 3))
    check(e_twin < max(2.0 * noise, BF16_L2) and e_twin < floor,
          f"{label}: gradients at relative L2 {e_twin} from the bf16 twins'; the twins' step "
          f"from weights one ulp away lies at {noise}, the f32 step at {floor}")
    leaves = sorted(((rel_l2(grads[0][n], grads[1][n]), rel_l2(grads[2][n], grads[1][n]), n)
                     for n in names if float(grads[1][n].norm()) > 0.0), reverse=True)
    under = sum(e < BF16_L2 for e, _, _ in leaves)
    return (f"{label} vs bf16 twins on the card: loss {m.loss:.6f} vs {tm.loss:.6f} "
            f"(one ulp away {nm.loss:.6f}, f32 {fm.loss:.6f}); flat gradient at relative L2 "
            f"{e_twin:.4g} from the twins'; the twins' step from weights one ulp away at "
            f"{noise:.4g}, the f32 step at {floor:.4g}; {under} of {len(leaves)} leaves within "
            f"{BF16_L2}; worst: " + ", ".join(f"{n} {e:.3g} (one ulp away {u:.3g})"
                                             for e, u, n in leaves[:3]))


def train_bf16(cfg, report, batch, device="cuda"):
    """One counted train step with ``compute_dtype="bfloat16"`` from the r5
    weights (K4's bf16 kernel launched, the f32 K2 and K4 never), held by
    ``hold_bf16_step``; then ``TRAIN_STEPS`` more bf16 steps."""
    import copy
    import math

    import torch
    from d3feat_tpu_torch.ops.band_conv import band_conv, band_conv_bwd
    from d3feat_tpu_torch.ops.pyramid import make_pyramid_spec
    from d3feat_tpu_torch.train.optim import make_optimizer
    from d3feat_tpu_torch.train.step import TrainState, make_train_step

    bcfg = bf16_config(cfg)
    spec = make_pyramid_spec(bcfg)
    model = r5_model(bcfg, device)
    base = copy.deepcopy(model)
    state = TrainState(model, make_optimizer(bcfg, model))
    torch.cuda.synchronize()
    for w in (band_conv, band_conv_bwd):
        w.launches = w.launches_bf16 = 0
    step = make_train_step(bcfg, spec)
    state, m = step(state, batch, 0)  # the counted bf16 training run
    torch.cuda.synchronize()
    check(band_conv_bwd.launches_bf16 > 0 and band_conv_bwd.launches == 0
          and band_conv.launches == 0 and band_conv.launches_bf16 > 0,
          f"bf16 train step: K2 launched {band_conv.launches_bf16} times in bf16, "
          f"{band_conv.launches} in f32; K4 {band_conv_bwd.launches_bf16} in bf16, "
          f"{band_conv_bwd.launches} in f32")
    report["K4 band_conv_bwd bf16"]["launches"] = band_conv_bwd.launches_bf16
    phase(f"bf16 training launches per step: K2 bf16 {band_conv.launches_bf16}, K4 bf16 "
          f"{band_conv_bwd.launches_bf16}, f32 0")
    phase(hold_bf16_step("bf16 train step", cfg, spec, batch, model, base, m))

    for i in range(TRAIN_STEPS):
        state, m = step(state, batch, 0)
        check(math.isfinite(m.loss) and m.skipped == 0.0 and m.overflow == 0.0,
              f"bf16 train step {i + 1}: loss {m.loss}, skipped {m.skipped}, "
              f"overflow {m.overflow}")
    phase(f"training bf16: {TRAIN_STEPS} steps after the checked one")


def launch_table():
    """(name in the kernels line, wrapper, count attribute) of ``KERNELS``."""
    import importlib

    return [(name, getattr(importlib.import_module(f"d3feat_tpu_torch.{mod}"), fn), attr)
            for name, mod, fn, attr, _, _ in KERNELS]


def reset_launches():
    """Every kernel wrapper's launch counts to 0."""
    for _, w, attr in launch_table():
        setattr(w, attr, 0)


def launches_by_kernel():
    """``{name in the kernels line: launches since reset_launches}``."""
    return {name: getattr(w, attr) for name, w, attr in launch_table()}


def counted_run(fn):
    """``fn()`` with every launch count set to 0 just before and read just
    after (the card synchronised around it); returns (its result, the
    counts by kernel name)."""
    import torch

    torch.cuda.synchronize()
    reset_launches()
    out = fn()
    torch.cuda.synchronize()
    return out, launches_by_kernel()


def list_counts():
    """The launch counts that tell the two routes apart."""
    c = launches_by_kernel()
    return {"K2 list": c["K2 band_conv list"], "K2 list bf16": c["K2 band_conv list bf16"],
            "K4 list": c["K4 band_conv_bwd list"],
            "K4 list bf16": c["K4 band_conv_bwd list bf16"],
            "list stage (list mode)": c["K2/K4 band_lists list"],
            "transpose": c["K4 band_lists transpose"],
            "K2": c["K2 band_conv"] + c["K2 band_conv bf16"],
            "K4": c["K4 band_conv_bwd"] + c["K4 band_conv_bwd bf16"],
            "list stage (threshold mode)": c["K2/K4 band_lists"], "K3": c["K3 band_head"],
            "K5": c["K5 band_head_bwd"]}


def list_path(cfg, model, frags, batch, report, device="cuda"):
    """The band route without thresholds through the port's entry points,
    on pyramids whose ``sel_thr`` is removed: one extraction call
    (``make_extract_step``, the first two eval-cache fragments, r5) and one
    train step (``make_train_step``, the training pair, a copy of r5), each
    counted (list-mode K2, its list stage and, in the step, list-mode K4
    and the transposes; never threshold-mode K2 or K4, K3 or K5: the head
    takes the gather route), against the same call and step through the
    twins on the card (descriptors within 1e-4 and the same top-250 sets;
    loss rtol 1e-3, gradients atol 5e-3 / rtol 5e-3); then one counted bf16
    train step (list-mode K2 and K4 bf16 only) held by ``hold_bf16_step``
    on the same list-mode pyramid (its twins', one-ulp witness's and f32
    steps too). The extraction's and the f32 step's distance to the
    threshold route is printed, not gated."""
    import copy
    import math

    import torch
    from d3feat_tpu_torch.data.pack import pack_fragments
    from d3feat_tpu_torch.ops.pyramid import build_pyramid, make_pyramid_spec
    from d3feat_tpu_torch.train.optim import make_optimizer, train_tensors
    from d3feat_tpu_torch.train.step import TrainState, make_extract_step, make_train_step

    n_convs = sum(hasattr(blk, "conv") for blk in model.encoder)
    n_search = len({(sp.layer, sp.strided) for sp, blk in zip(model.specs.encoder, model.encoder)
                    if hasattr(blk, "conv")})
    b = pack_fragments(frags[:2], point_capacity=cfg.caps.points[0], num_clouds=2)
    eb = {k: torch.from_numpy(v).to(device) for k, v in b.items()}
    pyr = build_pyramid(eb["points"], eb["lengths"], spec=make_pyramid_spec(cfg, num_clouds=2))
    check(not bool(pyr["overflow"]), "list path: the extraction pyramid overflowed")
    extract = make_extract_step(cfg, num_clouds=2)
    extract(model, eb, pyramid=dict(pyr, sel_thr={}))  # warm-up
    torch.cuda.synchronize()
    reset_launches()
    feats, scores, _ = extract(model, eb, pyramid=dict(pyr, sel_thr={}))  # the counted run
    torch.cuda.synchronize()
    c = list_counts()
    check(c["K2 list"] == n_convs and c["list stage (list mode)"] == n_search
          and c["K2"] + c["K4"] + c["K3"] + c["list stage (threshold mode)"] == 0,
          f"list path extraction: launches {c}")
    report["K2 band_conv list"]["launches"] = c["K2 list"]
    report["K2/K4 band_lists list"]["launches"] = c["list stage (list mode)"]
    phase("list path, extraction call launches: " + ", ".join(f"{k} {v}" for k, v in c.items()))
    tf, ts, _ = make_extract_step(cfg, num_clouds=2, impl="plain")(model, eb,
                                                                   pyramid=dict(pyr, sel_thr={}))
    thf = extract(model, eb, pyramid=pyr)[0]
    lengths = [int(v) for v in b["lengths"]]
    worst, ok_sets, at = float((feats - tf).abs().max()), True, 0
    for n in lengths:
        ok_sets &= topk_agree(scores[at:at + n, 0].cpu().numpy(), ts[at:at + n, 0].cpu().numpy(),
                              TOPK, 1e-4)
        at += n
    check(bool(torch.isfinite(feats).all() and torch.isfinite(scores).all()),
          "list path extraction: non-finite outputs")
    check(worst <= 1e-4, f"list path extraction: descriptors differ from the twins' by {worst}")
    check(ok_sets, "list path extraction: top-250 keypoint sets differ from the twins'")
    phase(f"list path extraction vs twins on the card: max descriptor diff {worst:.3g}, "
          f"top-{TOPK} sets agree; distance to the threshold route "
          f"{float((feats - thf).abs().max()):.3g} (not gated)")

    spec = make_pyramid_spec(cfg)
    tpyr = build_pyramid(batch["points"], batch["lengths"], spec=spec)
    base = r5_model(cfg, device)
    models = [copy.deepcopy(base) for _ in range(3)]  # kernels, twins, threshold route
    states = [TrainState(m_, make_optimizer(cfg, m_)) for m_ in models]
    torch.cuda.synchronize()
    reset_launches()
    _, m = make_train_step(cfg, spec)(states[0], batch, 0, pyramid=dict(tpyr, sel_thr={}))
    torch.cuda.synchronize()
    c = list_counts()
    check(c["K2 list"] == c["K4 list"] == n_convs and c["transpose"] == n_search
          and c["list stage (list mode)"] == n_search
          and c["K2"] + c["K4"] + c["K3"] + c["K5"] + c["list stage (threshold mode)"] == 0,
          f"list path train step: launches {c}")
    report["K4 band_conv_bwd list"]["launches"] = c["K4 list"]
    phase("list path, train step launches: " + ", ".join(f"{k} {v}" for k, v in c.items()))
    _, tm = make_train_step(cfg, spec, impl="plain")(states[1], batch, 0,
                                                      pyramid=dict(tpyr, sel_thr={}))
    _, hm = make_train_step(cfg, spec)(states[2], batch, 0, pyramid=tpyr)
    flat = [torch.cat([t.grad.reshape(-1) for _, t in train_tensors(m_)]) for m_ in models]
    gerr = float((flat[0] - flat[1]).abs().max())
    check(math.isfinite(m.loss) and m.skipped == 0.0 and abs(m.loss - tm.loss) <= 1e-3 * abs(
        tm.loss), f"list path train step: loss {m.loss} vs twins' {tm.loss}, skipped {m.skipped}")
    check(torch.allclose(flat[0], flat[1], atol=5e-3, rtol=5e-3),
          f"list path train step: gradients differ from the twins' by {gerr}")
    check(float(flat[1].abs().max()) > 1e-4, "list path train step: vacuous gradient comparison")
    phase(f"list path train step vs twins on the card: loss {m.loss:.6f} vs {tm.loss:.6f}, max "
          f"gradient diff {gerr:.3g}; threshold route loss {hm.loss:.6f}, gradient distance "
          f"{float((flat[0] - flat[2]).abs().max()):.3g} (not gated)")
    del models, states

    bcfg = bf16_config(cfg)
    bmodel = copy.deepcopy(base)
    torch.cuda.synchronize()
    reset_launches()
    _, m = make_train_step(bcfg, spec)(TrainState(bmodel, make_optimizer(bcfg, bmodel)), batch, 0,
                                       pyramid=dict(tpyr, sel_thr={}))
    torch.cuda.synchronize()
    c = list_counts()
    check(c["K2 list bf16"] == c["K4 list bf16"] == n_convs and c["K2 list"] + c["K4 list"] == 0
          and c["K2"] + c["K4"] + c["K3"] + c["K5"] == 0, f"list path bf16 train step: {c}")
    report["K2 band_conv list bf16"]["launches"] = c["K2 list bf16"]
    report["K4 band_conv_bwd list bf16"]["launches"] = c["K4 list bf16"]
    phase(f"list path bf16 train step: launches K2 list bf16 {c['K2 list bf16']}, K4 list bf16 "
          f"{c['K4 list bf16']}")
    phase(hold_bf16_step("list path bf16 train step", cfg, spec, batch, bmodel, base, m,
                         pyramid=dict(tpyr, sel_thr={})))


def dp_phase(cfg, batch, frags, device="cuda"):
    """Data parallelism at world size 1 on NCCL (a group of one on a
    ``file://`` store in a temporary directory): ``make_dp_train_step`` on
    the training pair from r5 equal bit for bit to ``make_train_step``
    (metrics, weights, momentum), and ``make_dp_extract_step`` equal bit for
    bit to ``make_extract_step`` on the first two eval-cache fragments.
    Returns the JSON summary."""
    import tempfile

    import torch
    import torch.distributed as dist
    from d3feat_tpu_torch.compat.weights import optimizer_state_by_name
    from d3feat_tpu_torch.data.pack import pack_fragments
    from d3feat_tpu_torch.ops.pyramid import make_pyramid_spec
    from d3feat_tpu_torch.parallel import init_group, make_dp_extract_step, \
        make_dp_train_step, shard_batch
    from d3feat_tpu_torch.train.optim import make_optimizer, train_tensors
    from d3feat_tpu_torch.train.step import TrainState, make_extract_step, make_train_step

    with tempfile.TemporaryDirectory() as tmp:
        rank, n = init_group("cuda", world_size=1, rank=0, init_method=f"file://{tmp}/store",
                             timeout_s=300)
        try:
            check((rank, n, dist.get_backend()) == (0, 1, "nccl"),
                  f"DP: rank {rank} of {n} on {dist.get_backend()}")
            spec = make_pyramid_spec(cfg)
            models = [r5_model(cfg, device) for _ in range(2)]
            states = [TrainState(m_, make_optimizer(cfg, m_)) for m_ in models]
            _, m = make_train_step(cfg, spec)(states[0], batch, 0)
            mine = shard_batch({k: v[None] for k, v in batch.items()}, rank, device, n)
            _, dm = make_dp_train_step(cfg, pyramid_spec=spec)(states[1], mine, 0)
            moms = [optimizer_state_by_name(s.model, s.optimizer)["momentum_buffer"]
                    for s in states]
            same = (dm == m and all(torch.equal(a, b) for (_, a), (_, b) in zip(
                train_tensors(models[0]), train_tensors(models[1])))
                and all(torch.equal(moms[0][k], moms[1][k]) for k in moms[0]))
            check(same, f"DP train step at world size 1: {dm} vs make_train_step's {m}")
            phase(f"DP train step (NCCL, world size 1) equals make_train_step bit for bit: "
                  f"loss {dm.loss:.6f}, weights and momentum")
            b = pack_fragments(frags[:2], point_capacity=cfg.caps.points[0], num_clouds=2)
            eb = {k: torch.from_numpy(v).to(device) for k, v in b.items()}
            f, s, o = make_extract_step(cfg, num_clouds=2)(models[0], eb)
            df, ds, do = make_dp_extract_step(cfg, num_clouds=2)(models[0], eb)
            check(df.shape[0] == 1 and torch.equal(df[0], f) and torch.equal(ds[0], s)
                  and bool(do[0]) == bool(o), "DP extraction differs from make_extract_step")
            phase("DP extraction (NCCL, world size 1) equals make_extract_step bit for bit")
        finally:
            dist.destroy_process_group()
    return {"world_size": n, "backend": "nccl", "train_step_bitwise": True,
            "extract_bitwise": True}


RECALL_SEEDS = (424242, 424243, 424244, 424245)  # the axis scenes of artifacts/eval_cache
RECALL_REFERENCE = os.path.join("tests", "torch_port_recall_r5.json")
RATIO_THRESHOLD = 0.05  # a pair is matched above this inlier ratio (reference test.py:78)


@contextlib.contextmanager
def count_twins():
    """``{name: calls}`` of the kernels' plain twins (K1, the list stage, K2
    and K3, and the backward twins of K4, the transpose and K5) inside the
    ``with`` block: the wrappers call them through their module globals,
    which this patches."""
    from d3feat_tpu_torch.ops import band_conv, band_lists, head, select

    calls, saved = {}, []
    for mod, name in ((select, "select_plain"), (band_lists, "band_lists_plain"),
                      (band_conv, "band_conv_plain"), (head, "band_head_plain"),
                      (band_conv, "band_conv_bwd_plain"), (head, "band_head_bwd_plain"),
                      (band_lists, "transpose_lists_plain")):
        fn = getattr(mod, name)
        saved.append((mod, name, fn))
        calls[name] = 0

        def counted(*a, _fn=fn, _name=name, **kw):
            calls[_name] += 1
            return _fn(*a, **kw)

        setattr(mod, name, counted)
    try:
        yield calls
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def recall_scenes():
    """{seed: (fragments, poses)} of the 4 axis scenes of the eval cache."""
    from d3feat_tpu_torch.data.pack import EVAL_CACHE
    from d3feat_tpu_torch.eval.scene_cache import cache_path, load_scene

    return {str(seed): load_scene(cache_path(EVAL_CACHE, seed, 12, "axis", 2.0))
            for seed in RECALL_SEEDS}


def recall_pass(cfg, model, scenes, device="cuda"):
    """``final_recall``'s pass: ``FeatureExtractor(batch_fragments=2,
    on_overflow="warn")``, then the registration protocol per scene at
    ``TOPK`` keypoints, 0.10 and 5 %. Returns the details per scene (as in
    the reference file)."""
    from d3feat_tpu_torch.eval.extract import FeatureExtractor
    from d3feat_tpu_torch.final_recall import scene_recall

    ex = FeatureExtractor(cfg, model, batch_fragments=2, on_overflow="warn", device=device)
    return {seed: scene_recall(ex, frags, poses, TOPK)[1] for seed, (frags, poses) in scenes.items()}


def recall_lines(got, label):
    """Print the recall of each scene and their mean; returns the mean."""
    for seed, g in got.items():
        phase(f"{label} scene {seed}: {g['gt_pairs']} gt pairs, {g['matched_pairs']} matched, "
              f"recall {g['recall']:.2f} %, average inlier ratio {g['avg_inlier_ratio']:.5f}, "
              f"overflowed groups {g['overflowed_groups']}")
    mean = sum(g["recall"] for g in got.values()) / len(got)
    phase(f"{label}: mean recall {mean:.4f} % over {len(got)} scenes")
    return mean


def hold_recall(ref, got, route, label="vs the reference"):
    """Hold a recall pass (``recall_pass``'s details) against the JAX
    reference scenes: gt pairs equal; the groups that overflow equal on the
    band route (side by side on another route); per pair the same matched
    state, except where the reference ratio lies within one correspondence
    of the 5 % threshold (each such pair printed with both ratios and the
    top-250 overlap of its fragments); and where both fragments of a pair
    select the same top-250 sets on both sides, the same correspondence
    and inlier counts. Prints the top-250 overlap per fragment. Returns
    the failures."""
    bad = []
    for seed, r in ref.items():
        g = got[seed]
        if g["gt_pairs"] != r["gt_pairs"] or set(g["pairs"]) != set(r["pairs"]):
            bad.append(f"scene {seed}: {g['gt_pairs']} gt pairs, reference {r['gt_pairs']}")
            continue
        if route == "band" and g["overflowed_groups"] != r["overflowed_groups"]:
            bad.append(f"scene {seed}: overflowed groups {g['overflowed_groups']}, reference "
                       f"{r['overflowed_groups']}")
        elif g["overflowed_groups"] != r["overflowed_groups"]:
            phase(f"scene {seed}: overflowed groups {g['overflowed_groups']}, reference "
                  f"({route} route) {r['overflowed_groups']}")
        same = [set(a["top"]) == set(b["top"]) for a, b in zip(g["fragments"], r["fragments"])]
        overlap = [len(set(a["top"]) & set(b["top"])) for a, b in zip(g["fragments"],
                                                                        r["fragments"])]
        phase(f"{label}, scene {seed}: top-{TOPK} overlap per fragment {overlap}")
        flips = 0
        for key, rp in r["pairs"].items():
            gp = g["pairs"][key]
            i, j = (int(v) for v in key.split("_"))
            if (gp["ratio"] > RATIO_THRESHOLD) != (rp["ratio"] > RATIO_THRESHOLD):
                near = rp["corr"] > 0 and abs(rp["ratio"] - RATIO_THRESHOLD) <= 1 / rp["corr"]
                flips += 1 if gp["ratio"] > RATIO_THRESHOLD else -1
                phase(f"{label}, scene {seed} pair {key}: matched {gp['ratio'] > RATIO_THRESHOLD} "
                      f"at ratio {gp['ratio']:.5f} ({gp['inliers']}/{gp['corr']}), reference "
                      f"{rp['ratio']:.5f} ({rp['inliers']}/{rp['corr']}); top-{TOPK} overlap "
                      f"{overlap[i]}, {overlap[j]}"
                      + ("" if near else "; the reference is not within one correspondence "
                         "of the threshold"))
                if not near:
                    bad.append(f"scene {seed} pair {key}: matched state differs from the "
                               f"reference's ({gp['ratio']:.5f} vs {rp['ratio']:.5f})")
            if same[i] and same[j] and (gp["corr"], gp["inliers"]) != (rp["corr"], rp["inliers"]):
                bad.append(f"scene {seed} pair {key}: same top-{TOPK} sets but "
                           f"{gp['inliers']}/{gp['corr']} vs the reference's "
                           f"{rp['inliers']}/{rp['corr']}")
        if g["matched_pairs"] - r["matched_pairs"] != flips:
            bad.append(f"scene {seed}: {g['matched_pairs']} matched, reference "
                       f"{r['matched_pairs']}, {flips} near-threshold flips")
    return bad


def recall_phase(card, device="cuda"):
    """Registration recall on the 4 axis scenes of the eval cache with the
    r5 weights on the r5 npz's own config: the f32 kernel path held to
    the JAX reference (``hold_recall``), one counted call (K1, K2 f32 and
    K3 launched, no twin), then the bf16 kernel path (K2's bf16 kernel,
    never its f32 one; finite), printed beside f32 and not gated on
    recall. Returns the JSON line's dict."""
    import numpy as np
    import torch
    from d3feat_tpu_torch.eval.extract import FeatureExtractor
    from d3feat_tpu_torch.final_recall import load_snapshot
    from d3feat_tpu_torch.ops.band_conv import band_conv
    from d3feat_tpu_torch.ops.head import band_head
    from d3feat_tpu_torch.ops.select import band_select

    here = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(here, RECALL_REFERENCE)) as f:
        ref = json.load(f)
    route = ref["meta"]["route"]
    cfg, model, meta = load_snapshot(os.path.join(here, "artifacts", "model_best_acc_r5.npz"),
                                     device)
    scenes = recall_scenes()
    phase(f"recall: r5 (epoch {meta['epoch']}) on its own config, {len(scenes)} scenes, "
          f"{sum(len(f) for f, _ in scenes.values())} fragments, "
          f"{sum(len(p) for _, p in scenes.values())} gt pairs; reference: JAX "
          f"{ref['meta']['jax']} on the {route} route")
    line = {"reference": {s: {k: r[k] for k in ("gt_pairs", "matched_pairs", "recall",
                                                 "avg_inlier_ratio", "overflowed_groups")}
                          for s, r in ref["scenes"].items()}, "card": card}

    for dtype in ("float32", "bfloat16"):
        c = cfg if dtype == "float32" else bf16_config(cfg)
        ex = FeatureExtractor(c, model, batch_fragments=2, on_overflow="warn", device=device)
        with count_twins() as twins:
            band_select.launches = band_conv.launches = band_conv.launches_bf16 = 0
            band_head.launches = 0
            ex.extract_many(next(iter(scenes.values()))[0][:2])  # one counted call
            torch.cuda.synchronize()
            counts = {"K1": band_select.launches, "K2 f32": band_conv.launches,
                      "K2 bf16": band_conv.launches_bf16, "K3": band_head.launches}
            got = recall_pass(c, model, scenes, device)
        k2 = "K2 f32" if dtype == "float32" else "K2 bf16"
        other = "K2 bf16" if dtype == "float32" else "K2 f32"
        check(counts["K1"] > 0 and counts[k2] > 0 and counts["K3"] > 0 and counts[other] == 0,
              f"recall {dtype}: launches of one call {counts}")
        check(not any(twins.values()), f"recall {dtype}: twins ran {twins}")
        phase(f"recall {dtype}: launches of one call " + ", ".join(
            f"{k} {v}" for k, v in counts.items()) + "; no twin ran in the pass")
        for seed, g in got.items():
            check(all(f["finite"] and len(f["top"]) == TOPK for f in g["fragments"]),
                  f"recall {dtype} scene {seed}: non-finite outputs or a short selection")
        mean = recall_lines(got, f"recall {dtype}")
        line[dtype] = {"mean_recall": mean, "launches": counts,
                       "scenes": {s: {k: g[k] for k in ("gt_pairs", "matched_pairs", "recall",
                                                        "avg_inlier_ratio",
                                                        "overflowed_groups")}
                                  for s, g in got.items()}}
        if dtype == "float32":
            bad = hold_recall(ref["scenes"], got, route)
            check(not bad, "recall f32 vs the JAX reference: " + "; ".join(bad))
            phase(f"recall f32 held to the JAX reference ({route} route): gt pairs, overflow, "
                  f"matched pairs and counts agree under the rules")
            f32 = got
        else:
            for seed, g in got.items():
                phase(f"recall bf16 scene {seed}: {g['recall'] - f32[seed]['recall']:+.2f} points "
                      f"on f32 ({g['matched_pairs'] - f32[seed]['matched_pairs']:+d} pairs)")
            hold_recall(f32, got, "f32", "bf16 vs f32")  # printed, not gated
    return line


TRAIN_SCENES = 8           # trainer phase: train steps an epoch, one a scene of the train role
VAL_SCENES = 2             # validation steps an epoch, one a scene of the validation role
CORPUS_SEED = 777          # gen_corpus's default seed


def flat_grads(model):
    import torch
    from d3feat_tpu_torch.train.optim import train_tensors

    return torch.cat([t.grad.reshape(-1) for _, t in train_tensors(model)])


def write_corpus(root):
    """The trainer phase's corpus, written by ``gen_corpus.write_scene``
    (default resolution, warp and crop) in threads: scenes ``1..
    TRAIN_SCENES + 3`` of the train role and ``0, 50, 100`` of the
    validation role (``DiskScanPairDataset.VAL_MOD``), of which gen_corpus
    skips a few (too few candidate pairs). Returns the scenes written of
    each role."""
    from concurrent.futures import ThreadPoolExecutor

    from d3feat_tpu_torch.data.synthetic import DiskScanPairDataset
    from d3feat_tpu_torch.gen_corpus import write_scene

    os.makedirs(root)
    train = list(range(1, TRAIN_SCENES + 4))
    val = [DiskScanPairDataset.VAL_MOD * k for k in range(VAL_SCENES + 1)]
    with ThreadPoolExecutor(8) as pool:
        ok = dict(zip(train + val, pool.map(lambda i: write_scene(root, i, seed=CORPUS_SEED),
                                            train + val)))
    n_train, n_val = sum(ok[i] for i in train), sum(ok[i] for i in val)
    check(n_train >= TRAIN_SCENES and n_val >= VAL_SCENES,
          f"gen_corpus wrote {n_train} train and {n_val} validation scenes")
    return n_train, n_val


def run_trainer(cfg, corpus, device="cuda"):
    """The port's ``Trainer`` on ``make_loaders``' corpus route, as
    ``python3 -m d3feat_tpu_torch.train_3dmatch --corpus`` builds it.
    Returns the trainer and, per epoch, its train meters, the validation
    results and the steps it took."""
    from d3feat_tpu_torch.train.trainer import Trainer
    from d3feat_tpu_torch.train_3dmatch import make_loaders

    train_loader, val_loader = make_loaders(cfg, False, False, corpus)
    tr = Trainer(cfg, train_loader, val_loader, device=device)
    epochs = []
    train_epoch, evaluate = tr.train_epoch, tr.evaluate

    def recorded_epoch(epoch):
        res = train_epoch(epoch)
        epochs.append({"epoch": epoch, "train": res, "steps": tr.step_timer.calls})
        return res

    def recorded_eval(epoch):
        epochs[-1]["val"] = evaluate(epoch)
        return epochs[-1]["val"]

    tr.train_epoch, tr.evaluate = recorded_epoch, recorded_eval
    return tr, epochs


def trainer_summary(epochs, label):
    """Check each epoch (finite loss, none skipped, validation ran) and
    print its losses; returns the JSON line's numbers."""
    import math

    for e in epochs:
        tm, vm = e["train"], e.get("val")
        check(math.isfinite(tm["loss"]) and tm["skipped"] == 0.0 and e["steps"] > 0,
              f"trainer {label} epoch {e['epoch']}: mean loss {tm['loss']}, skipped "
              f"{tm['skipped']}, {e['steps']} steps")
        check(vm is not None and math.isfinite(vm["loss"]),
              f"trainer {label} epoch {e['epoch']}: validation {vm}")
        phase(f"trainer {label} epoch {e['epoch']}: {e['steps']} steps, mean train loss "
              f"{tm['loss']:.6f} (accuracy {tm['accuracy']:.2f} %, overflow {tm['overflow']}), "
              f"validation loss {vm['loss']:.6f} (accuracy {vm['accuracy']:.2f} %)")
    steps = sum(e["steps"] for e in epochs)
    return {"epochs": [{"epoch": e["epoch"], "steps": e["steps"],
                        "train_loss": e["train"]["loss"], "train_accuracy": e["train"]["accuracy"],
                        "val_loss": e["val"]["loss"], "val_accuracy": e["val"]["accuracy"]}
                       for e in epochs],
            "steps": steps,
            "overflow_share": sum(e["train"]["overflow"] * e["steps"] for e in epochs) / steps}


def trainer_phase(card, device="cuda"):
    """The port's ``Trainer`` at full width on the card: the r5 npz's own
    config warm-started from r5 (epoch 114) for two epochs of a small
    ``gen_corpus`` corpus, in f32 and in bf16. Checks the snapshots, the
    best snapshots and the autoexport by the reference's rule, the weights
    read back through ``final_recall.load_snapshot`` (``model_final`` and an
    exported npz), a resume from ``latest_periodic()`` against the
    continuing run, and one counted step (every kernel, no twin). Returns
    the ``{"trainer": ...}`` line's dict."""
    import copy
    import math
    import tempfile

    import torch
    from d3feat_tpu_torch.compat.portable import export_npz, read_npz
    from d3feat_tpu_torch.compat.weights import optimizer_state_by_name
    from d3feat_tpu_torch.config import D3FeatConfig
    from d3feat_tpu_torch.data.pack import EVAL_CACHE
    from d3feat_tpu_torch.eval.scene_cache import cache_path, load_scene
    from d3feat_tpu_torch.final_recall import load_snapshot
    from d3feat_tpu_torch.ops.band_conv import band_conv, band_conv_bwd
    from d3feat_tpu_torch.ops.band_lists import band_lists, transpose_lists
    from d3feat_tpu_torch.ops.head import band_head, band_head_bwd
    from d3feat_tpu_torch.ops.select import band_select
    from d3feat_tpu_torch.train.checkpoint import BEST_ACC, BEST_LOSS
    from d3feat_tpu_torch.train.optim import train_tensors
    from d3feat_tpu_torch.train.trainer import Trainer
    from d3feat_tpu_torch.train_3dmatch import make_loaders

    here = os.path.dirname(os.path.abspath(__file__))
    r5 = os.path.join(here, "artifacts", "model_best_acc_r5.npz")
    meta = read_npz(r5)[2]
    r5_best = (meta["best_loss"], meta["best_acc"])
    line = {"card": card}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_trainer_") as tmp:
        corpus = os.path.join(tmp, "corpus")
        n_train, n_val = write_corpus(corpus)
        phase(f"trainer: corpus of {n_train} train and {n_val} validation scenes written by "
              f"gen_corpus")

        cfg = D3FeatConfig.from_dict(meta["config"])
        cfg.pretrain = r5
        cfg.max_epoch = meta["epoch"] + 2
        cfg.training_max_iter = TRAIN_SCENES
        cfg.val_max_iter = VAL_SCENES
        cfg.snapshot_interval = 1
        cfg.snapshot_root = tmp
        cfg.experiment_id = "f32"
        cfg.autoexport = os.path.join(tmp, "f32_best_acc.npz")
        check(cfg.first_features_dim == 128 and cfg.num_layers == 5
              and cfg.corpus_rotation == "mix" and cfg.num_node == 128,
              f"r5 config: width {cfg.first_features_dim}, {cfg.num_layers} layers, "
              f"rotation {cfg.corpus_rotation}, {cfg.num_node} correspondences")

        wrappers = {"K1": band_select, "lists": band_lists, "K2": band_conv, "K3": band_head,
                    "K4": band_conv_bwd, "transpose": transpose_lists, "K5": band_head_bwd}
        with count_twins() as twins:
            tr, epochs = run_trainer(cfg, corpus, device)
            check(tr.start_epoch == meta["epoch"] == 114,
                  f"trainer: warm start at epoch {tr.start_epoch}, r5 meta {meta['epoch']}")
            check((tr.best_loss, tr.best_acc) == r5_best,
                  f"trainer: bests {tr.best_loss}, {tr.best_acc} from r5's meta")
            tr.train()
        check(not any(twins.values()), f"trainer f32: twins ran {twins}")
        line["float32"] = trainer_summary(epochs, "f32")
        snap = tr.snapshots.directory
        for f in ("config.json", "metrics.jsonl", f"snapshot_epoch_{meta['epoch'] + 1}",
                  f"snapshot_epoch_{meta['epoch'] + 2}", "model_final"):
            check(os.path.exists(os.path.join(snap, f)), f"trainer: no {f}")

        # the reference's rule: a best snapshot (and the autoexport) exactly
        # when validation beat the bests the warm start took from r5's meta
        best_loss, best_acc = r5_best
        want = {BEST_LOSS: None, BEST_ACC: None}
        for e in epochs:
            if e["val"]["loss"] < best_loss:
                best_loss, want[BEST_LOSS] = e["val"]["loss"], e["epoch"] + 1
            if e["val"]["accuracy"] > best_acc:
                best_acc, want[BEST_ACC] = e["val"]["accuracy"], e["epoch"] + 1
        for name, epoch in want.items():
            check(tr.snapshots.exists(name) == (epoch is not None),
                  f"trainer: {name} exists {tr.snapshots.exists(name)}, expected at epoch "
                  f"{epoch}")
            if epoch is not None:
                with open(os.path.join(snap, name + ".meta.json")) as f:
                    m = json.load(f)
                check(m["epoch"] == epoch, f"trainer: {name} meta {m}, expected epoch {epoch}")
        auto = os.path.exists(cfg.autoexport)
        check(auto == (want[BEST_ACC] is not None),
              f"trainer: autoexport written {auto}, new best accuracy at {want[BEST_ACC]}")
        if auto:
            ameta = load_snapshot(cfg.autoexport, device)[2]
            check(ameta["epoch"] == want[BEST_ACC] and ameta["best_acc"] == best_acc,
                  f"trainer: autoexport meta {ameta}")
        line["best"] = {"model_best_loss_epoch": want[BEST_LOSS],
                        "model_best_acc_epoch": want[BEST_ACC], "autoexport": auto}
        phase(f"trainer: bests from r5 {r5_best}; model_best_loss "
              f"{'at epoch ' + str(want[BEST_LOSS]) if want[BEST_LOSS] else 'not written'}, "
              f"model_best_acc and the autoexport "
              f"{'at epoch ' + str(want[BEST_ACC]) if want[BEST_ACC] else 'not written'} "
              f"(validation did {'' if auto else 'not '}beat r5's best accuracy)")

        # the weights read back through final_recall: model_final and an npz
        # that export_npz writes from the trainer's model now
        final = {k: v.clone() for k, v in tr.state.model.state_dict().items()}
        npz = os.path.join(tmp, "trained.npz")
        export_npz(npz, tr.state.model.state_dict(), None,
                   meta={"epoch": cfg.max_epoch, "best_loss": tr.best_loss,
                         "best_acc": tr.best_acc, "config": cfg.to_dict()})
        for src, kw in ((snap, {"name": "model_final"}), (npz, {})):
            _, m, _ = load_snapshot(src, device, **kw)
            sd = m.state_dict()
            check(sd.keys() == final.keys() and all(torch.equal(sd[k], final[k]) for k in final),
                  f"trainer: weights loaded from {os.path.basename(src)} differ from the "
                  f"trainer's")
        phase("trainer: model_final (snapshot directory) and an exported npz load through "
              "final_recall.load_snapshot to the trainer's weights, bit for bit")

        # resume: a second trainer from latest_periodic() against the first
        # continuing, one step each on one fixed batch; the first trainer's
        # step is the counted one
        latest = tr.snapshots.latest_periodic()
        check(latest == f"snapshot_epoch_{cfg.max_epoch}", f"latest_periodic {latest}")
        cfg2 = copy.deepcopy(cfg)
        cfg2.pretrain = os.path.join(snap, latest)
        cfg2.experiment_id = "resumed"
        train_loader, _ = make_loaders(cfg2, False, False, corpus)
        tr2 = Trainer(cfg2, train_loader, None, device=device)
        check(tr2.start_epoch == cfg.max_epoch and tr2.state.step == tr.state.step,
              f"resume: epoch {tr2.start_epoch}, step {tr2.state.step} vs {tr.state.step}")
        mom = [optimizer_state_by_name(t.state.model, t.state.optimizer)["momentum_buffer"]
               for t in (tr, tr2)]
        check(all(torch.equal(mom[0][k], mom[1][k]) for k in mom[0]),
              "resume: momentum differs from the continuing run's")
        it = iter(train_loader)
        batch = tr._device_put(next(it))
        it.close()  # stops the loader's producer
        torch.cuda.synchronize()
        for w in wrappers.values():
            w.launches = 0
        band_conv.launches_bf16 = band_conv_bwd.launches_bf16 = 0
        with count_twins() as twins:
            tr.state, m1 = tr._train_step(tr.state, batch, cfg.max_epoch)  # the counted step
            torch.cuda.synchronize()
        counts = {n: w.launches for n, w in wrappers.items()}
        want_counts = {"K1": 13, "lists": 9, "K2": 14, "K3": 1, "K4": 14, "transpose": 9,
                       "K5": 1}
        check(counts == want_counts and not any(twins.values()),
              f"trainer step: launches {counts}, expected {want_counts}; twins {twins}")
        phase("trainer step launches: " + ", ".join(f"{n} {c}" for n, c in counts.items())
              + "; no twin ran")
        g1 = flat_grads(tr.state.model)
        tr2.state, m2 = tr2._train_step(tr2.state, batch, cfg.max_epoch)
        g2 = flat_grads(tr2.state.model)
        p1 = torch.cat([t.detach().reshape(-1) for _, t in train_tensors(tr.state.model)])
        p2 = torch.cat([t.detach().reshape(-1) for _, t in train_tensors(tr2.state.model)])
        same = m1 == m2 and torch.equal(g1, g2) and torch.equal(p1, p2)
        gerr, perr = float((g1 - g2).abs().max()), float((p1 - p2).abs().max())
        check(math.isfinite(m1.loss) and m1.skipped == m2.skipped == 0.0
              and abs(m1.loss - m2.loss) <= 1e-3 * abs(m1.loss)
              and torch.allclose(g2, g1, atol=5e-3, rtol=5e-3),
              f"resume: loss {m2.loss} vs {m1.loss}, gradients differ by {gerr}")
        phase(f"trainer resume from {latest}: loss {m2.loss!r} vs the continuing run's "
              f"{m1.loss!r}; " + ("bit for bit equal (metrics, gradients, weights)" if same else
                                  f"not bit for bit: max gradient diff {gerr:.3g}, max weight "
                                  f"diff {perr:.3g}, within the train-step gate (the pooling "
                                  f"gathers' backward sums into rows with atomic adds, whose "
                                  f"order is not fixed on the card)"))
        line["resume"] = {"bitwise": same, "loss": [m1.loss, m2.loss], "max_grad_diff": gerr,
                          "max_weight_diff": perr}
        line["counted_step_launches"] = counts
        del tr2

        # the trained npz's recall on one held-out scene (printed only)
        with open(os.path.join(here, RECALL_REFERENCE)) as f:
            r5_recall = json.load(f)["scenes"]["424245"]["recall"]
        scene = load_scene(cache_path(EVAL_CACHE, 424245, 12, "axis", 2.0))
        rcfg, rmodel, _ = load_snapshot(npz, device)
        g = recall_pass(rcfg, rmodel, {"424245": scene}, device)["424245"]
        line["recall_424245"] = {"trained": g["recall"], "matched_pairs": g["matched_pairs"],
                                 "gt_pairs": g["gt_pairs"], "r5": r5_recall}
        phase(f"trainer: the trained npz on scene 424245: recall {g['recall']:.2f} % "
              f"({g['matched_pairs']} of {g['gt_pairs']} pairs; r5 {r5_recall:.2f} %; printed, "
              f"not gated)")

        # bf16: the same run with compute_dtype="bfloat16"
        bcfg = copy.deepcopy(cfg)
        bcfg.compute_dtype = "bfloat16"
        bcfg.experiment_id = "bf16"
        bcfg.autoexport = os.path.join(tmp, "bf16_best_acc.npz")
        band_conv.launches = band_conv.launches_bf16 = 0
        band_conv_bwd.launches = band_conv_bwd.launches_bf16 = 0
        with count_twins() as twins:
            btr, bepochs = run_trainer(bcfg, corpus, device)
            btr.train()
        check(not any(twins.values()), f"trainer bf16: twins ran {twins}")
        check(band_conv.launches == band_conv_bwd.launches == 0
              and band_conv.launches_bf16 > 0 and band_conv_bwd.launches_bf16 > 0,
              f"trainer bf16: K2 {band_conv.launches_bf16} bf16 and {band_conv.launches} f32 "
              f"launches, K4 {band_conv_bwd.launches_bf16} and {band_conv_bwd.launches}")
        line["bfloat16"] = trainer_summary(bepochs, "bf16")
        line["bfloat16"]["launches"] = {"K2 bf16": band_conv.launches_bf16,
                                        "K4 bf16": band_conv_bwd.launches_bf16}
    f32 = line["float32"]
    phase(f"trainer: overflow share {f32['overflow_share']} (bf16 "
          f"{line['bfloat16']['overflow_share']}) on {card}")
    return line


GATHER_REFERENCE = os.path.join("tests", "torch_port_recall_r5_gather.json")
GATHER_SEARCHES = ("banded", "grid", "brute")  # the original-order route's searches
CALIBRATION_PAIRS = 4


def kernel_launches():
    """Every K1-K5 kernel launch counted since ``reset_launches``."""
    return sum(launches_by_kernel().values())


def packed_batch(frags, cap, device):
    import torch
    from d3feat_tpu_torch.data.pack import pack_fragments

    b = pack_fragments(frags, point_capacity=cap, num_clouds=2)
    return {k: torch.from_numpy(v).to(device) for k, v in b.items()}


def gather_conv_cases(cfg, model, pyr, device="cuda"):
    """(spec, conv, features, cotangent, {"band": K2's route, "gather": the
    gather KPConv}) at each of the model's 14 convs on the band pyramid
    ``pyr``: seeded leaky-ReLU features on the valid rows, zeros on the
    padding, and a seeded cotangent."""
    import torch
    from d3feat_tpu_torch.models.blocks import apply_band_kpconv, apply_gather_kpconv

    gen = torch.Generator(device=device)
    gen.manual_seed(7)
    for spec, blk in zip(model.specs.encoder, model.encoder):
        if not hasattr(blk, "conv"):
            continue
        conv = blk.conv
        q_level = spec.layer + 1 if spec.strided else spec.layer
        n_rows, n_q = (pyr["points"][l].shape[0] for l in (spec.layer, q_level))
        n_valid = int(pyr["lengths"][spec.layer].sum())
        x = torch.zeros((n_rows, conv.weights.shape[1]), device=device)
        x[:n_valid] = torch.nn.functional.leaky_relu(
            torch.randn((n_valid, x.shape[1]), generator=gen, device=device), 0.1)
        ct = torch.randn((n_q, conv.weights.shape[2]), generator=gen, device=device)
        fns = {"band": lambda a, conv=conv, spec=spec: apply_band_kpconv(conv, spec, a, pyr, cfg,
                                                                          impl="kernel"),
               "gather": lambda a, conv=conv, spec=spec: apply_gather_kpconv(conv, spec, a, pyr,
                                                                              cfg)}
        yield spec, conv, x, ct, fns


def time_gather_kpconv(pyr, cfg, model, report):
    """The gather KPConv's device ms beside K2's route (K2 and its list
    stage) and, forward and backward, beside K2's and K4's, summed over the
    14 convs of ``gather_conv_cases`` on the kernel phase's pyramid, by
    ``held_ms``."""
    import torch

    ms = dict(gather=0.0, gather_bwd=0.0, band=0.0, band_bwd=0.0)
    for _, conv, x, ct, fns in gather_conv_cases(cfg, model, pyr):
        for name, fn in fns.items():
            def fwd_bwd(fn=fn):
                xb = x.clone().requires_grad_(True)
                (fn(xb) * ct).sum().backward()

            with torch.no_grad():
                ms[name] += held_ms(lambda fn=fn: fn(x), reps=3)
            ms[name + "_bwd"] += held_ms(fwd_bwd, reps=3)
        conv.weights.grad = None
    phase(f"gather KPConv device ms summed over the 14 convs: forward {ms['gather']:.4f}, "
          f"forward and backward {ms['gather_bwd']:.4f}; band route (K2 and its lists) "
          f"{ms['band']:.4f}, forward and backward (K2, K4) {ms['band_bwd']:.4f}")
    report["gather KPConv"] = ms


def gather_mixed(cfg, model, frags, batch, report, line, device="cuda"):
    """(a) The gather KPConv on the band pyramid of the serving batch: at
    each of the 14 convs against K2 and its autograd gradients against K4
    on the same sorted lists and windows (their device ms are
    ``time_gather_kpconv``'s, from phase 3); one extraction
    call with every conv on the gather KPConv against the band route's
    (K2 and K4 never launched); one f32 train step on the training pair
    against the band route's."""
    import copy

    import numpy as np
    import torch
    from d3feat_tpu_torch.models.kpfcnn import init_kpfcnn
    from d3feat_tpu_torch.ops.band_conv import band_conv, band_conv_bwd
    from d3feat_tpu_torch.ops.pyramid import build_pyramid, make_pyramid_spec
    from d3feat_tpu_torch.train.optim import make_optimizer, train_tensors
    from d3feat_tpu_torch.train.step import TrainState, make_extract_step, make_train_step

    b = packed_batch(frags[:2], cfg.caps.points[0], device)
    pyr = build_pyramid(b["points"], b["lengths"], spec=make_pyramid_spec(cfg, num_clouds=2))
    check(not bool(pyr["overflow"]), "gather (a): the serving batch's band pyramid overflowed")
    worst = dict(out=0.0, dx=0.0, dw=0.0)
    n_convs = 0
    for spec, conv, x, ct, fns in gather_conv_cases(cfg, model, pyr, device):
        n_convs += 1
        res = {}
        for name, fn in fns.items():
            xa = x.clone().requires_grad_(True)
            conv.weights.grad = None
            out = fn(xa)
            (out * ct).sum().backward()
            res[name] = (out.detach(), xa.grad, conv.weights.grad.clone())
        conv.weights.grad = None
        (ob, dxb, dwb), (og, dxg, dwg) = res["band"], res["gather"]
        label = f"gather KPConv {conv_label(spec, conv, dict(q_rows=ob))}"
        check(torch.allclose(og, ob, atol=3e-5, rtol=1e-4),
              f"{label}: max |gather - K2| = {float((og - ob).abs().max())}")
        check(torch.allclose(dxg, dxb, atol=5e-4, rtol=1e-3),
              f"{label}: dx max |gather - K4| = {float((dxg - dxb).abs().max())}")
        check(torch.allclose(dwg, dwb, atol=5e-4, rtol=1e-3),
              f"{label}: dW max |gather - K4| = {float((dwg - dwb).abs().max())}")
        for k, a, c in (("out", og, ob), ("dx", dxg, dxb), ("dw", dwg, dwb)):
            worst[k] = max(worst[k], float((a - c).abs().max()))
    ms = report["gather KPConv"]
    phase(f"gather (a): the gather KPConv at all {n_convs} convs of the band pyramid "
          f"against K2 (max diff {worst['out']:.3g}, atol 3e-5 rtol 1e-4) and its autograd "
          f"dx, dW against K4 (max {worst['dx']:.3g}, {worst['dw']:.3g}; atol 5e-4 rtol 1e-3); "
          f"device ms (phase 3): gather forward {ms['gather']:.4f}, forward and backward "
          f"{ms['gather_bwd']:.4f}; band {ms['band']:.4f}, forward and backward "
          f"{ms['band_bwd']:.4f}")
    line["mixed"] = dict(max_diff=worst, held_ms=ms)

    gcfg = route_config(cfg, bandconv_max_layer=-1)
    gmodel = init_kpfcnn(gcfg, device=device)  # the blocks read their model's config
    gmodel.load_state_dict(model.state_dict())
    ext_b, ext_g = make_extract_step(cfg), make_extract_step(gcfg)
    fb, sb, _ = ext_b(model, b)
    reset_launches()
    fg, sg, ov = ext_g(gmodel, b)
    torch.cuda.synchronize()
    k2k4 = (band_conv.launches + band_conv.launches_bf16 + band_conv.launches_list
            + band_conv_bwd.launches + band_conv_bwd.launches_list)
    check(k2k4 == 0, f"gather (a): the all-gather extraction launched K2/K4 {k2k4} times")
    check(not bool(ov), "gather (a): the all-gather extraction overflowed")
    lens = b["lengths"].tolist()
    d = float((fg - fb).abs().max())
    check(d <= 1e-4, f"gather (a): all-gather descriptors differ from the band route's by {d}")
    at = 0
    for n in lens:
        check(topk_agree(sg[at:at + n, 0].cpu().numpy(), sb[at:at + n, 0].cpu().numpy(), TOPK,
                         1e-4), "gather (a): top-250 sets differ from the band route's")
        at += n
    phase(f"gather (a): extraction with every conv on the gather KPConv "
          f"(bandconv_max_layer=-1), no K2/K4 launch: descriptors within {d:.3g} of the band "
          f"route's, top-{TOPK} sets agree")

    states = []
    for c, src in ((cfg, model), (gcfg, gmodel)):
        m = copy.deepcopy(src)
        states.append((TrainState(m, make_optimizer(c, m)), make_train_step(c)))
    (sb_, stb), (sg_, stg) = states
    _, mb = stb(sb_, batch, 0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _, mg = stg(sg_, batch, 0)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2**30
    fb_ = torch.cat([t.grad.reshape(-1) for _, t in train_tensors(sb_.model)])
    fg_ = torch.cat([t.grad.reshape(-1) for _, t in train_tensors(sg_.model)])
    gerr = float((fg_ - fb_).abs().max())
    check(np.isfinite(mg.loss) and abs(mg.loss - mb.loss) <= 1e-3 * abs(mb.loss),
          f"gather (a): all-gather step loss {mg.loss} vs the band route's {mb.loss}")
    check(torch.allclose(fg_, fb_, atol=5e-3, rtol=5e-3),
          f"gather (a): all-gather step gradients differ from the band route's by {gerr}")
    phase(f"gather (a): train step with every conv on the gather KPConv: loss {mg.loss:.6f} vs "
          f"the band route's {mb.loss:.6f}, max gradient diff {gerr:.3g}; peak memory "
          f"{peak:.2f} GiB")
    line["mixed"].update(extract_max_diff=d, step_loss=mg.loss, band_step_loss=mb.loss,
                         step_grad_max_diff=gerr, step_peak_gib=peak)


def gather_pyramids(cfg, frags, line, device="cuda"):
    """(b) The original-order pyramid of the serving batch for each search,
    on the card and on the CPU: every array and flag bit for bit; no
    overflow for ``banded``."""
    import torch
    from d3feat_tpu_torch.ops.pyramid import build_pyramid, make_pyramid_spec

    b = packed_batch(frags[:2], cfg.caps.points[0], "cpu")
    line["pyramids"] = {}
    for search in GATHER_SEARCHES:
        spec = make_pyramid_spec(route_config(cfg, neighbor_search=search), num_clouds=2)

        got = build_pyramid(b["points"].to(device), b["lengths"].to(device), spec=spec)
        ref = build_pyramid(b["points"], b["lengths"], spec=spec)
        check(got["band"] == {} and got["sel_thr"] == {}, f"{search} pyramid: band state")
        for k in ("points", "neighbors", "pools", "upsamples", "lengths", "masks"):
            for l, (a, c) in enumerate(zip(got[k], ref[k])):
                check(torch.equal(a.cpu(), c), f"{search} pyramid: {k}[{l}] differs from the CPU's")
        check(sorted(got["overflow_by"]) == sorted(ref["overflow_by"]) and all(
            bool(v) == bool(ref["overflow_by"][n]) for n, v in got["overflow_by"].items()),
            f"{search} pyramid: overflow flags differ from the CPU's")
        over = sorted(n for n, v in got["overflow_by"].items() if bool(v))
        if search == "banded":
            check(not over, f"banded pyramid overflowed at the bench capacities: {over}")
        phase(f"gather (b): {search} pyramid on the card equals the CPU's bit for bit (every "
              f"level's points, lists, lengths, masks, overflow flags); overflow {over or 'none'}")
        line["pyramids"][search] = dict(overflow=over)


def gather_serving(cfg, model, frags, line, device="cuda"):
    """(c) Serving on the gather route (``neighbor_search='banded'``, r5):
    one counted call without any K1-K5 launch or twin call; finite unit
    descriptors; then the recall pass held pair by pair to the
    JAX package's CPU route (``tests/torch_port_recall_r5_gather.json``)."""
    import numpy as np
    import torch
    from d3feat_tpu_torch.eval.extract import FeatureExtractor
    from d3feat_tpu_torch.final_recall import load_snapshot

    bcfg = route_config(cfg, neighbor_search="banded")
    ex = FeatureExtractor(bcfg, model, batch_fragments=2, device=device)
    groups = [frags[i:i + 2] for i in range(0, len(frags) - 1, 2)]
    for i in range(WARMUP):
        ex.extract_many(groups[i % len(groups)])
    torch.cuda.synchronize()
    with count_twins() as twins:
        reset_launches()
        out = ex.extract_many(groups[0])
        torch.cuda.synchronize()
        launched = kernel_launches()
    check(launched == 0 and not any(twins.values()),
          f"gather (c): the counted call launched {launched} kernels, twins {twins}")
    for (desc, scores), frag in zip(out, groups[0]):
        err = float(np.abs(np.linalg.norm(desc, axis=1) - 1.0).max())
        check(desc.shape == (len(frag), cfg.output_dim) and np.isfinite(desc).all()
              and np.isfinite(scores).all() and err < 1e-5,
              f"gather (c): descriptors non-finite or norms off by {err}")
    phase("gather (c): serving on the gather route: no kernel or twin in a counted call, finite "
          "unit descriptors")

    here = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(here, GATHER_REFERENCE)) as f:
        ref = json.load(f)
    rcfg, rmodel, _ = load_snapshot(os.path.join(here, "artifacts", "model_best_acc_r5.npz"),
                                    device)
    rcfg.neighbor_search = "banded"
    got = recall_pass(rcfg, rmodel, recall_scenes(), device)
    mean = recall_lines(got, "gather (c) recall")
    bad = hold_recall(ref["scenes"], got, ref["meta"]["route"], "gather route vs JAX's CPU route")
    check(not bad, "gather (c) recall vs the JAX CPU route: " + "; ".join(bad))
    phase("gather (c): recall held pair by pair to the JAX package's CPU route")
    line["serving"] = dict(mean_recall=mean,
                           scenes={s: {k: g[k] for k in ("gt_pairs", "matched_pairs", "recall")}
                                   for s, g in got.items()})


def gather_training(cfg, model, batch, line, device="cuda"):
    """(d) Training on the gather route, one pair at full width from r5: a
    counted step without any K1-K5 launch or twin call (finite loss, not
    skipped, no overflow), then ``TRAIN_STEPS`` steps (the same gates); peak
    memory and the loss's distance to a band-route step, printed."""
    import copy
    import math

    import torch
    from d3feat_tpu_torch.train.optim import make_optimizer
    from d3feat_tpu_torch.train.step import TrainState, make_train_step

    bcfg = route_config(cfg, neighbor_search="banded")
    band = copy.deepcopy(model)
    _, mb = make_train_step(cfg)(TrainState(band, make_optimizer(cfg, band)), batch, 0)
    m = copy.deepcopy(model)
    state = TrainState(m, make_optimizer(bcfg, m))
    step = make_train_step(bcfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with count_twins() as twins:
        reset_launches()
        state, mt = step(state, batch, 0)
        torch.cuda.synchronize()
        launched = kernel_launches()
    peak = torch.cuda.max_memory_allocated() / 2**30
    check(launched == 0 and not any(twins.values()),
          f"gather (d): the counted step launched {launched} kernels, twins {twins}")
    check(math.isfinite(mt.loss) and mt.skipped == 0.0 and mt.overflow == 0.0,
          f"gather (d): loss {mt.loss}, skipped {mt.skipped}, overflow {mt.overflow}")
    for i in range(TRAIN_STEPS):
        state, mt2 = step(state, batch, 0)
        check(math.isfinite(mt2.loss) and mt2.skipped == 0.0 and mt2.overflow == 0.0,
              f"gather (d) step {i + 1}: loss {mt2.loss}, skipped {mt2.skipped}")
    phase(f"gather (d): training on the gather route: no kernel or twin in a counted step, loss "
          f"{mt.loss:.6f} (band route {mb.loss:.6f}, not gated: the lists differ at the "
          f"boundary), peak memory {peak:.2f} GiB; {TRAIN_STEPS} more steps")
    line["training"] = dict(loss=mt.loss, band_loss=mb.loss, peak_gib=peak)


def k1_unsorted_searches(cfg, frags, device="cuda"):
    """K1's searches on clouds that are not pre-sorted, as the
    original-order route would make them of the serving batch: (name,
    queries, query lengths, supports, support lengths, radius, keyword
    arguments of ``radius_neighbors_pallas``) of its level 0's conv search
    and its pool0 search (queries the voxel-subsampled level)."""
    from d3feat_tpu_torch.ops.pyramid import level_band_cap, make_pyramid_spec
    from d3feat_tpu_torch.ops.subsample import voxel_subsample

    spec = make_pyramid_spec(cfg, num_clouds=2)
    b = packed_batch(frags[:2], cfg.caps.points[0], device)
    p0, l0 = b["points"], b["lengths"]
    r0 = spec.radii[0]
    sub = voxel_subsample(p0, l0, 2.0 * r0 / spec.conv_radius, out_capacity=spec.point_caps[1],
                          num_clouds=2)
    out = []
    for name, (q, ql), tile in (("conv0", (p0, l0), 256),
                                ("pool0", (sub.points, sub.lengths), 128)):
        ratio = -(-p0.shape[0] // q.shape[0])
        cap = level_band_cap(p0.shape[0], 2, spec.band_frac, tile=tile, ratio=ratio)
        out.append((name, q, ql, p0, l0, r0, dict(max_k=spec.neighbor_caps[0], num_clouds=2,
                                                  query_tile=tile, band_cap=cap)))
    return out


def check_k1_unsorted(cfg, frags, report):
    """K1 on clouds that are not pre-sorted (``radius_neighbors_pallas``),
    on ``k1_unsorted_searches``: kernel against twin bit for bit, through
    the wrapper (lists, overflow) and raw (positions, d2); each search's
    K1 call timed by ``held_ms``; the kernels line's ms are the sums over
    the two searches."""
    import torch
    from d3feat_tpu_torch.ops.neighbors import radius_neighbors_pallas, unsorted_select_args
    from d3feat_tpu_torch.ops.select import band_select

    total = 0.0
    for name, q, ql, s, sl, r, kw in k1_unsorted_searches(cfg, frags):
        got = radius_neighbors_pallas(q, s, ql, sl, r, impl="kernel", **kw)
        ref = radius_neighbors_pallas(q, s, ql, sl, r, impl="plain", **kw)
        check(torch.equal(got[0], ref[0]) and bool(got[1]) == bool(ref[1]),
              f"K1 unsorted {name}: kernel differs from the twin")
        a = unsorted_select_args(q, s, ql, sl, r, **kw)
        skw = {x: a[x] for x in ("q_rows", "s_rows", "starts", "wends", "query_tile", "r2",
                                 "max_k")}
        kp, kd = band_select(impl="kernel", **skw)
        pp, pd = band_select(impl="plain", **skw)
        check(torch.equal(kp, pp) and torch.equal(kd, pd), f"K1 unsorted {name}: raw outputs "
              "differ from the twin's")
        ms = held_ms(lambda: band_select(impl="kernel", **skw))
        total += ms
        phase(f"K1 select unsorted {name} ({q.shape[0]} queries x {kw['max_k']}, band "
              f"{kw['band_cap']}): bit-exact vs twin; {ms:.4f} ms")
    phase(f"K1 select unsorted, sum over conv0 and pool0: {total:.4f} ms")
    report["K1 select unsorted"] = dict(max_abs_err=0.0, ms=total)


def gather_k1(cfg, frags, report, line, device="cuda"):
    """(e) K1 on clouds that are not pre-sorted (``radius_neighbors_pallas``)
    on ``k1_unsorted_searches``: one counted call a search (one launch),
    kernel against twin bit for bit; each row's set equal to the banded
    search's wherever neither list is full. The kernel's own time is
    ``check_k1_unsorted``'s, taken in the kernel phase."""
    import torch
    from d3feat_tpu_torch.ops.neighbors import radius_neighbors_banded, radius_neighbors_pallas

    launches, trunc = 0, {}
    for name, q, ql, s, sl, r, kw in k1_unsorted_searches(cfg, frags, device):
        radius_neighbors_pallas.launches = 0
        got, gov = radius_neighbors_pallas(q, s, ql, sl, r, impl="kernel", **kw)
        torch.cuda.synchronize()
        check(radius_neighbors_pallas.launches == 1, f"K1 unsorted {name}: "
              f"{radius_neighbors_pallas.launches} launches counted in one call")
        launches += radius_neighbors_pallas.launches
        ref, rov = radius_neighbors_pallas(q, s, ql, sl, r, impl="plain", **kw)
        check(torch.equal(got, ref) and bool(gov) == bool(rov),
              f"K1 unsorted {name}: kernel differs from the twin")
        check(not bool(gov), f"K1 unsorted {name}: overflow")
        band, _ = radius_neighbors_banded(q, s, ql, sl, r, max_k=kw["max_k"], num_clouds=2,
                                          query_tile=kw["query_tile"], band_cap=kw["band_cap"])
        ns = s.shape[0]
        free = ((got == ns).any(1)) & ((band == ns).any(1))
        sg, sb = torch.sort(got, 1).values, torch.sort(band, 1).values
        check(torch.equal(sg[free], sb[free]),
              f"K1 unsorted {name}: sets differ from the banded search's on untruncated rows")
        trunc[name] = int((~free[:int(ql.sum())]).sum())
        phase(f"gather (e): K1 unsorted {name} ({q.shape[0]} queries x {kw['max_k']}, band "
              f"{kw['band_cap']}): one launch in a counted call, bit-exact vs twin, sets equal "
              f"the banded search's on the {int(free.sum())} rows where neither list is full "
              f"({trunc[name]} valid rows truncated)")
    k1 = report["K1 select unsorted"]
    k1["gather_phase_launches"] = launches
    phase(f"gather (e): K1 unsorted over conv0 and pool0: {launches} launches in the counted "
          f"calls, {k1['launches']} on the main path; {k1['ms']:.4f} ms (kernel phase)")
    line["k1_unsorted"] = dict(ms=k1["ms"], truncated=trunc, launches=launches,
                               main_path_launches=k1["launches"])


def gather_calibration(cfg, frags, line, device="cuda"):
    """(f) ``calibrate_caps`` on ``CALIBRATION_PAIRS`` eval-cache pairs of
    fragments, on the card and on the CPU: the same caps."""
    from d3feat_tpu_torch.data.calibrate import calibrate_caps

    pairs = []
    for i in range(CALIBRATION_PAIRS):
        b = packed_batch(frags[2 * i:2 * i + 2], cfg.caps.points[0], "cpu")
        pairs.append({"points": b["points"].numpy(), "lengths": b["lengths"].numpy()})
    got = calibrate_caps(pairs, cfg, device=device)
    ref = calibrate_caps(pairs, cfg, device="cpu")
    check((got.points, got.neighbors, got.corr) == (ref.points, ref.neighbors, ref.corr),
          f"gather (f): caps on the card {got} differ from the CPU's {ref}")
    phase(f"gather (f): calibrate_caps on {len(pairs)} eval-cache pairs: points {got.points}, "
          f"neighbors {got.neighbors}, equal on the card and the CPU")
    line["calibration"] = dict(points=list(got.points), neighbors=list(got.neighbors))


def gather_phase(cfg, model, frags, batch, report, card, device="cuda"):
    """The gather route (``neighbor_search`` ``'banded'``, ``'grid'``,
    ``'brute'`` and the gather KPConv), subphases (a)-(f) of the module
    docstring. Returns the JSON line's dict."""
    line = {"card": card}
    gather_mixed(cfg, model, frags, batch, report, line, device)
    gather_pyramids(cfg, frags, line, device)
    gather_serving(cfg, model, frags, line, device)
    gather_training(cfg, model, batch, line, device)
    gather_k1(cfg, frags, report, line, device)
    gather_calibration(cfg, frags, line, device)
    return line


# ---------------------------------------------------------------------------
# phase 11: batch norm, deformable KPConv, randomised kernel points, KPCNN
# ---------------------------------------------------------------------------

DEFORM_LAYERS = (3, 4)    # the levels whose blocks are deformable in (b)
VARIANT_STEPS = 5         # train steps after a counted one in (b)
KPCNN_LABELS = (3, 17)    # the fixed synthetic labels of the two clouds in (d)
KPCNN_SGD_STEPS = 3


def counted(label, fn, acc):
    """``counted_run(fn)``, its counts added into ``acc``, no twin called;
    returns (its result, the counts)."""
    with count_twins() as twins:
        out, c = counted_run(fn)
    check(not any(twins.values()), f"{label}: plain twins called on the card: {twins}")
    for k, v in c.items():
        acc[k] = acc.get(k, 0) + v
    phase(f"{label}, launches: " + ", ".join(f"{k} {v}" for k, v in c.items() if v))
    return out, c


def need(c, label, names):
    for n in names:
        check(c[n] > 0, f"{label}: {n} was not launched")


def rigid_band_convs(model, pyr, cfg):
    """The number of the model's convs that ``band_conv_eligible`` gives to
    K2 (and K4) on the band pyramid ``pyr``."""
    from d3feat_tpu_torch.models.blocks import band_conv_eligible

    return sum(1 for spec, blk in zip(model.specs.encoder, model.encoder)
               if hasattr(blk, "conv") and band_conv_eligible(spec, pyr, cfg))


def warm_from_r5(model, rename=lambda name: name):
    """Copy the r5 weights into ``model`` wherever it has a tensor of the
    same name (after ``rename``; a bias norm's ``bias`` lands on a batch
    norm's ``offset``) and shape; the rest keeps its seeded draw. At a
    random draw a train step of these models is near-tie noise (a twin
    step from weights one ulp away lies as far from the twins' as the
    kernels' step, PERF.md), so the train gates start from trained weights.
    Returns the count of tensors copied."""
    import torch
    from d3feat_tpu_torch.compat.portable import read_npz

    params = read_npz(os.path.join(os.path.dirname(os.path.abspath(__file__)), "artifacts",
                                   "model_best_acc_r5.npz"))[0]
    sd = model.state_dict()
    n = 0
    with torch.no_grad():
        for k, v in params.items():
            k = rename(k)
            if k not in sd and k.endswith((".norm.bias", ".norm_conv.bias")):
                k = k[:-len("bias")] + "offset"
            if k in sd and tuple(sd[k].shape) == v.shape:
                sd[k].copy_(torch.from_numpy(v))
                n += 1
    return n


def hold_step(label, m, tm, model, twin, witness, noisy=False):
    """A kernel train step (metrics ``m``, ``model`` after it) against the
    twins' (``tm``, ``twin``) from the same state: loss rtol 1e-3, the flat
    gradient atol/rtol 5e-3, the batch norms' running statistics within
    1e-5. ``witness``: the model after a twin step from weights one ulp
    away, whose distance to the twins' is the step's own noise, printed
    beside. ``noisy`` (a step that sits on near-ties, as a random draw's
    does): the gradient held to that noise instead, as ``hold_bf16_step``
    holds the bf16 step: within twice the witness's distance, or atol/rtol
    5e-3 where the step is not that sensitive. Returns (max gradient diff,
    the witness's, max statistics diff, the three leaves farthest from the
    twins' with the witness's distance beside)."""
    import math

    import torch
    from d3feat_tpu_torch.train.optim import train_tensors

    check(math.isfinite(m.loss) and m.skipped == 0.0 and m.overflow == 0.0,
          f"{label}: loss {m.loss}, skipped {m.skipped}, overflow {m.overflow}")
    check(abs(m.loss - tm.loss) <= 1e-3 * abs(tm.loss), f"{label}: loss {m.loss} vs the "
          f"twins' {tm.loss}")
    g, gt = flat_grads(model), flat_grads(twin)
    gerr = float((g - gt).abs().max())
    werr = float((flat_grads(witness) - gt).abs().max())
    ok = torch.allclose(g, gt, atol=5e-3, rtol=5e-3) or (noisy and gerr <= 2.0 * werr)
    check(ok, f"{label}: gradients differ from the twins' by {gerr} (a twin step one ulp away "
              f"by {werr})")
    check(float(gt.abs().max()) > 1e-4, f"{label}: vacuous gradient comparison")
    tb = dict(twin.named_buffers())
    serr = max((float((b - tb[n]).abs().max()) for n, b in model.named_buffers()
                if n.endswith((".mean", ".var"))), default=0.0)
    check(serr <= 1e-5, f"{label}: running statistics differ from the twins' by {serr}")
    leaf = [dict(train_tensors(mm)) for mm in (model, twin, witness)]
    worst = sorted(((float((leaf[0][n].grad - t.grad).abs().max()),
                     float((leaf[2][n].grad - t.grad).abs().max()), n)
                    for n, t in leaf[1].items() if t.grad is not None), reverse=True)[:3]
    return gerr, werr, serr, ", ".join(f"{n} {e:.3g} (one ulp away {u:.3g})"
                                       for e, u, n in worst)


def twin_steps(cfg, spec, model, batch):
    """(twin model, its metrics, witness model) after one twin step from
    ``model``'s state and one from its weights moved by one f32 ulp."""
    import copy
    import math

    import torch
    from d3feat_tpu_torch.train.optim import make_optimizer
    from d3feat_tpu_torch.train.step import TrainState, make_train_step

    twin, witness = copy.deepcopy(model), copy.deepcopy(model)
    with torch.no_grad():
        for t in witness.parameters():
            t.copy_(torch.nextafter(t, torch.full_like(t, math.inf)))
    step = make_train_step(cfg, spec, impl="plain")
    _, tm = step(TrainState(twin, make_optimizer(cfg, twin)), batch, 0)
    step(TrainState(witness, make_optimizer(cfg, witness)), batch, 0)
    return twin, tm, witness


def hold_extraction(label, out, tout, lengths):
    """Descriptors within 1e-4 of the twins' and, per fragment, the same
    top-250 sets; finite, unit norm on the valid rows."""
    import numpy as np

    f, s, o = (t.cpu().numpy() for t in out)
    tf, ts, _ = (t.cpu().numpy() for t in tout)
    check(not bool(o), f"{label}: overflow")
    n = int(sum(lengths))
    check(np.isfinite(f).all() and np.isfinite(s).all(), f"{label}: non-finite outputs")
    check(np.abs(np.linalg.norm(f[:n], axis=1) - 1.0).max() < 1e-5, f"{label}: not unit norm")
    err = float(np.abs(f - tf).max())
    check(err <= 1e-4, f"{label}: descriptors differ from the twins' by {err}")
    start = 0
    for ln in lengths:
        check(topk_agree(s[start:start + ln, 0], ts[start:start + ln, 0], TOPK, 1e-4),
              f"{label}: top-{TOPK} sets differ from the twins'")
        start += ln
    return err


def more_steps(step, state, batch, n):
    """``n`` more train steps, each finite, not skipped, without overflow."""
    import math

    for i in range(n):
        state, m = step(state, batch, 0)
        check(math.isfinite(m.loss) and m.skipped == 0.0 and m.overflow == 0.0,
              f"step {i + 1} after the counted one: loss {m.loss}, skipped {m.skipped}, "
              f"overflow {m.overflow}")


def variants_bn(cfg, frags, batch, line, acc, device="cuda", keep=None):
    """(a) A ``use_batch_norm`` KPFCNN drawn from a seed: one counted train
    step against the twins, ``TRAIN_STEPS`` more, then one
    eval-mode extraction of the serving batch with the running statistics
    against the twins. The trained model and its config go into ``keep``."""

    import torch
    from d3feat_tpu_torch.models.kpfcnn import init_kpfcnn
    from d3feat_tpu_torch.ops.pyramid import make_pyramid_spec
    from d3feat_tpu_torch.train.optim import make_optimizer
    from d3feat_tpu_torch.train.step import TrainState, make_extract_step, make_train_step

    bcfg = route_config(cfg, use_batch_norm=True)
    spec = make_pyramid_spec(bcfg)
    model = init_kpfcnn(bcfg, seed=0, device=device)
    if keep is not None:
        keep["batch_norm"] = (bcfg, model)
    n_r5 = warm_from_r5(model)  # batch norms: scale 1, offset r5's bias, statistics 0 and 1
    twin, tm, witness = twin_steps(bcfg, spec, model, batch)
    state = TrainState(model, make_optimizer(bcfg, model))
    step = make_train_step(bcfg, spec)
    (state, m), c = counted("variants (a) batch norm, train step",
                            lambda: step(state, batch, 0), acc)
    need(c, "variants (a) train step", ("K1 select", "K2/K4 band_lists", "K2 band_conv",
                                         "K3 band_head", "K4 band_lists transpose",
                                         "K4 band_conv_bwd", "K5 band_head_bwd"))
    gerr, werr, serr, worst = hold_step("variants (a) train step", m, tm, model, twin, witness)
    more_steps(step, state, batch, TRAIN_STEPS)
    phase(f"variants (a): BN model, {n_r5} tensors from r5; train step vs twins: loss "
          f"{m.loss:.6f} vs {tm.loss:.6f}, max gradient diff {gerr:.3g} (a twin step one ulp "
          f"away {werr:.3g}; worst leaves {worst}), running statistics within {serr:.3g}; "
          f"{TRAIN_STEPS} more steps")
    # the seeded draw itself: its step sits on near-ties, held to its own noise
    drawn = init_kpfcnn(bcfg, seed=0, device=device)
    dtwin, dtm, dwitness = twin_steps(bcfg, spec, drawn, batch)
    _, dm = step(TrainState(drawn, make_optimizer(bcfg, drawn)), batch, 0)
    dgerr, dwerr, dserr, dworst = hold_step("variants (a) train step, seeded draw", dm, dtm,
                                            drawn, dtwin, dwitness, noisy=True)
    phase(f"variants (a): BN model as drawn from seed 0, train step vs twins: loss "
          f"{dm.loss:.6f} vs {dtm.loss:.6f}, max gradient diff {dgerr:.3g} (a twin step one "
          f"ulp away {dwerr:.3g}, gate twice that or 5e-3; worst leaves {dworst}), running "
          f"statistics within {dserr:.3g}")

    serving = packed_batch(frags[:2], bcfg.caps.points[0], device)
    lengths = serving["lengths"].tolist()
    before = {n: b.clone() for n, b in model.named_buffers()}
    out, c = counted("variants (a) batch norm, extraction",
                     lambda: make_extract_step(bcfg, num_clouds=2)(model, serving), acc)
    need(c, "variants (a) extraction", ("K1 select", "K2 band_conv", "K3 band_head"))
    check(all(torch.equal(b, before[n]) for n, b in model.named_buffers()),
          "variants (a): extraction moved the running statistics")
    tout = make_extract_step(bcfg, num_clouds=2, impl="plain")(model, serving)
    err = hold_extraction("variants (a) extraction", out, tout, lengths)
    phase(f"variants (a): BN extraction with the running statistics vs twins: max descriptor "
          f"diff {err:.3g}, top-{TOPK} sets agree")
    line["batch_norm"] = dict(loss=m.loss, twin_loss=tm.loss, grad_diff=gerr,
                              witness_grad_diff=werr, stats_diff=serr,
                              seeded_draw=dict(loss=dm.loss, twin_loss=dtm.loss,
                                               grad_diff=dgerr, witness_grad_diff=dwerr,
                                               stats_diff=dserr),
                              descriptor_diff=err)


def deform_config(cfg, **fields):
    """``cfg`` with the blocks of levels ``DEFORM_LAYERS`` deformable
    (``resnetb_deformable_strided``, ``resnetb_deformable``,
    ``resnetb_deformable``), the placement of KPConv's deformable
    architectures."""
    from d3feat_tpu_torch.config import D3FeatConfig

    class DeformConfig(D3FeatConfig):
        def architecture(self):
            arch = D3FeatConfig.architecture(self)
            for l in DEFORM_LAYERS:  # level l's blocks sit at 2 + 3 (l - 1) ...
                i = 2 + 3 * (l - 1)
                arch[i:i + 3] = ["resnetb_deformable_strided", "resnetb_deformable",
                                 "resnetb_deformable"]
            return arch

    c = DeformConfig.from_dict(cfg.to_dict())
    for k, v in fields.items():
        setattr(c, k, v)
    return c


def deform_caps(cfg, samples, device="cuda"):
    """Neighbour caps for the deformable config from ``calibrate_caps`` on
    ``samples`` at keep ratio 1 (the largest count, so the samples do not
    overflow), times 1.15 for the pool searches' barycentre queries: at the
    conv radius on the levels that ``make_pyramid_spec`` leaves unscaled,
    at ``deform_radius`` (the same voxels, the wider radius) on the levels
    whose conv or pool search it widens."""
    import math

    from d3feat_tpu_torch.config import PyramidCaps
    from d3feat_tpu_torch.data.calibrate import calibrate_caps
    from d3feat_tpu_torch.ops.pyramid import make_pyramid_spec
    from d3feat_tpu_torch.ops.select import KMAX

    spec = make_pyramid_spec(cfg)
    rigid = calibrate_caps(samples, cfg, keep_ratio=1.0, device=device)
    wide = calibrate_caps(samples, route_config(cfg, conv_radius=cfg.deform_radius),
                          keep_ratio=1.0, device=device)
    caps = [math.ceil(1.15 * (w if (spec.conv_r_scale[l] != 1.0 or spec.pool_r_scale[l] != 1.0)
                              else r))
            for l, (r, w) in enumerate(zip(rigid.neighbors, wide.neighbors))]
    check(max(caps) <= KMAX, f"variants (b): calibrated caps {caps} exceed K1's {KMAX}")
    return PyramidCaps(points=cfg.caps.points, neighbors=tuple(caps), corr=cfg.caps.corr)


def variants_deform(cfg, frags, batch, line, acc, device="cuda", keep=None):
    """(b) Levels ``DEFORM_LAYERS`` deformable, unmodulated and modulated,
    with calibrated caps: one counted extraction and one counted train step
    each against the twins, ``VARIANT_STEPS`` more steps and peak memory.
    The trained models and their configs go into ``keep``."""
    import math

    import torch
    from d3feat_tpu_torch.losses.regularizers import p2p_fitting_regularizer
    from d3feat_tpu_torch.models.kpfcnn import apply_kpfcnn, init_kpfcnn
    from d3feat_tpu_torch.ops.band_lists import LCAP
    from d3feat_tpu_torch.ops.deform_conv import deform_sums
    from d3feat_tpu_torch.ops.neighbors import permute_rows
    from d3feat_tpu_torch.ops.pyramid import build_pyramid, make_pyramid_spec
    from d3feat_tpu_torch.train.optim import make_optimizer
    from d3feat_tpu_torch.train.step import TrainState, make_extract_step, make_train_step

    serving = packed_batch(frags[:2], cfg.caps.points[0], device)
    lengths = serving["lengths"].tolist()
    samples = [{k: b[k].cpu().numpy() for k in ("points", "lengths")} for b in (serving, batch)]
    caps = deform_caps(deform_config(cfg), samples, device)
    phase(f"variants (b): architecture {deform_config(cfg).architecture()[2:14]}; calibrated "
          f"neighbour caps {caps.neighbors} (bench {cfg.caps.neighbors})")
    line["deformable"] = {"neighbor_caps": list(caps.neighbors)}
    for modulated in (False, True):
        tag = "modulated" if modulated else "unmodulated"
        dcfg = deform_config(cfg, caps=caps, modulated=modulated)
        spec = make_pyramid_spec(dcfg)
        model = init_kpfcnn(dcfg, seed=1, device=device)
        warm_from_r5(model)  # the offset convs keep their seeded draw
        if keep is not None:
            keep[f"deformable {tag}"] = (dcfg, model)
        n_def = sum(1 for blk in model.encoder if getattr(getattr(blk, "conv", None),
                                                          "deformable", False))
        pyr = build_pyramid(batch["points"], batch["lengths"], spec=spec)
        check(not bool(pyr["overflow"]), f"variants (b) {tag}: the training pair overflows "
              f"{[k for k, v in pyr['overflow_by'].items() if bool(v)]}")
        if not modulated:  # K1 at the wide caps (4 and 8 slots a lane) against its twin
            twin_pyr = build_pyramid(batch["points"], batch["lengths"], spec=spec,
                                     impl="plain")
            for key in ("neighbors", "pools", "upsamples"):
                check(all(torch.equal(a, b) for a, b in zip(pyr[key], twin_pyr[key])),
                      f"variants (b): K1's {key} lists differ from the twin's")
            check(all(torch.equal(a, b) for k in pyr["sel_thr"]
                      for a, b in zip(pyr["sel_thr"][k], twin_pyr["sel_thr"][k])),
                  "variants (b): K1's thresholds differ from the twin's")
            phase(f"variants (b): the pyramid's 13 K1 searches at caps {caps.neighbors} equal "
                  f"the twin's bit for bit (lists and thresholds)")
            # each kernel at the searches wider than 64, on the card against its twin
            wide = {}
            check_k1(pyr, spec, wide)
            check_lists(pyr, dcfg, model, wide, min_width=LCAP)
            check_list_stage(pyr, dcfg, model, wide, min_width=LCAP)
            for panel in PANELS:
                for mode in ("threshold", "list"):
                    check_k2(pyr, dcfg, model, wide, panel=panel, mode=mode, min_width=LCAP)
                    check_k4(pyr, dcfg, model, wide, panel=panel, mode=mode, min_width=LCAP)
            line["deformable"]["kernels"] = wide
        n_band = rigid_band_convs(model, pyr, dcfg)
        n_rigid = sum(1 for blk in model.encoder if hasattr(blk, "conv")) - n_def
        check(n_band == n_rigid > 0 and n_def == 3 * len(DEFORM_LAYERS),
              f"variants (b) {tag}: {n_band} band convs of {n_rigid} rigid, {n_def} deformable")

        k6 = deform_sums.launches
        out, c = counted(f"variants (b) {tag}, extraction",
                         lambda: make_extract_step(dcfg, num_clouds=2)(model, serving), acc)
        need(c, f"variants (b) {tag} extraction", ("K1 select", "K3 band_head"))
        check(deform_sums.launches - k6 == 2 * n_def, f"variants (b) {tag} extraction: K6 "
              f"launched {deform_sums.launches - k6} times for {n_def} deformable convs")
        check(c["K2 band_conv"] == n_band, f"variants (b) {tag} extraction: K2 launched "
              f"{c['K2 band_conv']} times for {n_band} rigid band convs")
        tout = make_extract_step(dcfg, num_clouds=2, impl="plain")(model, serving)
        err = hold_extraction(f"variants (b) {tag} extraction", out, tout, lengths)

        with torch.no_grad():
            order0 = pyr["band"][0]["order"]
            fwd = apply_kpfcnn(model, dict(pyr, features=permute_rows(batch["features"],
                                                                      order0)), train=True)
            reg = float(p2p_fitting_regularizer(fwd.auxes, KP_extent=dcfg.KP_extent))
        check(len(fwd.auxes) == n_def and math.isfinite(reg) and reg > 0.0,
              f"variants (b) {tag}: regularizer {reg} over {len(fwd.auxes)} convs")

        twin, tm, witness = twin_steps(dcfg, spec, model, batch)
        state = TrainState(model, make_optimizer(dcfg, model))
        step = make_train_step(dcfg, spec)
        torch.cuda.reset_peak_memory_stats()
        (state, m), c = counted(f"variants (b) {tag}, train step",
                                lambda: step(state, batch, 0), acc)
        peak = torch.cuda.max_memory_allocated() / 2**30
        need(c, f"variants (b) {tag} train step", ("K1 select", "K5 band_head_bwd"))
        check(c["K2 band_conv"] == c["K4 band_conv_bwd"] == n_band,
              f"variants (b) {tag} train step: K2 {c['K2 band_conv']}, K4 "
              f"{c['K4 band_conv_bwd']} launches for {n_band} rigid band convs")
        gerr, werr, _, worst = hold_step(f"variants (b) {tag} train step", m, tm, model, twin,
                                         witness)
        more_steps(step, state, batch, VARIANT_STEPS)
        phase(f"variants (b) {tag}: extraction vs twins max descriptor diff {err:.3g}; "
              f"regularizer {reg:.6g}; train step loss {m.loss:.6f} vs twins {tm.loss:.6f}, "
              f"max gradient diff {gerr:.3g} (a twin step one ulp away {werr:.3g}; worst "
              f"leaves {worst}); {VARIANT_STEPS} more steps, peak memory {peak:.2f} GiB in the "
              f"step")
        line["deformable"][tag] = dict(band_convs=n_band, deformable_convs=n_def,
                                       descriptor_diff=err, regularizer=reg, loss=m.loss,
                                       twin_loss=tm.loss, grad_diff=gerr,
                                       witness_grad_diff=werr, peak_gib=peak)


def variants_kernel_points(cfg, frags, line, acc, device="cuda"):
    """(c) ``init_kpfcnn`` with randomised kernel points on the card: every
    conv's kernel points equal those of the same call on the CPU bit for
    bit; one counted extraction through K2 and K3 on them."""
    import numpy as np

    import torch
    from d3feat_tpu_torch.models.kpfcnn import init_kpfcnn
    from d3feat_tpu_torch.train.step import make_extract_step

    rcfg = route_config(cfg, deterministic_kernel_points=False, seed=11)
    model = init_kpfcnn(rcfg, device=device)
    cpu = init_kpfcnn(rcfg, device="cpu")
    det = init_kpfcnn(cfg, device="cpu")
    convs = [(b.conv, c.conv, d.conv) for b, c, d in zip(model.encoder, cpu.encoder, det.encoder)
             if hasattr(b, "conv")]
    check(all(torch.equal(a.kernel_points.cpu(), b.kernel_points) for a, b, _ in convs),
          "variants (c): kernel points on the card differ from the CPU's")
    check(not any(torch.equal(b.kernel_points, d.kernel_points) for _, b, d in convs),
          "variants (c): kernel points not randomised")
    serving = packed_batch(frags[:2], rcfg.caps.points[0], device)
    (f, s, o), c = counted("variants (c) randomised kernel points, extraction",
                           lambda: make_extract_step(rcfg, num_clouds=2)(model, serving), acc)
    need(c, "variants (c) extraction", ("K1 select", "K2 band_conv", "K3 band_head"))
    n = int(serving["lengths"].sum())
    fn = f[:n].cpu().numpy()
    check(not bool(o) and np.isfinite(fn).all() and
          np.abs(np.linalg.norm(fn, axis=1) - 1.0).max() < 1e-5,
          "variants (c): extraction outputs not finite unit descriptors")
    phase(f"variants (c): kernel points of {len(convs)} convs equal the CPU's bit for bit; "
          f"extraction through K2 ({c['K2 band_conv']}) and K3 ({c['K3 band_head']})")
    line["kernel_points"] = dict(convs=len(convs))


def variants_kpcnn(cfg, frags, line, acc, device="cuda"):
    """(d) KPCNN at full width on the serving batch's two fragments as
    clouds with fixed labels: a counted forward on the band route against
    the twins, a counted loss and backward against the twins', a few SGD
    steps, the logits on ``'banded'`` against the band route's."""
    import copy
    import math

    import torch
    from d3feat_tpu_torch.models.kpcnn import apply_kpcnn, init_kpcnn, kpcnn_accuracy, kpcnn_loss
    from d3feat_tpu_torch.ops.neighbors import permute_rows
    from d3feat_tpu_torch.ops.pyramid import build_pyramid, make_pyramid_spec

    kcfg = route_config(cfg, num_classes=40)
    serving = packed_batch(frags[:2], kcfg.caps.points[0], device)
    labels = torch.tensor(KPCNN_LABELS, device=device)
    model = init_kpcnn(kcfg, seed=2, device=device)
    warm_from_r5(model, lambda name: name.replace("encoder.", "blocks.", 1))  # head: seeded
    width = kcfg.first_features_dim * 2 ** (kcfg.num_layers - 1)  # 2048 at the default
    check(model.specs.head_in_dim == width and model.head_softmax.linear.w.shape == (1024, 40),
          "variants (d): not the full-width KPCNN")
    twin = copy.deepcopy(model)
    spec = make_pyramid_spec(kcfg, num_clouds=2)

    def forward(m, impl="auto", train=False, sp=spec):
        pyr = build_pyramid(serving["points"], serving["lengths"], spec=sp, impl=impl)
        order0 = pyr["band"][0]["order"] if pyr["band"] else None
        feats = serving["features"] if order0 is None else permute_rows(serving["features"],
                                                                         order0)
        return apply_kpcnn(m, dict(pyr, features=feats), train=train, impl=impl)

    out, c = counted("variants (d) KPCNN, forward", lambda: forward(model), acc)
    need(c, "variants (d) forward", ("K1 select", "K2 band_conv"))
    tlogits = forward(twin, "plain").logits
    err = float((out.logits - tlogits).abs().max())
    check(out.logits.shape == (2, 40) and bool(torch.isfinite(out.logits).all()),
          "variants (d): logits shape or values")
    check(err <= 1e-4, f"variants (d): logits differ from the twins' by {err}")

    def loss_backward(m, impl="auto"):
        o = forward(m, impl, train=True)
        loss, ce = kpcnn_loss(o.logits, labels, o.auxes, kcfg)
        loss.backward()
        return float(loss.detach()), float(kpcnn_accuracy(o.logits.detach(), labels))

    (loss, acc_), c = counted("variants (d) KPCNN, loss and backward",
                              lambda: loss_backward(model), acc)
    need(c, "variants (d) loss and backward", ("K1 select", "K2 band_conv", "K4 band_conv_bwd"))
    tloss, _ = loss_backward(twin, "plain")
    g, gt = (torch.cat([p.grad.reshape(-1) for p in m.parameters()]) for m in (model, twin))
    gerr = float((g - gt).abs().max())
    check(math.isfinite(loss) and abs(loss - tloss) <= 1e-3 * abs(tloss),
          f"variants (d): loss {loss} vs the twins' {tloss}")
    check(torch.allclose(g, gt, atol=5e-3, rtol=5e-3) and float(gt.abs().max()) > 1e-4,
          f"variants (d): gradients differ from the twins' by {gerr}")

    opt = torch.optim.SGD(model.parameters(), lr=0.01)
    losses = []
    for _ in range(KPCNN_SGD_STEPS):
        opt.zero_grad(set_to_none=True)
        losses.append(loss_backward(model)[0])
        opt.step()
    check(all(math.isfinite(v) for v in losses), f"variants (d): SGD losses {losses}")

    gcfg = route_config(kcfg, neighbor_search="banded")
    with torch.no_grad():
        band = forward(model).logits
        banded = forward(model, sp=make_pyramid_spec(gcfg, num_clouds=2)).logits
    berr = float((band - banded).abs().max())
    check(berr <= 1e-4, f"variants (d): 'banded' logits differ from the band route's by {berr}")
    phase(f"variants (d): KPCNN logits vs twins {err:.3g}; loss {loss:.6f} vs twins "
          f"{tloss:.6f}, max gradient diff {gerr:.3g}; SGD losses "
          + ", ".join(f"{v:.5f}" for v in losses)
          + f"; 'banded' vs band route {berr:.3g}")
    line["kpcnn"] = dict(logits_diff=err, loss=loss, twin_loss=tloss, grad_diff=gerr,
                         accuracy=acc_, sgd_losses=losses, banded_diff=berr)


def variants_phase(cfg, frags, batch, report, card, device="cuda", keep=None):
    """Phase 11: batch norm, deformable KPConv, randomised kernel points
    and KPCNN on the card, subphases (a)-(d) of the module docstring; each
    kernel's launches in the phase's counted runs go into ``report`` as
    ``variants_phase_launches``; the batch norm and deformable models, as
    trained, into ``keep`` (for phase 12). Returns the JSON line's dict."""
    line = {"card": card}
    acc = {}
    variants_bn(cfg, frags, batch, line, acc, device, keep)
    variants_deform(cfg, frags, batch, line, acc, device, keep)
    variants_kernel_points(cfg, frags, line, acc, device)
    variants_kpcnn(cfg, frags, line, acc, device)
    for name, *_ in KERNELS:
        if name in report:
            report[name]["variants_phase_launches"] = acc.get(name, 0)
    line["launches"] = {k: v for k, v in acc.items() if v}
    return line


BRIDGE_LABELS_SEED = 13   # the seeded labels that (d) scores KPCNN's logits against
CLI_TIMEOUT_S = 300       # each command line of (b)
PORT_KERNELS_RE = r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?(\w+)\s*\("


def round_trip(label, path, model, mcfg, device="cuda", **kw):
    """``model`` out through ``save_torch_checkpoint`` to ``path`` and back
    through ``load_torch_checkpoint``; every tensor must come back bit for
    bit (dtype and device included). Returns (the loaded model, meta, the
    file's bytes)."""
    import torch
    from d3feat_tpu_torch.compat.torch_export import save_torch_checkpoint
    from d3feat_tpu_torch.compat.torch_import import load_torch_checkpoint

    save_torch_checkpoint(path, model, mcfg, **kw)
    loaded, meta = load_torch_checkpoint(path, mcfg, device=device)
    want, got = model.state_dict(), loaded.state_dict()
    bad = [k for k in want if not (got[k].dtype == want[k].dtype and got[k].device == want[k].device
                                   and torch.equal(got[k], want[k]))]
    check(set(got) == set(want) and not bad, f"{label}: the .pth round trip changed {bad[:4]}")
    return loaded, meta, os.path.getsize(path)


def bridges_round_trip(cfg, model, frags, models, tmp, line, acc, card, device="cuda"):
    """(a) The r5 model out to a reference-layout ``.pth`` and back, bit for
    bit; the serving batch through ``FeatureExtractor`` with both models,
    each call counted, descriptors and scores equal; then phase 11's batch
    norm and deformable models, tensors only. Returns the .pth's path and
    the extractor of the loaded model."""
    import numpy as np
    import torch
    from d3feat_tpu_torch.compat.portable import read_npz
    from d3feat_tpu_torch.eval.extract import FeatureExtractor

    params = read_npz(os.path.join(os.path.dirname(os.path.abspath(__file__)), "artifacts",
                                   "model_best_acc_r5.npz"))[0]
    sd = model.state_dict()
    check(all(torch.equal(sd[k].cpu(), torch.from_numpy(v)) for k, v in params.items()),
          "bridges (a): the serving model no longer holds the r5 npz's weights")
    pth = os.path.join(tmp, "model_best_acc_r5.pth")
    loaded, meta, size = round_trip("bridges (a) r5", pth, model, cfg, device, epoch=114,
                                    best_loss=0.0)
    check(meta == {"epoch": 114, "best_loss": 0.0}, f"bridges (a): meta {meta}")
    n_values = sum(v.numel() for v in model.state_dict().values())
    phase(f"bridges (a): r5 ({n_values} values, {len(model.state_dict())} tensors) to a "
          f"{size} byte .pth and back onto the card, bit for bit, on {card}")
    group = frags[:2]
    outs, exs = {}, {}
    for tag, m in (("npz", model), ("pth", loaded)):
        exs[tag] = FeatureExtractor(cfg, m, batch_fragments=2, device=device)
        outs[tag], c = counted(f"bridges (a) extraction, r5 from the {tag}",
                               lambda: exs[tag].extract_many(group), acc)
        need(c, f"bridges (a) extraction ({tag})", ("K1 select", "K2/K4 band_lists",
                                                    "K2 band_conv", "K3 band_head"))
    diff = max(max(float(np.abs(a - b).max()) for a, b in zip(x, y))
               for x, y in zip(outs["npz"], outs["pth"]))
    check(diff == 0.0, f"bridges (a): extraction from the .pth differs by {diff}")
    phase(f"bridges (a): the serving batch ({', '.join(str(len(f)) for f in group)} points) "
          f"from the .pth weights equals the npz weights' bit for bit (descriptors and "
          f"scores, max |diff| {diff})")
    line["r5"] = dict(values=n_values, tensors=len(model.state_dict()), pth_bytes=size,
                      extraction_max_abs_diff=diff)
    for tag, (mcfg, m) in models.items():
        sz = round_trip(f"bridges (a) {tag}", os.path.join(tmp, f"{tag}.pth"), m, mcfg,
                        device)[2]
        phase(f"bridges (a): phase 11's {tag} model, {sz} bytes, saved and loaded bit for bit, "
              f"on {card}")
        line[tag] = dict(pth_bytes=sz)
    return pth, exs["pth"], group


def bridges_cli_start(pth, tmp, device="cuda"):
    """(b) Both command lines started together: ``--synthetic`` on the .pth
    (the r5 npz's config as the run's ``config.json``) and on the npz, on
    ``device``."""
    import subprocess
    from d3feat_tpu_torch.compat.portable import read_npz

    here = os.path.dirname(os.path.abspath(__file__))
    npz = os.path.join(here, "artifacts", "model_best_acc_r5.npz")
    run = os.path.join(tmp, "r5_run")
    os.makedirs(run)
    with open(os.path.join(run, "config.json"), "w") as f:
        json.dump(read_npz(npz)[2]["config"], f)
    base = [sys.executable, "-m", "d3feat_tpu_torch.test_3dmatch", "--synthetic",
            *(["--cpu"] if device == "cpu" else [])]
    cmds = {"pth": base + ["--chosen_snapshot", run, "--torch_checkpoint", pth],
            "npz": base + ["--snapshot", npz]}
    return {k: subprocess.Popen(c, cwd=here, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                text=True)
            for k, c in cmds.items()}


def bridges_cli_finish(procs, line, card):
    import subprocess

    got = {}
    for k, p in procs.items():
        try:
            out, err = p.communicate(timeout=CLI_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            fail(f"bridges (b): the {k} command line ran past {CLI_TIMEOUT_S} s")
        check(p.returncode == 0, f"bridges (b): the {k} command line exited "
              f"{p.returncode}:\n{err[-3000:]}")
        got[k] = json.loads(out.strip().splitlines()[-1])
    check(got["pth"] == got["npz"], f"bridges (b): --torch_checkpoint {got['pth']} vs "
          f"--snapshot {got['npz']}")
    phase(f"bridges (b): test_3dmatch --synthetic on the .pth equals it on the npz: "
          f"{json.dumps(got['pth'])} (run together beside (c), on {card})")
    line["cli"] = dict(result=got["pth"])


def native_row_diffs(a, b, thr, nat, npy):
    """Rows where ``_nn_within``'s native route (``nat``) and its numpy route
    (``npy``) part, queries ``a`` against targets ``b``: (rows, rows that
    the two routes' own arithmetic does not explain, the largest gap in
    float32 ulps of thr²). The native search computes in float32, numpy in
    float64: a row is explained when the routes pick different targets and
    each is nearest by its own arithmetic (a tie), or when the target's
    squared distance lies on one side of thr² in float32 and on the other
    in float64 (the threshold)."""
    import numpy as np

    a32, b32 = a.astype(np.float32), b.astype(np.float32)
    r2_32, r2_64 = np.float32(thr) * np.float32(thr), float(thr) ** 2
    ulp = float(np.spacing(r2_32))

    def d2_32(r, j):  # the native's arithmetic: float32, no contraction
        dx, dy, dz = (b32[j] - a32[r]).tolist()
        dx, dy, dz = np.float32(dx), np.float32(dy), np.float32(dz)
        return (dx * dx + dy * dy) + dz * dz

    def d2_64(r, j):
        return float(np.sum((b[j] - a[r]) ** 2))

    (i_n, ok_n), (i_p, ok_p) = nat, npy
    rows = np.nonzero((ok_n != ok_p) | (ok_n & ok_p & (i_n != i_p)))[0]
    bad, gap = 0, 0.0
    for r in rows:
        if ok_n[r] and ok_p[r]:
            good = (d2_32(r, i_n[r]) <= d2_32(r, i_p[r])
                    and d2_64(r, i_p[r]) <= d2_64(r, i_n[r]))
            g = abs(d2_64(r, i_n[r]) - d2_64(r, i_p[r]))
        else:
            j = i_n[r] if ok_n[r] else i_p[r]
            good = (d2_32(r, j) <= r2_32) == bool(ok_n[r]) and (d2_64(r, j) <= r2_64) == bool(ok_p[r])
            g = abs(d2_64(r, j) - r2_64)
        bad += not good
        gap = max(gap, g / ulp)
    return len(rows), bad, gap


def bridges_native(cfg, frags, pair_name, line, card, device="cuda"):
    """(c) The native library built from the checkout; ``compute_correspondences``
    on the training pair on both routes (the search's results recorded as
    they are made, so the numpy route runs once); ``grid_subsample_batch``
    of the serving fragments against ``voxel_subsample`` on the card."""
    import numpy as np
    import torch
    from d3feat_tpu_torch import native
    from d3feat_tpu_torch.data import prepare
    from d3feat_tpu_torch.data.pack import EVAL_CACHE
    from d3feat_tpu_torch.ops.build import BUILD_DIR
    from d3feat_tpu_torch.ops.subsample import voxel_subsample

    lib = native.build()
    check(os.path.dirname(lib) == BUILD_DIR and native.available(),
          f"bridges (c): the native library {lib} is not the port's")
    phase(f"bridges (c): native library {os.path.relpath(lib)} built (or found) by g++ on the "
          f"host of {card}")

    fname, key = pair_name.split(":")
    i, j = key.split("_")[1:]
    with np.load(os.path.join(EVAL_CACHE, fname), allow_pickle=False) as z:
        src, tgt = (np.asarray(z[f"frag_{k}"], np.float32) for k in (i, j))
        pose = np.asarray(z[key], np.float64)
    calls = []
    orig = prepare._nn_within

    def recording(a, b, thr, use_native=True):
        out = orig(a, b, thr, use_native)
        calls.append((use_native, a, b, out))
        return out

    corr = {}
    prepare._nn_within = recording
    try:
        for use_native in (True, False):
            corr[use_native] = prepare.compute_correspondences(src, tgt, pose, CORR_RADIUS,
                                                               mutual=True,
                                                               use_native=use_native)
    finally:
        prepare._nn_within = orig
    rows, bad, gap = 0, 0, 0.0
    nat = [c for c in calls if c[0]]
    npy = [c for c in calls if not c[0]]
    for (_, a, b, n_out), (_, _, _, p_out) in zip(nat, npy):
        r, u, g = native_row_diffs(a, b, CORR_RADIUS, n_out, p_out)
        rows, bad, gap = rows + r, bad + u, max(gap, g)
    pairs = {tuple(p) for p in corr[True].tolist()} ^ {tuple(p) for p in corr[False].tolist()}
    check(len(nat) == len(npy) == 2 and bad == 0,
          f"bridges (c): {bad} of {rows} differing search rows not explained by float32 "
          f"rounding")
    phase(f"bridges (c): compute_correspondences on {pair_name} ({len(src)} + {len(tgt)} "
          f"points, radius {CORR_RADIUS}, mutual): native {len(corr[True])} pairs, numpy "
          f"{len(corr[False])} pairs, on the host of {card}; {rows} search rows differ ({bad} "
          f"unexplained, largest gap {gap:.3g} float32 ulps of r²), {len(pairs)} "
          f"correspondences differ")
    line["native"] = dict(pair=pair_name, pairs_native=len(corr[True]),
                          pairs_numpy=len(corr[False]), differing_rows=rows,
                          differing_pairs=len(pairs))

    group = frags[:2]
    pts = np.concatenate(group).astype(np.float32)
    lens = np.array([len(f) for f in group], np.int32)
    dl = cfg.first_subsampling_dl
    h_pts, h_lens, h_over = native.grid_subsample_batch(pts, lens, dl)
    pts_d, lens_d = torch.from_numpy(pts).to(device), torch.from_numpy(lens).to(device)
    res = voxel_subsample(pts_d, lens_d, dl, out_capacity=len(pts), num_clouds=2)
    d_lens = res.lengths.cpu().numpy()
    d_pts = res.points[:int(d_lens.sum())].cpu().numpy()
    check(not h_over and not bool(res.overflow) and np.array_equal(h_lens, d_lens),
          f"bridges (c): voxel counts native {h_lens.tolist()} vs the card's {d_lens.tolist()}")
    s = 0
    for n in h_lens:  # barycentres as sets, as tests/test_native.py compares them
        a = np.asarray(sorted(map(tuple, np.round(h_pts[s:s + n], 5))))
        b = np.asarray(sorted(map(tuple, np.round(d_pts[s:s + n], 5))))
        check(np.allclose(a, b, atol=1e-4, rtol=0), "bridges (c): barycentres differ")
        s += n
    row_diff = float(np.abs(h_pts - d_pts).max())
    phase(f"bridges (c): grid_subsample_batch at {dl} of {lens.tolist()} points: "
          f"{h_lens.tolist()} voxels as voxel_subsample on the card, barycentres equal as "
          f"sets (atol 1e-4; row by row within {row_diff:.3g}), on {card}")
    line["native"].update(voxels=h_lens.tolist(), barycentre_row_diff=row_diff)


def bridges_utils(cfg, frags, ex, group, tmp, line, card, device="cuda"):
    """(d) ``trace`` around one extraction call, whose file must hold the
    port's spans, and ``accuracy``/``iou`` of a KPCNN forward's logits on
    the card against the same functions on host copies."""
    import glob
    import re as re_

    import numpy as np
    import torch
    from d3feat_tpu_torch.models.kpcnn import apply_kpcnn, init_kpcnn
    from d3feat_tpu_torch.ops.neighbors import permute_rows
    from d3feat_tpu_torch.ops.pyramid import build_pyramid, make_pyramid_spec
    from d3feat_tpu_torch.utils.metrics import accuracy, iou
    from d3feat_tpu_torch.utils.profiling import TRACE_FILE, trace

    logdir = os.path.join(tmp, "trace")
    reset_launches()
    with trace(logdir):
        ex.extract_many(group)
        torch.cuda.synchronize()
    launched = sum(launches_by_kernel().values())
    path = os.path.join(logdir, TRACE_FILE)
    check(os.path.exists(path), f"bridges (d): no trace at {path}")
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    spans = {}  # base name -> [count, host ms]
    for e in events:
        n = str(e.get("name", ""))
        if n.startswith("port.") and e.get("cat") == "cpu_op":  # the host ranges
            s = spans.setdefault(n.split("[", 1)[0], [0, 0.0])
            s[0] += 1
            s[1] += float(e.get("dur", 0.0)) * 1e-3
    missing = {"port.extract", "port.extract.step", "port.pyramid", "port.model.head",
               "port.sync.copy_out"} - set(spans)
    check(not missing, f"bridges (d): the trace holds none of the spans {sorted(missing)}")
    names = set()
    src = os.path.join(os.path.dirname(os.path.abspath(__file__)), "d3feat_tpu_torch", "ops",
                       "cuda")
    for fn in glob.glob(os.path.join(src, "*.cu*")):
        with open(fn) as f:
            names.update(re_.findall(PORT_KERNELS_RE, f.read()))
    traced = {}
    for e in events:  # a kernel's name without its template arguments and signature
        m = re_.search(r"(\w+)\s*[<(]", str(e.get("name", "")))
        n = m.group(1) if m else str(e.get("name", ""))
        if e.get("cat") == "kernel" and n in names:
            traced[n] = traced.get(n, 0) + 1
    phase(f"bridges (d): trace of one extraction call, {len(events)} events, the port's "
          f"spans present; the port's kernels in it {traced} ({sum(traced.values())} "
          f"events) beside {launched} wrapper launches (information: a profile can leave "
          f"ctypes launches out), on {card}")
    print("bridges (d): the port's spans (count, host ms)\n" + "\n".join(
        f"{n}: {c} x, {ms:.3f} ms" for n, (c, ms) in sorted(spans.items())), flush=True)

    kcfg = route_config(cfg, num_classes=40)
    kpcnn = init_kpcnn(kcfg, seed=2, device=device)
    serving = packed_batch(group, kcfg.caps.points[0], device)
    pyr = build_pyramid(serving["points"], serving["lengths"],
                        spec=make_pyramid_spec(kcfg, num_clouds=2))
    with torch.no_grad():
        logits = apply_kpcnn(kpcnn, dict(pyr, features=permute_rows(
            serving["features"], pyr["band"][0]["order"]))).logits
    labels = torch.from_numpy(np.random.default_rng(BRIDGE_LABELS_SEED).integers(
        0, 40, logits.shape[0])).to(device)
    acc_d, acc_h = accuracy(logits, labels), accuracy(logits.cpu().numpy(), labels.cpu().numpy())
    iou_d = iou(logits.argmax(-1), labels, 40)
    iou_h = iou(logits.cpu().numpy().argmax(-1), labels.cpu().numpy(), 40)
    check(logits.device.type == torch.device(device).type and acc_d == acc_h and np.array_equal(iou_d, iou_h),
          f"bridges (d): metrics on the card's logits {acc_d} differ from the host copies' {acc_h}")
    phase(f"bridges (d): KPCNN logits {tuple(logits.shape)} on the card scored as their host "
          f"copies: accuracy {acc_d}, mean IoU {float(iou_d.mean()):.6g}")
    line["utils"] = dict(trace_events=len(events), traced_kernels=traced,
                         wrapper_launches=launched, accuracy=acc_d,
                         mean_iou=float(iou_d.mean()), spans=spans)


def bridges_phase(cfg, model, frags, pair_name, models, report, card, device="cuda"):
    """Phase 12: the reference ``.pth`` bridges, the native host geometry,
    and the metrics and profiling utilities, subphases (a)-(d) of the
    module docstring; K1-K3's launches in (a)'s counted extractions go into
    ``report`` as ``bridges_phase_launches``. Returns the JSON line's dict."""
    import tempfile

    line = {"card": card}
    acc = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_bridges_") as tmp:
        pth, ex, group = bridges_round_trip(cfg, model, frags, models, tmp, line, acc, card,
                                            device)
        procs = bridges_cli_start(pth, tmp, device)
        try:  # the command lines run while (c) runs here
            bridges_native(cfg, frags, pair_name, line, card, device)
            bridges_cli_finish(procs, line, card)
        finally:
            for p in procs.values():
                if p.poll() is None:
                    p.kill()
                    p.wait()
        bridges_utils(cfg, frags, ex, group, tmp, line, card, device)
    for name, *_ in KERNELS:
        if name in report:
            report[name]["bridges_phase_launches"] = acc.get(name, 0)
    line["launches"] = {k: v for k, v in acc.items() if v}
    return line


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    from d3feat_tpu_torch import card_name
    from d3feat_tpu_torch.compat.weights import load_npz
    from d3feat_tpu_torch.data.pack import bench_config, load_eval_fragments, pack_fragments
    from d3feat_tpu_torch.models.kpfcnn import init_kpfcnn
    from d3feat_tpu_torch.ops import build
    from d3feat_tpu_torch.ops.pyramid import build_pyramid, make_pyramid_spec

    torch.backends.cuda.matmul.allow_tf32 = False  # full FP32 everywhere
    torch.backends.cudnn.allow_tf32 = False
    # bf16 products of the unary layers accumulate in f32, as the JAX package's
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False

    phase("device")
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = card_name("cuda")
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
    check_k1_unsorted(cfg, frags, report)
    check_lists(pyr, cfg, model, report)
    check_k2(pyr, cfg, model, report)
    check_k3(pyr, cfg, report)
    check_k4(pyr, cfg, model, report)
    check_k5(pyr, cfg, report)
    check_k7(cfg, report)
    time_gather_kpconv(pyr, cfg, model, report)
    phase("bf16 kernels vs bf16 twins")
    check_k2(pyr, cfg, model, report, panel="bfloat16")
    check_k4(pyr, cfg, model, report, panel="bfloat16")
    phase("list mode (no thresholds): kernels vs twins")
    check_list_stage(pyr, cfg, model, report)
    for panel in ("float32", "bfloat16"):
        check_k2(pyr, cfg, model, report, panel=panel, mode="list")
        check_k4(pyr, cfg, model, report, panel=panel, mode="list")
    del pyr

    phase("serving path")
    f32_out = main_path(cfg, model, frags, report)
    phase("serving path, bf16")
    serve_bf16(cfg, model, frags, report, f32_out)
    phase("training path")
    batch, (name, n0, n1, n_corr) = training_pair(cfg, make_pyramid_spec(cfg))
    phase(f"training pair {name}: {n0} + {n1} points, {n_corr} correspondences within "
          f"{CORR_RADIUS}, {NUM_NODE} used")
    train_phase(cfg, report, batch)
    phase("training path, bf16")
    train_bf16(cfg, report, batch)
    phase("list path (no thresholds)")
    list_path(cfg, model, frags, batch, report)
    phase("data parallelism")
    dp_line = dp_phase(cfg, batch, frags)
    phase("trainer")
    trainer_line = trainer_phase(smi)
    phase("recall")
    recall_line = recall_phase(smi)
    phase("gather route")
    gather_line = gather_phase(cfg, model, frags, batch, report, smi)
    phase("variants: batch norm, deformable KPConv, randomised kernel points, KPCNN")
    trained = {}
    variants_line = variants_phase(cfg, frags, batch, report, smi, keep=trained)
    phase("bridges: the reference .pth, native host geometry, metrics and profiling")
    bridges_line = bridges_phase(cfg, model, frags, name, trained, report, smi)
    del trained

    kernels = []
    for name, _, _, _, src, replaces in KERNELS:
        r = report[name]
        kernels.append({"name": name, "route": "cuda",
                        "source": f"d3feat_tpu_torch/ops/cuda/{src}", "replaces": replaces,
                        "launches": r["launches"], "max_abs_err": r["max_abs_err"],
                        "ms": r["ms"]})
        if "gather_phase_launches" in r:  # off the main path: its launches in phase 10
            kernels[-1]["gather_phase_launches"] = r["gather_phase_launches"]
        kernels[-1]["variants_phase_launches"] = r["variants_phase_launches"]  # phase 11
        kernels[-1]["bridges_phase_launches"] = r["bridges_phase_launches"]  # phase 12
    k7 = report["K7 neighbor_max"]  # replaces no TPU kernel: XLA's max over lists
    kernels.append({"name": "K7 neighbor_max", "route": "cuda",
                    "source": "d3feat_tpu_torch/ops/cuda/neighbor_max.cu", "replaces": None,
                    "launches": k7["launches"], "max_abs_err": k7["max_abs_err"],
                    "ms": k7["ms"], "plain_ms": k7["plain_ms"]})
    print(json.dumps({"recall": recall_line}), flush=True)
    print(json.dumps({"trainer": trainer_line}), flush=True)
    print(json.dumps({"data_parallel": dp_line}), flush=True)
    print(json.dumps({"gather_route": gather_line}), flush=True)
    print(json.dumps({"variants": variants_line}), flush=True)
    print(json.dumps({"bridges": bridges_line}), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                              "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
