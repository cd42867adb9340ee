"""Held-out registration recall through the port's serving path (port of
``tools/final_recall.py``).

Run from the repository root::

    python3 -m d3feat_tpu_torch.final_recall --snapshot artifacts/model_best_acc_r5.npz \
        --scenes 4 --scene_cache artifacts/eval_cache --skip_init [--bf16] [--out PATH]

Held-out warped scenes (exact ground-truth poses; ``eval/scene_cache.py``,
loaded from ``--scene_cache`` or generated) go through the bucketed
``FeatureExtractor`` (``batch_fragments`` per call, overflow warned and
kept) on the card, then the registration protocol (top-k keypoints,
mutual-NN, inlier ratio at 0.10, recall at 5 %; reference test.py:20-82)
for (a) the snapshot and (b) the same architecture at the port's own
random init (``init_kpfcnn``, the config's seed; its stream is not JAX's,
so its numbers are not comparable with the JAX tool's). ``--skip_init``
leaves (b) out.

It prints the JAX tool's JSON, plus ``card`` (``nvidia-smi``'s name and
power limit), ``compute_dtype`` and the overflow warnings per scene, and
writes it to ``--out`` only when given. ``--snapshot`` takes the portable
npz, or a snapshot directory of the port's trainer (its ``config.json``
and the snapshot ``--name``, default ``model_best_acc``); ``--cpu`` runs
the plain PyTorch twins on the CPU. Without ``--cpu`` it needs a CUDA
device.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import warnings

import numpy as np
import torch

PROTOCOL = "reference test.py:20-82 (top-k, mutual-NN, inlier>0.05 at 0.10 m)"


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description="held-out registration recall (port)")
    ap.add_argument("--snapshot", type=str, default="artifacts/model_best_acc_r5.npz",
                    help="portable params-only npz, or a snapshot directory")
    ap.add_argument("--name", type=str, default="model_best_acc",
                    help="the snapshot to load from a snapshot directory")
    ap.add_argument("--fragments", type=int, default=12)
    ap.add_argument("--num_points", type=int, default=250)
    ap.add_argument("--seed", type=int, default=424242)  # held-out scenes
    ap.add_argument("--scenes", type=int, default=4)
    ap.add_argument("--warp", type=float, default=2.0,
                    help="domain-warp amplitude; match the training corpus")
    ap.add_argument("--frame", type=str, default="axis", choices=["axis", "so3"])
    ap.add_argument("--batch_fragments", type=int, default=2)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (the kernels' plain twins)")
    ap.add_argument("--bf16", action="store_true", help='compute_dtype="bfloat16"')
    ap.add_argument("--out", type=str, default=None, help="also write the JSON here")
    ap.add_argument("--scene_cache", type=str, default=None,
                    help="directory of scene_<seed>_<fragments>_<frame>_<warp>.npz "
                    "(a missing scene is generated and written there)")
    ap.add_argument("--skip_init", action="store_true",
                    help="skip the init-weights control pass")
    return ap.parse_args(argv)


def load_snapshot(path: str, device, bf16: bool = False, name: str = "model_best_acc"):
    """(config, model with the snapshot's weights, meta without the config)
    of a portable npz (its meta's config), or of a snapshot directory of the
    port's ``Trainer`` (its ``config.json`` and the snapshot ``name``)."""
    from d3feat_tpu_torch.compat.portable import read_npz
    from d3feat_tpu_torch.compat.weights import load_npz
    from d3feat_tpu_torch.config import D3FeatConfig
    from d3feat_tpu_torch.models.kpfcnn import init_kpfcnn
    from d3feat_tpu_torch.train.checkpoint import SnapshotManager

    npz = path.endswith(".npz")
    cfg = (D3FeatConfig.from_dict(read_npz(path)[2]["config"]) if npz
           else D3FeatConfig.from_json(os.path.join(path, "config.json")))
    if bf16:
        cfg.compute_dtype = "bfloat16"
    model = init_kpfcnn(cfg, seed=cfg.seed, device=device)
    meta = load_npz(model, path) if npz else SnapshotManager(path).restore_model(name, model)
    meta.pop("config", None)
    return cfg, model, meta


def scene_recall(ex, frags, poses, num_points: int = 250):
    """One scene: ``ex.extract_many`` group by group (overflow warnings
    caught per group), then ``register_scene``. Returns the
    ``SceneResult`` and the details: per fragment its size, group, whether
    the group overflowed, whether its descriptors and scores are finite and
    the selected keypoints; per gt pair the correspondences, inliers and
    inlier ratio; the warnings."""
    from d3feat_tpu_torch.eval.matching import inlier_stats, mutual_nn_numpy, select_keypoints
    from d3feat_tpu_torch.eval.registration import FragmentFeatures, register_scene

    feats, rows, groups, msgs = FragmentFeatures(), [], [], []
    b = ex.batch_fragments
    for g in range(0, len(frags), b):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            out = ex.extract_many(frags[g:g + b])
        over = [str(w.message) for w in caught if "overflow" in str(w.message)]
        if over:
            groups.append(g // b)
            msgs.extend(over)
        for i, (desc, sc) in enumerate(out, start=g):
            feats.add(i, frags[i], desc, sc)
            rows.append({"points": len(frags[i]), "group": g // b, "overflow": bool(over),
                         "finite": bool(np.isfinite(desc).all() and np.isfinite(sc).all())})
    res = register_scene(feats, poses, num_points=num_points)
    sel = {i: select_keypoints(feats.scores[i], num_points) for i in range(len(rows))}
    for i, row in enumerate(rows):
        row["top"] = sel[i].tolist()
    pairs = {}
    for key in poses:
        i, j = (int(v) for v in key.split("_"))
        corr = mutual_nn_numpy(np.nan_to_num(feats.descriptors[i][sel[i]]),
                               np.nan_to_num(feats.descriptors[j][sel[j]]))
        n_in, ratio = inlier_stats(feats.keypts[i][sel[i]], feats.keypts[j][sel[j]], corr,
                                   poses[key], 0.10)
        pairs[key] = {"corr": int(len(corr)), "inliers": int(n_in), "ratio": float(ratio)}
    return res, {"gt_pairs": res.gt_pairs, "matched_pairs": res.matched_pairs,
                 "recall": res.recall, "avg_inlier_ratio": res.avg_inlier_ratio,
                 "overflowed_groups": groups, "fragments": rows, "pairs": pairs,
                 "warnings": msgs}


def main(argv=None) -> int:
    args = parse_args(argv)
    from d3feat_tpu_torch import card_name, resolve_device
    from d3feat_tpu_torch.eval.extract import FeatureExtractor
    from d3feat_tpu_torch.eval.scene_cache import get_scene
    from d3feat_tpu_torch.models.kpfcnn import init_kpfcnn

    device = resolve_device("cpu" if args.cpu else "cuda")
    # the unary layers' f32 products in full f32, bf16 ones accumulated in
    # f32, as the JAX package computes them
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    torch.backends.cudnn.allow_tf32 = False
    cfg, trained, meta = load_snapshot(args.snapshot, device, args.bf16, args.name)
    card = card_name(device)
    print("loaded", args.snapshot, args.name, "meta:", meta, "device:", card, flush=True)

    scenes = []
    for s in range(args.scenes):
        frags, poses = get_scene(args.seed + s, args.fragments, args.frame, args.warp,
                                 cache_dir=args.scene_cache)
        print(f"scene {s}: {len(frags)} fragments ({[len(f) for f in frags]}), "
              f"{len(poses)} gt pairs", flush=True)
        scenes.append((frags, poses))

    results, per_scene, overflow = {}, {}, {}
    gt_total = 0
    passes = [("init", None), ("trained", trained)]
    if args.skip_init:
        results["init"] = {"recall": None, "avg_inlier_ratio": None,
                           "inlier_ratio_pctiles": {}}
        per_scene["init"] = {"per_scene_recall": []}
        passes = passes[1:]
    for tag, model in passes:
        if model is None:
            model = init_kpfcnn(cfg, seed=cfg.seed, device=device)
        ex = FeatureExtractor(cfg, model, batch_fragments=args.batch_fragments,
                              on_overflow="warn", device=device)
        recalls, ratios, pair_ratios, pair_detail = [], [], [], {}
        for s, (frags, poses) in enumerate(scenes):
            res, detail = scene_recall(ex, frags, poses, args.num_points)
            recalls.append(res.recall)
            ratios.append(res.avg_inlier_ratio)
            pair_ratios.extend((res.pair_ratios or {}).values())
            pair_detail[f"scene{s}"] = {k: round(v, 5)
                                        for k, v in (res.pair_ratios or {}).items()}
            if tag == "trained":
                gt_total += len(poses)
                overflow[f"scene{s}"] = detail["warnings"]
            print(f"  {tag} scene {s}: recall {res.recall:.1f} "
                  f"inlier_ratio {res.avg_inlier_ratio:.4f}", flush=True)
        pr = np.asarray(pair_ratios, np.float64)
        results[tag] = {
            "recall": float(np.mean(recalls)),
            "avg_inlier_ratio": float(np.mean(ratios)),
            "inlier_ratio_pctiles": {
                str(p): float(np.percentile(pr, p)) if pr.size else 0.0
                for p in (10, 25, 50, 75, 90)
            },
        }
        per_scene[tag] = {"per_scene_recall": recalls}
        if tag == "trained":
            results[tag]["pair_inlier_ratios"] = pair_detail
        print(tag, {k: v for k, v in results[tag].items() if k != "pair_inlier_ratios"},
              flush=True)

    out = {
        "protocol": PROTOCOL,
        "path": f"serving FeatureExtractor (bucketed), device {device.type}",
        "gt_pairs": gt_total,
        "frame": args.frame,
        "warp": args.warp,
        "num_points": args.num_points,
        "snapshot": (args.snapshot if args.snapshot.endswith(".npz")
                     else os.path.join(args.snapshot, args.name)),
        "epochs_meta": meta,
        "per_scene_recall": per_scene,
        "fragment_sizes": {f"scene{s}": [len(f) for f in frags]
                           for s, (frags, _) in enumerate(scenes)},
        **{f"{k}_{t}": v for t, r in results.items() for k, v in r.items()},
        "recall_gain": (results["trained"]["recall"] - results["init"]["recall"]
                        if not args.skip_init else None),
        "inlier_ratio_gain": (results["trained"]["avg_inlier_ratio"]
                              - results["init"]["avg_inlier_ratio"]
                              if not args.skip_init else None),
        "card": card,
        "compute_dtype": cfg.compute_dtype,
        "overflow_warnings": overflow,
    }
    print(json.dumps(out, indent=2, default=str))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=2, default=str)
    return 0


if __name__ == "__main__":
    sys.exit(main())
