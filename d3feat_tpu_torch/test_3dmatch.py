"""Evaluation entry point of the port: feature generation and
geometric-registration recall (port of the JAX package's
``test_3dmatch.py``).

Run from the repository root::

    python3 -m d3feat_tpu_torch.test_3dmatch --snapshot artifacts/model_best_acc_r5.npz \
        --root <3DMatch root> --generate_features [--save_path DIR]
    python3 -m d3feat_tpu_torch.test_3dmatch --synthetic [--cpu]

``--generate_features`` extracts every test fragment (``<root>/fragments/
<scene>/*.ply``, voxel-downsampled) and saves keypoints, descriptors and
scores per fragment in the reference's ``.npy`` layout; without it the
saved features are read back. Then per-scene feature-match recall runs
against ``<gt_root>/<scene>-evaluation/gt.log``. ``--synthetic`` runs the
whole pipeline hermetically on generated fragments with exact poses.

``--snapshot`` takes the portable npz (default: the config's random init,
the port's own stream); ``--chosen_snapshot`` a snapshot directory of the
port's trainer (its ``config.json`` and the snapshot ``--snapshot_name``,
default ``model_best_acc``). ``--torch_checkpoint`` takes a reference
``.pth`` (``compat/torch_import.py::load_torch_checkpoint``; the layout
that either package's ``save_torch_checkpoint`` writes), on the config of
``--chosen_snapshot``'s ``config.json`` when that is given, else
``D3FeatConfig()``. Without ``--cpu`` it needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="d3feat_tpu_torch evaluation")
    p.add_argument("--snapshot", type=str, default="", help="portable params-only npz")
    p.add_argument("--chosen_snapshot", type=str, default="",
                   help="snapshot directory of the port's trainer (config.json + snapshots)")
    p.add_argument("--torch_checkpoint", type=str, default="",
                   help="reference .pth checkpoint (its config from --chosen_snapshot's "
                   "config.json, else the default config)")
    p.add_argument("--snapshot_name", type=str, default="model_best_acc")
    p.add_argument("--inlier_ratio_threshold", default=0.05, type=float)
    p.add_argument("--distance_threshold", default=0.10, type=float)
    p.add_argument("--random_points", default=False, action="store_true")
    p.add_argument("--num_points", default=250, type=int)
    p.add_argument("--generate_features", default=False, action="store_true")
    p.add_argument("--root", type=str, default="",
                   help="3DMatch root (overrides the snapshot's config)")
    p.add_argument("--gt_root", type=str, default="geometric_registration/gt_result")
    p.add_argument("--save_path", type=str, default="")
    p.add_argument("--synthetic", default=False, action="store_true")
    p.add_argument("--cpu", default=False, action="store_true",
                   help="run on the CPU (the kernels' plain twins)")
    return p.parse_args(argv)


def load_model(args, device):
    """(config, model): the ``.pth``'s weights (``--torch_checkpoint``), the
    npz's, the snapshot directory's (``--chosen_snapshot``,
    ``--snapshot_name``), or the default config's init."""
    from d3feat_tpu_torch.config import D3FeatConfig
    from d3feat_tpu_torch.models.kpfcnn import init_kpfcnn

    if args.torch_checkpoint:
        from d3feat_tpu_torch.compat.torch_import import load_torch_checkpoint

        config = (D3FeatConfig.from_json(os.path.join(args.chosen_snapshot, "config.json"))
                  if args.chosen_snapshot else D3FeatConfig())
        model, _ = load_torch_checkpoint(args.torch_checkpoint, config, device=device)
    elif args.snapshot or args.chosen_snapshot:
        from d3feat_tpu_torch.final_recall import load_snapshot

        config, model, _ = load_snapshot(args.snapshot or args.chosen_snapshot, device,
                                         name=args.snapshot_name)
    else:
        config = D3FeatConfig()
        model = init_kpfcnn(config, seed=config.seed, device=device)
    if args.root:
        config.root = args.root
    return config, model


def synthetic_eval(args, config, model, device):
    """Hermetic: one synthetic scene of three transformed fragment views."""
    from d3feat_tpu_torch.data.synthetic import synthetic_fragment
    from d3feat_tpu_torch.data.threedmatch import voxel_downsample
    from d3feat_tpu_torch.eval.extract import FeatureExtractor
    from d3feat_tpu_torch.eval.registration import FragmentFeatures, register_scene

    rng = np.random.default_rng(0)
    extractor = FeatureExtractor(config, model, device=device)
    feats = FragmentFeatures()
    poses = {}
    # the protocol always voxel-downsamples fragments before the network
    # (reference: datasets/ThreeDMatch.py:190-191)
    base = voxel_downsample(
        synthetic_fragment(rng, 4000, extent=3.0),
        max(config.downsample, config.first_subsampling_dl),
    )
    frames = []
    for f in range(3):
        rot = np.linalg.qr(rng.normal(size=(3, 3)))[0]
        if np.linalg.det(rot) < 0:
            rot[:, 0] *= -1
        t = rng.normal(size=3) * 0.3
        frames.append((rot, t))
        local = (base - t) @ rot
        desc, scores = extractor.extract(local.astype(np.float32))
        feats.add(f, local, desc, scores)
    for i in range(3):
        for j in range(i + 1, 3):
            ri, ti = frames[i]
            rj, tj = frames[j]
            gt = np.eye(4)
            gt[:3, :3] = ri.T @ rj
            gt[:3, 3] = (tj - ti) @ ri
            poses[f"{i}_{j}"] = gt
    res = register_scene(
        feats, poses, scene="synthetic", num_points=args.num_points,
        inlier_ratio_threshold=args.inlier_ratio_threshold,
        distance_threshold=args.distance_threshold,
        random_points=args.random_points,
    )
    print(json.dumps({
        "scene": res.scene, "recall": res.recall,
        "avg_inlier_ratio": res.avg_inlier_ratio,
        "avg_inlier_num": res.avg_inlier_num,
    }))
    return 0


def main(argv=None):
    import torch

    from d3feat_tpu_torch import resolve_device

    args = parse_args(argv)
    device = resolve_device("cpu" if args.cpu else "cuda")
    torch.backends.cuda.matmul.allow_tf32 = False  # full f32, as the JAX package
    torch.backends.cudnn.allow_tf32 = False
    config, model = load_model(args, device)

    if args.synthetic:
        return synthetic_eval(args, config, model, device)

    from d3feat_tpu_torch.data.threedmatch import ThreeDMatchTestset
    from d3feat_tpu_torch.eval.extract import FeatureExtractor, generate_features
    from d3feat_tpu_torch.eval.registration import FragmentFeatures, evaluate_scenes

    save_path = args.save_path or os.path.join(
        "geometric_registration",
        os.path.splitext(os.path.basename(args.torch_checkpoint or args.snapshot))[0]
        or os.path.basename(args.chosen_snapshot.rstrip("/")) or "d3feat_tpu_torch")
    testset = ThreeDMatchTestset(config.root, downsample=config.downsample)

    if args.generate_features:
        extractor = FeatureExtractor(config, model, device=device)
        scene_features = generate_features(extractor, testset, save_path=save_path,
                                           verbose=True)
    else:
        scene_features = {scene: FragmentFeatures.load(save_path, scene)
                          for scene in testset.scene_list}

    results, summary = evaluate_scenes(
        scene_features, args.gt_root,
        num_points=args.num_points,
        inlier_ratio_threshold=args.inlier_ratio_threshold,
        distance_threshold=args.distance_threshold,
        random_points=args.random_points,
    )
    for r in results:
        print(f"{r.scene}: Recall={r.recall:.2f}%, "
              f"inlier ratio={r.avg_inlier_ratio*100:.2f}%, "
              f"inlier num={r.avg_inlier_num:.2f}")
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
