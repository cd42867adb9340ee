"""Tiny cells for the CPU tests: three-level model at width 16 on balls of
a held-out fragment, so a whole run (set-up, window, check) takes seconds
with the program's plain twins."""

import json
import os

import numpy as np

from harness.manifest import BENCH_DIR, ROOT, Cell

SCENE = os.path.join(ROOT, "artifacts", "eval_cache", "scene_424242_12_axis_2.0.npz")
DEFORM_ARCH = ["simple", "resnetb", "resnetb_strided", "resnetb", "resnetb",
               "resnetb_deformable_strided", "resnetb_deformable", "resnetb_deformable",
               "nearest_upsample", "unary", "nearest_upsample", "last_unary"]


def write_scene(path, n=600, frags=4, seed=0):
    """Fragments of ``n``, ``n - 50``, ... points nearest one point of a
    held-out fragment, paired (0, 1) and (2, 3) with identity poses."""
    rng = np.random.default_rng(seed)
    with np.load(SCENE) as z:
        p0 = np.asarray(z["frag_0"], np.float32)
    order = np.argsort(np.linalg.norm(p0 - p0[rng.integers(len(p0))], axis=1))
    out = {f"frag_{i}": p0[order[: n - 50 * i]] for i in range(frags)}
    out.update(n_frags=np.array(frags), pair_keys=np.array(["0_1", "2_3"]),
               pose_0_1=np.eye(4), pose_2_3=np.eye(4))
    np.savez(path, **out)
    return str(path)


def tiny_cell(kind: str, scene: str, deform: bool = False, batch_fragments: int = 2) -> Cell:
    with open(os.path.join(BENCH_DIR, "configs", "d3feat-3dmatch.json")) as f:
        cfg = json.load(f)
    cfg.update(num_layers=3, first_features_dim=16, num_node=16,
               caps={"points": [2048, 1024, 512], "neighbors": [24, 24, 24], "corr": 16},
               weights={"file": "artifacts/model_best_acc_r5.npz",
                        "draw": ["weights", "w", "offset_weights"],
                        "zeros": ["b", "bias", "offset_bias"],
                        "copy": {"offset_kernel_points": "kernel_points"}})
    if deform:
        cfg["architecture"] = DEFORM_ARCH
    if kind == "extract":
        traffic = {"kind": "extract", "scenes": scene, "batch_fragments": batch_fragments,
                   "on_overflow": "retry", "buckets": [1024], "translation": 1.0,
                   "warmup": 0, "check_groups": 2, "trace_seconds": 1,
                   "prepared_per_s": 20}
        limits = {"pyramid_miss": 0, "desc_off_share": 10.0, "score_off_share": 1.0}
        e2e = "extract_fragments_per_s"
    else:
        traffic = {"kind": "train", "scenes": scene, "point_budget": 2048, "num_corr": 16,
                   "corr_radius": 0.0375, "translation": 1.0, "check_steps": 3,
                   "warmup": 0, "trace_seconds": 1, "prepared_per_s": 20}
        limits = {"pyramid_miss": 0, "start_miss": 0, "loss_gap": 1e-3, "grad_gap": 4e-2,
                  "update_gap": 0.05}
        e2e = "train_steps_per_s"
    return Cell(name="tiny." + kind, config_name="tiny", traffic_name=kind, chips=1,
                config=cfg, traffic=traffic, limits=limits,
                end_to_end=[{"name": "setup_s", "unit": "s"}, {"name": e2e, "unit": "1/s"}])
